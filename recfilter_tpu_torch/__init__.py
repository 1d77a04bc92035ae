"""recfilter_tpu_torch — the PyTorch + CUDA port of recfilter_tpu.

The first slice: 2-D recursive filters that scan the trailing two axes in
float32 (zero or clamp border, any extents ≥ 128 with zero border), run by
the 3-touch executor on two hand-written CUDA kernels for Hopper (sm_90a),
with plain PyTorch twins on the CPU. The JAX package ``recfilter_tpu`` is
the reference; this package imports neither it nor jax.

    import recfilter_tpu_torch as rft

    x = rft.Dim("x", 4096); y = rft.Dim("y", 4096)
    F = rft.RecFilter("GaussianIIR")
    F[y, x] = image
    w = rft.gaussian_weights(5.0, 3)
    for d in (+x, -x, +y, -y):
        F.add_filter(d, w)
    F.split(x, 128, y, 128)
    out = F.realize(device="cuda")
"""

from .api import RecFilter
from .dimfuse import apply_filter_fused
from .iir import (gaussian_box_filter, gaussian_weights, integral_image_coeff,
                  overlap_feedback_coeff)
from .overlap2d import Fused2DPx, fused_2d_px
from .planner import Plan
from .scan_core import oracle_apply
from .spec import (BorderMode, Dim, DimAndCausality, FilterSpec, Scan,
                   make_scan, spec_from_arrays, spec_from_json, spec_to_json)
from .utils.testing import CheckResult, CheckResultVerbose, generate_random_image

__all__ = [
    "RecFilter", "Plan", "Dim", "DimAndCausality", "FilterSpec", "Scan",
    "BorderMode", "make_scan", "spec_to_json", "spec_from_json",
    "spec_from_arrays", "gaussian_weights", "integral_image_coeff",
    "overlap_feedback_coeff", "gaussian_box_filter", "oracle_apply",
    "apply_filter_fused", "Fused2DPx", "fused_2d_px", "CheckResult",
    "CheckResultVerbose", "generate_random_image",
]

__version__ = "0.1.0"
