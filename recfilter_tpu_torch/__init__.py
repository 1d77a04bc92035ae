"""recfilter_tpu_torch — the PyTorch + CUDA port of recfilter_tpu.

Its paths run on hand-written CUDA kernels for Hopper (sm_90a), with
plain PyTorch twins on the CPU:

  * float32 2-D filters that scan the trailing two axes (any extents
    ≥ 128 with zero border): the 3-touch executor on
    ``moments2d``/``final2d``;
  * float32 filters whose scans all lie on the last axis — 1-D signals up
    to audio scale (10M samples), channels on leading axes: the last-axis
    executor on ``tails``/``completion``;
  * float32 scans on any other axis (extents that are multiples of 128):
    the rows pass on ``rows_tails``/``rows_final`` — volumes (rows pass,
    then the 2-D executor), vertical-only filters, non-adjacent axes, and
    the staged Gaussian cascades of ``apps.gaussian``;
  * everything those executors decline on 2–5 trailing axes — clamp
    images of any extent (the B-spline prefilters of ``apps.bspline``),
    small images, panoramas, more than 8 carries, volumes of any depth,
    4-D and 5-D filters, and every such filter at ``highest``: the rotation
    chain (``dimfuse.RotationChain``) on ``tails``/``completion_rot``, each
    pass after the first taking its tails from ``completion_rot_tails``;
    a non-last axis the rows pass declines takes the same rotated pass
    (``dimfuse.FusedAxisPass``);
  * banded FIR banks (``fir``: the iterated box filters and the difference
    of Gaussians of ``apps.box`` / ``apps.dog``) on ``fir_band``;
  * integer filters (int8/16/32, uint8/16/32), bit exact with
    wrap-around: unit-feedback scans under a zero border — summed-area
    tables and integral images — on ``int_scan`` and, for long axes,
    ``int_seg_scan``; any other scan or a clamp border as mantissa limbs
    through the tiled pass at ``f32x9`` (float64 einsum forms); the
    sequential core past the gain gate and for int64;
  * every precision grade of the JAX package: px6 and ``highest``; px3,
    px4 and ``default`` on the split-bf16 kernels ``final2d_split``,
    ``rows_final`` (volumes; the rows pass at px3 and px4),
    ``completion_split`` and the rotated ``completion_rot``,
    ``completion_rot_epi`` and ``completion_rot_tails`` (the rotation
    chain, ``FusedAxisPass``, the rotated emit; at ``default`` where the
    JAX package finds a structural win); ``f32x3``, ``f32x4``, ``f32x6`` and ``high`` as
    split bf16 chunk products in the einsum forms, ``f32x9`` in float64;
  * the ``scripts/`` probes as studies: ``split_mm`` and the int8
    ``ozaki_i8``, ``dual_px6``, ``gemm_i8``, ``gemm_bf16``
    (``kernels.split_mm``, ``kernels.int8_mm``);
  * the fused consumers of ``RecFilter.as_func(epilogue=, stencil=,
    stencil2d=)``: the rotated emit (``Plan.rotate_emit``,
    ``dimfuse.RotatedPass``) with its 1-D stencil on ``completion_rot``, a
    2-D bank on ``final2d_stencil`` or ``stencil2d`` — the SAT forms of
    the box and DoG apps;
  * the unsharp mask (``apps.unsharp_mask``): the Gaussian cascade merged
    back into one filter (``fuse_cascade``) with the combine inside
    ``final2d``'s store loop — every affine epilogue rides the final
    kernel (``final2d_epi``, ``completion_epi``, ``completion_rot_epi``);
    Tuple filters, ``compute_at`` and ``overlap_to_higher_order_filter``;
  * the JAX package's other executor backends, chosen by ``Plan.backend``
    (``set_plan(backend=...)``, or a schedule directive:
    ``F.intra_schedule(1).compute_locally()`` selects ``pallas``): the
    strip passes of ``pallas`` on ``dim_pass_rows``/``dim_pass_cols``
    (``kernels.fused.StripFilter``); the paired executors of
    ``overlap``/``overlap_k`` (``overlap2d.OverlapFilter``), the latter's
    HIGHEST 2-D pair on ``moments2d_k``/``final2d_k``; the blocked algebra
    (``tiling.BlockedFilter``); the sequential core
    (``scan_core.ScanFilter``: untiled filters, and every axis with no
    tile plan on the other routes); the float64 oracle;
  * the learnable (training) path, ``learnable.LearnableRecFilter``: any
    filter's coefficients as trainable parameters, each axis one fused pass
    on ``tails_traced``/``completion_traced`` (runtime matrices, gradients
    for the coefficients) where the JAX package's kernel gate holds, float64
    einsums elsewhere.

The JAX package ``recfilter_tpu`` is the reference; this package imports
neither it nor jax. Filters run on the card unless the caller asks for
the CPU (``device="cpu"``).

    import recfilter_tpu_torch as rft

    x = rft.Dim("x", 4096); y = rft.Dim("y", 4096)
    F = rft.RecFilter("GaussianIIR")
    F[y, x] = image
    w = rft.gaussian_weights(5.0, 3)
    for d in (+x, -x, +y, -y):
        F.add_filter(d, w)
    F.split(x, 128, y, 128)
    out = F.realize()

    from recfilter_tpu_torch.apps import audio_filter_high_order
    A = audio_filter_high_order(10_000_000, order=29, tile_width=1000)
    y = A.realize(signal)

    from recfilter_tpu_torch.apps import gaussian_1xy_2x_2y, run_cascade
    out = run_cascade(gaussian_1xy_2x_2y(4096, 4096), image)

    from recfilter_tpu_torch.apps import box_filter_3, summed_table
    blur = box_filter_3(4096, 4096, B=5)(image_on_the_card)
    sat = summed_table(4096, 4096, dtype="int32").realize(int_image)

    from recfilter_tpu_torch.apps import unsharp_mask
    sharp = unsharp_mask(4096, 4096)(image_on_the_card)

    model = rft.LearnableRecFilter(F.spec, tile_width=128)
    opt = torch.optim.Adam(model.parameters(), 2e-2)
    ((model(image) - target) ** 2).mean().backward(); opt.step()
"""

from .api import (Composed, EpilogueAfter, RecFilter, TupleFilter,
                  fuse_cascade)
from .epilogue import Affine, affine_form, is_elementwise
from .dimfuse import (FusedAxisPass, FusedLastAxis, IntUnitPass,
                      RotatedPass, RotationChain, StagedPass,
                      apply_filter_fused, apply_filter_rotated)
from .fir import FirPass, FirSeparable2D, fir_pass_last, fir_separable_2d
from .iir import (gaussian_box_filter, gaussian_weights, integral_image_coeff,
                  overlap_feedback_coeff)
from .learnable import (LearnableRecFilter, fused_dim_learnable,
                        params_from_jax)
from .kernels.fused import StripFilter
from .overlap2d import (Fused2DK, Fused2DPx, FusedRowsPx, OverlapFilter,
                        apply_filter_overlap, fused_2d_px, fused_rows_px)
from .planner import Plan, RecFilterSchedule
from .scan_core import OracleFilter, ScanFilter, oracle_apply
from .tiling import BlockedFilter
from .spec import (BorderMode, Dim, DimAndCausality, FilterSpec, Scan,
                   make_scan, spec_from_arrays, spec_from_json, spec_to_json)
from .utils.testing import CheckResult, CheckResultVerbose, generate_random_image

__all__ = [
    "RecFilter", "Plan", "TupleFilter", "Composed", "fuse_cascade",
    "Affine", "affine_form", "is_elementwise", "Dim", "DimAndCausality", "FilterSpec", "Scan",
    "BorderMode", "make_scan", "spec_to_json", "spec_from_json",
    "spec_from_arrays", "gaussian_weights", "integral_image_coeff",
    "overlap_feedback_coeff", "gaussian_box_filter", "oracle_apply",
    "apply_filter_fused", "apply_filter_rotated", "RotatedPass",
    "RotationChain", "Fused2DPx", "fused_2d_px", "FusedLastAxis",
    "FusedAxisPass",
    "FusedRowsPx", "fused_rows_px", "StagedPass", "IntUnitPass",
    "FirPass", "FirSeparable2D", "fir_pass_last", "fir_separable_2d",
    "LearnableRecFilter", "fused_dim_learnable", "params_from_jax",
    "CheckResult", "CheckResultVerbose", "generate_random_image",
    "EpilogueAfter", "StripFilter", "Fused2DK", "OverlapFilter",
    "apply_filter_overlap", "RecFilterSchedule", "OracleFilter",
    "ScanFilter", "BlockedFilter",
]

__version__ = "0.1.0"
