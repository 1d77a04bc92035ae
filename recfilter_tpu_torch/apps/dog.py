"""Difference of Gaussians via iterated box filters (the JAX package's
``recfilter_tpu/apps/dog.py``; the reference's ``apps/DoG/diff_gauss.cpp``).

The FIR variant (the default whenever both box³ supports fit two tiles)
collapses the six-stage pipeline to two banded FIR passes on the
``fir_band`` kernel: the dual radius rides a C = 2 bank in the x pass, and
the difference contracts away in the y pass. It matches the reference's
zero-padded-margin contract at every pixel.

The SAT variant is the reference's own formulation, needed once the radii
outgrow the tile (the FIR cost grows with B, the integral images' does
not): the summed-area table with both radii's 4-corner differencing fused
into its final kernel (``stencil2d``, the ``final2d_stencil`` kernel), then
per radius a 2nd-order x integral and a 2nd-order y integral, chained
through the rotated emit with their double differencing fused into the
rotated completion kernel (``stencil``), and the subtraction as the last
stage's epilogue.

Known accuracy limit of the SAT variant: its float32 integrals of an
image-like input grow with the size (1e6–1e7 at 4096²), and the
differencing cancels the digits the output needs. On uniform [0, 1)
input the error short of the far margin is 0.38× the output's peak there
at 1024² and 7.3× at 4096² (the JAX package's pipeline, run on the CPU
on the same input: 4.2× and 67×; ``tests/torch_sat_interior.py``). It is
accurate where the integrals stay bounded (zero-mean, band-limited
input). f64 or compensated sums in the integral kernels are the fix
(ROADMAP Queue 3); ``variant="auto"`` takes the exact FIR form wherever
both box³ supports fit two tiles.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..api import RecFilter, resolve_device
from ..fir import FirSeparable2D, box_taps
from ..planner import auto_tile_width
from ..spec import Dim


def _diffxy_taps(B: int):
    """The 4-corner SAT differencing at radius B (``diff_gauss.cpp:29-38``)
    as (dy, dx, coeff) taps."""
    s = 1.0 / float((2 * B + 1) ** 2)
    return [(B, B, s), (B, -B - 1, -s), (-B - 1, B, -s), (-B - 1, -B - 1, s)]


def _stencil(B: int):
    """The double difference of a 2nd-order integral at radius B, as the
    rotated pass's stencil consumer: the integral is 0 in the zeroed
    margin ("zero" start) and holds real totals at the far edge ("clamp"
    end)."""
    s = 1.0 / float(2 * B + 1) ** 2
    return {"taps": [(2 * B, s), (-1, -2.0 * s), (-2 * B - 2, s)],
            "start": "zero", "end": "clamp"}


class _DogSat(nn.Module):
    """The six-stage SAT pipeline (``diff_gauss.cpp:72-110``)."""

    def __init__(self, sat_box, sat2x, sat2y):
        super().__init__()
        self.sat_box = sat_box
        self.sat2x, self.sat2y = nn.ModuleList(sat2x), nn.ModuleList(sat2y)

    def forward(self, image):
        return self._run(image, lambda m, *a: m(*a))

    def forward_plain(self, image):
        return self._run(image, lambda m, *a: m.forward_plain(*a))

    def _run(self, image, call):
        box = call(self.sat_box, image.to(torch.float32))  # (y, x) per radius
        b = [call(m, v) for m, v in zip(self.sat2x, box)]  # (x, y)
        g0 = call(self.sat2y[0], b[0])                     # (y, x)
        return call(self.sat2y[1], b[1], g0)               # g0 − g1


def difference_of_gaussians(width: int, height: int, B1: int = 5,
                            B2: int = 9, tile_width: int = 0,
                            variant: str = "auto", device="cuda", *,
                            matmul_precision: str = "px6"):
    """Return an ``nn.Module`` ``fn(image (h, w)) -> DoG`` on ``device``
    (the card unless the caller asks for the CPU): ``variant="fir"``, the
    two banded FIR passes, or ``"sat"``, the reference's SAT pipeline
    (module docstring); ``"auto"`` takes the FIR form where both box³
    supports fit two tiles. ``matmul_precision``: every stage's grade
    (the JAX package's process-wide default made explicit)."""
    d = resolve_device(device)
    tw = tile_width or auto_tile_width(min(width, height))
    if variant == "auto":
        variant = "fir" if 6 * max(B1, B2) + 1 <= 2 * tw else "sat"
    if variant == "fir":
        return FirSeparable2D(
            height, width, [box_taps(B1, 3), box_taps(B2, 3)],
            signs=[1.0, -1.0], tile_width=tw,
            matmul_precision=matmul_precision,
            tap_scale=[float((2 * B1 + 1) ** 3),
                       float((2 * B2 + 1) ** 3)]).to(d)
    if variant != "sat":
        raise ValueError(f"unknown variant {variant!r}")
    x, y = Dim("x", width), Dim("y", height)
    SAT = RecFilter("SAT")
    SAT[y, x] = np.zeros((height, width), dtype=np.float32)
    SAT.add_filter(+x, [1.0, 1.0])
    SAT.add_filter(+y, [1.0, 1.0])
    SAT.split_all_dimensions(tw)
    SAT.set_plan(matmul_precision=matmul_precision)
    sat_box = SAT.as_func(stencil2d=[_diffxy_taps(B1), _diffxy_taps(B2)],
                          device=d)
    SAT2x = RecFilter("SAT2x")
    SAT2x[y, x] = np.zeros((height, width), dtype=np.float32)
    SAT2x.add_filter(+x, [1.0, 2.0, -1.0])
    SAT2x.split(x, tw)
    SAT2x.set_plan(rotate_emit=2, matmul_precision=matmul_precision)
    sat2x = [SAT2x.as_func(stencil=_stencil(B), device=d) for B in (B1, B2)]
    SAT2y = RecFilter("SAT2y")
    SAT2y[x, y] = np.zeros((width, height), dtype=np.float32)
    SAT2y.add_filter(+y, [1.0, 2.0, -1.0])
    SAT2y.split(y, tw)
    SAT2y.set_plan(rotate_emit=2, matmul_precision=matmul_precision)
    sat2y = [SAT2y.as_func(stencil=_stencil(B1), device=d),
             SAT2y.as_func(stencil=_stencil(B2),
                           epilogue=lambda o, a: a - o, device=d)]
    return _DogSat(sat_box, sat2x, sat2y)
