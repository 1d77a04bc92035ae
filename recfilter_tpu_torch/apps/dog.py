"""Difference of Gaussians via iterated box filters (the JAX package's
``recfilter_tpu/apps/dog.py``; the reference's ``apps/DoG/diff_gauss.cpp``).

The FIR variant (the default whenever both box³ supports fit two tiles)
collapses the six-stage pipeline to two banded FIR passes on the
``fir_band`` kernel: the dual radius rides a C = 2 bank in the x pass, and
the difference contracts away in the y pass. It matches the reference's
zero-padded-margin contract at every pixel.
"""

from __future__ import annotations

from ..fir import FirSeparable2D, box_taps
from ..planner import auto_tile_width


def difference_of_gaussians(width: int, height: int, B1: int = 5,
                            B2: int = 9, tile_width: int = 0,
                            variant: str = "auto"):
    """Return an ``nn.Module`` ``fn(image (h, w)) -> DoG`` (move it to the
    card with ``.to("cuda")``).

    ``variant="sat"`` — the reference's own SAT + differencing pipeline,
    needed when the radii outgrow the tile — runs the fused stencil
    consumers and the rotated emit of the JAX package, not ported yet: it
    raises ``NotImplementedError``."""
    tw = tile_width or auto_tile_width(min(width, height))
    if variant == "auto":
        variant = "fir" if 6 * max(B1, B2) + 1 <= 2 * tw else "sat"
    if variant == "fir":
        return FirSeparable2D(
            height, width, [box_taps(B1, 3), box_taps(B2, 3)],
            signs=[1.0, -1.0], tile_width=tw,
            tap_scale=[float((2 * B1 + 1) ** 3), float((2 * B2 + 1) ** 3)])
    if variant != "sat":
        raise ValueError(f"unknown variant {variant!r}")
    raise NotImplementedError(
        "difference_of_gaussians(variant='sat') needs the rotated emit and "
        "the epilogue (ROADMAP Queue 1 items 6-7) and the fused stencil "
        "kernel (Queue 2 #3); variant='fir' runs")
