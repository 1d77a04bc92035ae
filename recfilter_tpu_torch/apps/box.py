"""Iterated box filters (the JAX package's ``recfilter_tpu/apps/box.py``;
the reference's ``apps/box/box_filter.h``).

By default (``variant="auto"``) an n-fold box of radius B whose 2nB+1 taps
fit two tiles runs as a (2nB+1)-tap FIR in two banded passes
(:class:`..fir.FirSeparable2D`, on the ``fir_band`` kernel), with exact
zero-padded semantics at every pixel. ``box_filter_order_1`` also runs its
SAT form: the summed-area table (:class:`..overlap2d.Fused2DPx`) and the
4-corner differencing as torch shifts.

Each builder returns an ``nn.Module`` that takes an (h, w) tensor; move it
to the card with ``.to("cuda")``. What the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item: the 2nd-order integral
image (``box_filter_order_2``, the rotated emit of Queue 1 item 6) and the
SAT variants of ``box_filter_3`` and ``box_filter_6`` built on it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..api import RecFilter
from ..fir import FirSeparable2D, box_taps
from ..planner import auto_tile_width
from ..spec import Dim


def _shift_clamped(f: torch.Tensor, offset: int, axis: int) -> torch.Tensor:
    """f[..., i+offset, ...] with edge clamping. Negative offsets read
    toward the array start, where the apps' zeroed input margins make the
    integral-image values 0, so the pad there is 0; positive offsets clamp
    to the far edge, whose integral values are real totals."""
    n = f.shape[axis]
    lo, hi = max(offset, 0), max(-offset, 0)
    g = f.movedim(axis, -1)
    if offset > 0:
        g = torch.cat([g, g[..., -1:].expand(*g.shape[:-1], lo)], dim=-1)
    else:
        g = F.pad(g, (hi, 0))
    return g[..., lo:lo + n].movedim(-1, axis)


def _no_sat(what: str):
    return NotImplementedError(
        f"{what}: the SAT variant needs the 2nd-order integral image with "
        "the rotated emit (box_filter_order_2), not ported yet (ROADMAP "
        "Queue 1 item 6); variant='fir' runs")


class _SatBox1(nn.Module):
    """One box iteration as SAT + separable 4-corner differencing."""

    def __init__(self, sat: nn.Module, B: int):
        super().__init__()
        self.sat, self.B = sat, B
        self.norm = float((2 * B + 1) ** 2)

    def _diff(self, f):
        # D(x,y) = [f(x+B, y+B) - f(x+B, y-B-1) + f(x-B-1, y-B-1)
        #           - f(x-B-1, y+B)] / (2B+1)^2, as (Dy∘Dx)
        B = self.B
        g = _shift_clamped(f, B, 0) - _shift_clamped(f, -B - 1, 0)
        d = _shift_clamped(g, B, 1) - _shift_clamped(g, -B - 1, 1)
        return d / self.norm

    def forward(self, image):
        return self._diff(self.sat(image.to(torch.float32)))

    def forward_plain(self, image):
        return self._diff(self.sat.forward_plain(image.to(torch.float32)))


def box_filter_order_1(width: int, height: int, B: int, tile_width: int = 0,
                       variant: str = "auto"):
    """One box iteration. Returns (module, sat_filter); ``variant="fir"``
    (the default where the 2B+1 taps fit the tile band) builds no SAT
    filter (second element None)."""
    if _box_variant(variant, B, 1, tile_width, width, height) == "fir":
        return _box_fir(width, height, B, 1, tile_width), None
    tile_width = tile_width or auto_tile_width(min(width, height))
    x, y = Dim("x", width), Dim("y", height)
    Fs = RecFilter("Box1_Sat")
    Fs[y, x] = np.zeros((height, width), dtype=np.float32)
    Fs.add_filter(x, [1.0, 1.0])
    Fs.add_filter(y, [1.0, 1.0])
    Fs.split(x, tile_width, y, tile_width)
    return _SatBox1(Fs.as_func(), B), Fs


def box_filter_order_2(width: int, height: int, B: int, tile_width: int = 0):
    """Two box iterations via 2nd-order integral images: not ported."""
    raise NotImplementedError(
        "box_filter_order_2 chains 2nd-order integral images through the "
        "rotated emit (Plan.rotate_emit=2), not ported yet (ROADMAP Queue 1 "
        "item 6)")


def _box_fir(width, height, B, iterations, tile_width):
    """The n-fold box as a (2nB+1)-tap FIR in two banded passes: exact
    zero-pad semantics, the reference's zeroed-margin contract."""
    tw = tile_width or auto_tile_width(min(width, height))
    return FirSeparable2D(height, width, [box_taps(B, iterations)],
                          tile_width=tw,
                          tap_scale=float((2 * B + 1) ** iterations))


def _box_variant(variant, B, iterations, tile_width, width, height):
    if variant != "auto":
        return variant
    tw = tile_width or auto_tile_width(min(width, height))
    return "fir" if 2 * iterations * B + 1 <= 2 * tw else "sat"


def box_filter_3(width: int, height: int, B: int, tile_width: int = 0,
                 variant: str = "auto"):
    """Three iterations as the equivalent 6B+1-tap FIR in two passes."""
    if _box_variant(variant, B, 3, tile_width, width, height) == "fir":
        return _box_fir(width, height, B, 3, tile_width)
    raise _no_sat("box_filter_3")


def box_filter_6(width: int, height: int, B: int, tile_width: int = 0,
                 variant: str = "auto"):
    """Six iterations as the equivalent 12B+1-tap FIR in two passes."""
    if _box_variant(variant, B, 6, tile_width, width, height) == "fir":
        return _box_fir(width, height, B, 6, tile_width)
    raise _no_sat("box_filter_6")


def box_oracle(image: np.ndarray, B: int, iterations: int) -> np.ndarray:
    """Brute-force iterated box blur with zero padding (test oracle)."""
    img = np.asarray(image, dtype=np.float64)
    norm = float((2 * B + 1) ** 2)
    for _ in range(iterations):
        h, w = img.shape
        padded = np.zeros((h + 2 * B, w + 2 * B))
        padded[B: B + h, B: B + w] = img
        out = np.zeros_like(img)
        for dy in range(-B, B + 1):
            for dx in range(-B, B + 1):
                out += padded[B + dy: B + dy + h, B + dx: B + dx + w]
        img = out / norm
    return img
