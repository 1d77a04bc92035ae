"""Iterated box filters (the JAX package's ``recfilter_tpu/apps/box.py``;
the reference's ``apps/box/box_filter.h``).

By default (``variant="auto"``) an n-fold box of radius B whose 2nB+1 taps
fit two tiles runs as a (2nB+1)-tap FIR in two banded passes
(:class:`..fir.FirSeparable2D`, on the ``fir_band`` kernel), with exact
zero-padded semantics at every pixel. The SAT forms, the reference's own:
order 1 is the summed-area table (:class:`..overlap2d.Fused2DPx`) and the
4-corner differencing as torch shifts; order 2 two 2nd-order integral
images chained through the rotated emit (``Plan.rotate_emit=2``, on the
``tails`` and ``completion_rot`` kernels), each followed by a torch double
difference; box ×3 = 1∘2 and box ×6 = 2∘2∘2, as the JAX package composes
them. The SAT forms share the difference of Gaussians' accuracy limit:
float32 integrals of image-like input at large sizes lose the interior
(``apps/dog.py``; ROADMAP Queue 3).

Each builder returns an ``nn.Module`` that takes an (h, w) tensor, on the
card unless the caller asks for the CPU (``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..api import RecFilter, resolve_device
from ..fir import FirSeparable2D, box_taps
from ..iir import integral_image_coeff
from ..kernels.stencil2d import shift2
from ..planner import auto_tile_width
from ..spec import Dim


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
        g = shift2(f, B, 0) - shift2(f, -B - 1, 0)
        d = shift2(g, B, 1) - shift2(g, -B - 1, 1)
        return d / self.norm

    def forward(self, image):
        return self._diff(self.sat(image.to(torch.float32)))

    def forward_plain(self, image):
        return self._diff(self.sat.forward_plain(image.to(torch.float32)))


def box_filter_order_1(width: int, height: int, B: int, tile_width: int = 0,
                       variant: str = "auto", device="cuda", *,
                       matmul_precision: str = "px6"):
    """One box iteration. Returns (module, sat_filter); ``variant="fir"``
    (the default where the 2B+1 taps fit the tile band) builds no SAT
    filter (second element None). ``matmul_precision``: every stage's
    grade (the JAX package's process-wide default made explicit)."""
    d = resolve_device(device)
    if _box_variant(variant, B, 1, tile_width, width, height) == "fir":
        return _box_fir(width, height, B, 1, tile_width,
                        matmul_precision).to(d), None
    tile_width = tile_width or auto_tile_width(min(width, height))
    x, y = Dim("x", width), Dim("y", height)
    Fs = RecFilter("Box1_Sat")
    Fs[y, x] = np.zeros((height, width), dtype=np.float32)
    Fs.add_filter(x, [1.0, 1.0])
    Fs.add_filter(y, [1.0, 1.0])
    Fs.split(x, tile_width, y, tile_width)
    Fs.set_plan(matmul_precision=matmul_precision)
    return _SatBox1(Fs.as_func(device=d), B), Fs


def _double_diff(f, B: int, axis: int):
    """D1(x) = [f(x+B) − f(x−B−1)]/(2B+1) applied twice, as one 3-tap
    stencil: [f(x+2B) − 2 f(x−1) + f(x−2B−2)]/(2B+1)² (exact in the
    interior; the borders lie in the zeroed margin)."""
    norm = float(2 * B + 1)
    return (shift2(f, 2 * B, axis)
            - 2.0 * shift2(f, -1, axis)
            + shift2(f, -2 * B - 2, axis)) / (norm * norm)


class _SatBox2(nn.Module):
    """Two box iterations: the x 2nd-order integral (rotated emit, (x, y)
    out), its double difference along axis 0; the y integral (rotated
    back to (y, x)), its double difference along axis 0."""

    def __init__(self, fx: nn.Module, fy: nn.Module, B: int):
        super().__init__()
        self.fx, self.fy, self.B = fx, fy, B

    def forward(self, image):
        a = _double_diff(self.fx(image.to(torch.float32)), self.B, 0)
        return _double_diff(self.fy(a), self.B, 0)

    def forward_plain(self, image):
        a = _double_diff(self.fx.forward_plain(image.to(torch.float32)),
                         self.B, 0)
        return _double_diff(self.fy.forward_plain(a), self.B, 0)


def box_filter_order_2(width: int, height: int, B: int, tile_width: int = 0,
                       device="cuda", *, matmul_precision: str = "px6"):
    """Two box iterations: a 2nd-order integral image and its double
    difference per dimension, x then y, the two integral stages chained
    through the rotated emit (``box_filter.h:105-225``). Returns
    (module, (sat_x, sat_y))."""
    d = resolve_device(device)
    tile_width = tile_width or auto_tile_width(min(width, height))
    x, y = Dim("x", width), Dim("y", height)
    coeff = integral_image_coeff(2)
    sat_x = RecFilter("Box2_Satx")
    sat_x[y, x] = np.zeros((height, width), dtype=np.float32)
    sat_x.add_filter(+x, coeff)
    sat_x.split_all_dimensions(tile_width)
    sat_x.set_plan(rotate_emit=2, matmul_precision=matmul_precision)
    sat_y = RecFilter("Box2_Saty")
    sat_y[y, x] = np.zeros((height, width), dtype=np.float32)
    sat_y.add_filter(+y, coeff)
    sat_y.split_all_dimensions(tile_width)
    sat_y.set_plan(rotate_emit=2, matmul_precision=matmul_precision)
    mod = _SatBox2(sat_x.as_func(device=d), sat_y.as_func(device=d), B)
    return mod, (sat_x, sat_y)


def _box_fir(width, height, B, iterations, tile_width, matmul_precision):
    """The n-fold box as a (2nB+1)-tap FIR in two banded passes: exact
    zero-pad semantics, the reference's zeroed-margin contract. The
    (2B+1)^n-scaled taps are small integers, exact in bf16: below px6 the
    band kernel takes one tap chunk (``tap_scale``)."""
    tw = tile_width or auto_tile_width(min(width, height))
    return FirSeparable2D(height, width, [box_taps(B, iterations)],
                          tile_width=tw, matmul_precision=matmul_precision,
                          tap_scale=float((2 * B + 1) ** iterations))


def _box_variant(variant, B, iterations, tile_width, width, height):
    if variant != "auto":
        return variant
    tw = tile_width or auto_tile_width(min(width, height))
    return "fir" if 2 * iterations * B + 1 <= 2 * tw else "sat"


class _Chain(nn.Module):
    """Box stages run one after another (box ×3 and ×6 in SAT form)."""

    def __init__(self, stages):
        super().__init__()
        self.stages = nn.ModuleList(stages)

    def forward(self, image):
        for m in self.stages:
            image = m(image)
        return image

    def forward_plain(self, image):
        for m in self.stages:
            image = m.forward_plain(image)
        return image


def box_filter_3(width: int, height: int, B: int, tile_width: int = 0,
                 variant: str = "auto", device="cuda", *,
                 matmul_precision: str = "px6"):
    """Three iterations: the equivalent 6B+1-tap FIR in two passes where it
    fits the tile band, else order 1 (its own variant rule) ∘ order 2
    (``box_filter_3.cpp:37-41``)."""
    d = resolve_device(device)
    mp = dict(matmul_precision=matmul_precision)
    if _box_variant(variant, B, 3, tile_width, width, height) == "fir":
        return _box_fir(width, height, B, 3, tile_width, **mp).to(d)
    f1, _ = box_filter_order_1(width, height, B, tile_width, device=d, **mp)
    f2, _ = box_filter_order_2(width, height, B, tile_width, device=d, **mp)
    return _Chain([f1, f2])


def box_filter_6(width: int, height: int, B: int, tile_width: int = 0,
                 variant: str = "auto", device="cuda", *,
                 matmul_precision: str = "px6"):
    """Six iterations: the equivalent 12B+1-tap FIR in two passes where it
    fits the tile band, else three chained order-2 stages
    (``box_filter_6.cpp:40-46``)."""
    d = resolve_device(device)
    mp = dict(matmul_precision=matmul_precision)
    if _box_variant(variant, B, 6, tile_width, width, height) == "fir":
        return _box_fir(width, height, B, 6, tile_width, **mp).to(d)
    f2, _ = box_filter_order_2(width, height, B, tile_width, device=d, **mp)
    return _Chain([f2, f2, f2])


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
