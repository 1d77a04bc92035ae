"""The blocked algebra: one tiled scan as three dense products.

The JAX package's ``tiling.py`` (the ``blocked`` backend, and the
``pallas`` backend's fallback for a clamp border on an extent the tile
does not divide). Per scan, with the scanned axis cut into n tiles of T
(zero-padded at the end):

    b_t    = P·B · x_t                    local tails (k per tile)
    s_prev = M · b                        every tile's incoming state at
                                          once (``coeffs.carry_chain_matrix``)
    y_t    = [R | B] · [s_prev_t ; x_t]   completion

An anticausal scan runs as flip ∘ causal ∘ flip. Every product runs in
float64 (the port's einsum forms all do: the carries amplify rounding),
and no kernel launches. Scans apply one at a time, in order.

The tile is the split width widened to the scan's order the way the fused
executors widen it (``dimfuse._plan_tiles``, a clamp border searching for
a dividing width): a tile narrower than the order has fewer samples than
tails. Where no legal tile exists the scan runs the sequential core
(``scan_core.ScanAxis``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import coeffs
from .spec import BorderMode, FilterSpec


def blocked_tile(w: int, tile_width: int, order: int, clamp: bool):
    """The blocked tile of a scan of ``order`` along an extent ``w`` split
    by ``tile_width``: the fused executors' tile plan
    (``dimfuse._plan_tiles``), or None where no legal tile exists."""
    from .dimfuse import _plan_tiles

    plan = _plan_tiles(w, tile_width, order, clamp)
    return None if plan is None else plan[0]


def tiled_scan_matrices(feedfwd: float, feedback: Sequence[float],
                        tile_width: int, num_tiles: int,
                        clamp_border: bool) -> dict:
    """The host matrices (float64) of one blocked scan: B, its border
    variant B_first, the tails extractor rows PB (PB_first), the
    completion matrix RB = [R | B] and the carry-chain matrix M."""
    T, k = int(tile_width), len(tuple(feedback))
    B = coeffs.impulse_matrix(feedfwd, feedback, T, clamp_border=False)
    B_first = (coeffs.impulse_matrix(feedfwd, feedback, T, clamp_border=True)
               if clamp_border else B)
    P = coeffs.tail_projector(T, k)
    R = coeffs.state_matrix(feedback, T)
    return {"B": B, "B_first": B_first, "PB": P @ B, "PB_first": P @ B_first,
            "RB": np.concatenate([R, B], axis=1),
            "M": coeffs.carry_chain_matrix(feedback, T, num_tiles, prev=True)}


class BlockedScan(nn.Module):
    """One blocked scan along ``axis`` of arrays whose extent there is
    ``w``, tiled by ``tile_width`` widened to the order
    (:func:`blocked_tile`; ValueError where no legal tile exists): the JAX
    package's ``tiled_apply_scan``, with the matrices built once as
    float64 buffers. Returns the input's type; ``forward_plain`` is
    ``forward``."""

    def __init__(self, axis: int, causal: bool, feedfwd: float,
                 feedback: Sequence[float], tile_width: int, w: int,
                 border: str = BorderMode.ZERO):
        super().__init__()
        self.k = len(tuple(feedback))
        self.clamp = border == BorderMode.CLAMP
        T = blocked_tile(w, tile_width, self.k, self.clamp)
        if T is None:
            raise ValueError(f"no blocked tile for an order-{self.k} scan "
                             f"along {w} samples split by {tile_width}: the "
                             "sequential core runs it (BlockedFilter)")
        n = -(-w // T)
        self.axis, self.causal, self.w, self.T, self.n = axis, causal, w, T, n
        for name, m in tiled_scan_matrices(feedfwd, feedback, T, n,
                                           self.clamp).items():
            self.register_buffer(name, torch.from_numpy(
                np.ascontiguousarray(m, np.float64)))

    def scan_last(self, x: torch.Tensor) -> torch.Tensor:
        """The causal blocked scan along the last axis of a float64
        (L, w) array: the JAX package's ``blocked_scan_last_axis``."""
        L, T, n, k = x.shape[0], self.T, self.n, self.k
        pad = n * T - self.w
        xt = (F.pad(x, (0, pad)) if pad else x).reshape(L, n, T)
        b = torch.einsum("kt,lnt->lnk", self.PB, xt)
        if self.clamp:
            b = torch.cat([torch.einsum("kt,lt->lk", self.PB_first,
                                        xt[:, 0])[:, None], b[:, 1:]], 1)
        s_prev = torch.einsum("ls,ts->lt", b.reshape(L, n * k),
                              self.M).reshape(L, n, k)
        y = torch.einsum("tz,lnz->lnt", self.RB, torch.cat([s_prev, xt], -1))
        if self.clamp:  # s_prev_0 == 0: no R term for the first tile
            y = torch.cat([torch.einsum("ts,ls->lt", self.B_first,
                                        xt[:, 0])[:, None], y[:, 1:]], 1)
        return y.reshape(L, n * T)[:, :self.w]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = x.movedim(self.axis, -1)
        shape = v.shape
        if not self.causal:
            v = v.flip(-1)
        y = self.scan_last(v.reshape(-1, self.w).double()).reshape(shape)
        if not self.causal:
            y = y.flip(-1)
        return y.movedim(-1, self.axis).to(x.dtype)

    forward_plain = forward


def tiled_apply_scan(x: torch.Tensor, axis: int, causal: bool,
                     feedfwd: float, feedback: Sequence[float],
                     tile_width: int,
                     border: str = BorderMode.ZERO) -> torch.Tensor:
    """One blocked scan along ``axis`` of ``x`` (functional
    :class:`BlockedScan`; the sequential core where no legal tile
    exists)."""
    from .scan_core import ScanAxis
    from .spec import Scan

    axis, k = axis % x.ndim, len(tuple(feedback))
    if blocked_tile(x.shape[axis], tile_width, k,
                    border == BorderMode.CLAMP) is None:
        mod = ScanAxis([Scan(axis, causal, feedfwd, tuple(feedback))], axis,
                       border)
        return mod.to(x.device)(x.to(torch.float32)).to(x.dtype)
    mod = BlockedScan(axis, causal, feedfwd, feedback, tile_width,
                      x.shape[axis], border)
    return mod.to(x.device)(x)


def blocked_scan_last_axis(x: torch.Tensor, feedfwd: float,
                           feedback: Sequence[float], tile_width: int,
                           clamp_border: bool) -> torch.Tensor:
    """One causal blocked scan along the last axis of the 2-D ``x``."""
    return tiled_apply_scan(
        x, -1, True, feedfwd, feedback, tile_width,
        BorderMode.CLAMP if clamp_border else BorderMode.ZERO)


class BlockedFilter(nn.Module):
    """The ``blocked`` backend: every scan of ``spec`` in order, a
    :class:`BlockedScan` on a tiled axis with a legal tile
    (:func:`blocked_tile`) and the sequential core
    (:class:`.scan_core.ScanAxis`) on an untiled one or where no legal
    tile exists — the JAX package's ``tiling.apply_filter``, with its
    tile widened to the order. Integer filters run the core
    (:class:`.scan_core.ScanFilter`), as there. ``forward_plain`` is
    ``forward`` (no kernel)."""

    def __init__(self, spec: FilterSpec):
        super().__init__()
        from . import scan_core

        spec = spec.stacked()
        self.dtype = getattr(torch, spec.dtype, None)
        scan_core._compute_type(spec.dtype)  # raises on other dtypes
        self.int_core = (scan_core.ScanFilter(spec)
                         if spec.dtype != "float32" else None)
        tiles = spec.tile_widths or (0,) * spec.ndim
        stages = []
        clamp = spec.border == BorderMode.CLAMP
        for s in spec.scans:
            T, w = tiles[s.axis], spec.dims[s.axis].extent
            stages.append(
                BlockedScan(s.axis, s.causal, s.feedfwd, s.feedback, T, w,
                            spec.border)
                if T > 0 and blocked_tile(w, T, s.order, clamp) is not None
                else scan_core.ScanAxis([s], s.axis, spec.border))
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int_core is not None:
            return self.int_core(x)
        y = torch.as_tensor(x).to(torch.float32)
        for st in self.stages:
            y = st(y)
        return y

    forward_plain = forward


def apply_filter(spec: FilterSpec, x: torch.Tensor) -> torch.Tensor:
    """The ``blocked`` executor on ``x``'s device (functional
    :class:`BlockedFilter`)."""
    x = torch.as_tensor(x)
    return BlockedFilter(spec).to(x.device)(x)
