"""The strip passes of the ``pallas`` backend, with their plain twins.

One launch applies EVERY scan of one axis: a block owns a few lines and
walks the tiles of the scanned axis in order, carrying each scan's state
(the last K outputs of a tile, the first K for an anticausal scan) from
tile to tile — the JAX package's ``kernels/fused.py``, whose TPU strip of
Lb lines × the whole extent does not fit an H100 block
(``csrc/fused.cu`` says how the kernel lays it out instead). Per tile and
scan, with the anticausal matrices anti-diagonally transformed on the
host (J·B·J, J·R) so one formula serves both directions:

  * :class:`DimPassRows` — the scanned axis last, x (L, w):
    ``y_t = x_t·B_tᵀ + carry·RNᵀ``;
  * :class:`DimPassCols` — the scanned axis second to last, x (outer, h,
    L), lines on the minor axis: ``y_t = B_t·x_t + RN·carry``.

``B_t`` is the clamp-border variant at the edge tile (tile 0 causal, n − 1
anticausal) and the interior matrix elsewhere; with ``w_real`` below the
padded extent the pad is re-zeroed after every scan but the last. Each
module's ``forward`` launches the CUDA kernel (``dim_pass_rows`` /
``dim_pass_cols``) for a CUDA tensor and runs its twin ``plain`` — the
tile loop in torch, as ``_apply_scans_row`` / ``_apply_scans_col`` run it —
for a CPU tensor.

:class:`StripAxis` and :class:`StripFilter` are ``apply_dim`` and
``apply_filter``: one pass per scanned axis, the row kernel on the last
axis and the column kernel on any other (the array viewed as (lead, h,
trail)), zero padding at the end of an extent the tile does not divide,
the blocked algebra (``tiling.BlockedScan``) for a clamp border there, and
the sequential core for integer filters. Tiles follow the JAX package on
the TPU: 128 on the last axis; on any other the split width rounded up to
8, at most the padded extent.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from .. import coeffs
from ..spec import BorderMode, FilterSpec
from .launch import _check, _KernelFn, _launch

ROW_TILE = 128  # the rows pass's tile (the TPU lane width the JAX pins)
COL_TILE_MAX = 128  # the column kernel's largest tile
_LINE_BLOCKS = (16, 32, 64)
_SMEM = 232448  # bytes of shared memory one H100 block may take
_SM_SMEM = 233472  # bytes of shared memory of one SM (1 KB per block kept)
_SM_COUNT = 132


@dataclasses.dataclass(frozen=True)
class ScanMats:
    """Per-scan host matrices, transformed for the tile loop.

    Convention ("natural order", no in-kernel reversal): causal — the
    carry is ``y_prev[:, T-K:]``; anticausal — ``y_next[:, :K]``; in both
    ``y = x·Bᵀ + carry·RNᵀ`` with the anti-diagonal transform baked into
    B, B_edge and RN. ``K`` is the largest order of the axis's scans;
    unused carry columns meet zero columns of RN. The TPU kernel's carry
    selector ``Sel`` has no counterpart: the kernels read the carry's
    rows directly."""

    causal: bool
    order: int
    has_edge: bool
    B: np.ndarray  # (T, T) interior-tile impulse matrix (transformed)
    B_edge: np.ndarray  # (T, T) border-tile variant (== B unless clamp)
    RN: np.ndarray  # (T, K) carry-injection matrix, natural order


def prepare_scan_mats(feedfwd: float, feedback: Sequence[float],
                      causal: bool, tile_width: int, max_order: int,
                      clamp: bool) -> ScanMats:
    """One scan's :class:`ScanMats` (the JAX package's builder)."""
    T, k, K = int(tile_width), len(tuple(feedback)), int(max_order)
    if T < K:
        raise ValueError("tile width must be at least the max filter order")
    B = coeffs.impulse_matrix(feedfwd, feedback, T)
    Be = (coeffs.impulse_matrix(feedfwd, feedback, T, clamp_border=True)
          if clamp else B)
    R = coeffs.state_matrix(feedback, T)  # (T, k), s[j] = v[-1-j]
    RN = np.zeros((T, K), dtype=np.float64)
    if causal:
        RN[:, K - k:] = R[:, ::-1]
    else:
        B = B[::-1, ::-1].copy()
        Be = Be[::-1, ::-1].copy()
        RN[:, :k] = R[::-1, :]
    return ScanMats(causal=causal, order=k, has_edge=clamp, B=B, B_edge=Be,
                    RN=RN)


def _dim_pass_mats(spec: FilterSpec, scan_ids: Sequence[int],
                   tile_width: int):
    """The :class:`ScanMats` of ``spec``'s scans ``scan_ids`` (one axis)
    and their largest order."""
    scans = [spec.scans[i] for i in scan_ids]
    return _scan_mats(scans, tile_width, spec.border == BorderMode.CLAMP)


def _scan_mats(scans, tile_width: int, clamp: bool):
    K = max(s.order for s in scans)
    return [prepare_scan_mats(s.feedfwd, s.feedback, s.causal, tile_width, K,
                              clamp) for s in scans], K


def _smem(T: int, K: int, rows: bool, lb: int) -> int:
    """Shared memory of one strip block: the (T+K) × 16·RM double operand
    and the (T+K) × lb float tile (``csrc/fused.cu``)."""
    rm = 8 if rows or T > 64 else (4 if T > 32 else 2)
    return (T + K) * (8 * 16 * rm + 4 * lb)


def pick_line_block(lines: int, outer: int, T: int, K: int, rows: bool,
                    request: int = 0) -> int:
    """Lines per block of the strip kernels (``Plan.line_block``): 16, 32
    or 64, whose shared memory fits. A request is quantised down to that
    set (at least 16) and clamped to the lines there are; 0 picks the
    largest block whose waves × lines per block (the time of the tile
    chain) is within 5 % of the fewest. No one block wins everywhere:
    timed on an H100 (``chip_smoke.line_block_sweep``), 32 lines is the
    fastest at 4096 lines, 16 at 1080 and 64 at 65,536 lines or 256 × 256,
    and this rule picks each of them."""
    fit = [lb for lb in _LINE_BLOCKS if _smem(T, K, rows, lb) <= _SMEM]
    if not fit:
        raise NotImplementedError(
            f"tile {T} with {K} carries: no line block fits shared memory "
            "(ROADMAP Queue 2: shape limits of the HIGHEST pair and the "
            "strip kernels)")
    enough = [lb for lb in fit if lb >= lines] or [fit[-1]]
    if request:
        lb = max([b for b in fit if b <= max(int(request), fit[0])])
        return min(lb, enough[0])

    def cost(lb):
        per_sm = max(1, _SM_SMEM // (_smem(T, K, rows, lb) + 1024))
        return -(-outer * -(-lines // lb) // (per_sm * _SM_COUNT)) * lb

    best = min(cost(lb) for lb in fit)
    return min(max(lb for lb in fit if cost(lb) <= 1.05 * best), enough[0])


def _masks(mats: List[ScanMats]):
    """Bit i set where scan i is causal / has a clamp edge tile."""
    if len(mats) > 30:
        raise NotImplementedError(f"{len(mats)} scans on one axis: the "
                                  "strip kernels take at most 30")
    return (sum(1 << i for i, m in enumerate(mats) if m.causal),
            sum(1 << i for i, m in enumerate(mats) if m.has_edge))


class _DimPass(nn.Module):
    """The matrices of one axis's strip pass: twin operands B, B_edge, RN
    (the kernel's float32 values, held as float64) and the kernel operand
    ``ops`` (nscan, 2, T+K, T) = [Bᵀ; RNᵀ], [B_edgeᵀ; RNᵀ] per scan.
    Kernel and twin multiply float32 values and sum in float64, then store
    float32 (``csrc/fused.cu`` says why)."""

    def __init__(self, mats: List[ScanMats], T: int, n: int, w_real: int,
                 line_block: int = 0):
        super().__init__()
        self.T, self.n, self.K = int(T), int(n), mats[0].RN.shape[1]
        self.w_real = int(w_real) or self.T * self.n
        self.causal = [m.causal for m in mats]
        self.edge = [m.has_edge for m in mats]
        self.line_block = int(line_block)
        self.causal_mask, self.edge_mask = _masks(mats)

        def f32(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32))

        def f32_64(a):  # the kernel's fp32 operands, for fp64 sums
            return f32(a).double()

        self.register_buffer("B", f32_64(np.stack([m.B for m in mats])))
        self.register_buffer("Be", f32_64(np.stack([m.B_edge
                                                    for m in mats])))
        self.register_buffer("RN", f32_64(np.stack([m.RN for m in mats])))
        ops = np.stack([np.stack([np.concatenate([Bm.T, m.RN.T])
                                  for Bm in (m.B, m.B_edge)])
                        for m in mats])
        self.register_buffer("ops", f32(ops))

    def _mat(self, si: int, t: int) -> torch.Tensor:
        edge_tile = 0 if self.causal[si] else self.n - 1
        return self.Be[si] if self.edge[si] and t == edge_tile else self.B[si]

    def forward(self, x):
        if x.is_cuda:
            return _KernelFn.apply(self, x)
        return self.plain(x)


class DimPassRows(_DimPass):
    """Every scan of one axis along the LAST axis of x (L, w), w = n·T —
    the JAX package's ``dim_pass_rows``: the ``dim_pass_rows`` kernel, or
    the twin :meth:`plain` for a CPU tensor. T must be 128 (the kernel's
    tile); the twin takes any T."""

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        T, n, K = self.T, self.n, self.K
        y = x.float().clone()
        for si in range(self.B.shape[0]):
            carry = y.new_zeros((y.shape[0], K), dtype=torch.float64)
            for i in range(n):
                t = i if self.causal[si] else n - 1 - i
                yt = (y[:, t * T:(t + 1) * T].double() @ self._mat(si, t).T
                      + carry @ self.RN[si].T).float()
                y[:, t * T:(t + 1) * T] = yt
                carry = (yt[:, T - K:] if self.causal[si]
                         else yt[:, :K]).double()
            if self.w_real < n * T and si + 1 < self.B.shape[0]:
                y[:, self.w_real:] = 0.0
        return y

    def _kernel(self, x: torch.Tensor) -> torch.Tensor:
        if self.T != ROW_TILE:
            raise ValueError(f"the dim_pass_rows kernel takes {ROW_TILE}-wide "
                             f"tiles, not {self.T}")
        L, w = x.shape
        _check(x, "x", (L, self.n * self.T), x.device)
        _check(self.ops, "ops", self.ops.shape, x.device)
        lb = pick_line_block(L, 1, self.T, self.K, True, self.line_block)
        y = torch.empty_like(x)
        _launch("dim_pass_rows", (
            x.data_ptr(), self.ops.data_ptr(), y.data_ptr(), L, self.n,
            self.K, self.B.shape[0], self.w_real, self.causal_mask,
            self.edge_mask, lb), x.device)
        return y


class DimPassCols(_DimPass):
    """Every scan of one axis along axis −2 of x (outer, h, L), h = n·T,
    lines on the minor axis — the JAX package's ``dim_pass_cols``: the
    ``dim_pass_cols`` kernel (T ≤ 128), or the twin :meth:`plain` for a
    CPU tensor."""

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        T, n, K = self.T, self.n, self.K
        y = x.float().clone()
        for si in range(self.B.shape[0]):
            carry = y.new_zeros((y.shape[0], K, y.shape[2]),
                                dtype=torch.float64)
            for i in range(n):
                t = i if self.causal[si] else n - 1 - i
                yt = (self._mat(si, t) @ y[:, t * T:(t + 1) * T].double()
                      + self.RN[si] @ carry).float()
                y[:, t * T:(t + 1) * T] = yt
                carry = (yt[:, T - K:] if self.causal[si]
                         else yt[:, :K]).double()
            if self.w_real < n * T and si + 1 < self.B.shape[0]:
                y[:, self.w_real:] = 0.0
        return y

    def _kernel(self, x: torch.Tensor) -> torch.Tensor:
        outer, h, L = x.shape
        _check(x, "x", (outer, self.n * self.T, L), x.device)
        _check(self.ops, "ops", self.ops.shape, x.device)
        if not 0 < outer < 65536:
            raise ValueError(f"leading extent {outer}: outside the launch "
                             "grid")
        lb = pick_line_block(L, outer, self.T, self.K, False,
                             self.line_block)
        y = torch.empty_like(x)
        _launch("dim_pass_cols", (
            x.data_ptr(), self.ops.data_ptr(), y.data_ptr(), outer, L,
            self.n, self.T, self.K, self.B.shape[0], self.w_real,
            self.causal_mask, self.edge_mask, lb), x.device)
        return y


def dim_pass_rows(x: torch.Tensor, mats: List[ScanMats], tile_width: int,
                  w_real: int = 0, line_block: int = 0) -> torch.Tensor:
    """Functional :class:`DimPassRows` on the 2-D ``x`` (L, w)."""
    T = int(tile_width)
    mod = DimPassRows(mats, T, x.shape[-1] // T, w_real, line_block)
    return mod.to(x.device)(x)


def dim_pass_cols(x: torch.Tensor, mats: List[ScanMats], tile_width: int,
                  w_real: int = 0, line_block: int = 0) -> torch.Tensor:
    """Functional :class:`DimPassCols` on the 3-D ``x`` (outer, h, L)."""
    T = int(tile_width)
    mod = DimPassCols(mats, T, x.shape[1] // T, w_real, line_block)
    return mod.to(x.device)(x)


def _round_up(v: int, q: int) -> int:
    return -(-v // q) * q


def strip_tile(axis: int, ndim: int, w: int, tile_width: int) -> int:
    """The strip pass's tile on ``axis`` of extent ``w`` (the JAX package's
    rule on the TPU): 128 on the last axis; elsewhere the split width
    rounded up to 8 (at least 8); at most the extent rounded up to it."""
    T = ROW_TILE if axis == ndim - 1 else max(8, _round_up(int(tile_width), 8))
    return min(T, _round_up(w, T))


class StripAxis(nn.Module):
    """All ``scans`` of ``axis`` of float32 arrays of ``shape`` — the JAX
    package's ``fused.apply_dim``. ``route`` says how:

      * ``"rows"`` — the last axis: :class:`DimPassRows` on (lead, w);
      * ``"cols"`` — any other axis: :class:`DimPassCols` on the array
        viewed as (lead, h, trail);
      * ``"blocked"`` — a clamp border on an extent the tile does not
        divide (the zero pad would move the clamped edge): one
        :class:`..tiling.BlockedScan` per scan.

    The scanned axis is zero-padded at the end to whole tiles (exact for
    a zero border in both directions) and cropped after.
    ``forward_plain`` runs the kernels' twins."""

    def __init__(self, scans, axis: int, shape, tile_width: int, border: str,
                 line_block: int = 0):
        super().__init__()
        from ..tiling import BlockedScan

        nd = len(shape)
        self.axis, self.shape = axis % nd, tuple(int(e) for e in shape)
        w = self.shape[self.axis]
        T = strip_tile(self.axis, nd, w, tile_width)
        n = -(-w // T)
        self.w, self.T, self.n, self.pad = w, T, n, n * T - w
        clamp = border == BorderMode.CLAMP
        if self.pad and clamp:
            self.route = "blocked"
            self.body = nn.ModuleList(
                BlockedScan(self.axis, s.causal, s.feedfwd, s.feedback, T, w,
                            border) for s in scans)
            return
        if self.axis != nd - 1 and T > COL_TILE_MAX:
            raise NotImplementedError(
                f"tile {T} on axis {self.axis}: the dim_pass_cols kernel "
                f"takes tiles up to {COL_TILE_MAX} (ROADMAP Queue 2: shape "
                "limits of the HIGHEST pair and the strip kernels); split "
                "the axis narrower")
        mats, _ = _scan_mats(scans, T, clamp)
        if self.axis == nd - 1:
            self.route = "rows"
            self.body = DimPassRows(mats, T, n, w, line_block)
        else:
            self.route = "cols"
            self.body = DimPassCols(mats, T, n, w, line_block)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, False)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, True)

    def kernel_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` zero-padded to whole tiles and viewed as the kernel takes
        it: (lead, n·T) for ``rows``, (lead, n·T, trail) for ``cols``."""
        if tuple(x.shape) != self.shape:
            raise ValueError(f"input shape {tuple(x.shape)} != "
                             f"{self.shape}")
        ax, nd = self.axis, len(self.shape)
        if self.pad:
            x = torch.nn.functional.pad(x, [0, 0] * (nd - 1 - ax)
                                        + [0, self.pad])
        if self.route == "rows":
            return x.reshape(-1, x.shape[-1]).contiguous()
        lead = int(np.prod(x.shape[:ax], dtype=np.int64))
        return x.reshape(lead, x.shape[ax], -1).contiguous()

    def _run(self, x, plain):
        if self.route == "blocked":
            if tuple(x.shape) != self.shape:
                raise ValueError(f"input shape {tuple(x.shape)} != "
                                 f"{self.shape}")
            for st in self.body:
                x = st(x)
            return x
        run = self.body.plain if plain else self.body
        padded = list(self.shape)
        padded[self.axis] = self.n * self.T
        y = run(self.kernel_input(x)).reshape(padded)
        return y.narrow(self.axis, 0, self.w) if self.pad else y


def apply_dim(x: torch.Tensor, spec: FilterSpec, axis: int, scan_ids,
              tile_width: int, line_block: int = 0) -> torch.Tensor:
    """Functional :class:`StripAxis`: ``spec``'s scans ``scan_ids`` (all on
    ``axis``) applied to the float32 ``x``."""
    mod = StripAxis([spec.scans[i] for i in scan_ids], axis, x.shape,
                    tile_width, spec.border, line_block)
    return mod.to(x.device)(x)


class StripFilter(nn.Module):
    """The ``pallas`` backend: one :class:`StripAxis` per scanned axis, in
    order of first appearance (scans on different axes commute), each
    tiled by its split width or ``min(128, extent)`` — the JAX package's
    ``fused.apply_filter``. Integer filters run the sequential core
    (:class:`..scan_core.ScanFilter`), as there. float32 in and out;
    ``forward_plain`` runs the kernels' twins. ``Plan.line_block`` reaches
    the kernels; ``Plan.unroll`` has no effect (module docstring of
    :mod:`..planner`)."""

    def __init__(self, spec: FilterSpec, line_block: int = 0):
        super().__init__()
        from ..scan_core import ScanFilter, _compute_type

        spec = spec.stacked()
        _compute_type(spec.dtype)  # raises on the dtypes the port lacks
        self.ext = tuple(d.extent for d in spec.dims)
        self.core = ScanFilter(spec) if spec.dtype != "float32" else None
        tiles = spec.tile_widths or (0,) * spec.ndim
        self.stages = nn.ModuleList(
            StripAxis([spec.scans[i] for i in ids], ax, self.ext,
                      tiles[ax] or min(ROW_TILE, self.ext[ax]), spec.border,
                      line_block)
            for ax, ids in spec.scans_by_axis().items())

    @property
    def routes(self) -> List[str]:
        return [st.route for st in self.stages]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, False)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, True)

    def _run(self, x, plain):
        if self.core is not None:
            return self.core(x)
        x = torch.as_tensor(x).to(torch.float32)
        for st in self.stages:
            x = st.forward_plain(x) if plain else st(x)
        return x


def apply_filter(spec: FilterSpec, x: torch.Tensor,
                 line_block: int = 0) -> torch.Tensor:
    """The ``pallas`` executor on ``x``'s device (functional
    :class:`StripFilter`)."""
    x = torch.as_tensor(x)
    return StripFilter(spec, line_block).to(x.device)(x)
