"""The 3-touch 2-D executor: both dimensions' carries from one read.

For a filter with scans on dims A (rows, axis -2) then B (columns, axis -1)
— cross-dimension scans commute — the dim-B local tails of the dim-A
completed image Z are carry-sized expressions:

    Gb ∘_B Z = Btot_A ∘_A (Gb ∘_B x) + Rhat_A ∘_A (Gb ∘_B N_A)

so the whole filter reads the image three times:

    pass 1 (read x):   dim-A tails b_A, dim-B term Btot_A·(x·G_Bᵀ)   kernel
    solves (tiny):     N_A = CM_A·b_A, then b_B → N_B = CM_B·b_B     torch
    pass 2 (read x):   Y = dim-B completion of the dim-A completion   kernel
                       (write Y; Z stays on chip)

The solves are carry-sized ``torch.matmul``/``einsum`` calls, as the JAX
package leaves them to XLA, in float64: the carries amplify rounding about
thirtyfold for the sigma=5 Gaussian, and fp32 glue left the filter at
7e-6 of the output peak against the f64 oracle where the px6 bound is 2e-6
(plain twins on the CPU, 512²). The solve is always the dense padded
(n·8)² matmul. Every host matrix is built once, at module construction.

:class:`FusedRowsPx` is the dim-A half on its own — the rows pass, for a
scan along any axis but the last, everything after that axis flattened
into lanes: tails kernel → float64 carry solve (banded from 64 tiles on)
→ completion kernel, the image read twice and written once. Volumes run
their leading scanned axis through it before :class:`Fused2DPx` takes the
trailing pair (``dimfuse.fused_filter_module``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import dimfuse
from .kernels import final2d as k2d
from .kernels.completion import _SLOTS, _per_tile, pad_solve_matrix
from .spec import BorderMode, Scan

TILE = k2d.TILE


class Fused2DPx(nn.Module):
    """Executor for scans ``scans_a`` on axis -2 and ``scans_b`` on axis
    -1 of float32 arrays ``(..., wa, wb)``; leading axes are a batch.

    ``forward`` runs the CUDA kernels for CUDA tensors (their plain twins
    for CPU tensors); ``forward_plain`` runs the twins on any device — the
    all-PyTorch reference for the kernel path.

    Raises ``NotImplementedError`` where the JAX package's executor would
    decline the filter (extents below one tile, clamp with extents that
    are not tile multiples, more than 256 tiles, more than 8 carries per
    dimension)."""

    def __init__(self, scans_a: Sequence[Scan], scans_b: Sequence[Scan],
                 wa: int, wb: int, border: str):
        super().__init__()
        T = TILE
        if wa < T or wb < T:
            raise NotImplementedError(
                f"extents ({wa}, {wb}) below the {T} tile: small images run "
                "the JAX package's rotation chain (ROADMAP Queue 1 item 6)")
        clamp = border == BorderMode.CLAMP
        na, nb = -(-wa // T), -(-wb // T)
        pad_a, pad_b = na * T - wa, nb * T - wb
        if clamp and (pad_a or pad_b):
            raise NotImplementedError(
                f"clamp border with extents ({wa}, {wb}) that are not "
                f"multiples of {T} (ROADMAP Queue 1 item 6)")
        cap = dimfuse._CHAIN_MATMUL_MAX_TILES
        if na > cap or nb > cap:
            raise NotImplementedError(
                f"{na} x {nb} tiles: more than {cap} per dimension needs "
                "the associative carry chain (ROADMAP Queue 1 item 6)")
        ma = dimfuse.prepare_dim_pass(scans_a, T, na, clamp, pad_slots=pad_a)
        mb = dimfuse.prepare_dim_pass(scans_b, T, nb, clamp, pad_slots=pad_b)
        Ka, Kb = int(sum(ma.orders)), int(sum(mb.orders))
        if Ka > _SLOTS or Kb > _SLOTS:
            raise NotImplementedError(
                f"carries Ka={Ka}, Kb={Kb}: more than {_SLOTS} per "
                "dimension run the JAX package's rotation chain (ROADMAP "
                "Queue 1 item 6)")
        self.wa, self.wb, self.na, self.nb = wa, wb, na, nb
        self.pad_a, self.pad_b, self.Ka = pad_a, pad_b, Ka

        Ga_cat = np.concatenate([np.asarray(g) for g in ma.G], axis=1)
        Gb_cat = np.concatenate([np.asarray(g) for g in mb.G], axis=1)
        Ra_cat = np.concatenate([np.asarray(r) for r in ma.Rhat], axis=2)
        Rb_cat = np.concatenate([np.asarray(r) for r in mb.Rhat], axis=2)
        self.moments = k2d.Moments2D(Ga_cat, Gb_cat, ma.Btot, na, nb)
        self.final = k2d.Final2D(ma.Btot, Ra_cat, mb.Btot, Rb_cat, na, nb)

        def buf(name, a):  # glue constants stay float64 (module docstring)
            self.register_buffer(
                name, torch.from_numpy(np.ascontiguousarray(a, np.float64)))

        buf("CMa_p", pad_solve_matrix(
            dimfuse.combined_solve_matrix(ma, na), na, Ka))
        buf("CMb_p", pad_solve_matrix(
            dimfuse.combined_solve_matrix(mb, nb), nb, Kb))
        Gb8 = np.zeros((Gb_cat.shape[0], _SLOTS, T))
        Gb8[:, :Kb] = Gb_cat
        buf("Ran", _per_tile(Ra_cat, na))                     # (na, Ta, Ka)
        buf("Gb8n", _per_tile(Gb8, nb))                       # (nb, 8, Tb)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, self.moments, self.final)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, self.moments.plain, self.final.plain)

    def tile(self, x: torch.Tensor) -> torch.Tensor:
        """(..., wa, wb) float32 → the kernels' zero-padded (p, na, Ta, W)."""
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32 input, got {x.dtype}")
        if x.ndim < 2 or tuple(x.shape[-2:]) != (self.wa, self.wb):
            raise ValueError(f"input shape {tuple(x.shape)} does not end in "
                             f"the filter's extents ({self.wa}, {self.wb})")
        if self.pad_a or self.pad_b:
            x = F.pad(x, (0, self.pad_b, 0, self.pad_a))
        return x.reshape(-1, self.na, TILE, self.nb * TILE).contiguous()

    def carries(self, X4: torch.Tensor, moments=None):
        """Pass 1 and the carry solves: the solved carries ``(NA_t, NB_t)``
        of the tiled image X4, in the final kernel's float32 layouts."""
        if moments is None:
            moments = self.moments
        T, na, nb, Ka = TILE, self.na, self.nb, self.Ka
        p, W = X4.shape[0], nb * T
        # pass 1: dim-A raw tails + dim-B term1 = Btot_a·(x·G_Bᵀ)
        bA_t, term1 = moments(X4)
        bA_t, term1 = bA_t.double(), term1.double()
        # dim-A chain solve (slot-padded layout)
        NA_t = torch.matmul(self.CMa_p, bA_t.reshape(p, na * _SLOTS, W))
        # dim-B raw tails from carry-sized data only
        NAr = NA_t.reshape(p, na, _SLOTS, nb, T)[:, :, :Ka]
        GN = torch.einsum("bkt,pajbt->pabkj", self.Gb8n, NAr)
        term2 = torch.einsum("aoj,pabkj->pabko", self.Ran, GN)
        bB = term1.reshape(p, na, nb, _SLOTS, T) + term2
        # dim-B chain solve
        NB_t = torch.matmul(self.CMb_p, bB.reshape(p * na, nb * _SLOTS, T))
        return (NA_t.reshape(p, na, _SLOTS, W).float(),
                NB_t.reshape(p, na, nb * _SLOTS, T).float())

    def _run(self, x, moments, final):
        lead = x.shape[:-2]
        X4 = self.tile(x)
        # passes 2+3: read x once, emit Y
        Y4 = final(X4, *self.carries(X4, moments))
        y = Y4.reshape(*lead, self.na * TILE, self.nb * TILE)
        return y[..., :self.wa, :self.wb]


def _rows_decline(L: int, W: int, scans: Sequence[Scan]):
    """Why the rows kernels do not take a scan of extent ``L`` with ``W``
    lanes (the static gates of the JAX package's ``fused_rows_px``), or
    None where they do."""
    T = TILE
    if L < T or L % T or W % T:
        return (f"scanned extent {L} with {W} lanes: the rows kernels take "
                f"multiples of {T} in both")
    if L // T > dimfuse._CHAIN_MATMUL_MAX_TILES:
        return (f"{L // T} tiles: more than "
                f"{dimfuse._CHAIN_MATMUL_MAX_TILES} need the associative "
                "carry chain")
    K = sum(s.order for s in scans)
    if K > _SLOTS:
        return f"{K} carries: more than {_SLOTS}"
    return None


class FusedRowsPx(nn.Module):
    """Executor for ``scans`` along one axis that is not the last, of
    float32 arrays ``(..., L, *trailing)``: the JAX package's
    ``overlap2d.fused_rows_px``. The ``trailing`` extents are flattened
    into W lanes, the leading axes into a batch p, and the scanned axis is
    cut into n tiles of 128 rows:

        pass 1 (read x):  raw tails b = G·x per tile       rows_tails kernel
        solve (tiny):     N = CM·b — banded from 64 tiles  torch, float64
        pass 2 (read x):  y = Btot·x + Rhat·N, write y     rows_final kernel

    ``forward`` runs the CUDA kernels for CUDA tensors (their plain twins
    for CPU tensors); ``forward_plain`` runs the twins on any device.
    Raises ``NotImplementedError`` where the JAX package declines the rows
    kernels (extents that are not multiples of 128, more than 256 tiles,
    more than 8 carries): it runs its einsum pass there."""

    def __init__(self, scans: Sequence[Scan], L: int,
                 trailing: Sequence[int], border: str):
        super().__init__()
        T = TILE
        trailing = tuple(int(e) for e in trailing)
        if not trailing:
            raise NotImplementedError(
                "the rows pass scans a non-last axis; the last axis runs "
                "dimfuse.FusedLastAxis")
        W = int(np.prod(trailing, dtype=np.int64))
        why = _rows_decline(L, W, scans)
        if why:
            raise NotImplementedError(
                f"{why}; the JAX package runs its einsum pass on a non-last "
                "axis here (ROADMAP Queue 1 item 6)")
        n = L // T
        mats = dimfuse.prepare_dim_pass(scans, T, n,
                                        border == BorderMode.CLAMP)
        K = int(sum(mats.orders))
        self.L, self.trailing, self.n, self.W, self.K = L, trailing, n, W, K
        G_cat = np.concatenate([np.asarray(g) for g in mats.G], axis=1)
        R_cat = np.concatenate([np.asarray(r) for r in mats.Rhat], axis=2)
        self.tails = k2d.RowsTails(G_cat, n)
        self.final = k2d.RowsFinal(mats.Btot, R_cat, n)
        # carry solve, float64 (module docstring): banded where the chain
        # matrix is (n ≥ 64 tiles, a decaying filter), else dense
        CM = dimfuse.combined_solve_matrix(mats, n)
        bands = dimfuse.banded_solve_blocks(CM, n, K)
        self.offsets = None
        if bands is not None:
            self.offsets = [d for d, _ in bands]
            self.register_buffer("bands", torch.from_numpy(
                np.stack([b for _, b in bands])))
        else:
            self.register_buffer("CMp", torch.from_numpy(
                pad_solve_matrix(CM, n, K).astype(np.float64)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, self.tails, self.final)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, self.tails.plain, self.final.plain)

    def tile(self, x: torch.Tensor) -> torch.Tensor:
        """(..., L, *trailing) float32 → the kernels' (p, n, 128, W)."""
        if x.dtype != torch.float32:
            raise TypeError(f"expected float32 input, got {x.dtype}")
        ext = (self.L, *self.trailing)
        if x.ndim < len(ext) or tuple(x.shape[-len(ext):]) != ext:
            raise ValueError(f"input shape {tuple(x.shape)} does not end in "
                             f"the filter's extents {ext}")
        return x.reshape(-1, self.n, TILE, self.W).contiguous()

    def carries(self, X4: torch.Tensor, tails=None) -> torch.Tensor:
        """Pass 1 and the carry solve: the slot-padded carries
        (p, n, 8, W) of the tiled array X4, in float32."""
        b = (self.tails if tails is None else tails)(X4).double()
        if self.offsets is not None:
            N = dimfuse._banded_solve_apply(
                list(zip(self.offsets, self.bands)), b, self.K)
        else:
            p = b.shape[0]
            N = torch.matmul(self.CMp, b.reshape(p, self.n * _SLOTS, self.W))
        return N.reshape(b.shape).float().contiguous()

    def _run(self, x, tails, final):
        X4 = self.tile(x)
        return final(X4, self.carries(X4, tails)).reshape(x.shape)


def fused_rows_px(x: torch.Tensor, axis: int, scans: Sequence[Scan],
                  border: str) -> torch.Tensor:
    """Functional form of :class:`FusedRowsPx` (the JAX package's
    ``overlap2d.fused_rows_px`` without its precision/interpret
    arguments): all ``scans`` along ``axis`` of ``x``, which must not be
    the last axis."""
    if not 0 <= axis < x.ndim - 1:
        raise NotImplementedError(
            f"axis {axis} of a {x.ndim}-D array: the rows pass scans a "
            "non-last axis (the last axis runs dimfuse.FusedLastAxis)")
    mod = FusedRowsPx(scans, x.shape[axis], x.shape[axis + 1:], border)
    return mod.to(x.device)(x)


def fused_2d_px(x: torch.Tensor, axis_a: int, scans_a: Sequence[Scan],
                axis_b: int, scans_b: Sequence[Scan],
                border: str) -> torch.Tensor:
    """Functional form of :class:`Fused2DPx` (the JAX package's
    ``overlap2d.fused_2d_px`` without its precision/interpret arguments):
    the scanned dims must be the trailing two axes."""
    if (axis_a, axis_b) != (x.ndim - 2, x.ndim - 1):
        raise NotImplementedError(
            "the 2-D executor scans the trailing two axes (ROADMAP Queue 1 "
            "item 6: non-trailing axes)")
    mod = Fused2DPx(scans_a, scans_b, x.shape[-2], x.shape[-1], border)
    return mod.to(x.device)(x)
