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
(plain twins on the CPU, 512²). Each dimension's solve is banded from 64
tiles on, for a decaying filter, else the dense padded (n·8)² matmul —
``fused_2d_px``'s rule. Every host matrix is built once, at module
construction.

Two consumers ride :class:`Fused2DPx` as in the JAX package's
``fused_2d_px``: an elementwise ``epilogue(y, *eaux)`` — inside the final
kernel's store loop where its structure is affine (``final2d_epi``: the
unsharp mask's combine, :func:`.epilogue.affine_form`), as torch ops on
the kernel's output otherwise — and a ``stencil2d`` bank — per channel 2-D shifted taps —
fused into the final kernel (``final2d_stencil``), so the filter output
never reaches device memory: the moments kernel also emits each tile's
edge completion partials, and the glue completes them into the row-halo
strips above and below every tile (float64, :meth:`Fused2DPx.halo_strips`).

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
from .epilogue import kernel_form
from .kernels import final2d as k2d
from .kernels.completion import _SLOTS, _per_tile, pad_solve_matrix
from .kernels.stencil2d import stencil_reach
from .spec import BorderMode, Scan

TILE = k2d.TILE


def stencil2d_decline(wa: int, wb: int, stencil2d):
    """Why the JAX package's ``fused_2d_px`` declines a ``stencil2d`` bank
    on extents (wa, wb) (its gates: no pad, a row reach h8 = ⌈max|dy|/8⌉·8
    ≤ 128 and a column reach ≤ 128), or None where it fuses it."""
    up, down, left, right = stencil_reach(stencil2d)
    if wa % TILE or wb % TILE:
        return f"extents not multiples of {TILE}"
    if stencil_h8(stencil2d) > TILE or max(left, right) > TILE:
        return (f"reach {max(up, down)} rows, {max(left, right)} columns: "
                f"beyond {TILE}")
    return None


def fused2d_decline(scans_a: Sequence[Scan], scans_b: Sequence[Scan],
                    wa: int, wb: int, border: str, stencil2d=None):
    """Why the JAX package's ``fused_2d_px`` declines a filter with
    ``scans_a`` on axis -2 and ``scans_b`` on axis -1 of extents (wa, wb)
    (and a ``stencil2d`` bank), or None where it runs it. Its gates:
    extents of at least one tile, no pad under a clamp border, at most 256
    tiles and 8 carries per dimension, and :func:`stencil2d_decline`'s."""
    T, cap = TILE, dimfuse._CHAIN_MATMUL_MAX_TILES
    na, nb = -(-wa // T), -(-wb // T)
    Ka, Kb = (sum(s.order for s in sc) for sc in (scans_a, scans_b))
    if wa < T or wb < T:
        return f"extents ({wa}, {wb}) below the {T} tile"
    if border == BorderMode.CLAMP and (wa % T or wb % T):
        return (f"clamp border with extents ({wa}, {wb}) that are not "
                f"multiples of {T}")
    if na > cap or nb > cap:
        return f"{na} x {nb} tiles: more than {cap} per dimension"
    if Ka > _SLOTS or Kb > _SLOTS:
        return f"carries Ka={Ka}, Kb={Kb}: more than {_SLOTS} per dimension"
    if stencil2d is not None:
        return stencil2d_decline(wa, wb, stencil2d)
    return None


def stencil_h8(stencil2d) -> int:
    """The row-halo height: max|dy| rounded up to 8, at least 8."""
    up, down, _, _ = stencil_reach(stencil2d)
    return -(-max(up, down, 1) // 8) * 8


class Fused2DPx(nn.Module):
    """Executor for scans ``scans_a`` on axis -2 and ``scans_b`` on axis
    -1 of float32 arrays ``(..., wa, wb)``; leading axes are a batch.

    ``forward`` runs the CUDA kernels for CUDA tensors (their plain twins
    for CPU tensors); ``forward_plain`` runs the twins on any device — the
    all-PyTorch reference for the kernel path.

    ``epilogue(y, *eaux)``: an elementwise combine of the filter output
    (``forward(x, *eaux)``, the aux arrays in the output's layout, padded
    and tiled like x). Where :func:`.epilogue.affine_form` reads it as
    ``a·y + Σᵢ bᵢ·auxᵢ + c`` (k ≤ 4) the final kernel applies it in its
    store loop (``epilogue_route == "kernel"``); otherwise it runs as
    torch ops on the kernel's output (``"torch"``). ``stencil2d``: per channel
    ``[(dy, dx, coeff), ...]`` fused into the final kernel
    (``final2d_stencil``); ``forward`` then returns a tuple of C channels.

    Raises ``NotImplementedError`` where the JAX package's executor would
    decline the filter (:func:`fused2d_decline`: extents below one tile,
    clamp with extents that are not tile multiples, more than 256 tiles,
    more than 8 carries per dimension, a stencil bank past
    :func:`stencil2d_decline`'s gates): the router runs the rotation
    chain there (``dimfuse.RotationChain``)."""

    def __init__(self, scans_a: Sequence[Scan], scans_b: Sequence[Scan],
                 wa: int, wb: int, border: str, epilogue=None,
                 stencil2d=None):
        super().__init__()
        T = TILE
        if stencil2d is not None and epilogue is not None:
            raise ValueError("stencil2d is mutually exclusive with epilogue")
        why = fused2d_decline(scans_a, scans_b, wa, wb, border, stencil2d)
        if why:
            raise NotImplementedError(
                f"{why}: the JAX package's 3-touch executor declines this "
                "filter, and dimfuse.fused_filter_module runs its rotation "
                "chain (dimfuse.RotationChain) instead")
        clamp = border == BorderMode.CLAMP
        na, nb = -(-wa // T), -(-wb // T)
        pad_a, pad_b = na * T - wa, nb * T - wb
        ma = dimfuse.prepare_dim_pass(scans_a, T, na, clamp, pad_slots=pad_a)
        mb = dimfuse.prepare_dim_pass(scans_b, T, nb, clamp, pad_slots=pad_b)
        Ka, Kb = int(sum(ma.orders)), int(sum(mb.orders))
        self.wa, self.wb, self.na, self.nb = wa, wb, na, nb
        self.pad_a, self.pad_b, self.Ka, self.Kb = pad_a, pad_b, Ka, Kb
        self.epilogue = epilogue
        self.affine = kernel_form(epilogue)
        self.epilogue_route = (None if epilogue is None else
                               "torch" if self.affine is None else "kernel")
        self.h8 = 0 if stencil2d is None else stencil_h8(stencil2d)

        Ga_cat = np.concatenate([np.asarray(g) for g in ma.G], axis=1)
        Gb_cat = np.concatenate([np.asarray(g) for g in mb.G], axis=1)
        Ra_cat = np.concatenate([np.asarray(r) for r in ma.Rhat], axis=2)
        Rb_cat = np.concatenate([np.asarray(r) for r in mb.Rhat], axis=2)
        self.moments = k2d.Moments2D(
            Ga_cat, Gb_cat, ma.Btot, na, nb,
            edge=(ma.Btot, self.h8) if self.h8 else None)
        if self.h8:
            self.final = k2d.Final2DStencil(ma.Btot, Ra_cat, mb.Btot,
                                            Rb_cat, na, nb, stencil2d,
                                            self.h8)
        else:
            self.final = k2d.Final2D(ma.Btot, Ra_cat, mb.Btot, Rb_cat, na,
                                     nb, affine=self.affine)

        def buf(name, a):  # glue constants stay float64 (module docstring)
            self.register_buffer(
                name, torch.from_numpy(np.ascontiguousarray(a, np.float64)))

        # each dimension's carry solve: banded from 64 tiles on (a decaying
        # filter), else the dense padded matmul — fused_2d_px's rule
        self.offsets = {}
        for d, m, n, K in (("a", ma, na, Ka), ("b", mb, nb, Kb)):
            CM = dimfuse.combined_solve_matrix(m, n)
            bands = dimfuse.banded_solve_blocks(CM, n, K)
            self.offsets[d] = None if bands is None else [o for o, _ in bands]
            if bands is None:
                buf(f"CM{d}_p", pad_solve_matrix(CM, n, K))
            else:
                buf(f"bands_{d}", np.stack([b for _, b in bands]))
        Gb8 = np.zeros((Gb_cat.shape[0], _SLOTS, T))
        Gb8[:, :Kb] = Gb_cat
        buf("Ran", _per_tile(Ra_cat, na))                     # (na, Ta, Ka)
        buf("Gb8n", _per_tile(Gb8, nb))                       # (nb, 8, Tb)
        if self.h8:  # the halo strips' dim-B completion
            buf("Bbn", _per_tile(mb.Btot, nb))                # (nb, Tb, Tb)
            buf("Rbn", _per_tile(Rb_cat, nb))                 # (nb, Tb, Kb)

    def forward(self, x: torch.Tensor, *eaux):
        return self._run(x, self.moments, self.final, eaux)

    def forward_plain(self, x: torch.Tensor, *eaux):
        return self._run(x, self.moments.plain, self.final.plain, eaux)

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
        NA_t, NB_t = self._carries(X4, moments)[:2]
        return NA_t.float(), NB_t.float()

    def _carries(self, X4, moments=None):
        """:meth:`carries` in float64, followed by the moments kernel's
        edge partials where a stencil bank is fused."""
        if moments is None:
            moments = self.moments
        T, na, nb, Ka = TILE, self.na, self.nb, self.Ka
        p, W = X4.shape[0], nb * T
        # pass 1: dim-A raw tails + dim-B term1 = Btot_a·(x·G_Bᵀ)
        bA_t, term1, *edges = moments(X4)
        bA_t, term1 = bA_t.double(), term1.double()
        # dim-A chain solve (slot-padded layout)
        NA_t = self._solve("a", bA_t, Ka)
        # dim-B raw tails from carry-sized data only
        NAr = NA_t.reshape(p, na, _SLOTS, nb, T)[:, :, :Ka]
        GN = torch.einsum("bkt,pajbt->pabkj", self.Gb8n, NAr)
        term2 = torch.einsum("aoj,pabkj->pabko", self.Ran, GN)
        bB = term1.reshape(p, na, nb, _SLOTS, T) + term2
        # dim-B chain solve
        NB_t = self._solve("b", bB, self.Kb)
        return (NA_t.reshape(p, na, _SLOTS, W),
                NB_t.reshape(p, na, nb * _SLOTS, T), *edges)

    def _solve(self, d: str, b, K: int):
        """Dimension ``d``'s carry solve of the slot-padded tails
        ``b`` (..., n, 8, lanes), leading axes a batch: banded or dense."""
        if self.offsets[d] is not None:
            return dimfuse._banded_solve_apply(
                list(zip(self.offsets[d], getattr(self, f"bands_{d}"))), b, K)
        lead, (n, sl, w) = b.shape[:-3], b.shape[-3:]
        N = torch.matmul(getattr(self, f"CM{d}_p"),
                         b.reshape(-1, n * sl, w))
        return N.reshape(*lead, n, sl, w)

    def halo_strips(self, ht, hb, NA_t, NB_t):
        """The row-halo strips of the fused stencil, in float64: the
        moments kernel's edge partials ``ht``/``hb`` (Btot_a's first/last
        h8 rows · x) completed with both dimensions' carries — the bottom
        h8 rows of each tile's upper neighbour (``top``) and the top h8
        rows of its lower neighbour (``bot``), (p, na, h8, W), zeros past
        the first/last tile. Returns float32 (top, bot)."""
        T, h8, na, nb, Ka, Kb = TILE, self.h8, self.na, self.nb, self.Ka, \
            self.Kb
        p, W = NA_t.shape[0], nb * T
        NAk = NA_t[:, :, :Ka]
        NBr = NB_t.reshape(p, na, nb, _SLOTS, T)[:, :, :, :Kb]
        Ztop = ht.double() + torch.einsum("ahk,pakw->pahw", self.Ran[:, :h8],
                                          NAk)
        Zbot = hb.double() + torch.einsum("ahk,pakw->pahw",
                                          self.Ran[:, T - h8:], NAk)

        zpad = Ztop.new_zeros((p, 1, h8, W))
        nbpad = NBr.new_zeros((p, 1, nb, Kb, h8))
        # tile a's top halo = tile a−1's bottom rows; bottom = a+1's top;
        # both strips' dim-B completion in one pair of products
        Z = torch.cat([torch.cat([zpad, Zbot[:, :na - 1]], 1),
                       torch.cat([Ztop[:, 1:], zpad], 1)], 2)
        NBrows = torch.cat([
            torch.cat([nbpad, NBr[:, :na - 1, ..., T - h8:]], 1),
            torch.cat([NBr[:, 1:, ..., :h8], nbpad], 1)], -1)
        y = (torch.einsum("bot,pahbt->pahbo", self.Bbn,
                          Z.reshape(p, na, 2 * h8, nb, T))
             + torch.einsum("bok,pabkh->pahbo", self.Rbn, NBrows))
        y = y.reshape(p, na, 2 * h8, W).float()
        return y[:, :, :h8].contiguous(), y[:, :, h8:].contiguous()

    def _run(self, x, moments, final, eaux=()):
        lead = x.shape[:-2]
        X4 = self.tile(x)
        NA_t, NB_t, *edges = self._carries(X4, moments)
        NA32, NB32 = NA_t.float(), NB_t.float()
        if self.h8:
            # passes 2+3 with the bank: C channels, the output unwritten
            outs = final(X4, NA32, NB32, *self.halo_strips(*edges, NA_t,
                                                           NB_t))
            return tuple(o.reshape(*lead, self.wa, self.wb) for o in outs)
        # the aux arrays padded and tiled like x (position-free), a
        # broadcast aux materialized
        aux = [self.tile(torch.as_tensor(a).to(device=x.device,
                                               dtype=torch.float32)
                         .expand_as(x))
               for a in (eaux if self.epilogue is not None else ())]
        # passes 2+3: read x once, emit Y (or the affine epilogue's output)
        if self.affine is not None:
            Y4 = final(X4, NA32, NB32, *aux)
        else:
            Y4 = final(X4, NA32, NB32)
            if self.epilogue is not None:
                Y4 = self.epilogue(Y4, *aux)
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
    kernels (:func:`_rows_decline`: extents that are not multiples of 128,
    more than 256 tiles, more than 8 carries): the router runs the einsum
    pass there (``dimfuse.FusedAxisPass``)."""

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
                f"{why}: the JAX package declines its rows kernels here, "
                "and dimfuse.fused_filter_module runs the einsum pass on a "
                "non-last axis (dimfuse.FusedAxisPass) instead")
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
            "the 2-D executor scans the trailing two axes; "
            "dimfuse.fused_filter_module routes any other pair")
    mod = Fused2DPx(scans_a, scans_b, x.shape[-2], x.shape[-1], border)
    return mod.to(x.device)(x)
