"""The kernels of the 3-touch 2-D executor and of the rows pass, with
their plain twins.

  * :class:`Moments2D` (pass 1): read tiles of x once, emit the dim-A local
    tails ``G_A·x`` and the dim-B term ``Btot_A·(x·G_Bᵀ)`` (carry-sized).
  * :class:`Final2D` (passes 2+3 fused): read the x tile once, form the
    dim-A completion Z = Btot_A·x + Rhat_A·N_A on chip, and write
    Y = Z·Btot_Bᵀ + N_B·Rhat_Bᵀ. Z never touches device memory. With an
    affine epilogue (``final2d_epi``) it writes ``a·Y + Σᵢ bᵢ·auxᵢ + c``
    instead, the aux arrays in x's layout: the unsharp mask's combine,
    its image the one aux, and Y never touches device memory either.
  * :class:`Final2DStencil`: :class:`Final2D` with a fused 2-D stencil
    consumer — C channel banks of shifted taps over Y, which itself never
    touches device memory; the rows above and below each tile come from
    halo strips that the glue completes from :class:`Moments2D`'s edge
    rows (``edge=``).
  * :class:`Moments2DK` / :class:`Final2DK`: the HIGHEST grade's pair
    (``moments2d_k`` / ``final2d_k``, the ``overlap_k`` backend's kernel
    path): the same two passes at the JAX package's ``moments2d`` /
    ``final2d`` layouts — any leading tile Ta ≤ 128, carries Ka, Kb ≤ 32
    unpadded, raw dim-B moments U (no term1 fold), NA in row form.
  * :class:`RowsTails` / :class:`RowsFinal`: the dim-A halves of those two
    on their own — tails ``G·x`` and completion ``Btot·x + Rhat·N`` of a
    scan along a non-last axis, everything after it flattened into W
    lanes (:class:`.overlap2d.FusedRowsPx`).

Each module holds its host-built matrices as buffers and has two paths:
``forward`` launches the CUDA kernel (``csrc/*.cu``) for a CUDA tensor and
runs the plain PyTorch twin for a CPU tensor; ``plain`` is the twin, the
reference the kernel is held against. The CUDA path is
:class:`.launch._KernelFn`, whose backward is the twin's VJP (both passes
are linear); :data:`.launch.LAUNCHES` counts kernel launches.

Layouts are the JAX package's (``recfilter_tpu/kernels/final2d.py``):
  x      (p, na, Ta, W), W = nb·Tb      bA_t / NA_t   (p, na, 8, W)
  term1 / NB_t  (p, na, nb·8, Ta)
with carries slot-padded to 8 rows and Ta = Tb = 128; the rows kernels
take the same x and bA_t / NA_t layouts with any W that is a multiple of
128.

Per-tile matrix variants (clamp edges, pad projector) differ only at the
globally-first/last tiles, so the kernels take ≤ 3 distinct variants
[interior, first, last] and pick one by tile position.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .completion import (_SLOTS, TILE, _aux_ptrs, _epi_coef, _expand_stack,
                         _f32, _f64, _per_tile, _variants3, _variants_like,
                         tile_einsum)
from .launch import _check, _KernelFn, _launch


def _pad_slots(M, k_axis: int = 2) -> np.ndarray:
    """Zero-pad a carry axis (size K ≤ 8) up to the 8-row slot."""
    M = np.asarray(M, np.float64)
    k = M.shape[k_axis]
    if k == _SLOTS:
        return M
    pad = [(0, 0)] * M.ndim
    pad[k_axis] = (0, _SLOTS - k)
    return np.pad(M, pad)


def _cat_t(B, R) -> np.ndarray:
    """(n|1, T, T), (n|1, T, 8) stacks → the GEMM operand [Bᵀ; Rᵀ]
    (1|3, T+8, T) per variant."""
    B, R = _variants_like(B, R)
    return np.concatenate([B.transpose(0, 2, 1), R.transpose(0, 2, 1)],
                          axis=1)


def _grid_ok(p: int, n: int, W: int) -> None:
    """The kernels' launch grid is (W/128, n, p): gridDim.y and gridDim.z
    stop at 65535."""
    if not (0 < p < 65536 and 0 < n < 65536 and 0 < W // TILE < 2**31):
        raise ValueError(f"leading extent {p}, {n} tiles, {W} lanes: "
                         "outside the launch grid")


class Moments2D(nn.Module):
    """Pass 1: ``(bA_t, term1) = moments(x)`` for x (p, na, Ta, W).

    G_a_cat : (na|1, Ka, Ta)   G_b_cat : (nb|1, Kb, Tb)
    term1_mats : (na|1, Ta, Ta), the dim-A Btot folded into the dim-B term.
    edge : optional ``(Btot_a, h8)`` — also emit each tile's edge
    completion partials ``ht = Btot_a[:h8]·x`` and ``hb =
    Btot_a[Ta-h8:]·x``, (p, na, h8, W) each (the JAX package's
    ``moments2d_px(edge_mats=)``): ``moments(x)`` then returns
    ``(bA_t, term1, ht, hb)``.
    solve : optional slot-padded (na·8)² dim-A solve matrix CM_A — emit
    the solved carries ``N_A = CM_A·bA`` (p, na, 8, W) in place of bA_t
    (the ``moments2d_naf`` entry; the JAX package's
    ``moments2d_px(solve_mats=)``). Exclusive with ``edge``.
    """

    def __init__(self, G_a_cat, G_b_cat, term1_mats, na: int, nb: int,
                 edge=None, solve=None):
        super().__init__()
        Ga, Gb = np.asarray(G_a_cat), np.asarray(G_b_cat)
        self.na, self.nb = int(na), int(nb)
        self.Ka, self.Kb = Ga.shape[1], Gb.shape[1]
        if not (Ga.shape[2] == Gb.shape[2] == TILE):
            raise ValueError(f"tiles must be {TILE} wide")
        if self.Ka > _SLOTS or self.Kb > _SLOTS:
            raise ValueError(f"carries Ka={self.Ka}, Kb={self.Kb} exceed "
                             f"the {_SLOTS}-row slot")
        Ga8, Gb8 = _pad_slots(Ga, 1), _pad_slots(Gb, 1)
        # kernel operands: distinct variants; Btot_a transposed to [s][o]
        Ga_v, Ba1_v = _variants_like(Ga8, term1_mats)
        self.register_buffer("Ga_v", _f32(Ga_v))
        self.register_buffer("Gb_v", _f32(_variants3(Gb8)))
        self.register_buffer("Ba1T_v", _f32(Ba1_v.transpose(0, 2, 1)))
        # twin operands: per-tile float64 stacks (the twin, like the
        # kernel, sums in fp64 — see csrc/moments2d.cu)
        self.register_buffer("Gan", torch.from_numpy(_per_tile(Ga8, na)))
        self.register_buffer("Gbn", torch.from_numpy(_per_tile(Gb8, nb)))
        self.register_buffer("Ba1n",
                             torch.from_numpy(_per_tile(term1_mats, na)))
        # edge rows: kernel operand E (1|3, 2·h8, Ta), twin per-tile f64
        self.h8 = 0 if edge is None else int(edge[1])
        if not 0 <= self.h8 <= TILE:
            raise ValueError(f"h8 = {self.h8} outside [0, {TILE}]")
        if self.h8:
            B = np.asarray(edge[0], np.float64)
            E = np.concatenate([B[:, :self.h8], B[:, TILE - self.h8:]], 1)
            self.register_buffer("E_v", _f32(_variants3(E)))
            self.register_buffer("En", torch.from_numpy(_per_tile(E, na)))
        else:
            self.register_buffer("E_v", torch.zeros(1, 0, TILE))
        # the dim-A solve, float64, transposed to [s][r] for the kernel
        self.solve = solve is not None
        if self.solve:
            if self.h8:
                raise ValueError("solve is exclusive with edge rows")
            CM = np.asarray(solve, np.float64)
            if CM.shape != (na * _SLOTS, na * _SLOTS):
                raise ValueError(f"solve matrix shape {CM.shape} != "
                                 f"({na * _SLOTS}, {na * _SLOTS})")
            self.register_buffer("CMaT", _f64(CM.T))

    def solve_plain(self, bA):
        """The dim-A solve of the tails bA (p, na, 8, W) in float64: the
        twin of ``moments2d_naf``'s in-kernel solve."""
        p, W = bA.shape[0], bA.shape[-1]
        N = torch.matmul(self.CMaT.t(), bA.double().reshape(
            p, self.na * _SLOTS, W))
        return N.reshape(p, self.na, _SLOTS, W)

    def plain(self, x):
        p, na, Ta, W = x.shape
        xd = x.double()
        bA = torch.einsum("aks,pasw->pakw", self.Gan, xd)
        U = torch.einsum("bkt,pasbt->pabks", self.Gbn,
                         xd.reshape(p, na, Ta, self.nb, W // self.nb))
        term1 = torch.einsum("aos,pabks->pabko", self.Ba1n, U)
        # the kernel solves its fp32 tails, as the glue solves bA_t
        bA = bA.float()
        out = (self.solve_plain(bA).float() if self.solve else bA,
               term1.reshape(p, na, self.nb * _SLOTS, Ta).float())
        if self.h8:
            e = torch.einsum("aks,pasw->pakw", self.En, xd).float()
            out += (e[:, :, :self.h8], e[:, :, self.h8:])
        return out

    def _kernel(self, x):
        p, na, nb, h8 = x.shape[0], self.na, self.nb, self.h8
        _check(x, "x", (p, na, TILE, nb * TILE), x.device)
        for name in ("Ga_v", "Gb_v", "Ba1T_v", "E_v"):
            t = getattr(self, name)
            _check(t, name, t.shape, x.device)
        _grid_ok(p, na, nb * TILE)
        bA = torch.empty((p, na, _SLOTS, nb * TILE), device=x.device)
        term1 = torch.empty((p, na, nb * _SLOTS, TILE), device=x.device)
        if self.solve:
            _check(self.CMaT, "CMaT", self.CMaT.shape, x.device,
                   torch.float64)
            _launch("moments2d_naf", (
                x.data_ptr(), self.Ga_v.data_ptr(), self.Gb_v.data_ptr(),
                self.Ba1T_v.data_ptr(), self.CMaT.data_ptr(), bA.data_ptr(),
                term1.data_ptr(), p, na, nb, self.Ka, self.Kb,
                self.Ga_v.shape[0], self.Gb_v.shape[0]), x.device)
            return bA, term1
        ht, hb = (torch.empty((p, na, h8, nb * TILE), device=x.device)
                  for _ in range(2))
        _launch("moments2d", (
            x.data_ptr(), self.Ga_v.data_ptr(), self.Gb_v.data_ptr(),
            self.Ba1T_v.data_ptr(), self.E_v.data_ptr(), bA.data_ptr(),
            term1.data_ptr(), ht.data_ptr(), hb.data_ptr(),
            p, na, nb, self.Ka, self.Kb, self.Ga_v.shape[0],
            self.Gb_v.shape[0], h8), x.device)
        return (bA, term1, ht, hb) if h8 else (bA, term1)

    def forward(self, x):
        if x.is_cuda:
            return _KernelFn.apply(self, x)
        return self.plain(x)


class Final2D(nn.Module):
    """Passes 2+3: ``Y = final(x, NA_t, NB_t)``.

    Btot_a : (na|1, Ta, Ta);  Rhat_a_cat : (na|1, Ta, Ka)
    Btot_b : (nb|1, Tb, Tb);  Rhat_b_cat : (nb|1, Tb, Kb)
    affine : an optional :class:`..epilogue.Affine` (k ≤ 4 aux arrays):
    ``final(x, NA_t, NB_t, *aux)`` then returns ``a·Y + Σᵢ bᵢ·auxᵢ + c``,
    each aux (p, na, Ta, W) like x (the ``final2d_epi`` entry; the twin
    applies the form after ``plain``'s Y).
    """

    def __init__(self, Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat, na: int,
                 nb: int, affine=None):
        super().__init__()
        self.na, self.nb = int(na), int(nb)
        Ra8, Rb8 = _pad_slots(Rhat_a_cat), _pad_slots(Rhat_b_cat)
        if not (np.shape(Btot_a)[1] == np.shape(Btot_b)[1] == TILE):
            raise ValueError(f"tiles must be {TILE} wide")
        if Ra8.shape[2] != _SLOTS or Rb8.shape[2] != _SLOTS:
            raise ValueError(f"carries exceed the {_SLOTS}-row slot")

        self.register_buffer("A1_v", _f32(_cat_t(Btot_a, Ra8)))
        self.register_buffer("B2_v", _f32(_cat_t(Btot_b, Rb8)))
        self.register_buffer("Ban", _f32(_expand_stack(Btot_a, na)))
        self.register_buffer("Ran", _f32(_expand_stack(Ra8, na)))
        self.register_buffer("Bbn", _f32(_expand_stack(Btot_b, nb)))
        self.register_buffer("Rbn", _f32(_expand_stack(Rb8, nb)))
        self.affine, self.k = affine, _epi_coef(self, affine)

    def plain(self, x, NA_t, NB_t, *aux):
        p, na, Ta, W = x.shape
        nb = self.nb
        z = (torch.einsum("aos,pasw->paow", self.Ban, x)
             + torch.einsum("aok,pakw->paow", self.Ran, NA_t))
        y = (torch.einsum("bot,pasbt->pasbo", self.Bbn,
                          z.reshape(p, na, Ta, nb, W // nb))
             + torch.einsum("bok,pabks->pasbo", self.Rbn,
                            NB_t.reshape(p, na, nb, _SLOTS, Ta)))
        y = y.reshape(p, na, Ta, W)
        return y if self.affine is None else self.affine.apply(y, aux)

    def _kernel(self, x, NA_t, NB_t, *aux):
        p, na, nb = x.shape[0], self.na, self.nb
        W = nb * TILE
        _check(x, "x", (p, na, TILE, W), x.device)
        _check(NA_t, "NA_t", (p, na, _SLOTS, W), x.device)
        _check(NB_t, "NB_t", (p, na, nb * _SLOTS, TILE), x.device)
        for name in ("A1_v", "B2_v"):
            t = getattr(self, name)
            _check(t, name, t.shape, x.device)
        _grid_ok(p, na, W)
        y = torch.empty_like(x)
        ops = (x.data_ptr(), NA_t.data_ptr(), NB_t.data_ptr(),
               self.A1_v.data_ptr(), self.B2_v.data_ptr())
        dims = (p, na, nb, self.A1_v.shape[0], self.B2_v.shape[0])
        if self.affine is None:
            _launch("final2d", (*ops, y.data_ptr(), *dims), x.device)
            return y
        _check(self.epi_coef, "epi_coef", self.epi_coef.shape, x.device)
        _launch("final2d_epi", (
            *ops, *_aux_ptrs(aux, self.k, x.shape, x.device),
            self.epi_coef.data_ptr(), y.data_ptr(), *dims, self.k), x.device)
        return y

    def forward(self, x, NA_t, NB_t, *aux):
        if len(aux) != self.k:
            raise ValueError(f"expected {self.k} aux arrays, got {len(aux)}")
        if x.is_cuda:
            return _KernelFn.apply(self, x, NA_t, NB_t, *aux)
        return self.plain(x, NA_t, NB_t, *aux)


class Final2DStencil(nn.Module):
    """Passes 2+3 with a fused 2-D stencil consumer:
    ``outs = final(x, NA_t, NB_t, halo_top, halo_bot)``, a (C, p, na, Ta,
    W) stack of the C channels

        out[c] = Σ_(dy, dx, coeff) coeff · Y[· + dy, · + dx]

    over the dual completion Y of :class:`Final2D` (the same operands),
    with the JAX package's border rule: positive offsets clamp at the far
    edges (rows, then columns), negative offsets read zero. The halo
    strips (p, na, h8, W) hold the completed bottom h8 rows of each tile's
    upper neighbour (``halo_top``) and top h8 rows of its lower neighbour
    (``halo_bot``); the kernel completes the neighbour columns itself
    (``csrc/final2d_stencil.cu``). The twin ``plain`` is the JAX package's
    ``_ref``: Y recomputed whole, then :func:`.stencil2d.stencil2d_ref` —
    it reads no halo strip, so the strips get zero gradients.

    taps_c : per channel ``[(dy, dx, coeff), ...]`` with |dy| ≤ h8 ≤ 128
    and |dx| ≤ 128.
    """

    def __init__(self, Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat, na: int,
                 nb: int, taps_c, h8: int):
        super().__init__()
        from .stencil2d import Stencil2D

        self.final = Final2D(Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat, na, nb)
        self.bank = Stencil2D(taps_c)
        self.na, self.nb, self.h8, self.C = int(na), int(nb), int(h8), \
            self.bank.C
        up, down, left, right = self.bank.reach
        if max(up, down) > self.h8 or self.h8 > TILE or max(left, right) \
                > TILE:
            raise ValueError(f"stencil reach {self.bank.reach} outside h8 = "
                             f"{self.h8} rows and {TILE} columns")
        self.dxl, self.dxr = left, right

    def plain(self, x, NA_t, NB_t, *halos):
        p, na, Ta, W = x.shape
        y = self.final.plain(x, NA_t, NB_t).reshape(p, na * Ta, W)
        return torch.stack(self.bank.plain(y)).reshape(self.C, p, na, Ta, W)

    def _kernel(self, x, NA_t, NB_t, halo_top, halo_bot):
        p, na, nb, h8 = x.shape[0], self.na, self.nb, self.h8
        W = nb * TILE
        _check(x, "x", (p, na, TILE, W), x.device)
        _check(NA_t, "NA_t", (p, na, _SLOTS, W), x.device)
        _check(NB_t, "NB_t", (p, na, nb * _SLOTS, TILE), x.device)
        _check(halo_top, "halo_top", (p, na, h8, W), x.device)
        _check(halo_bot, "halo_bot", (p, na, h8, W), x.device)
        fin, bank = self.final, self.bank
        for t in (fin.A1_v, fin.B2_v, bank.taps_k):
            _check(t, "operand", t.shape, x.device)
        _check(bank.toff, "toff", bank.toff.shape, x.device, torch.int32)
        _grid_ok(p, na, W)
        out = torch.empty((self.C, p, na, TILE, W), device=x.device)
        _launch("final2d_stencil", (
            x.data_ptr(), NA_t.data_ptr(), NB_t.data_ptr(),
            fin.A1_v.data_ptr(), fin.B2_v.data_ptr(), halo_top.data_ptr(),
            halo_bot.data_ptr(), bank.taps_k.data_ptr(), bank.toff.data_ptr(),
            out.data_ptr(), p, na, nb, fin.A1_v.shape[0], fin.B2_v.shape[0],
            h8, self.dxl, self.dxr, self.C, bank.taps_k.shape[0]), x.device)
        return out

    def forward(self, x, NA_t, NB_t, halo_top, halo_bot):
        if x.is_cuda:
            return _KernelFn.apply(self, x, NA_t, NB_t, halo_top, halo_bot)
        return self.plain(x, NA_t, NB_t, halo_top, halo_bot)


KMAX_K = 32  # the HIGHEST pair's largest carry count per axis


def highest_pair_limits(Ta: int, Ka: int, Kb: int) -> None:
    """Raise ``NotImplementedError`` past the HIGHEST pair's shapes: a
    leading tile above 128 or more than 32 carries on an axis."""
    if not 1 <= Ta <= TILE or not 1 <= Ka <= KMAX_K or not 1 <= Kb <= KMAX_K:
        raise NotImplementedError(
            f"tile Ta={Ta} with carries Ka={Ka}, Kb={Kb}: moments2d_k and "
            f"final2d_k take Ta ≤ {TILE} and at most {KMAX_K} carries per "
            "axis (ROADMAP Queue 2: shape limits of the HIGHEST pair and "
            "the strip kernels)")


class Moments2DK(nn.Module):
    """HIGHEST pass 1 (``moments2d_k``): ``(bA, U) = moments(x)`` for x
    (p, na, Ta, W), W = nb·128 — the JAX package's ``moments2d``.

    G_a_cat : (na|1, Ka, Ta)   G_b_cat : (nb|1, Kb, 128)
    returns bA (p, na, Ka, W) and the raw U (p, na, nb, Ta, Kb). Kernel
    and twin sum in float64 from float32 values (``csrc/moments2d.cu``)."""

    def __init__(self, G_a_cat, G_b_cat, na: int, nb: int):
        super().__init__()
        Ga, Gb = np.asarray(G_a_cat), np.asarray(G_b_cat)
        self.na, self.nb = int(na), int(nb)
        self.Ta, self.Ka, self.Kb = Ga.shape[2], Ga.shape[1], Gb.shape[1]
        if Gb.shape[2] != TILE:
            raise ValueError(f"dim-B tiles must be {TILE} wide")
        highest_pair_limits(self.Ta, self.Ka, self.Kb)
        self.register_buffer("Ga_v", _f32(_variants3(Ga)))
        self.register_buffer("Gb_v", _f32(_variants3(Gb)))
        self.register_buffer("Gan", _f32(_per_tile(Ga, na)).double())
        self.register_buffer("Gbn", _f32(_per_tile(Gb, nb)).double())

    def plain(self, x):
        p, na, Ta, W = x.shape
        xd = x.double()
        bA = torch.einsum("aks,pasw->pakw", self.Gan, xd)
        U = torch.einsum("bkt,pasbt->pabsk", self.Gbn,
                         xd.reshape(p, na, Ta, self.nb, TILE))
        return bA.float(), U.float()

    def _kernel(self, x):
        p, na, nb, Ta = x.shape[0], self.na, self.nb, self.Ta
        _check(x, "x", (p, na, Ta, nb * TILE), x.device)
        for name in ("Ga_v", "Gb_v"):
            t = getattr(self, name)
            _check(t, name, t.shape, x.device)
        _grid_ok(p, na, nb * TILE)
        bA = torch.empty((p, na, self.Ka, nb * TILE), device=x.device)
        U = torch.empty((p, na, nb, Ta, self.Kb), device=x.device)
        _launch("moments2d_k", (
            x.data_ptr(), self.Ga_v.data_ptr(), self.Gb_v.data_ptr(),
            bA.data_ptr(), U.data_ptr(), p, na, nb, Ta, self.Ka, self.Kb,
            self.Ga_v.shape[0], self.Gb_v.shape[0]), x.device)
        return bA, U

    def forward(self, x):
        if x.is_cuda:
            return _KernelFn.apply(self, x)
        return self.plain(x)


def _pad_rows(M, rows: int) -> np.ndarray:
    """Zero rows appended to axis 1 of a (v, r, c) stack, up to ``rows``."""
    return np.pad(M, ((0, 0), (0, rows - M.shape[1]), (0, 0)))


class Final2DK(nn.Module):
    """HIGHEST passes 2+3 (``final2d_k``): ``Y = final(x, NA, NB)`` — the
    JAX package's ``final2d``.

    Btot_a : (na|1, Ta, Ta);  Rhat_a_cat : (na|1, Ta, Ka)
    Btot_b : (nb|1, 128, 128);  Rhat_b_cat : (nb|1, 128, Kb)
    x (p, na, Ta, W); NA (p, na, Ka, W) in row form; NB (p, na, nb, Ta,
    Kb). fp32 products, as the JAX package's kernel has them; the kernel
    pads each carry count to a multiple of 8 with zero rows."""

    def __init__(self, Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat, na: int,
                 nb: int):
        super().__init__()
        Ba, Ra = np.asarray(Btot_a), np.asarray(Rhat_a_cat)
        Bb, Rb = np.asarray(Btot_b), np.asarray(Rhat_b_cat)
        self.na, self.nb = int(na), int(nb)
        self.Ta, self.Ka, self.Kb = Ba.shape[1], Ra.shape[2], Rb.shape[2]
        if Bb.shape[1:] != (TILE, TILE):
            raise ValueError(f"dim-B tiles must be {TILE} wide")
        highest_pair_limits(self.Ta, self.Ka, self.Kb)
        Kap, Kbp = (-(-k // _SLOTS) * _SLOTS for k in (self.Ka, self.Kb))
        # A1 = [Baᵀ; Raᵀ] with its columns padded to 128 and its rows to
        # Ta + Kap; B2 = [Bbᵀ; Rbᵀ] with its rows padded to 128 + Kbp
        A1 = _cat_t(Ba, Ra)
        A1 = np.pad(A1, ((0, 0), (0, Kap - self.Ka), (0, TILE - self.Ta)))
        self.register_buffer("A1_v", _f32(A1))
        self.register_buffer("B2_v", _f32(_pad_rows(_cat_t(Bb, Rb),
                                                    TILE + Kbp)))
        self.register_buffer("Ban", _f32(_expand_stack(Ba, na)))
        self.register_buffer("Ran", _f32(_expand_stack(Ra, na)))
        self.register_buffer("Bbn", _f32(_expand_stack(Bb, nb)))
        self.register_buffer("Rbn", _f32(_expand_stack(Rb, nb)))

    def plain(self, x, NA, NB):
        p, na, Ta, W = x.shape
        z = (torch.einsum("aos,pasw->paow", self.Ban, x)
             + torch.einsum("aok,pakw->paow", self.Ran, NA))
        y = (torch.einsum("bot,pasbt->pasbo", self.Bbn,
                          z.reshape(p, na, Ta, self.nb, TILE))
             + torch.einsum("bok,pabsk->pasbo", self.Rbn, NB))
        return y.reshape(p, na, Ta, W)

    def _kernel(self, x, NA, NB):
        p, na, nb, Ta = x.shape[0], self.na, self.nb, self.Ta
        W = nb * TILE
        _check(x, "x", (p, na, Ta, W), x.device)
        _check(NA, "NA", (p, na, self.Ka, W), x.device)
        _check(NB, "NB", (p, na, nb, Ta, self.Kb), x.device)
        for name in ("A1_v", "B2_v"):
            t = getattr(self, name)
            _check(t, name, t.shape, x.device)
        _grid_ok(p, na, W)
        y = torch.empty_like(x)
        _launch("final2d_k", (
            x.data_ptr(), NA.data_ptr(), NB.data_ptr(), self.A1_v.data_ptr(),
            self.B2_v.data_ptr(), y.data_ptr(), p, na, nb, Ta, self.Ka,
            self.Kb, self.A1_v.shape[0], self.B2_v.shape[0]), x.device)
        return y

    def forward(self, x, NA, NB):
        if x.is_cuda:
            return _KernelFn.apply(self, x, NA, NB)
        return self.plain(x, NA, NB)


def _rows_x(x, n: int) -> int:
    """Check the rows kernels' x (p, n, T, W) beyond ``_check``'s shape
    test; return W."""
    if x.ndim != 4 or x.shape[1:3] != (n, TILE) or x.shape[3] % TILE:
        raise ValueError(f"x shape {tuple(x.shape)} is not (p, {n}, {TILE}, "
                         f"W) with W a multiple of {TILE}")
    return x.shape[3]


class RowsTails(nn.Module):
    """Rows pass 1: ``b = tails(x)`` for x (p, n, T, W) → (p, n, 8, W),
    ``b[p,a,k,w] = Σ_s G_v(a)[k,s]·x[p,a,s,w]`` for k < K, zeros below.

    G_cat : (n|1, K, T) stacked per-scan tail rows (per-tile variants).
    The sums run in float64 from float32 loads, in the kernel and in the
    twin (see ``csrc/rows_tails.cu``)."""

    def __init__(self, G_cat, n: int):
        super().__init__()
        G = np.asarray(G_cat, np.float64)
        if G.shape[2] != TILE:
            raise ValueError(f"tiles must be {TILE} wide")
        if G.shape[1] > _SLOTS:
            raise ValueError(f"K={G.shape[1]} exceeds the {_SLOTS}-row slot")
        self.n, self.K = int(n), G.shape[1]
        Gv = _variants3(_pad_slots(G, 1))
        self.register_buffer("G_v", _f32(Gv))      # kernel operand
        self.register_buffer("G_v64", _f64(Gv))    # twin operand

    def plain(self, x):
        return tile_einsum("nks,pnsw->pnkw", self.G_v64, x.double()).float()

    def _kernel(self, x):
        p, n, W = x.shape[0], self.n, _rows_x(x, self.n)
        _check(x, "x", (p, n, TILE, W), x.device)
        _check(self.G_v, "G_v", self.G_v.shape, x.device)
        _grid_ok(p, n, W)
        b = torch.empty((p, n, _SLOTS, W), device=x.device)
        _launch("rows_tails", (
            x.data_ptr(), self.G_v.data_ptr(), b.data_ptr(),
            p, n, W // TILE, self.K, self.G_v.shape[0]), x.device)
        return b

    def forward(self, x):
        if x.is_cuda:
            return _KernelFn.apply(self, x)
        return self.plain(x)


class RowsFinal(nn.Module):
    """Rows pass 2: ``y = final(x, N)`` for x (p, n, T, W) and slot-padded
    carries N (p, n, 8, W): ``y[p,a] = Btot_v(a)·x[p,a] + Rhat_v(a)·N[p,a]``.

    Btot : (n|1, T, T);  Rhat_cat : (n|1, T, K). fp32 products, as the JAX
    package's twin has them."""

    def __init__(self, Btot, Rhat_cat, n: int):
        super().__init__()
        R8 = _pad_slots(Rhat_cat)
        if np.shape(Btot)[1:] != (TILE, TILE) or R8.shape[1:] != (TILE,
                                                                   _SLOTS):
            raise ValueError(f"tiles must be {TILE} wide with at most "
                             f"{_SLOTS} carries")
        self.n = int(n)
        self.register_buffer("A1_v", _f32(_cat_t(Btot, R8)))  # kernel
        self.register_buffer("B_v", _f32(_variants3(Btot)))   # twin
        self.register_buffer("R_v", _f32(_variants3(R8)))

    def plain(self, x, N):
        return (tile_einsum("nos,pnsw->pnow", self.B_v, x)
                + tile_einsum("nok,pnkw->pnow", self.R_v, N))

    def _kernel(self, x, N):
        p, n, W = x.shape[0], self.n, _rows_x(x, self.n)
        _check(x, "x", (p, n, TILE, W), x.device)
        _check(N, "N", (p, n, _SLOTS, W), x.device)
        _check(self.A1_v, "A1_v", self.A1_v.shape, x.device)
        _grid_ok(p, n, W)
        y = torch.empty_like(x)
        _launch("rows_final", (
            x.data_ptr(), N.data_ptr(), self.A1_v.data_ptr(), y.data_ptr(),
            p, n, W // TILE, self.A1_v.shape[0]), x.device)
        return y

    def forward(self, x, N):
        if x.is_cuda:
            return _KernelFn.apply(self, x, N)
        return self.plain(x, N)


def moments2d(x, G_a_cat, G_b_cat, term1_mats):
    """Functional pass 1: ``(bA_t, term1)`` for x (p, na, Ta, W)."""
    na, nb = x.shape[1], x.shape[3] // TILE
    return Moments2D(G_a_cat, G_b_cat, term1_mats, na, nb).to(x.device)(x)


def final2d(x, Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat, NA_t, NB_t):
    """Functional passes 2+3: Y (p, na, Ta, W)."""
    na, nb = x.shape[1], x.shape[3] // TILE
    mod = Final2D(Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat, na, nb)
    return mod.to(x.device)(x, NA_t, NB_t)


def carry_b_tails(Gb8n, Ran, NA_t, term1, Ka: int):
    """The dim-B raw tails of the dim-A completed image from carry-sized
    data only, in float64: ``bB = term1 + Ran·(Gb·N_A)`` (p, na, nb, 8, Tb)
    from the solved dim-A carries NA_t (p, na, 8, W), term1 (p, na, nb·8,
    Ta) and the per-tile stacks Gb8n (nb, 8, Tb), Ran (na, Ta, Ka)."""
    p, na, nb = NA_t.shape[0], Ran.shape[0], Gb8n.shape[0]
    NAr = NA_t.double().reshape(p, na, _SLOTS, nb, TILE)[:, :, :Ka]
    GN = torch.einsum("bkt,pajbt->pabkj", Gb8n, NAr)
    term2 = torch.einsum("aoj,pabkj->pabko", Ran, GN)
    return term1.double().reshape(p, na, nb, _SLOTS, TILE) + term2


class BSolve(nn.Module):
    """The dim-B carry glue and its solve in one launch (``bsolve``):
    ``NB_t = bsolve(NA_t, term1)`` from the solved dim-A carries NA_t
    (p, na, 8, W) and :class:`Moments2D`'s term1 (p, na, nb·8, Ta), both
    float32 — the JAX package's ``bsolve_pass``. Per (p, a):

        GN[b, k, j] = Σ_t Gb(b)[k, t] · NA_t[j, b·Tb + t]
        bB          = term1 + GN · Ra(a)ᵀ
        NB_t        = CM_B · bB

    in float64, as :class:`.overlap2d.Fused2DPx`'s glue computes them;
    NB_t float32 in the final kernel's layout, zeros in the pad slots.

    Gb_cat : (nb|1, Kb, Tb)   Ra_cat : (na|1, Ta, Ka)
    CMb_p : the slot-padded (nb·8)² dim-B solve matrix (its pad columns
    meet term1's rows ≥ Kb of each slot group, which the kernel skips).
    """

    def __init__(self, Gb_cat, Ra_cat, CMb_p, na: int, nb: int):
        super().__init__()
        Gb, Ra = np.asarray(Gb_cat, np.float64), np.asarray(Ra_cat, np.float64)
        CM = np.asarray(CMb_p, np.float64)
        self.na, self.nb = int(na), int(nb)
        self.Kb, self.Ka = Gb.shape[1], Ra.shape[2]
        if Gb.shape[2] != TILE or Ra.shape[1] != TILE:
            raise ValueError(f"tiles must be {TILE} wide")
        if not (1 <= self.Ka <= _SLOTS and 1 <= self.Kb <= _SLOTS):
            raise ValueError(f"carries Ka={self.Ka}, Kb={self.Kb} outside "
                             f"[1, {_SLOTS}]")
        if CM.shape != (nb * _SLOTS, nb * _SLOTS):
            raise ValueError(f"solve matrix shape {CM.shape} != "
                             f"({nb * _SLOTS}, {nb * _SLOTS})")
        # kernel operands (float64): variants, Ra transposed to [j][o], the
        # solve matrix's real rows and columns transposed to [q][r]
        real = (np.arange(nb)[:, None] * _SLOTS + np.arange(self.Kb)).ravel()
        self.register_buffer("Gb_v", _f64(_variants3(Gb)))
        self.register_buffer("RaT_v", _f64(_variants3(Ra).transpose(0, 2, 1)))
        self.register_buffer("CMT", _f64(CM[np.ix_(real, real)].T))
        # twin operands: the glue's per-tile stacks and padded matrix
        Gb8 = _pad_slots(Gb, 1)
        self.register_buffer("Gb8n", torch.from_numpy(_per_tile(Gb8, nb)))
        self.register_buffer("Ran", torch.from_numpy(_per_tile(Ra, na)))
        self.register_buffer("CMb_p", _f64(CM))

    def plain64(self, NA_t, term1):
        """The twin in float64 (float64 out): the glue's dim-B carries."""
        bB = carry_b_tails(self.Gb8n, self.Ran, NA_t, term1, self.Ka)
        NB = torch.matmul(self.CMb_p, bB.reshape(-1, self.nb * _SLOTS, TILE))
        return NB.reshape(NA_t.shape[0], self.na, self.nb * _SLOTS, TILE)

    def plain(self, NA_t, term1):
        return self.plain64(NA_t, term1).float()

    def _kernel(self, NA_t, term1):
        p, na, nb = NA_t.shape[0], self.na, self.nb
        _check(NA_t, "NA_t", (p, na, _SLOTS, nb * TILE), NA_t.device)
        _check(term1, "term1", (p, na, nb * _SLOTS, TILE), NA_t.device)
        for name in ("Gb_v", "RaT_v", "CMT"):
            t = getattr(self, name)
            _check(t, name, t.shape, NA_t.device, torch.float64)
        _grid_ok(p, na, nb * TILE)
        NB = torch.empty((p, na, nb * _SLOTS, TILE), device=NA_t.device)
        _launch("bsolve", (
            NA_t.data_ptr(), term1.data_ptr(), self.Gb_v.data_ptr(),
            self.RaT_v.data_ptr(), self.CMT.data_ptr(), NB.data_ptr(), p, na,
            nb, self.Ka, self.Kb, self.RaT_v.shape[0], self.Gb_v.shape[0]),
            NA_t.device)
        return NB

    def forward(self, NA_t, term1):
        if NA_t.is_cuda:
            return _KernelFn.apply(self, NA_t, term1)
        return self.plain(NA_t, term1)
