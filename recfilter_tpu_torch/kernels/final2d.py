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

bf16 storage (the JAX package's ``dtype="bfloat16"`` mode: the image in
bf16 between passes, one product): :class:`Moments2D`, :class:`RowsTails`
take a bf16 x (their outputs stay float32, the sums those of the float32
path on the same values), :class:`Final2DSplit` and :class:`RowsFinal` at
nprod 1 take a bf16 x and return a bf16 y, and :class:`Final2DStencil` at
nprod 1 a bf16 x and bf16 banks — the kernels' ``*_bf16`` entries; the
twins compute in float32 on ``x.float()`` and round once.

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

from .completion import (_SLOTS, TILE, XTYPES, _aux_ptrs, _bf16_grade,
                         _entry, _epi_coef, _expand_stack, _f32, _f64,
                         _per_tile, _variants3, _variants_like, core_pack,
                         core_unpack, grade_chunks, tc_constant, tc_depth,
                         tc_exact, tile_einsum)
from . import split
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


def _variant(nv: int, i: int, n: int) -> int:
    """The matrix variant of tile i of n, as the kernels pick it
    (``csrc/moments2d.cu``'s ``variant``): [interior, first, last]."""
    if nv == 1:
        return 0
    return 1 if i == 0 else (2 if i == n - 1 else 0)


def _two_sum(a, b):
    """s = a + b rounded, and its error: a + b = s + e exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma64(a, b, c):
    """``fma(a, b, c)`` as the card's fp64 FMA rounds it, a·b + c rounded
    once, for float64 tensors whose b holds float32 values (where a holds
    them too, a·b is exact and ``c + a·b`` is the same). a splits in two
    (Veltkamp: 29 bits and at most 23), so a·b is the exact sum of two
    float64 products; TwoSum turns that into a head and its tail, the
    head meets c, and the two tails meet in a sum rounded to odd before
    the one last rounding (Boldo and Melquiond's emulated FMA, exact
    where nothing underflows)."""
    t = a * 16777217.0  # 2^24 + 1
    hi = t - (t - a)
    uh, ul = _two_sum(hi * b, (a - hi) * b)
    th, tl = _two_sum(c, uh)
    v, e = _two_sum(tl, ul)
    even = (v.view(torch.int64) & 1) == 0
    away = torch.nextafter(v, torch.where(e > 0, torch.inf, -torch.inf))
    return th + torch.where((e != 0) & even, away, v)


class Moments2D(nn.Module):
    """Pass 1: ``(bA_t, term1) = moments(x)`` for x (p, na, Ta, W),
    float32 or bf16 (``moments2d_bf16``, ``moments2d_naf_bf16``: the same
    sums on the same values; float32 outputs).

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

    def naf_ordered(self, x):
        """``moments2d_naf``'s outputs bit for bit (the module built with
        ``solve=``): its sums in float64 on the CPU in the kernel's order,
        by :func:`fma64` where a product is inexact — the tails down each
        column, s ascending, rounded to float32; U along each row, t
        ascending, kept in float64; term1 over U's columns, s ascending;
        the solve over the source rows (a, k < Ka) ascending, from the
        float32 tails."""
        if not self.solve:
            raise ValueError("naf_ordered is moments2d_naf's: build the "
                             "module with solve=")
        p, na, nb, S = x.shape[0], self.na, self.nb, _SLOTS
        xd = x.detach().cpu().float().double()
        va = [_variant(self.Ga_v.shape[0], a, na) for a in range(na)]
        vb = [_variant(self.Gb_v.shape[0], b, nb) for b in range(nb)]
        Ga = self.Ga_v.cpu().double()[va]    # (na, 8, T)
        Gb = self.Gb_v.cpu().double()[vb]    # (nb, 8, T)
        Bt = self.Ba1T_v.cpu().double()[va]  # (na, T_s, T_o)
        tails = torch.zeros(p, na, S, nb * TILE, dtype=torch.float64)
        for s in range(TILE):  # float32 products: exact
            tails = tails + Ga[None, :, :, s, None] * xd[:, :, s, None, :]
        tails[:, :, self.Ka:] = 0
        tails = tails.float().double()
        xr = xd.reshape(p, na, TILE, nb, TILE).permute(0, 1, 3, 2, 4)
        U = torch.zeros(p, na, nb, S, TILE, dtype=torch.float64)
        for t in range(TILE):  # float32 products: exact
            U = U + Gb[None, None, :, :, t, None] * xr[:, :, :, None, :, t]
        U[:, :, :, self.Kb:] = 0
        t1 = torch.zeros_like(U)
        for s in range(TILE):
            t1 = fma64(U[..., s, None], Bt[None, :, None, None, s, :], t1)
        t1[:, :, :, self.Kb:] = 0
        CM = self.CMaT.cpu().t().reshape(na, S, na, S)
        NA = torch.zeros(p, na, S, nb * TILE, dtype=torch.float64)
        for a in range(na):
            for k in range(self.Ka):
                NA = fma64(CM[None, :, :, a, k, None],
                           tails[:, a, k][:, None, None, :], NA)
        NA[:, :, self.Ka:] = 0
        return NA.float(), t1.float().reshape(p, na, nb * S, TILE)

    def _kernel(self, x):
        p, na, nb, h8 = x.shape[0], self.na, self.nb, self.h8
        _check(x, "x", (p, na, TILE, nb * TILE), x.device, XTYPES)
        for name in ("Ga_v", "Gb_v", "Ba1T_v", "E_v"):
            t = getattr(self, name)
            _check(t, name, t.shape, x.device)
        _grid_ok(p, na, nb * TILE)
        bA = torch.empty((p, na, _SLOTS, nb * TILE), device=x.device)
        term1 = torch.empty((p, na, nb * _SLOTS, TILE), device=x.device)
        if self.solve:
            _check(self.CMaT, "CMaT", self.CMaT.shape, x.device,
                   torch.float64)
            _launch(_entry("moments2d_naf", x), (
                x.data_ptr(), self.Ga_v.data_ptr(), self.Gb_v.data_ptr(),
                self.Ba1T_v.data_ptr(), self.CMaT.data_ptr(), bA.data_ptr(),
                term1.data_ptr(), p, na, nb, self.Ka, self.Kb,
                self.Ga_v.shape[0], self.Gb_v.shape[0]), x.device)
            return bA, term1
        ht, hb = (torch.empty((p, na, h8, nb * TILE), device=x.device)
                  for _ in range(2))
        _launch(_entry("moments2d", x), (
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


# final2d's px6 operands (csrc/final2d.cu): the 136-deep contraction
# padded to 144, nine k16 steps (the carries' last), three bf16 chunks,
# two warpgroups of 128 threads a block, each 64 rows s of a tile
_PX_KP = TILE + 16
_PX_KS = _PX_KP // 16
_PX_NC = 3
_WG = 128
# the first product's pairs (constant chunk, data chunk) in the kernel's
# order (csrc/final2d.cu's oa_d): grouped by the constant's chunk, each
# chunk's fragments loaded while the group before runs, smallest level
# first within a group; the second product's are split.prods(6)'s
PX_ORDER_A = [(2, 0), (1, 1), (1, 0), (0, 2), (0, 1), (0, 0)]


def _px_matrix(B, R) -> np.ndarray:
    """(n|1, T, T), (n|1, T, 8) stacks → per variant ``[B | R | 0]``,
    (1|3, T, 144) float64: rows s (or o), the contraction along the last
    axis."""
    Bv, Rv = _variants_like(B, R)
    M = np.zeros(Bv.shape[:2] + (_PX_KP,))
    M[..., :TILE] = Bv
    M[..., TILE:TILE + _SLOTS] = Rv
    return M


def _frag_index():
    """The A fragment map of ``final2d``'s first product: for (half h,
    step c, thread τ, element 2e + u) of a 16-byte fragment, the row and
    contraction position it holds — (2, 1, 128, 8) rows and (1, KS, 128,
    8) positions. Thread τ (warp w, lane l, qd = l % 4) holds in register
    e the pair (row 64h + 16w + l/4 + 8(e % 2), positions 16c + 8(e // 2)
    + 2qd + u), u = 0 its low half: ``wgmma``'s register A operand
    (``csrc/wgmma.cuh``)."""
    tau = np.arange(_WG)[:, None]
    e = np.arange(8)[None, :] // 2
    u = np.arange(8)[None, :] % 2
    lane = tau % 32
    rows = 16 * (tau // 32) + lane // 4 + 8 * (e % 2)
    pos = 8 * (e // 2) + 2 * (lane % 4) + u
    R = np.stack([rows, rows + 64])[:, None]                       # (2,1,τ,8)
    K = (16 * np.arange(_PX_KS)[:, None, None] + pos[None])[None]  # (1,KS,τ,8)
    return torch.from_numpy(R), torch.from_numpy(K)


def px_fragments(M) -> torch.Tensor:
    """``final2d``'s A1 operand: per variant the three bf16 chunks of M
    (nv, T, 144) (:func:`.split.split_const`), cut into each thread's
    register fragments (:func:`_frag_index`): (nv, 2, 3, KS, 128, 8)
    bf16, one 16-byte load a thread, chunk and step."""
    C = torch.stack(split.split_const(M, _PX_NC), dim=1)  # (nv, 3, T, KP)
    R, K = _frag_index()
    return C[:, :, R, K].permute(0, 2, 1, 3, 4, 5).contiguous()


def px_unfragment(F: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`px_fragments`: (nv, 2, 3, KS, 128, 8) →
    the chunks (nv, 3, T, 144)."""
    R, K = _frag_index()
    R, K = R.expand(2, _PX_KS, _WG, 8), K.expand(2, _PX_KS, _WG, 8)
    C = F.new_zeros(F.shape[0], _PX_NC, TILE, _PX_KP)
    C[:, :, R, K] = F.permute(0, 2, 1, 3, 4, 5)
    return C


def _split_z(A, x, NA_t, nprod: int) -> torch.Tensor:
    """The split dim-A completion in float32: A the per-tile chunk stack
    (na, nc, T, ≥ T + 8) float32 of ``[Ba | Ra]``; Z = Σ_(i,j) A_i·[x;
    NA]_j over the pairs of :func:`.split.prods` at ``nprod`` (the carry
    rows at :func:`.split.carry_nprod`), smallest level first. (p, na, T,
    W)."""
    return split.pair_sum(nprod, lambda i, d: torch.einsum(
        "ask,pakw->pasw", A[:, i, :, :TILE + _SLOTS], d), torch.cat(
            [x.float(), NA_t], dim=2), TILE, dim=2)


def _split_dual(A, B, x, NA_t, NB_t, nprod: int) -> torch.Tensor:
    """The split dual completion in float32: Z by :func:`_split_z`, then
    Y = Σ_(i,j) B_i·[Z | NB]_j, B the per-tile chunk stack (nb, nc, T, ≥
    T + 8) of ``[Bb | Rb]``, at the same grade. (p, na, T, W)."""
    p, na, Ta, W = x.shape
    nb, K = B.shape[0], TILE + _SLOTS
    z = _split_z(A, x, NA_t, nprod)
    nbr = NB_t.reshape(p, na, nb, _SLOTS, Ta).permute(0, 1, 4, 2, 3)
    ins = torch.cat([z.reshape(p, na, Ta, nb, TILE), nbr], dim=-1)
    y = split.pair_sum(nprod, lambda i, d: torch.einsum(
        "bok,pasbk->pasbo", B[:, i, :, :K], d), ins, TILE)
    return y.reshape(p, na, Ta, W)


class Final2D(nn.Module):
    """Passes 2+3: ``Y = final(x, NA_t, NB_t)``.

    Btot_a : (na|1, Ta, Ta);  Rhat_a_cat : (na|1, Ta, Ka)
    Btot_b : (nb|1, Tb, Tb);  Rhat_b_cat : (nb|1, Tb, Kb)
    affine : an optional :class:`..epilogue.Affine` (k ≤ 4 aux arrays):
    ``final(x, NA_t, NB_t, *aux)`` then returns ``a·Y + Σᵢ bᵢ·auxᵢ + c``,
    each aux (p, na, Ta, W) like x (the ``final2d_epi`` entry; the twin
    applies the form after ``plain``'s Y).

    The kernel computes the JAX package's px6 arithmetic (``final2d_px``
    at nprod 6): six split-bf16 products a contraction, the constants'
    chunks split from float64 on the host (``Af_k``: A1 = [Ba | Ra | 0]
    as register fragments, :func:`px_fragments`; ``Bc_k``: B2 = [Bb | Rb |
    0] by :func:`.completion.core_pack` without the k permutation), x, NA,
    Z and NB split on chip. ``plain`` is the float32 product (the CPU's
    twin, the backward's map); :meth:`split_plain` the six products in
    float32; :meth:`split_exact` their exact sum and the kernel's bound.
    ``A1_v``/``B2_v`` (the float32 [Bᵀ; Rᵀ] operands) feed
    ``final2d_stencil`` at px6.
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
        self.register_buffer("Af_k", px_fragments(_px_matrix(Btot_a, Ra8)))
        self.register_buffer("Bc_k", core_pack(torch.stack(split.split_const(
            _px_matrix(Btot_b, Rb8), _PX_NC), dim=1), perm=False))
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

    def chunks_a(self) -> torch.Tensor:
        """A1's bf16 chunks (nva, 3, T, 144), from ``Af_k``."""
        return px_unfragment(self.Af_k)

    def chunks_b(self) -> torch.Tensor:
        """B2's bf16 chunks (nvb, 3, T, 144), from ``Bc_k``."""
        return core_unpack(self.Bc_k, TILE, _PX_KP, perm=False)

    def split_plain(self, x, NA_t, NB_t, *aux):
        """The kernel's arithmetic in float32 (:func:`_split_dual` at six
        products), then the epilogue."""
        y = _split_dual(_per_variant(self.chunks_a(), self.na).float(),
                        _per_variant(self.chunks_b(), self.nb).float(), x,
                        NA_t, NB_t, 6)
        return y if self.affine is None else self.affine.apply(y, aux)

    def split_exact(self, x, NA_t, NB_t, drop=None):
        """The kernel's Y (before an epilogue) held to the exact sums of
        its products: ``(ref, bound)``, float64, (p, na, T, W).

        Z: :func:`.completion.tc_exact` of A1's chunks by [x; NA; 0] (the
        first product's wgmma steps in the kernel's order, ``PX_ORDER_A``),
        the exact sum
        ``z`` and its bound ``bz``. Y: ``tc_exact`` of B2's chunks by [Z32
        | NB | 0], Z32 = float32(z) (``drop``, a pair left out of this
        sum: a control). The kernel splits its own Z, within ``dz = bz +
        |z − Z32|`` of Z32; the six pairs sum Bb₀·Z + Bb₁·(Z − c₂) +
        Bb₂·(Z − c₁ − c₂) of Z's chunks c, |c₂| ≤ 2⁻¹⁵·|Z| and |c₁ + c₂|
        ≤ 2⁻⁸·|Z|, so the two splits part by at most Σᵢ|Bbᵢ|·dz +
        (2⁻¹⁵·|Bb₁| + 2⁻⁸·|Bb₂|)·2·(|Z32| + dz) summed over the
        contraction; the accumulation bound of Y, taken on Z32's chunks,
        is widened by 2⁻⁸ of itself and of Σᵢ|Bbᵢ|·dz for the kernel's
        chunks (each step's share of it some 2⁻¹⁴ of that: far less)."""
        p, na, Ta, W = x.shape
        nb, T = self.nb, TILE
        A = _per_variant(self.chunks_a(), na)
        B = _per_variant(self.chunks_b(), nb)
        pad = x.new_zeros(p, na, nb, T, _PX_KP - T - _SLOTS).float()
        xt = x.float().reshape(p, na, Ta, nb, T).permute(0, 1, 3, 4, 2)
        nat = NA_t.reshape(p, na, _SLOTS, nb, T).permute(0, 1, 3, 4, 2)
        z, bz = tc_exact(A.unbind(1), torch.cat([xt, nat, pad], dim=-1),
                         lambda m, v: torch.einsum("ask,pabwk->pabsw", m, v),
                         order=PX_ORDER_A)
        z32 = z.float()
        nbt = NB_t.reshape(p, na, nb, _SLOTS, Ta).permute(0, 1, 2, 4, 3)
        y, by = tc_exact(B.unbind(1), torch.cat([z32, nbt, pad], dim=-1),
                         lambda m, v: torch.einsum("bok,pabsk->pabso", m, v),
                         drop)
        dz = bz + (z - z32.double()).abs()
        Bd = B[..., :T].double()
        ein = lambda m, v: torch.einsum("bow,pabsw->pabso", m, v)
        bound = ((1 + 2.0 ** -8) * (by + ein(Bd.abs().sum(1), dz))
                 + ein(2.0 ** -15 * Bd[:, 1].abs() + 2.0 ** -8
                       * Bd[:, 2].abs(), 2 * (z32.double().abs() + dz)))
        out = lambda a: a.permute(0, 1, 3, 2, 4).reshape(p, na, Ta, W)
        return out(y), out(bound)

    def _kernel(self, x, NA_t, NB_t, *aux):
        p, na, nb = x.shape[0], self.na, self.nb
        W = nb * TILE
        _check(x, "x", (p, na, TILE, W), x.device)
        _check(NA_t, "NA_t", (p, na, _SLOTS, W), x.device)
        _check(NB_t, "NB_t", (p, na, nb * _SLOTS, TILE), x.device)
        for name in ("Af_k", "Bc_k"):
            t = getattr(self, name)
            _check(t, name, t.shape, x.device, torch.bfloat16)
        _grid_ok(p, na, W)
        y = torch.empty_like(x)
        ops = (x.data_ptr(), NA_t.data_ptr(), NB_t.data_ptr(),
               self.Af_k.data_ptr(), self.Bc_k.data_ptr())
        dims = (p, na, nb, self.Af_k.shape[0], self.Bc_k.shape[0])
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


# final2d_split's operands: the 136-deep contraction (128 rows + 8 carry
# slots) padded to 144, rows _SPLIT_LD apart (csrc/final2d_split.cu)
_SPLIT_KP = TILE + 16
_SPLIT_LD = _SPLIT_KP + 8


def _split_operand(B, R, nc: int) -> torch.Tensor:
    """(n|1, T, T), (n|1, T, 8) stacks → the split operand [B | R | 0] of
    ``final2d_split``, (1|3, nc, T, _SPLIT_LD) bf16: per variant, nc chunks
    of rows o with the contraction contiguous."""
    Bv, Rv = _variants_like(B, R)
    M = np.zeros((Bv.shape[0], TILE, _SPLIT_LD))
    M[:, :, :TILE] = Bv
    M[:, :, TILE:TILE + _SLOTS] = Rv
    return torch.stack(split.split_const(M, nc), dim=1).contiguous()


def _per_variant(M: torch.Tensor, n: int) -> torch.Tensor:
    """A (1|3, ...) variant stack expanded to its n tiles (the kernels'
    variant rule: first, interior…, last)."""
    if M.shape[0] == 1:
        return M.expand(n, *M.shape[1:])
    idx = torch.zeros(n, dtype=torch.long)
    idx[0], idx[n - 1] = 1, 2
    return M[idx]


class Final2DSplit(nn.Module):
    """Passes 2+3 at a reduced precision grade: :class:`Final2D`'s
    ``Y = final(x, NA_t, NB_t)`` as ``nprod`` split-bf16 products, the
    carry rows of both contractions at :func:`.split.carry_nprod`
    (``final2d_split``; the JAX package's ``final2d_px`` at nprod 1, 3, 4,
    which at 1 takes one product on the carries too).

    The constants are split on the host, once, for every variant
    (:func:`_split_operand`); x, the carries and the dim-A completion Z
    are split on chip. The twin ``plain`` runs the same chunk products in
    float32 (:func:`.split.pair_sum`). The kernel's backward is the
    VJP of the float32 product with the constant's grade (the sum of its
    chunks), the map the forward rounds. ``affine`` (an
    :class:`..epilogue.Affine`, k ≤ 4 aux arrays): ``final(x, NA_t, NB_t,
    *aux)`` returns ``a·Y + Σᵢ bᵢ·auxᵢ + c`` instead, each aux (p, na, Ta,
    W) like x (the ``final2d_split_epi`` entry; the twins apply the form
    after Y), as :class:`Final2D` at px6.

    bf16 storage: at nprod 1, x may be bf16 (``final2d_split_bf16``,
    ``final2d_split_epi_bf16``): y is bf16, the float32 Y (after the
    epilogue, its aux arrays float32) rounded once to nearest even; the
    twin computes on ``x.float()`` and rounds once too. The JAX kernel
    rounds Y to bf16 before its epilogue; the port rounds after it.
    """

    def __init__(self, Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat, na: int,
                 nb: int, nprod: int, affine=None):
        super().__init__()
        if nprod not in (1, 3, 4):
            raise ValueError(f"final2d_split runs nprod 1, 3 or 4, not "
                             f"{nprod}")
        self.na, self.nb, self.nprod = int(na), int(nb), int(nprod)
        self.nc = split.nchunks(split.carry_nprod(nprod))
        Ra8, Rb8 = _pad_slots(Rhat_a_cat), _pad_slots(Rhat_b_cat)
        if not (np.shape(Btot_a)[1] == np.shape(Btot_b)[1] == TILE):
            raise ValueError(f"tiles must be {TILE} wide")
        if Ra8.shape[2] != _SLOTS or Rb8.shape[2] != _SLOTS:
            raise ValueError(f"carries exceed the {_SLOTS}-row slot")
        self.register_buffer("Ac", _split_operand(Btot_a, Ra8, self.nc))
        self.register_buffer("Bc", _split_operand(Btot_b, Rb8, self.nc))
        self.affine, self.k = affine, _epi_coef(self, affine)

    def _epi(self, y, aux):
        return y if self.affine is None else self.affine.apply(y, aux)

    def _tiles(self):
        """Per-tile chunk stacks (na|nb, nc, T, T + 8) in float32."""
        K = TILE + _SLOTS
        return (_per_variant(self.Ac, self.na)[..., :K].float(),
                _per_variant(self.Bc, self.nb)[..., :K].float())

    def dim_a(self, x, NA_t):
        """The twin's dim-A completion Z (p, na, T, W), float32:
        ``Z[p,a,s,w] = Σ_(i,j) Σ_k A_i[a][s][k]·[x; NA]_j[p,a,k,w]``."""
        return _split_z(self._tiles()[0], x, NA_t, self.nprod)

    def plain(self, x, NA_t, NB_t, *aux):
        _bf16_grade(x, self.nprod)
        y = _split_dual(*self._tiles(), x, NA_t, NB_t, self.nprod)
        return self._epi(y, aux).to(x.dtype)

    def resplit_bound(self, x, NA_t) -> torch.Tensor:
        """Per output (the shape of Y), how far one product's kernel and
        twin may lie apart beyond their float32 sums of Y. Each rounds its
        own float32 Z to bf16 for the dim-B product, so a Z value can round
        two ways only where the rounding boundary lies between the twin's
        Z and the kernel's. The kernel's Z lies within e = 2^-18·Σ|a·b| of
        the exact sum of the same chunk products (float64 here): at most 11
        ``mma.sync`` steps a value (8 on the image rows, 3 on the carry
        rows), each adding with at most two roundings or truncations of
        2^-23·Σ|a·b|, is 2^-18.5. Where bf16 maps the span of the twin's Z
        and [Z − e, Z + e] to one value the two agree; elsewhere they part
        by at most the gap d of that span (one bf16 step). The bound is
        |Bb₀|·d, zero where every Z value of the row rounds one way. At 3
        and 4 products the second chunk carries the step, and the bound is
        0."""
        x = x.float()
        if self.nprod != 1:
            return torch.zeros_like(x)
        A, B = self._tiles()
        data = torch.cat([x, NA_t], dim=2)
        zt = self.dim_a(x, NA_t).double()
        zx = split.pair_sum(1, lambda i, c: torch.einsum(
            "ask,pakw->pasw", A[:, i].double(), c.double()), data, TILE,
            dim=2)
        e = 2.0 ** -18 * torch.einsum("ask,pakw->pasw",
                                      A.double().abs().sum(1),
                                      data.double().abs())
        inf = zt.new_tensor(np.inf).float()
        lo = torch.nextafter(torch.minimum(zt, zx - e).float(), -inf)
        hi = torch.nextafter(torch.maximum(zt, zx + e).float(), inf)
        d = hi.to(torch.bfloat16).double() - lo.to(torch.bfloat16).double()
        p, na, Ta, W = zt.shape
        t = torch.einsum("bot,pasbt->pasbo", B[:, 0, :, :TILE].double().abs(),
                         d.reshape(p, na, Ta, self.nb, TILE))
        return t.reshape(p, na, Ta, W).float()

    def _twin(self, x, NA_t, NB_t, *aux):
        """The float32 product with the constants' grade, then the
        epilogue (linear: the backward's map)."""
        p, na, Ta, W = x.shape
        nb, T = self.nb, TILE
        A, B = (m.sum(1) for m in self._tiles())
        z = torch.einsum("ask,pakw->pasw", A, torch.cat([x, NA_t], dim=2))
        nbr = NB_t.reshape(p, na, nb, _SLOTS, Ta).permute(0, 1, 4, 2, 3)
        ins = torch.cat([z.reshape(p, na, Ta, nb, T), nbr], dim=-1)
        y = torch.einsum("bok,pasbk->pasbo", B, ins)
        return self._epi(y.reshape(p, na, Ta, W), aux)

    def _kernel(self, x, NA_t, NB_t, *aux):
        p, na, nb = x.shape[0], self.na, self.nb
        W = nb * TILE
        _check(x, "x", (p, na, TILE, W), x.device, XTYPES)
        _bf16_grade(x, self.nprod)
        _check(NA_t, "NA_t", (p, na, _SLOTS, W), x.device)
        _check(NB_t, "NB_t", (p, na, nb * _SLOTS, TILE), x.device)
        for name in ("Ac", "Bc"):
            t = getattr(self, name)
            _check(t, name, t.shape, x.device, torch.bfloat16)
        _grid_ok(p, na, W)
        y = torch.empty_like(x)
        ops = (x.data_ptr(), NA_t.data_ptr(), NB_t.data_ptr(),
               self.Ac.data_ptr(), self.Bc.data_ptr())
        dims = (p, na, nb, self.Ac.shape[0], self.Bc.shape[0], self.nprod)
        if self.affine is None:
            _launch(_entry("final2d_split", x), (*ops, y.data_ptr(), *dims),
                    x.device)
            return y
        _check(self.epi_coef, "epi_coef", self.epi_coef.shape, x.device)
        _launch(_entry("final2d_split_epi", x), (
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

    over the dual completion Y of :class:`Final2D` (the same operands), or,
    at ``nprod`` 1, 3 or 4, of :class:`Final2DSplit`, with the JAX
    package's border rule: positive offsets clamp at the far edges (rows,
    then columns), negative offsets read zero. The halo strips (p, na, h8,
    W) hold the completed bottom h8 rows of each tile's upper neighbour
    (``halo_top``) and top h8 rows of its lower neighbour (``halo_bot``);
    the kernel completes the neighbour columns itself, at the grade as the
    neighbour tile emits them (``csrc/final2d_stencil.cu``). The twin
    ``plain`` is the JAX package's ``_ref``: Y recomputed whole (at the
    grade, :meth:`Final2DSplit.plain`), then
    :func:`.stencil2d.stencil2d_ref` — it reads no halo strip, so the
    strips get zero gradients; the backward differentiates the float32
    product with the grade's constants (``_twin``).

    bf16 storage: at nprod 1, x may be bf16 (``final2d_stencil_bf16``):
    the banks are bf16, each value the float32 sum of its taps on the
    float32 Y, rounded once; the twin computes on ``x.float()`` and rounds
    once (the JAX kernel's arithmetic, ``_final2d_px_stencil`` on a bf16
    x, whose banks ``apply_filter_fused`` rounds once).

    taps_c : per channel ``[(dy, dx, coeff), ...]`` with |dy| ≤ h8 ≤ 128
    and |dx| ≤ 128.
    """

    def __init__(self, Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat, na: int,
                 nb: int, taps_c, h8: int, nprod: int = 6):
        super().__init__()
        from .stencil2d import Stencil2D

        self.nprod = int(nprod)
        self.final = (Final2D(Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat, na, nb)
                      if nprod == 6 else
                      Final2DSplit(Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat,
                                   na, nb, nprod))
        self.bank = Stencil2D(taps_c)
        self.na, self.nb, self.h8, self.C = int(na), int(nb), int(h8), \
            self.bank.C
        up, down, left, right = self.bank.reach
        if max(up, down) > self.h8 or self.h8 > TILE or max(left, right) \
                > TILE:
            raise ValueError(f"stencil reach {self.bank.reach} outside h8 = "
                             f"{self.h8} rows and {TILE} columns")
        self.dxl, self.dxr = left, right

    def _bank(self, y):
        p, na, Ta, W = y.shape
        return torch.stack(self.bank.plain(y.reshape(p, na * Ta, W))
                           ).reshape(self.C, p, na, Ta, W)

    def plain(self, x, NA_t, NB_t, *halos):
        _bf16_grade(x, self.nprod)
        return self._bank(self.final.plain(x.float(), NA_t, NB_t)).to(
            x.dtype)

    def _twin(self, x, NA_t, NB_t, *halos):
        return self._bank(getattr(self.final, "_twin", self.final.plain)(
            x, NA_t, NB_t))

    def resplit_bound(self, x, NA_t) -> torch.Tensor:
        """Per output channel, how far the kernel and the twin may lie
        apart beyond their float32 sums: each tap's |coeff| times
        :meth:`Final2DSplit.resplit_bound` of the Y it reads (zero but at
        one product)."""
        if self.nprod == 6:
            return x.new_zeros((self.C,) + tuple(x.shape))
        bound = self.final.resplit_bound(x.float(), NA_t)
        p, na, Ta, W = bound.shape
        from .stencil2d import Stencil2D

        absbank = Stencil2D([[(dy, dx, abs(c)) for dy, dx, c in taps]
                             for taps in self.bank.taps_c])
        return torch.stack(absbank.plain(bound.reshape(p, na * Ta, W))
                           ).reshape(self.C, p, na, Ta, W)

    def _kernel(self, x, NA_t, NB_t, halo_top, halo_bot):
        p, na, nb, h8 = x.shape[0], self.na, self.nb, self.h8
        W = nb * TILE
        _check(x, "x", (p, na, TILE, W), x.device, XTYPES)
        _bf16_grade(x, self.nprod)
        _check(NA_t, "NA_t", (p, na, _SLOTS, W), x.device)
        _check(NB_t, "NB_t", (p, na, nb * _SLOTS, TILE), x.device)
        _check(halo_top, "halo_top", (p, na, h8, W), x.device)
        _check(halo_bot, "halo_bot", (p, na, h8, W), x.device)
        fin, bank = self.final, self.bank
        if self.nprod == 6:
            A, B, side = fin.A1_v, fin.B2_v, None
            _check(A, "A1_v", A.shape, x.device)
            _check(B, "B2_v", B.shape, x.device)
        else:
            A, B = fin.Ac, fin.Bc
            _check(A, "Ac", A.shape, x.device, torch.bfloat16)
            _check(B, "Bc", B.shape, x.device, torch.bfloat16)
            # the neighbour columns' scratch, written and read by each block
            side = torch.empty((p, na, nb, TILE, self.dxl + self.dxr),
                               device=x.device)
        _check(bank.taps_k, "taps_k", bank.taps_k.shape, x.device)
        _check(bank.toff, "toff", bank.toff.shape, x.device, torch.int32)
        _grid_ok(p, na, W)
        out = torch.empty((self.C, p, na, TILE, W), device=x.device,
                          dtype=x.dtype)
        _launch(_entry("final2d_stencil", x), (
            x.data_ptr(), NA_t.data_ptr(), NB_t.data_ptr(), A.data_ptr(),
            B.data_ptr(), halo_top.data_ptr(), halo_bot.data_ptr(),
            bank.taps_k.data_ptr(), bank.toff.data_ptr(), out.data_ptr(),
            0 if side is None else side.data_ptr(), p, na, nb, A.shape[0],
            B.shape[0], h8, self.dxl, self.dxr, self.C,
            bank.taps_k.shape[0], self.nprod), x.device)
        return out

    def forward(self, x, NA_t, NB_t, halo_top, halo_bot):
        if x.is_cuda:
            return _KernelFn.apply(self, x, NA_t, NB_t, halo_top, halo_bot)
        return self.plain(x, NA_t, NB_t, halo_top, halo_bot)


KMAX_K = 32  # the HIGHEST pair's largest carry count per axis
LDK_BF16 = TILE + 8  # final2d_k_bf16's bf16 operand rows (csrc/final2d.cu)


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

    def ordered(self, x):
        """``moments2d_k``'s outputs bit for bit: its sums in float64 on
        the CPU in the kernel's order (bA down each column, s ascending; U
        along each row, t ascending; float32 products, so every product
        is exact and each step one rounding of the sum)."""
        p, na, nb, Ta = x.shape[0], self.na, self.nb, self.Ta
        xd = x.detach().cpu().double()
        Ga = self.Ga_v.cpu().double()[
            [_variant(self.Ga_v.shape[0], a, na) for a in range(na)]]
        Gb = self.Gb_v.cpu().double()[
            [_variant(self.Gb_v.shape[0], b, nb) for b in range(nb)]]
        bA = torch.zeros(p, na, self.Ka, nb * TILE, dtype=torch.float64)
        for s in range(Ta):
            bA = bA + Ga[None, :, :, s, None] * xd[:, :, s, None, :]
        xr = xd.reshape(p, na, Ta, nb, TILE).permute(0, 1, 3, 2, 4)
        U = torch.zeros(p, na, nb, Ta, self.Kb, dtype=torch.float64)
        for t in range(TILE):
            U = U + xr[..., t, None] * Gb[None, None, :, None, :, t]
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
    pads each carry count to a multiple of 8 with zero rows.

    ``matmul_dtype="bfloat16"`` (``final2d_k_bf16``): the JAX package's
    ``final2d(matmul_dtype=bfloat16)`` — x and Btot_a rounded to bf16,
    Z = Btot_a·x with fp32 accumulation plus Rhat_a·NA in fp32, Z rounded
    to bf16, Y = Z·Btot_bᵀ (Btot_b rounded) with fp32 accumulation plus
    NB·Rhat_bᵀ in fp32; x and Y float32. The twin makes the same
    roundings with float32 einsums (the kernel's products on bf16 tensor
    cores, the carry rows in fp32 FMAs); the backward is the float32
    product's VJP."""

    def __init__(self, Btot_a, Rhat_a_cat, Btot_b, Rhat_b_cat, na: int,
                 nb: int, matmul_dtype: str = "float32"):
        super().__init__()
        if matmul_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"matmul_dtype {matmul_dtype!r}: float32 or "
                             "bfloat16")
        self.bf16 = matmul_dtype == "bfloat16"
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
        if self.bf16:
            # the tensor cores' operands: bf16(Ba) rows s, bf16(Bb) rows o,
            # the contraction contiguous, rows LDK apart (zero past Ta)
            Ab = np.zeros((A1.shape[0], TILE, LDK_BF16))
            Ab[:, :, :self.Ta] = A1[:, :self.Ta].transpose(0, 2, 1)
            B2 = _pad_rows(_cat_t(Bb, Rb), TILE + Kbp)
            Bk = np.zeros((B2.shape[0], TILE, LDK_BF16))
            Bk[:, :, :TILE] = B2[:, :TILE].transpose(0, 2, 1)
            for name, M in (("Ab_v", Ab), ("Bb_v", Bk)):
                self.register_buffer(name, _f32(M).to(torch.bfloat16))

    def _twin(self, x, NA, NB, bf16: bool = False):
        """The pair's products: float32, or (``bf16``) with x, Btot_a, Z
        and Btot_b rounded to bf16 (float32 einsums of bf16 values)."""
        p, na, Ta, W = x.shape
        Ba, Bb = self.Ban, self.Bbn
        if bf16:
            x, Ba, Bb = (t.to(torch.bfloat16).float() for t in (x, Ba, Bb))
        z = (torch.einsum("aos,pasw->paow", Ba, x)
             + torch.einsum("aok,pakw->paow", self.Ran, NA))
        if bf16:
            z = z.to(torch.bfloat16).float()
        y = (torch.einsum("bot,pasbt->pasbo", Bb,
                          z.reshape(p, na, Ta, self.nb, TILE))
             + torch.einsum("bok,pabsk->pasbo", self.Rbn, NB))
        return y.reshape(p, na, Ta, W)

    def plain(self, x, NA, NB):
        return self._twin(x, NA, NB, self.bf16)

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
        dims = (p, na, nb, Ta, self.Ka, self.Kb, self.A1_v.shape[0],
                self.B2_v.shape[0])
        if self.bf16:
            for name in ("Ab_v", "Bb_v"):
                t = getattr(self, name)
                _check(t, name, t.shape, x.device, torch.bfloat16)
            _launch("final2d_k_bf16", (
                x.data_ptr(), NA.data_ptr(), NB.data_ptr(),
                self.A1_v.data_ptr(), self.B2_v.data_ptr(),
                self.Ab_v.data_ptr(), self.Bb_v.data_ptr(), y.data_ptr(),
                *dims), x.device)
            return y
        _launch("final2d_k", (
            x.data_ptr(), NA.data_ptr(), NB.data_ptr(), self.A1_v.data_ptr(),
            self.B2_v.data_ptr(), y.data_ptr(), *dims), x.device)
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
    The sums run in float64 from float32 loads, with G in float64, in the
    kernel and in the twin (see ``csrc/rows_tails.cu``); the kernel sums
    each warp's :data:`ROW_GROUP` rows, then the groups in order
    (:meth:`grouped`). x may be bf16 (``rows_tails_bf16``: the same sums
    of the same values; b float32)."""

    ROW_GROUP = 16  # rows a warp of the kernel sums (csrc/rows_tails.cu: RW)

    def __init__(self, G_cat, n: int):
        super().__init__()
        G = np.asarray(G_cat, np.float64)
        if G.shape[2] != TILE:
            raise ValueError(f"tiles must be {TILE} wide")
        if G.shape[1] > _SLOTS:
            raise ValueError(f"K={G.shape[1]} exceeds the {_SLOTS}-row slot")
        self.n, self.K = int(n), G.shape[1]
        # kernel and twin operand
        self.register_buffer("G_v64", _f64(_variants3(_pad_slots(G, 1))))

    def plain64(self, x):
        """The twin in float64 (float64 out)."""
        return tile_einsum("nks,pnsw->pnkw", self.G_v64, x.double())

    def plain(self, x):
        return self.plain64(x).float()

    def grouped(self, x):
        """The kernel's summation order in float64 (float64 out): each
        group of :data:`ROW_GROUP` rows summed alone, the groups' sums then
        added in ascending order."""
        g, out = self.ROW_GROUP, None
        for s0 in range(0, TILE, g):
            part = tile_einsum("nks,pnsw->pnkw", self.G_v64[..., s0:s0 + g],
                               x[:, :, s0:s0 + g].double())
            out = part if out is None else out + part
        return out

    def _kernel(self, x):
        p, n, W = x.shape[0], self.n, _rows_x(x, self.n)
        _check(x, "x", (p, n, TILE, W), x.device, XTYPES)
        _check(self.G_v64, "G_v64", self.G_v64.shape, x.device,
               torch.float64)
        _grid_ok(p, n, W)
        b = torch.empty((p, n, _SLOTS, W), device=x.device)
        _launch(_entry("rows_tails", x), (
            x.data_ptr(), self.G_v64.data_ptr(), b.data_ptr(),
            p, n, W // TILE, self.K, self.G_v64.shape[0]), x.device)
        return b

    def forward(self, x):
        if x.is_cuda:
            return _KernelFn.apply(self, x)
        return self.plain(x)


_ROWS_KP = tc_depth(_SLOTS)  # rows_final's contraction: 128 + 8 + 8 zeros


def _stage_off(s: int, w: int) -> int:
    """Where ``csrc/rows_final.cu`` stages row s (x's 128, then N's 8),
    lane w < 64 of an item: rows of 64 floats, each row's 8-lane groups
    XOR-swizzled by (s // 4) % 4 (its ``stage_off``). The bf16 form stages
    x's rows at the same offsets in 2-byte elements, N's in an fp32 stage
    of their own (s < 8)."""
    return s * 64 + (w ^ (8 * ((s >> 2) & 3)))


class RowsFinal(nn.Module):
    """Rows pass 2: ``y = final(x, N)`` for x (p, n, T, W) and slot-padded
    carries N (p, n, 8, W): ``y[p,a] = Btot_v(a)·x[p,a] + Rhat_v(a)·N[p,a]``.

    Btot : (n|1, T, T);  Rhat_cat : (n|1, T, K).
    nprod : the grade — 6 (px6), 4 (px4), 3 (px3) or 1 (``default``).

    The kernel (``csrc/rows_final.cu``) computes the JAX package's
    arithmetic at that grade on the tensor cores: ``nprod`` split-bf16
    products (:func:`.split.prods`) on x and :func:`.split.carry_nprod` on
    N — at least three, where the JAX package takes one at ``default``
    (``kernels/split.py``) — the constant ``[Btot | Rhat | 0]`` split from
    float64 on the host (``Bc_k`` (nv, nc, T·KP), KP = 144: three chunks at
    px6, two at the reduced grades, :func:`.completion.grade_chunks`; in
    the byte order of the tensor-core completion,
    :func:`.completion.core_pack`; :meth:`chunks` unpacks them), x and N
    on chip. :meth:`split_exact` is the exact sum of its chunk products
    and the kernel's bound about it. ``plain``, the twin the CPU runs, is
    the float32 product at px6 and the grade's chunk products in float32
    at the reduced grades (:func:`.split.pair_sum`); the backward
    differentiates the float32 product with the constant's grade
    (``_twin``). bf16 storage: at nprod 1, x may be bf16
    (``rows_final_bf16``): y is bf16, the float32 sums rounded once to
    nearest even; the twin computes on ``x.float()`` and rounds once."""

    def __init__(self, Btot, Rhat_cat, n: int, nprod: int = 6):
        super().__init__()
        if nprod not in (1, 3, 4, 6):
            raise ValueError(f"rows_final runs nprod 1, 3, 4 or 6, not "
                             f"{nprod}")
        R8 = _pad_slots(Rhat_cat)
        if np.shape(Btot)[1:] != (TILE, TILE) or R8.shape[1:] != (TILE,
                                                                   _SLOTS):
            raise ValueError(f"tiles must be {TILE} wide with at most "
                             f"{_SLOTS} carries")
        self.n, self.nprod = int(n), nprod
        self.register_buffer("Bc_k", tc_constant(               # kernel
            *_variants_like(Btot, R8), grade_chunks(nprod)))
        self.register_buffer("B_v", _f32(_variants3(Btot)))   # twin
        self.register_buffer("R_v", _f32(_variants3(R8)))

    def plain(self, x, N):
        _bf16_grade(x, self.nprod)
        if self.nprod == 6:
            return self._twin(x, N)
        Mc = self.chunks()[..., :TILE + _SLOTS].float()
        return split.pair_sum(self.nprod, lambda i, d: tile_einsum(
            "nok,pnkw->pnow", Mc[:, i], d), torch.cat([x.float(), N], dim=2),
            TILE, dim=2).to(x.dtype)

    def _twin(self, x, N):
        """The float32 product with the constant's grade (at the reduced
        grades the sum of its chunks): linear, the backward's map."""
        B, R = self.B_v, self.R_v
        if self.nprod != 6:
            M = self.chunks().float().sum(1)
            B, R = M[..., :TILE], M[..., TILE:TILE + _SLOTS]
        return (tile_einsum("nos,pnsw->pnow", B, x)
                + tile_einsum("nok,pnkw->pnow", R, N))

    def chunks(self) -> torch.Tensor:
        """The constant's bf16 chunks, (nv, nc, T, KP), unpacked from
        ``Bc_k`` (:func:`.completion.core_unpack`)."""
        return core_unpack(self.Bc_k, TILE, _ROWS_KP)

    def split_exact(self, x, N, drop=None):
        """:func:`.completion.tc_exact` of the kernel at its grade: the
        exact sum of its chunk products and its bound, per output (p, n,
        T, W)."""
        data = torch.cat([x.float(), N, torch.zeros_like(N)], dim=2)
        return tc_exact(self.chunks().unbind(1), data.transpose(2, 3),
                        lambda m, v: tile_einsum("nok,pnwk->pnow", m, v),
                        drop, self.nprod)

    def _kernel(self, x, N):
        p, n, W = x.shape[0], self.n, _rows_x(x, self.n)
        _check(x, "x", (p, n, TILE, W), x.device, XTYPES)
        _bf16_grade(x, self.nprod)
        _check(N, "N", (p, n, _SLOTS, W), x.device)
        _check(self.Bc_k, "Bc_k", self.Bc_k.shape, x.device, torch.bfloat16)
        _grid_ok(p, n, W)
        y = torch.empty_like(x)
        _launch(_entry("rows_final", x), (
            x.data_ptr(), N.data_ptr(), self.Bc_k.data_ptr(), y.data_ptr(),
            p, n, W // TILE, self.Bc_k.shape[0], self.nprod), x.device)
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
