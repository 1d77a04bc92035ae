"""The two kernels of the 1-D last-axis executor, their plain twins, and
the host helpers of the slot-padded carry layout.

  * :class:`TailsPass` (``csrc/tails.cu``): read x (q, n, T) once and emit
    every tile's local tails ``G·x`` in the transposed slot-padded layout
    (n, sl, q) that the carry solve and :class:`CompletionPass` consume.
  * :class:`CompletionPass` (``csrc/completion.cu``): read x once and write
    ``Y = Btot·x + Rcat·N`` per tile, the carries N in that same layout —
    in place, or with ``rot=True`` rotated (each tile transposed, an
    (n·T, q) output: the scanned axis leads) with an optional shifted-tap
    stencil consumer along the scanned axis fused into the emit
    (``completion_rot``).

With ``next_tails`` the rotated completion also extracts the NEXT pass's
local tails from the tiles it emits (``completion_rot_tails``): in a
rotation chain the next pass scans this pass's line axis, so its tails are
per-tile sums over the emitted tile's columns, and the next pass starts at
its carry solve without reading the signal (:func:`next_tails_ok` is the
port's gate).

With a stencil consumer, :class:`TailsPass` also emits the halo base rows
(``extra_rows``: the first and last rows of each tile's Btot times x), the
caller completes the neighbour tiles' halo strips from them and the
carries (``dimfuse._stencil_halo``), and the rotated completion combines
the strips with each completed tile before the write — the consumer costs
no extra read or write of the signal. The twins: :func:`_stencil_flat`,
the global-shift form the kernel is held against (it reads the whole
output, not the strips), and :func:`_stencil_rows`, the per-tile form on
the strips (what the kernel computes).

Carries ride 8-row slots: ΣK = S carry values per tile take sl = 8·⌈S/8⌉
rows, zero-padded (S ≤ 56). The JAX package chose 8 for the TPU's sublane
quantum; the port keeps the layout so both packages exchange the same
arrays, and the CUDA kernels take it as is.

bf16 storage (the JAX package's ``dtype="bfloat16"`` mode: the image in
bf16 between passes, one product): :class:`TailsPass` takes a bf16 x
(``tails_bf16``, ``tails_extra_bf16`` with extra rows; its tails stay
float32, the sums those of the float32 path on the same values),
:class:`CompletionPass` at nprod 1 a bf16 x and returns a bf16 y
(``completion_split_bf16``, ``completion_rot_bf16``, their ``_epi``
forms, ``completion_rot_tails_bf16``, and with a stencil
``completion_rot_stencil_bf16`` and ``completion_rot_stencil_epi_bf16``:
the float32 accumulators, after the stencil's taps and the epilogue, whose
halo strips and aux arrays stay float32, rounded once; the next pass's
tails from the rounded outputs). The twins compute in float32 on
``x.float()`` and round once.

With ``affine`` (an :class:`..epilogue.Affine`, the structure of an
elementwise epilogue) the completion also applies ``a·y + Σᵢ bᵢ·auxᵢ + c``
to every output before the write (``completion_epi``; rotated, after the
stencil: ``completion_rot_epi``), the aux arrays in the output's layout —
the JAX package's ``completion_pass(epilogue=, eaux=)``.

The learnable executor's forms take their matrices as runtime tensors
built from trainable coefficients: :func:`tails_traced` (``tails.cu``'s
``tails_traced`` entry) and :func:`completion_traced` (``completion.cu``'s
``completion_traced``), one matrix for every tile, the carries in one
slot. Both are bilinear, so their autograd Functions save the inputs and
return the matrices' gradients too (the JAX package's custom VJPs).

Each module holds its host-built matrices as buffers. ``forward`` launches
the CUDA kernel for a CUDA tensor (through :class:`.launch._KernelFn`,
whose backward is the twin's VJP: both passes are linear) and runs the
plain PyTorch twin for a CPU tensor; ``plain`` is the twin, the reference
the kernel is held against. Per-tile matrix variants (clamp edges, the pad
projector) differ only at the globally-first/last tiles, so the kernels
take ≤ 3 distinct variants [interior, first, last] and pick one by tile
position.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import split
from .launch import MAX_AUX, LaunchError, _check, _KernelFn, _launch
from .stencil2d import shift_mode

TILE = 128  # the kernels' tile edge
_SLOTS = 8  # carry rows per tile slot
_MAX_S = 56  # ΣK the multi-slot carry layout takes (7 slots)


# the element types of x the kernels read: float32, or bf16 (bf16 storage)
XTYPES = (torch.float32, torch.bfloat16)


def _entry(name: str, x: torch.Tensor) -> str:
    """The launch entry of kernel ``name`` for x's element type."""
    return name + "_bf16" if x.dtype == torch.bfloat16 else name


def _bf16_grade(x: torch.Tensor, nprod: int) -> None:
    """Raise unless x is float32, or bf16 at one product (the JAX
    package's ``_kernel_nprod`` gives bf16 storage one)."""
    if x.dtype == torch.bfloat16 and nprod != 1:
        raise ValueError(f"a bf16 x runs one product, not {nprod} (bf16 "
                         "storage)")


def slots_for(S: int) -> int:
    """Slot-padded carry rows for ΣK = S (a multiple of the slot size)."""
    return -(-int(S) // _SLOTS) * _SLOTS


def completion_ok(T: int, q: int, n: int, S: int) -> bool:
    """The JAX package's static gate for the tails/completion kernels
    (``recfilter_tpu/kernels/completion.py::completion_ok``): 128-wide
    tiles, carries within the multi-slot layout, at most 512 tiles and at
    least 8 lines."""
    return T == TILE and S <= _MAX_S and n <= 512 and q >= 8


def next_tails_ok(q: int, sl: int, n2: int, S2: int, T2: int) -> bool:
    """The port's gate for ``completion_rot_tails`` on q lines of a pass
    with sl carry rows, the next pass having n2 tiles of T2 and ΣK = S2:
    single-slot carries on both sides, 128-wide next tiles, and whole
    next-pass extents in the lines (q a multiple of n2·128: one 128-line
    block is one tile of the next pass).

    The JAX package's gate (``completion.py::_tails_gate`` with the block
    geometry of ``_block_geom``) asks the same of the carries and the next
    tiles, and in place of the last condition that its TPU line block Lb
    be a multiple of the next pass's extent (volumes) or equal q with
    q == n2·T2 (images), with no padded block. Where the port's gate holds
    and the JAX gate does not (q = 5·128 against a 4096-line block, say),
    the JAX package reads the next pass's tails with ``tails_pass``
    instead; the values agree to summation order (both fp32 products of
    the same f32 grade)."""
    return (sl == _SLOTS and S2 <= _SLOTS and T2 == TILE
            and q > 0 and q % (n2 * T2) == 0)


def _per_tile(M, n: int) -> np.ndarray:
    """(nv, ...) matrix stack -> per-tile (n, ...) float64 (a uniform
    stack broadcasts its one matrix to every tile)."""
    M = np.asarray(M, np.float64)
    return M[np.minimum(np.arange(n), M.shape[0] - 1)]


def _expand_stack(M, n: int) -> np.ndarray:
    """:func:`_per_tile` in float32."""
    return np.asarray(_per_tile(M, n), np.float32)


def _variants3(stack) -> np.ndarray:
    """(n|1, r, c) per-tile stack → (1|3, r, c) distinct variants
    [interior, first, last]. ``prepare_dim_pass``'s stacks are uniform
    except at tiles 0 and n-1; stack[1] is interior whenever n > 2."""
    M = np.asarray(stack, np.float64)
    n = M.shape[0]
    if n == 1:
        return M
    interior = M[1] if n > 2 else M[0]
    return np.stack([interior, M[0], M[n - 1]])


def _variants_like(A, B):
    """Variant stacks of two operands one kernel selects with one index:
    a uniform stack is repeated to the other's three variants."""
    A, B = _variants3(A), _variants3(B)
    nv = max(A.shape[0], B.shape[0])
    return (np.broadcast_to(A, (nv,) + A.shape[1:]),
            np.broadcast_to(B, (nv,) + B.shape[1:]))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _f64(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float64))


def tile_einsum(eq: str, Mv: torch.Tensor, *ops: torch.Tensor):
    """``torch.einsum(eq, M, *ops)`` for a per-tile matrix stack M given by
    its (1|3) variants ``Mv`` [interior, first, last] (three only for
    n ≥ 2 tiles); the letter ``n`` of ``eq`` is the tile axis (the
    matrix's first). The interior matrix runs on every tile and the
    first/last tiles are recomputed with theirs, so no (n, ...) stack is
    ever formed."""
    lhs, out = eq.split("->")
    subs = lhs.split(",")
    eq0 = ",".join([subs[0][1:]] + subs[1:]) + "->" + out
    y = torch.einsum(eq0, Mv[0], *ops)
    if Mv.shape[0] == 1:
        return y
    ax = out.index("n")
    n = y.shape[ax]
    edges = [torch.einsum(eq0, Mv[v], *(
        o.narrow(s.index("n"), t, 1) if "n" in s else o
        for o, s in zip(ops, subs[1:]))) for v, t in ((1, 0), (2, n - 1))]
    return torch.cat([edges[0], y.narrow(ax, 1, n - 2), edges[1]], dim=ax)


def pad_solve_matrix(CMfull, n: int, S: int) -> np.ndarray:
    """Embed the (n·S, n·S) combined-solve matrix into the slot-padded
    layout: (n·sl, n·sl) with sl = ⌈S/8⌉·8, zero rows/cols on the pad
    slots — so the solve runs directly on slot-padded tails."""
    CM = np.asarray(CMfull)
    sl = slots_for(S)
    out = np.zeros((n * sl, n * sl), CM.dtype)
    for t in range(n):
        for u in range(n):
            out[t * sl:t * sl + S, u * sl:u * sl + S] = (
                CM[t * S:(t + 1) * S, u * S:(u + 1) * S]
            )
    return out


def _aux_ptrs(aux, k: int, shape, device) -> tuple:
    """The aux operands of an ``*_epi`` launch, checked (float32, ``shape``,
    on ``device``, contiguous, aligned): their pointers, 0 past k."""
    if len(aux) != k:
        raise ValueError(f"the affine epilogue takes {k} aux arrays, got "
                         f"{len(aux)}")
    for i, a in enumerate(aux):
        _check(a, f"aux{i}", shape, device)
    return tuple(a.data_ptr() for a in aux) + (0,) * (MAX_AUX - k)


def _epi_coef(module, affine) -> int:
    """Register ``affine``'s kernel coefficients on ``module`` (buffer
    ``epi_coef``); its aux count, 0 without one."""
    if affine is None:
        return 0
    if affine.k > MAX_AUX:
        raise ValueError(f"{affine.k} aux arrays: the kernels' affine "
                         f"epilogue takes at most {MAX_AUX}")
    module.register_buffer("epi_coef", affine.coefficients())
    return affine.k


def _grid_ok(what: str, n: int, blocks_y: int) -> None:
    if not (0 < n < 2**31 and 0 < blocks_y < 65536):
        raise ValueError(f"{what}: {n} tiles x {blocks_y} line blocks "
                         "outside the launch grid")


def _items_ok(what: str, n: int, q: int, lines: int = TILE) -> None:
    """The persistent kernels (``completion_rot``, ``tails``: 128 lines an
    item; ``completion``, ``completion_split``, ``completion_traced``: 64)
    walk n tiles × ⌈q/lines⌉ line blocks as work items, numbered in an
    int."""
    items = n * -(-q // lines)
    if not (n > 0 and q > 0 and items < 2**31):
        raise ValueError(f"{what}: {n} tiles x {q} lines: {items} work items "
                         "outside the kernel's walk")


# the CUDA error a launcher gives where its shared memory does not fit
_OUT_OF_RESOURCES = 701  # cudaErrorLaunchOutOfResources
_MAX_HE = 2 * TILE  # extra rows: a stencil reach of one tile each way
_TC_LINES = 64  # lines of a tensor-core completion's work item (wgmma M)


def _launch_fitting(entry: str, args, device, layout: str) -> None:
    """``_launch``, the launcher's refusal of a layout whose shared memory
    does not fit (cudaErrorLaunchOutOfResources) raised as a ValueError
    naming ``layout``; any other refusal as the launch error it is."""
    try:
        _launch(entry, args, device)
    except LaunchError as e:
        if e.err != _OUT_OF_RESOURCES:
            raise
        raise ValueError(f"{entry}: {layout} outgrow the block's shared "
                         "memory") from e


def _kperm(k: int) -> int:
    """The sample position k of a tensor-core k16 step holds (the step's
    contraction permuted so a thread reads its A pairs as float4:
    ``csrc/wgmma.cuh``'s ``kperm``), for k in [0, KP)."""
    kl = k % 16
    return k - kl + 4 * ((kl % 8) // 2) + 2 * (kl // 8) + kl % 2


def core_pack(C: torch.Tensor, perm: bool = True) -> torch.Tensor:
    """(..., 128, KP) → (..., 128·KP): the B operand of the tensor-core
    completion in ``csrc/wgmma.cuh``'s order — 8 × 8 core matrices (8
    outputs, 8 contraction positions), an output group's along k
    contiguous, each k16 step's contraction permuted by :func:`_kperm` —
    so staging it is a flat copy. ``perm=False``: the contraction in its
    own order (``final2d``'s second product, whose A fragments are the
    first product's accumulators)."""
    *lead, no, kp = C.shape
    P = C[..., [_kperm(k) for k in range(kp)]] if perm else C
    P = P.reshape(*lead, no // 8, 8, kp // 8, 8).transpose(-3, -2)
    return P.reshape(*lead, no * kp).contiguous()


def core_unpack(P: torch.Tensor, no: int, kp: int,
                perm: bool = True) -> torch.Tensor:
    """The inverse of :func:`core_pack`: (..., no·kp) → (..., no, kp)."""
    *lead, _ = P.shape
    C = P.reshape(*lead, no // 8, kp // 8, 8, 8).transpose(-3, -2)
    C = C.reshape(*lead, no, kp)
    if not perm:
        return C.contiguous()
    inv = [0] * kp
    for k in range(kp):
        inv[_kperm(k)] = k
    return C[..., inv].contiguous()


def tc_exact(Mc, data: torch.Tensor, ein, drop=None, nprod: int = 6,
             order=None):
    """The tensor-core completion's sum, exact, and per output how far the
    kernel may lie from it: ``(ref, bound)``, float64, of ``ein``'s shape.

    ``ref`` sums the chunk products of :func:`.split.prods` at grade
    ``nprod`` — the carry slab's (k ≥ 128) at :func:`.split.carry_nprod`,
    the signal slab's at ``nprod`` — the constant's chunks ``Mc`` ((..., o,
    KP) each) by the bf16 chunks of ``data`` (q, n, KP) = [x | Nᵀ | 0],
    split in float32 — in float64 (each bf16 product exact, the sum's
    error some 2⁻⁴³ of its terms' magnitude: far below float32's).
    ``bound`` follows the kernel's ``wgmma`` steps in its order — the carry
    slab, then the signal slab, in each the pairs smallest level first,
    each over its k16 steps — each step at most two roundings of 2⁻²³ of
    what it adds to: the accumulator (the exact partial sum's magnitude
    plus the bound so far) and the step's sixteen terms, plus 2⁻¹⁰⁰ for
    values float32 holds only as subnormals (at most 72 steps each losing
    2⁻¹²⁶ times the step's coefficients: far less; and far below any
    output a real input gives).
    ``ein(M, D)`` contracts the last axes (by tile where the matrix has
    variants). ``drop``: a pair left out of ``ref`` — a control that the
    check against ``bound`` rejects. ``order``: the kernel's pairs in
    another order (the same pairs; ``final2d``'s second product)."""
    cn = split.carry_nprod(nprod)
    ds = [c.double() for c in split.split_data(data, split.nchunks(cn))]
    ms = [c.double() for c in Mc]
    kp = data.shape[-1]
    acc = bound = left = None
    for k0s, grade in ((range(TILE, kp, 16), cn), (range(0, TILE, 16), nprod)):
        for i, j in split.prods(grade) if order is None else order:
            for k0 in k0s:
                m, d = ms[i][..., k0:k0 + 16], ds[j][..., k0:k0 + 16]
                t, a = ein(m, d), ein(m.abs(), d.abs())
                if acc is None:
                    acc, bound, left = (torch.zeros_like(t) for _ in "abc")
                bound = bound + 2.0 ** -22 * (acc.abs() + bound + a)
                acc = acc + t
                if (i, j) == drop:
                    left = left + t
    return acc - left, bound + 2.0 ** -100


def tc_depth(sl: int) -> int:
    """KP: the tensor-core completion's contraction, 128 samples and sl
    carry rows padded with zeros to a multiple of 16."""
    return TILE + -(-sl // 16) * 16


def tc_constant(Bv, Rv, nc: int = 3) -> torch.Tensor:
    """The tensor-core kernels' B operand (``completion``'s,
    ``completion_split``'s and ``rows_final``'s): per variant ``[Btot | R |
    0]`` — Bv (nv, T, T), Rv (nv, T, sl), the contraction padded to
    :func:`tc_depth` — split from float64 into ``nc`` bf16 chunks (three at
    px6, two at the reduced grades: :func:`.split.nchunks` of the carry
    rows' grade) and packed by :func:`core_pack`: (nv, nc, T·KP)."""
    sl = Rv.shape[-1]
    M = np.zeros(Bv.shape[:2] + (tc_depth(sl),))
    M[..., :TILE] = Bv
    M[..., TILE:TILE + sl] = Rv
    return core_pack(torch.stack(split.split_const(M, nc), dim=1))


def grade_chunks(nprod: int) -> int:
    """Chunks of the tensor-core kernels' constant at grade ``nprod``: those
    of the carry rows, which take the most products (``csrc/wgmma.cuh``'s
    ``b_chunks``)."""
    return split.nchunks(split.carry_nprod(nprod))


class TailsPass(nn.Module):
    """``tails(x)``: x (q, n, T) → slot-padded transposed tails (n, sl, q),
    ``out[t, s, l] = Σ_τ G_v(t)[s, τ]·x[l, t, τ]`` for s < S, zeros below.

    Gcat : (n|1, S, T) stacked per-scan tail rows (per-tile variants).
    extra_rows : optional (n|1, He, T) rows appended below the sl slot rows
    (the JAX package's ``tails_pass(extra_rows=)``): the output is then
    (n, sl + He, q), rows sl.. carrying ``E_v(t)·x``.
    The sums run in float64 from float32 loads, in the kernel and in the
    twin (see ``csrc/tails.cu``). Setting ``fp64 = False`` launches the
    kernel's fp32-accumulating instantiation instead — kept to measure
    what fp64 buys (``chip_smoke.py`` phase 5c). x may be bf16
    (``tails_bf16``, with extra rows ``tails_extra_bf16``; fp64 sums only:
    the float32 entry's bits on the same values).
    """

    def __init__(self, Gcat, n: int, extra_rows=None):
        super().__init__()
        G = np.asarray(Gcat, np.float64)
        nv, S, T = G.shape
        if T != TILE:
            raise ValueError(f"tiles must be {TILE} wide, got {T}")
        if S > _MAX_S:
            raise ValueError(f"ΣK={S} exceeds the {_MAX_S}-row carry layout")
        self.n, self.S, self.sl = int(n), S, slots_for(S)
        E = (np.zeros((1, 0, T)) if extra_rows is None
             else np.asarray(extra_rows, np.float64))
        self.He = E.shape[1]
        if self.He > _MAX_HE:
            raise ValueError(f"{self.He} extra rows exceed {_MAX_HE}")
        self.fp64 = True
        Gp = np.zeros((nv, self.sl, T))
        Gp[:, :S] = G
        Gv, Ev = _variants_like(Gp, E)
        Gv = np.concatenate([Gv, Ev], axis=1)
        self.register_buffer("G_v", _f32(Gv))      # kernel operand
        self.register_buffer("G_v64", _f64(Gv))    # twin operand

    def plain(self, x):
        return tile_einsum("nst,qnt->nsq", self.G_v64, x.double()).float()

    def _kernel(self, x):
        q, n = x.shape[0], self.n
        _check(x, "x", (q, n, TILE), x.device, XTYPES)
        if x.dtype == torch.bfloat16 and not self.fp64:
            raise ValueError("the bf16 tails sum in fp64 only")
        _check(self.G_v, "G_v", self.G_v.shape, x.device)
        out = torch.empty((n, self.sl + self.He, q), device=x.device)
        args = (x.data_ptr(), self.G_v.data_ptr(), out.data_ptr(), q, n,
                self.S, self.sl, self.He, self.G_v.shape[0], int(self.fp64))
        if self.He:
            _grid_ok("tails_extra", n, -(-q // 64))
            _launch(_entry("tails_extra", x), args, x.device)
        else:
            _items_ok("tails", n, q)
            _launch(_entry("tails", x), args, x.device)
        return out

    def forward(self, x):
        if x.is_cuda:
            return _KernelFn.apply(self, x)
        return self.plain(x)


def stencil_reach(taps):
    """(hp, hn): the rows a tile's stencil reads from the previous tile's
    tail (the largest −d) and the next tile's head (the largest d)."""
    ds = [int(d) for d, _ in taps]
    return max([-d for d in ds] + [0]), max(ds + [0])


def _stencil_flat(yf, taps, start: str, end: str):
    """The JAX package's ``_stencil_flat``: the taps as global shifts of
    the flat rotated output (L, q) along its first axis — "clamp"
    replicates the first (d < 0, ``start``) or last (d > 0, ``end``) row,
    "zero" reads zeros. fp32 product, then sum, per tap."""
    out = None
    for d, c in taps:
        d = int(d)
        t = float(c) * shift_mode(yf, d, 0, end if d > 0 else start)
        out = t if out is None else out + t
    return out


def _stencil_rows(yf, prev, nxt, taps, n: int, start: str, end: str):
    """The JAX package's ``_stencil_rows`` for every tile at once: the
    taps over each completed tile of the flat rotated output yf (n·T, q)
    stacked between its halo strips — ``prev`` (n, hp, q), the previous
    tile's last hp rows, and ``nxt`` (n, hn, q), the next tile's first hn
    rows — with the border rule at the globally-first/last tile. This is
    what ``completion_rot`` computes from the strips."""
    q = yf.shape[1]
    Y = yf.reshape(n, TILE, q)
    hp, hn = stencil_reach(taps)
    zero = Y.new_zeros((1,) + Y.shape[1:])
    parts = [Y]
    if hp:
        parts.insert(0, torch.cat([zero[:, :hp], prev[1:]]))
    if hn:
        parts.append(torch.cat([nxt[:-1], zero[:, :hn]]))
    Z = torch.cat(parts, dim=1)  # (n, hp + T + hn, q)
    rows = torch.arange(TILE, device=yf.device)[:, None]
    out = None
    for d, c in taps:
        d = int(d)
        term = Z[:, hp + d:hp + d + TILE]
        if d > 0 and end == "clamp":
            term = term.clone()
            term[-1] = torch.where(rows >= TILE - d, Y[-1, -1:], term[-1])
        if d < 0 and start == "clamp":
            term = term.clone()
            term[0] = torch.where(rows < -d, Y[0, :1], term[0])
        term = float(c) * term
        out = term if out is None else out + term
    return out.reshape(n * TILE, q)


class CompletionPass(nn.Module):
    """``completion(x, N)``: x (q, n, T), N (n, sl, q) → Y (q, n, T),
    ``Y[l, t] = Btot_v(t)·x[l, t] + Rcat_v(t)·N[t, :S, l]`` (the JAX
    package's ``completion_pass`` with transposed slot-padded carries).

    Btot : (n|1, T, T);  Rcat : (n|1, T, S).

    ``rot=True`` emits rotated: ``Yr[t·T + o, l] = Y[l, t, o]``, an
    (n·T, q) output (the JAX package's rot layout (n, T, q), flat).
    ``stencil = {"taps": [(d, c), ...], "start", "end"}`` (rot only; both
    modes "zero" unless given, the JAX package's ``completion_pass``
    defaults) applies the taps along the scanned axis before the write:
    ``forward(x, N, prev, nxt)`` then takes the halo strips, prev
    (n, hp, q) and nxt (n, hn, q) — present where hp > 0 and hn > 0 — the
    neighbour tiles' completed edge rows (module docstring). The float32
    twin reads the whole output instead (:func:`_stencil_flat`), so the
    strips get zero gradients, as in the JAX package's VJP.

    ``next_tails = (Gcat2, n2)`` (rot only, no stencil, sl = 8): the next
    pass of a rotation chain scans this pass's line axis, n2 tiles of 128
    with per-tile tail rows Gcat2 (n2|1, S2 ≤ 8, 128). ``forward(x, N)``
    then returns ``(Yr, tails2)``: tails2 (n2, 8, n·T·ra), ra = q / (n2·128),
    the next pass's slot-padded transposed tails in its line order,
    ``tails2[c, s, (t·T + o)·ra + a] = Σ_j G2_v(c)[s, j]·Yr[t·T + o,
    (a·n2 + c)·128 + j]`` — the JAX package's ``braw2`` of
    ``_completion_ref``, flat. Summed in float64 from the float32 output,
    in the kernel and in the twins, as :class:`TailsPass` sums them (the
    JAX package splits them at the grade). The lines must hold whole
    next-pass extents (:func:`next_tails_ok`).

    ``affine`` (an :class:`..epilogue.Affine`, not with ``next_tails``):
    the output becomes ``a·y + Σᵢ bᵢ·auxᵢ + c`` — after the stencil where
    there is one — and ``forward`` takes the k aux arrays after the halo
    strips, in the output's layout ((q, n, T), or (n·T, q) rotated).

    ``nprod``: the grade's product count (:data:`.split.NPROD`), 6, 4, 3
    or 1. The kernels compute the JAX package's arithmetic at the grade on
    the tensor cores (``completion``, ``completion_epi`` at px6,
    ``completion_split``, ``completion_split_epi`` at the other grades;
    the rotated ``completion_rot``, ``completion_rot_epi`` and
    ``completion_rot_tails`` at every grade):
    ``nprod`` split-bf16 products (:func:`.split.prods`) on the signal rows,
    :func:`.split.carry_nprod` on the carry rows, the constant
    ``[Btot | Rcat]`` split from float64 on the host (``Bc_k`` (nv,
    :func:`grade_chunks`, T·KP) in the kernels' byte order,
    :func:`core_pack`; KP = :func:`tc_depth`; :meth:`chunks` unpacks them),
    x and N on chip; rotated, the stencil and the epilogue follow in
    float32. :meth:`split_plain` is that arithmetic in float32 on any
    device, the kernels' split twin; :meth:`split_exact` its exact sum and
    the kernels' bound about it (before a stencil or an epilogue). ``plain``
    is the twin the CPU runs: at px6 the float32 product, at the other
    grades :meth:`split_plain`; the backward differentiates the float32
    product with the grade's constant (``_twin``; at px6 the constant
    itself).

    bf16 storage: at nprod 1, x may be bf16 (the ``*_bf16`` entries;
    with a stencil ``completion_rot_stencil_bf16`` and
    ``completion_rot_stencil_epi_bf16``): Yr (or Y) is bf16, the float32
    accumulators rounded once after the stencil and the epilogue (halo
    strips and aux arrays float32); the next pass's tails are float32
    sums of the rounded outputs (the tails a :class:`TailsPass` reads from
    the stored output). ``plain`` computes on ``x.float()`` and rounds
    once.
    """

    def __init__(self, Btot, Rcat, n: int, rot: bool = False, stencil=None,
                 next_tails=None, affine=None, nprod: int = 6):
        super().__init__()
        R = np.asarray(Rcat, np.float64)
        nvr, T, S = R.shape
        if T != TILE or np.shape(Btot)[1:] != (T, T):
            raise ValueError(f"tiles must be {TILE} wide")
        if S > _MAX_S:
            raise ValueError(f"ΣK={S} exceeds the {_MAX_S}-row carry layout")
        if stencil is not None and not rot:
            raise ValueError("the stencil consumer rides the rotated emit")
        if nprod not in (1, 3, 4, 6):
            raise ValueError(f"nprod {nprod}: the completion runs 6, 4, 3 "
                             "or 1 products")
        self.n, self.S, self.sl = int(n), S, slots_for(S)
        self.rot, self.nprod = bool(rot), nprod
        if affine is not None and next_tails is not None:
            raise ValueError("the next pass's tails read the filter output: "
                             "no epilogue with next_tails")
        self.affine, self.k = affine, _epi_coef(self, affine)
        self.n2 = None
        if next_tails is not None:
            Gcat2, n2 = next_tails
            G2 = np.asarray(Gcat2, np.float64)
            if not rot or stencil is not None:
                raise ValueError("the next pass's tails ride the rotated "
                                 "emit, without a stencil")
            if not next_tails_ok(n2 * TILE, self.sl, n2, G2.shape[1],
                                 G2.shape[2]):
                raise ValueError(f"next-pass tails need single-slot carries "
                                 f"on both sides and {TILE}-wide tiles "
                                 f"(sl={self.sl}, G2 {G2.shape})")
            self.n2, self.S2 = int(n2), G2.shape[1]
            Gp = np.zeros((G2.shape[0], _SLOTS, TILE))
            Gp[:, :self.S2] = G2
            self.register_buffer("G2_v", _f32(_variants3(Gp)))    # kernel
            self.register_buffer("G2_v64", _f64(_variants3(Gp)))  # twin
        self.taps, self.hp, self.hn = [], 0, 0
        if stencil is not None:
            self.taps = [(int(d), float(c)) for d, c in stencil["taps"]]
            if not self.taps:
                raise ValueError("a stencil needs at least one tap")
            self.start = stencil.get("start", "zero")
            self.end = stencil.get("end", "zero")
            self.hp, self.hn = stencil_reach(self.taps)
            if max(self.hp, self.hn) > TILE:
                raise ValueError(f"stencil reach {self.hp}, {self.hn} "
                                 f"exceeds the {TILE}-row tile")
        self.register_buffer("taps_k", torch.tensor(
            self.taps or [(0, 0.0)], dtype=torch.float32))
        Rp = np.zeros((nvr, T, self.sl))
        Rp[..., :S] = R
        Bv, Rv = _variants_like(Btot, Rp)
        # the split constant [Btot | Rcat | 0], (nv, nc, T·KP) bf16, in the
        # kernels' byte order
        self.register_buffer("Bc_k", tc_constant(Bv, Rv,
                                                 grade_chunks(nprod)))
        # the float32 product's operands: at px6 the constant, else the
        # grade's (the sum of its chunks)
        if nprod == 6:
            self.register_buffer("B_v", _f32(_variants3(Btot)))
            self.register_buffer("R_v", _f32(_variants3(R)))
        else:
            M = self.grade_constant()
            self.register_buffer("B_v", M[..., :TILE].contiguous())
            self.register_buffer("R_v", M[..., TILE:TILE + S].contiguous())

    @property
    def n_halos(self) -> int:
        return (self.hp > 0) + (self.hn > 0)

    def _next_tails(self, yf, G2):
        """The next pass's tails of the rotated output yf in float64: its
        lines (n·T·ra, n2, 128)."""
        y2 = yf.reshape(-1, self.n2, TILE).double()
        return tile_einsum("nst,qnt->nsq", G2, y2).float()

    def _twin(self, x, N, *rest):
        """The float32 product (then the flat stencil, the epilogue, the
        next tails): linear, the backward's map; at px6 the CPU's twin."""
        aux = rest[self.n_halos:]
        y = (tile_einsum("nos,qns->qno", self.B_v, x)
             + tile_einsum("nou,nuq->qno", self.R_v, N[:, :self.S]))
        if not self.rot:
            return y if self.affine is None else self.affine.apply(y, aux)
        yf = y.permute(1, 2, 0).reshape(-1, x.shape[0])
        if self.taps:
            yf = _stencil_flat(yf, self.taps, self.start, self.end)
        if self.affine is not None:
            yf = self.affine.apply(yf, aux)
        if self.n2 is None:
            return yf
        return yf, self._next_tails(yf, self.G2_v64)

    def plain(self, x, N, *rest):
        """The twin the CPU runs: the float32 product at px6, the split
        arithmetic (:meth:`split_plain`) at the other grades and on a bf16
        x."""
        _bf16_grade(x, self.nprod)
        if self.nprod == 6:
            return self._twin(x, N, *rest)
        return self.split_plain(x, N, *rest)

    def split_plain(self, x, N, *rest):
        """The kernels' arithmetic (class docstring) in float32:
        ``Σ_(i,j) Bc_i·[x | Nᵀ]_j`` over the pairs of :func:`.split.prods`
        at ``nprod``, smallest level first (the carry rows at
        :func:`.split.carry_nprod`); rotated, then the stencil on the halo
        strips (:func:`_stencil_rows`, the kernel's per-tile form), the
        epilogue, and the next tails (float64 sums of the float32 output by
        ``G2_v``, the kernel's rows). A bf16 x: the output rounded once to
        bf16 after the epilogue, the next tails summed from it."""
        Bc = self.chunks()[..., :TILE + self.sl].float()
        y = split.pair_sum(self.nprod, lambda i, d: tile_einsum(
            "nok,qnk->qno", Bc[:, i], d), torch.cat(
                [x.float(), N.permute(2, 0, 1)], dim=-1), TILE)
        halos, aux = list(rest[:self.n_halos]), rest[self.n_halos:]
        if not self.rot:
            return (y if self.affine is None
                    else self.affine.apply(y, aux)).to(x.dtype)
        yf = y.permute(1, 2, 0).reshape(-1, x.shape[0])
        if self.taps:
            prev = halos.pop(0) if self.hp else None
            nxt = halos.pop(0) if self.hn else None
            yf = _stencil_rows(yf, prev, nxt, self.taps, self.n, self.start,
                               self.end)
        if self.affine is not None:
            yf = self.affine.apply(yf, aux)
        yf = yf.to(x.dtype)
        if self.n2 is None:
            return yf
        return yf, self._next_tails(yf, self.G2_v.double())

    def chunks(self) -> torch.Tensor:
        """The constant's bf16 chunks, (nv, nc, T, KP), unpacked from
        ``Bc_k`` (:func:`core_unpack`)."""
        return core_unpack(self.Bc_k, TILE, tc_depth(self.sl))

    def grade_constant(self) -> torch.Tensor:
        """``[Btot | Rcat]`` at the grade, the sum of its chunks in float32:
        (nv, T, T + sl)."""
        return self.chunks()[..., :TILE + self.sl].float().sum(1)

    def split_exact(self, x, N, drop=None):
        """:func:`tc_exact` of the kernels at ``nprod`` (before a stencil
        or an epilogue): the exact sum of their chunk products and their
        bound, per output — (q, n, T), or rotated (n·T, q)."""
        Bc = self.chunks()
        x = x.float()
        d = torch.cat([x, N.permute(2, 0, 1), x.new_zeros(
            x.shape[:2] + (Bc.shape[-1] - TILE - self.sl,))], dim=-1)
        ref, bound = tc_exact(Bc.unbind(1), d, lambda m, v: tile_einsum(
            "nok,qnk->qno", m, v), drop, self.nprod)
        if self.rot:
            q = x.shape[0]
            ref, bound = (a.permute(1, 2, 0).reshape(-1, q)
                          for a in (ref, bound))
        return ref, bound

    def _kernel(self, x, N, *rest):
        q, n = x.shape[0], self.n
        _check(x, "x", (q, n, TILE), x.device, XTYPES)
        _bf16_grade(x, self.nprod)
        bf16 = x.dtype == torch.bfloat16
        _check(N, "N", (n, self.sl, q), x.device)
        _check(self.Bc_k, "Bc_k", self.Bc_k.shape, x.device, torch.bfloat16)
        halos, aux = list(rest[:self.n_halos]), rest[self.n_halos:]
        epi = ()
        if self.affine is not None:
            _check(self.epi_coef, "epi_coef", self.epi_coef.shape, x.device)
            shape = (n * TILE, q) if self.rot else (q, n, TILE)
            epi = (*_aux_ptrs(aux, self.k, shape, x.device),
                   self.epi_coef.data_ptr())
        if not self.rot and self.nprod != 6:
            _items_ok("completion_split", n, q, _TC_LINES)
            y = torch.empty_like(x)
            _launch(_entry("completion_split_epi" if epi
                           else "completion_split", x), (
                x.data_ptr(), N.data_ptr(), self.Bc_k.data_ptr(), *epi,
                y.data_ptr(), q, n, self.sl, self.Bc_k.shape[0],
                *((self.k,) if epi else ()), self.nprod), x.device)
            return y
        if not self.rot:
            _items_ok("completion", n, q, _TC_LINES)
            y = torch.empty_like(x)
            entry = "completion_epi" if epi else "completion"
            _launch_fitting(entry, (
                x.data_ptr(), N.data_ptr(), self.Bc_k.data_ptr(), *epi,
                y.data_ptr(), q, n, self.sl, self.Bc_k.shape[0],
                *((self.k,) if epi else ())), x.device,
                f"sl={self.sl} carry rows")
            return y
        if self.n2 is not None:
            return self._kernel_tails(x, N)
        _items_ok("completion_rot", n, q, _TC_LINES)
        y = torch.empty((n * TILE, q), device=x.device, dtype=x.dtype)
        if bf16 and not self.taps:
            _launch_fitting(_entry("completion_rot_epi" if epi
                                   else "completion_rot", x), (
                x.data_ptr(), N.data_ptr(), self.Bc_k.data_ptr(), *epi,
                y.data_ptr(), q, n, self.sl, self.Bc_k.shape[0],
                *((self.k,) if epi else ()), self.nprod),
                x.device, f"sl={self.sl} carry rows")
            return y
        prev = halos.pop(0) if self.hp else None
        nxt = halos.pop(0) if self.hn else None
        for h, name, rows in ((prev, "prev", self.hp), (nxt, "nxt", self.hn)):
            if h is not None:
                _check(h, name, (n, rows, q), x.device)
        _check(self.taps_k, "taps_k", self.taps_k.shape, x.device)
        entry = "completion_rot_epi" if epi else "completion_rot"
        if bf16:
            entry = ("completion_rot_stencil_epi_bf16" if epi
                     else "completion_rot_stencil_bf16")
        _launch_fitting(entry, (
            x.data_ptr(), N.data_ptr(), self.Bc_k.data_ptr(),
            0 if prev is None else prev.data_ptr(),
            0 if nxt is None else nxt.data_ptr(), self.taps_k.data_ptr(),
            *epi, y.data_ptr(), q, n, self.sl, self.Bc_k.shape[0],
            self.hp, self.hn, len(self.taps),
            int(self.taps != [] and self.start == "clamp"),
            int(self.taps != [] and self.end == "clamp"),
            *((self.k,) if epi else ()), self.nprod), x.device,
            f"sl={self.sl}, reach ({self.hp}, {self.hn}) and "
            f"{len(self.taps)} taps")
        return y

    def _kernel_tails(self, x, N):
        q, n, n2 = x.shape[0], self.n, self.n2
        if not next_tails_ok(q, self.sl, n2, self.S2, TILE):
            raise ValueError(f"{q} lines do not hold whole extents of the "
                             f"next pass ({n2} tiles of {TILE})")
        _check(self.G2_v, "G2_v", self.G2_v.shape, x.device)
        _items_ok("completion_rot_tails", n, q)
        y = torch.empty((n * TILE, q), device=x.device, dtype=x.dtype)
        t2 = torch.empty((n2, _SLOTS, n * q // n2), device=x.device)
        _launch_fitting(_entry("completion_rot_tails", x), (
            x.data_ptr(), N.data_ptr(), self.Bc_k.data_ptr(),
            self.G2_v.data_ptr(), y.data_ptr(), t2.data_ptr(), q, n,
            self.sl, self.Bc_k.shape[0], n2, self.S2, self.G2_v.shape[0],
            self.nprod), x.device, "the chunks and two stages")
        return y, t2

    def forward(self, x, N, *rest):
        """``forward(x, N, *halos, *aux)``: the halo strips of a stencil,
        then the affine epilogue's aux arrays."""
        if len(rest) != self.n_halos + self.k:
            raise ValueError(f"expected {self.n_halos} halo strips and "
                             f"{self.k} aux arrays, got {len(rest)} arrays")
        if x.is_cuda:
            return _KernelFn.apply(self, x, N, *rest)
        return self.plain(x, N, *rest)


# ---------------------------------------------------------------------------
# The learnable executor's kernels: runtime matrices, one slot of carries
# ---------------------------------------------------------------------------


def tails_traced_plain(x, G):
    """The twin of ``tails_traced``: x (q, n, T) and the runtime tail rows
    G (S ≤ 8, T) → (n, 8, q), ``out[t, s, l] = Σ_τ G[s, τ]·x[l, t, τ]``
    for s < S and zeros below, summed in float64 from the float32 values,
    as the kernel sums them."""
    out = torch.einsum("st,qnt->nsq", G.double(), x.double()).float()
    return F.pad(out, (0, 0, 0, _SLOTS - G.shape[0]))


def tails_ordered_plain(x, G, f64: bool = False):
    """The tails in the kernels' summation order, for tests: x (q, n, T)
    float32 and G (S, T) — one matrix for every tile — or (n, S, T) per
    tile, float32 → (n, S, q), ``Σ_τ G[s, τ]·x[l, t, τ]`` as one float64
    loop over τ ascending from 0.0. An fp32 × fp32 product is exact in
    float64, so each step rounds once, as the ``tails`` and
    ``tails_traced`` kernels' ``fma`` does: rounded to float32 (``f64``
    False) the result is theirs bit for bit. The main path does not run
    it."""
    x64 = x.double()
    G64 = G.double()
    if G64.dim() == 2:
        G64 = G64[None]
    acc = x64.new_zeros((x.shape[1], G64.shape[1], x.shape[0]))
    for tau in range(x.shape[2]):
        acc = acc + G64[:, :, tau, None] * x64[:, :, tau].t()[:, None, :]
    return acc if f64 else acc.float()


def completion_traced_plain(x, Btot, Rcat, N):
    """The twin of ``completion_traced``: x (q, n, T), Btot (T, T), Rcat
    (T, S ≤ 8), N (n, 8, q) → ``Y[l, t] = Btot·x[l, t] + Rcat·N[t, :S, l]``
    (q, n, T), float32 products (the function the backward
    differentiates; the kernel's arithmetic is
    :func:`completion_traced_split`'s)."""
    return (torch.einsum("os,qns->qno", Btot, x)
            + torch.einsum("ou,nuq->qno", Rcat, N[:, :Rcat.shape[1]]))


def completion_traced_split(x, Btot, Rcat, N):
    """The kernel's arithmetic in float32, its split twin: the runtime
    ``[Btot | Rcat]`` and ``[x | Nᵀ]`` each split into three bf16 chunks in
    float32 (:func:`.split.split_data`, the JAX package's ``_split_vmem``),
    the six products of :func:`.split.prods` summed smallest level first
    — ``completion_pass_traced(nprod=6)``."""
    S = Rcat.shape[1]
    Ms = [c.float() for c in split.split_data(torch.cat([Btot, Rcat], 1), 3)]
    return split.pair_sum(6, lambda i, d: torch.einsum(
        "ok,qnk->qno", Ms[i], d), torch.cat(
            [x, N[:, :S].permute(2, 0, 1)], dim=-1), TILE)


def completion_traced_exact(x, Btot, Rcat, N, drop=None):
    """:func:`tc_exact` of ``completion_traced``: the exact sum of its six
    chunk products (the runtime matrices split in float32) and its bound,
    per output (q, n, T)."""
    S, kp = Rcat.shape[1], tc_depth(_SLOTS)
    M = torch.cat([Btot, Rcat, Btot.new_zeros(TILE, kp - TILE - S)], 1)
    d = torch.cat([x, N[:, :S].permute(2, 0, 1), x.new_zeros(
        x.shape[:2] + (kp - TILE - S,))], dim=-1)
    return tc_exact(split.split_data(M, 3), d, lambda m, v: torch.einsum(
        "ok,qnk->qno", m, v), drop)


def _tails_traced_kernel(x, G):
    q, n = x.shape[0], x.shape[1]
    S = G.shape[0]
    _check(x, "x", (q, n, TILE), x.device)
    _check(G, "G", (S, TILE), x.device)
    if not 1 <= S <= _SLOTS:
        raise ValueError(f"tails_traced takes 1..{_SLOTS} tail rows, got {S}")
    _items_ok("tails_traced", n, q)
    out = torch.empty((n, _SLOTS, q), device=x.device)
    _launch("tails_traced", (x.data_ptr(), G.data_ptr(), out.data_ptr(),
                             q, n, S), x.device)
    return out


def _completion_traced_kernel(x, Btot, Rcat, N):
    q, n = x.shape[0], x.shape[1]
    S = Rcat.shape[1]
    _check(x, "x", (q, n, TILE), x.device)
    _check(Btot, "Btot", (TILE, TILE), x.device)
    _check(Rcat, "Rcat", (TILE, S), x.device)
    _check(N, "N", (n, _SLOTS, q), x.device)
    if not 1 <= S <= _SLOTS:
        raise ValueError(f"completion_traced takes 1..{_SLOTS} carries, "
                         f"got {S}")
    _items_ok("completion_traced", n, q, _TC_LINES)
    y = torch.empty_like(x)
    _launch_fitting("completion_traced", (
        x.data_ptr(), N.data_ptr(), Btot.data_ptr(), Rcat.data_ptr(),
        y.data_ptr(), q, n, S), x.device, "the traced operands")
    return y


class _TailsTraced(torch.autograd.Function):
    """Forward through the kernel (a CUDA tensor, unless ``plain``) or the
    twin; backward: the twin's einsums at the saved inputs, cotangents for
    x and G (``tails_pass_traced``'s custom VJP). fp32 products."""

    @staticmethod
    def forward(ctx, x, G, plain):
        ctx.save_for_backward(x, G)
        if x.is_cuda and not plain:
            return _tails_traced_kernel(x, G)
        return tails_traced_plain(x, G)

    @staticmethod
    def backward(ctx, ct):
        x, G = ctx.saved_tensors
        c = ct[:, :G.shape[0]]
        gx = gG = None
        if ctx.needs_input_grad[0]:
            gx = torch.einsum("nsq,st->qnt", c, G)
        if ctx.needs_input_grad[1]:
            gG = torch.einsum("nsq,qnt->st", c, x)
        return gx, gG, None


class _CompletionTraced(torch.autograd.Function):
    """Forward through the kernel (a CUDA tensor, unless ``plain``) or the
    twin; backward: the twin's einsums at the saved inputs, cotangents for
    x, Btot, Rcat and N (zeros on N's pad slots) —
    ``completion_pass_traced``'s custom VJP. fp32 products."""

    @staticmethod
    def forward(ctx, x, Btot, Rcat, N, plain):
        ctx.save_for_backward(x, Btot, Rcat, N)
        if x.is_cuda and not plain:
            return _completion_traced_kernel(x, Btot, Rcat, N)
        return completion_traced_plain(x, Btot, Rcat, N)

    @staticmethod
    def backward(ctx, ct):
        x, Btot, Rcat, N = ctx.saved_tensors
        S = Rcat.shape[1]
        need = ctx.needs_input_grad
        gx = gB = gR = gN = None
        if need[0]:
            gx = torch.einsum("qno,os->qns", ct, Btot)
        if need[1]:
            gB = torch.einsum("qno,qns->os", ct, x)
        if need[2]:
            gR = torch.einsum("qno,nuq->ou", ct, N[:, :S])
        if need[3]:
            gN = F.pad(torch.einsum("qno,ou->nuq", ct, Rcat),
                       (0, 0, 0, N.shape[1] - S))
        return gx, gB, gR, gN, None


def tails_traced(x, G, plain: bool = False):
    """Local tails with runtime tail rows: x (q, n, 128) float32, G (S ≤ 8,
    128) float32 → the slot-padded transposed tails (n, 8, q) (the JAX
    package's ``tails_pass_traced``). A CUDA tensor launches the
    ``tails_traced`` kernel (``plain``: the twin on the card); a CPU tensor
    runs the twin. Differentiable in x and G."""
    return _TailsTraced.apply(x, G, plain)


def completion_traced(x, Btot, Rcat, N, plain: bool = False):
    """``Y[l, t] = Btot·x[l, t] + Rcat·N[t, :S, l]`` with runtime matrices:
    x (q, n, 128), Btot (128, 128), Rcat (128, S ≤ 8), N (n, 8, q), all
    float32 → Y (q, n, 128) (the JAX package's ``completion_pass_traced``).
    A CUDA tensor launches the ``completion_traced`` kernel (``plain``: the
    twin on the card); a CPU tensor runs the twin. Differentiable in every
    tensor input."""
    return _CompletionTraced.apply(x, Btot, Rcat, N, plain)
