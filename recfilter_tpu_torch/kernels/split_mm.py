"""The split-bf16 probes of the JAX package's ``scripts/`` as H100 studies:
the wrappers of ``csrc/split_mm.cu`` and their plain twins.

Every probe is one product shape (``csrc/split_mm.cu``'s header): for
each 128-wide tile t of x (L lines of n tiles) and each line l,

    C[l][o] = Σ_k Bn[o][k]·x[l, t·128 + k]  (+ Σ_s R[o][s]·N[l][s])

emitted in place, y (L, n·128) (``emit=0``), or transposed, y (n·128, L),
straight from the accumulators (``emit=1``) or through a shared-memory
transpose (``emit=2``, bf16 only). The carry rides the contraction at the
product's grade (``carry=1``) or is added in fp32 after it (``carry=2``,
bf16 only). ``nt`` tiles and ``lb`` lines per block.

Three mechanisms, one launch entry each, the constant prepared on the host
by the matching ``*_operand``:

  * :func:`split_mm` — bf16 chunk products on tensor cores, ``nprod`` 1, 3,
    4, 6 (``stack=True``: all chunk fragments loaded once per k step);
  * :func:`split_mm_tf32` — 1xTF32 or 3xTF32 on tensor cores;
  * :func:`split_mm_fp32` — fp32 FMA on the CUDA cores.

The probes (``PROBES``) fix the shapes: ``pallas_split_mm`` (x 131072 ×
128, y = x·B), ``pallas_split_mm_t`` (4096², transposed emit, the carry
term with S = 6), ``px3t_sweep`` (the same at px3 over block widths, tiles
per block, orientation and carry precision) and ``px6_stack`` (4096²,
transposed emit, six products separate or stacked). The twins compute the
same arithmetic in float32 on any device: bf16 chunks upcast, TF32 parts
rounded as ``cvt.rna.tf32.f32`` rounds (``*_plain``, on any device). A
wrapper runs its twin for CPU tensors and launches the kernel for CUDA
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import split
from .launch import _check, _launch

TILE = 128
MAX_S = 8

# scripts/ probe → (file:line of its Pallas kernel's function, shape)
PROBES = {
    "pallas_split_mm": "scripts/pallas_split_matmul.py:70",
    "pallas_split_mm_t": "scripts/pallas_split_matmul.py:113",
    "px3t_sweep": "scripts/px3t_sweep.py:74",
    "px6_stack": "scripts/px6_stack_exp.py:56",
}


def bf16_operand(Bn, nprod: int, R=None) -> torch.Tensor:
    """(nc, 128, K + 8) bf16 chunks of ``[Bn | R | 0]`` (rows o, the
    contraction contiguous): K = 128, or 144 with the carry rows R (128,
    S) in the contraction (``carry=1``)."""
    K = TILE + (16 if R is not None else 0)
    M = np.zeros((TILE, K + 8))
    M[:, :TILE] = np.asarray(Bn, np.float64)
    if R is not None:
        M[:, TILE:TILE + np.shape(R)[1]] = R
    return torch.stack(split.split_const(M, split.nchunks(nprod)))


def tf32_operand(Bn, R=None) -> torch.Tensor:
    """(128, K) float32 ``[Bn | R | 0]``: K = 128, or 136 with the carry
    rows in the contraction."""
    K = TILE + (MAX_S if R is not None else 0)
    M = np.zeros((TILE, K), np.float32)
    M[:, :TILE] = Bn
    if R is not None:
        M[:, TILE:TILE + np.shape(R)[1]] = R
    return torch.from_numpy(M)


def fp32_operand(Bn, R=None) -> torch.Tensor:
    """(K, 128) float32 ``[Bnᵀ; Rᵀ; 0]`` (the CUDA-core GEMM's k rows)."""
    return tf32_operand(Bn, R).t().contiguous()


def _geom(x, N, S, nt, lb):
    L, W = x.shape
    n = W // TILE
    if W % TILE or L % 4 or not 0 <= S <= MAX_S or lb % TILE or nt < 1:
        raise ValueError(f"x {tuple(x.shape)}, S {S}, nt {nt}, lb {lb}: "
                         "the probes take 128-wide tiles, L a multiple of "
                         "4, S ≤ 8, lb a multiple of 128")
    return L, n


def _emit(C, emit: int):
    """(L, n, 128) products → the emit layout."""
    L, n, T = C.shape
    return (C.reshape(L, n * T) if emit == 0
            else C.permute(1, 2, 0).reshape(n * T, L))


def _carry_term(N, R):
    """Σ_s R[o][s]·N[l][s] in float32, broadcast over the tiles."""
    return torch.einsum("os,ls->lo", R.float(), N.float())[:, None, :]


def _empty(x, emit: int, L: int, n: int):
    shape = (L, n * TILE) if emit == 0 else (n * TILE, L)
    return torch.empty(shape, device=x.device, dtype=torch.float32)


def _nptr(N):
    return 0 if N is None else N.data_ptr()


def _with_carry(x, N, S, L, n, k):
    """x as (L, n, 128) lines of tiles, with N's carries (padded to ``k``
    rows) appended to every tile's contraction where ``k``."""
    D = x.reshape(L, n, TILE)
    if not k:
        return D
    Nk = torch.nn.functional.pad(N, (0, k - S))[:, None, :]
    return torch.cat([D, Nk.expand(L, n, k)], -1)


def split_mm_plain(x, C, *, nprod: int, emit: int = 0, carry: int = 0,
                   N=None, R=None, stack: bool = False, nt: int = 1,
                   lb: int = TILE) -> torch.Tensor:
    """:func:`split_mm`'s twin, on any device (``stack``, ``nt`` and
    ``lb`` change no value)."""
    S = 0 if N is None else N.shape[1]
    L, n = _geom(x, N, S, nt, lb)
    K = TILE + (16 if carry == 1 else 0)
    D = _with_carry(x, N, S, L, n, 16 if carry == 1 else 0)
    Cf = C[..., :K]
    y = split.pair_sum(nprod, lambda i, d: torch.einsum(
        "ok,lnk->lno", Cf[i].float(), d), D)
    if carry == 2:
        y = y + _carry_term(N, R)
    return _emit(y, emit)


def split_mm(x, C, *, nprod: int, emit: int = 0, carry: int = 0,
             N=None, R=None, stack: bool = False, nt: int = 1,
             lb: int = TILE) -> torch.Tensor:
    """bf16 split products: ``C`` from :func:`bf16_operand` (with the
    carry rows for ``carry=1``), ``R`` (128, S) fp32 for ``carry=2``,
    ``N`` (L, S) the carries."""
    if not x.is_cuda:
        return split_mm_plain(x, C, nprod=nprod, emit=emit, carry=carry,
                              N=N, R=R, stack=stack, nt=nt, lb=lb)
    S = 0 if N is None else N.shape[1]
    L, n = _geom(x, N, S, nt, lb)
    K = TILE + (16 if carry == 1 else 0)
    _check(x, "x", (L, n * TILE), x.device)
    _check(C, "C", (split.nchunks(nprod), TILE, K + 8), x.device,
           torch.bfloat16)
    if carry:
        _check(N, "N", (L, S), x.device)
    if carry == 2:
        _check(R, "R", (TILE, S), x.device)
    y = _empty(x, emit, L, n)
    _launch("split_mm", (
        x.data_ptr(), _nptr(N), _nptr(R) if carry == 2 else 0, C.data_ptr(),
        y.data_ptr(), L, n, nt, lb, S, nprod, emit, carry, int(stack)),
        x.device)
    return y


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to 10 mantissa bits, ties
    away from zero."""
    i = v.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_parts(v):
    big = tf32_round(v)
    return big, tf32_round(v - big)


def split_mm_tf32_plain(x, Bf, *, npass: int, emit: int = 0,
                        carry: int = 0, N=None, nt: int = 1,
                        lb: int = TILE) -> torch.Tensor:
    """:func:`split_mm_tf32`'s twin, on any device."""
    S = 0 if N is None else N.shape[1]
    L, n = _geom(x, N, S, nt, lb)
    D = _with_carry(x, N, S, L, n, MAX_S if carry else 0)
    (db, ds), (bb, bs) = _tf32_parts(D), _tf32_parts(Bf)
    mm = lambda b, d: torch.einsum("ok,lnk->lno", b, d)  # noqa: E731
    y = mm(bb, db)
    if npass == 3:  # smallest first, as the kernel sums them
        y = mm(bb, ds) + mm(bs, db) + y
    return _emit(y, emit)


def split_mm_tf32(x, Bf, *, npass: int, emit: int = 0, carry: int = 0,
                  N=None, nt: int = 1, lb: int = TILE) -> torch.Tensor:
    """1xTF32 (``npass=1``) or 3xTF32 (big·big + big·small + small·big)
    products: ``Bf`` from :func:`tf32_operand`, the carry in the
    contraction for ``carry=1``."""
    if not x.is_cuda:
        return split_mm_tf32_plain(x, Bf, npass=npass, emit=emit,
                                   carry=carry, N=N, nt=nt, lb=lb)
    S = 0 if N is None else N.shape[1]
    L, n = _geom(x, N, S, nt, lb)
    K = TILE + (MAX_S if carry else 0)
    _check(x, "x", (L, n * TILE), x.device)
    _check(Bf, "Bf", (TILE, K), x.device)
    if carry:
        _check(N, "N", (L, S), x.device)
    y = _empty(x, emit, L, n)
    _launch("split_mm_tf32", (
        x.data_ptr(), _nptr(N), Bf.data_ptr(), y.data_ptr(), L, n, nt, lb,
        S, npass, emit, carry), x.device)
    return y


def split_mm_fp32_plain(x, Bk, *, emit: int = 0, carry: int = 0, N=None,
                        nt: int = 1, lb: int = TILE) -> torch.Tensor:
    """:func:`split_mm_fp32`'s twin, on any device."""
    S = 0 if N is None else N.shape[1]
    L, n = _geom(x, N, S, nt, lb)
    D = _with_carry(x, N, S, L, n, MAX_S if carry else 0)
    return _emit(torch.einsum("ko,lnk->lno", Bk, D), emit)


def split_mm_fp32(x, Bk, *, emit: int = 0, carry: int = 0, N=None,
                  nt: int = 1, lb: int = TILE) -> torch.Tensor:
    """fp32 FMA products: ``Bk`` from :func:`fp32_operand`, the carry
    rows in the contraction for ``carry=1``."""
    if not x.is_cuda:
        return split_mm_fp32_plain(x, Bk, emit=emit, carry=carry, N=N,
                                   nt=nt, lb=lb)
    S = 0 if N is None else N.shape[1]
    L, n = _geom(x, N, S, nt, lb)
    K = TILE + (MAX_S if carry else 0)
    _check(x, "x", (L, n * TILE), x.device)
    _check(Bk, "Bk", (K, TILE), x.device)
    if carry:
        _check(N, "N", (L, S), x.device)
    y = _empty(x, emit, L, n)
    _launch("split_mm_fp32", (
        x.data_ptr(), _nptr(N), Bk.data_ptr(), y.data_ptr(), L, n, nt, lb,
        S, emit, carry), x.device)
    return y
