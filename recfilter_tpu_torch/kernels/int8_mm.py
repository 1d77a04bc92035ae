"""The int8 and bf16 probes of the JAX package's ``scripts/`` as H100
studies: the wrappers of ``csrc/ozaki.cu`` and ``csrc/gemm_pair.cu`` and
their plain twins. None of them is on an executor's path.

**The dual completion** (``scripts/int8_ozaki_exp.py``): the A-dot and the
per-sub-tile B-dot of the 3-touch executor's final pass with no carries,
on x (P, na, 128, W) — for each 128-row block a,

    z = Ba · x[a]                      (128 × 128 by 128 × W)
    y[:, c] = z[:, c] · Bbᵀ            (each 128-wide sub-tile c)

by two product schemes:

  * :func:`ozaki_i8` (``int8_ozaki_exp.py:249``, kernel ``k_i8``) — int8
    Ozaki slicing. x takes one power-of-two scale per 128 × Lb block (Lb
    2048, or W where 2048 does not divide it) from the block's |max|
    (:func:`exp_scale`, the script's ``_exp_scale``), each z sub-tile one
    of its own; four 7-bit slices by round-to-nearest residuals
    (:func:`slice_int8`). The constants are sliced on the host
    (:func:`int8_const`, the script's ``_int8_const_np``: one scale, four
    slices) and each level's slices stand side by side along K
    (:func:`ozaki_operand`, (128, 10·128) int8). Level d = i + j ≤ 3 is
    one exact int32 sum of the products Bᵢ·sⱼ, converted to float32 and
    scaled by 2^(15−7d); the levels add in float32 from d = 0, then the
    two block scales multiply in.
  * :func:`dual_px6` (``int8_ozaki_exp.py:159``, kernel ``k_px6``) — six
    split-bf16 products of 3-chunk splits, the pairs of
    :func:`.split.prods` (6) smallest first, fp32 sums.

**The GEMM pair** (``scripts/int8_rate_probe.py``): C = A·B at one tiling
for both products, B passed transposed (``bt`` (N, K), K contiguous):

  * :func:`gemm_i8` (``int8_rate_probe.py:53``, ``k_int8``): int8 × int8 →
    int32 sums, ``>> 13`` and the low 8 bits stored (``raw=True``: the
    int32 sums);
  * :func:`gemm_bf16` (``int8_rate_probe.py:77``, ``k_bf16``): bf16 × bf16
    → fp32 sums, stored bf16.

Each wrapper runs its twin for a CPU tensor and launches its kernel for a
CUDA tensor. The twins compute the same arithmetic on any device: the
int8 products as float64 products of the integer slices (every level sum
is an integer below 2³¹, so float64 holds it exactly), then the kernel's
float32 steps in its order; the bf16 chunk products summed in float64 and
rounded to float32 once each; the GEMMs' int32 sums as a float64 product
of integers below 2⁵³.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import split
from .launch import _check, _launch

TILE = 128
NS = 4                         # 7-bit slices of a float32 mantissa
LMAX = 3                       # levels i + j ≤ 3: ten products
OFFS = (0, 1, 3, 6, 10)        # level d's slices: columns OFFS[d]·128 ...
LB = 2048                      # x's scale block width, where it divides W


# ---------------------------------------------------------------------------
# Host slicing of the constants
# ---------------------------------------------------------------------------


def int8_const(M, nslices: int = NS) -> Tuple[List[np.ndarray], float]:
    """Four 7-bit int8 slices of a constant and its power-of-two scale eB:
    M = eB · Σᵢ sᵢ · 2^(21−7i) · 2^−27, round-to-nearest residuals in
    float64 (the script's ``_int8_const_np``)."""
    M = np.asarray(M, np.float64)
    m = np.abs(M).max()
    e = int(np.ceil(np.log2(m))) if m > 0 else 0
    eB = 2.0 ** e
    xs = M / eB * (2.0 ** 27)
    slices = []
    for i in range(nslices):
        sh = 2.0 ** (21 - 7 * i)
        s = np.round(xs / sh)
        if np.abs(s).max() > 127:
            raise ValueError(f"slice {i} leaves int8: {np.abs(s).max()}")
        slices.append(s.astype(np.int8))
        xs = xs - s * sh
    return slices, eB


def ozaki_operand(M) -> Tuple[torch.Tensor, int]:
    """(C, e): C (128, 10·128) int8, level d's slices [s₀ … s_d] side by
    side at columns OFFS[d]·128 (the script's ``BaCat``), and the
    constant's scale 2^e."""
    slices, eB = int8_const(M)
    levels = [np.concatenate(slices[:d + 1], axis=1) for d in range(LMAX + 1)]
    return (torch.from_numpy(np.ascontiguousarray(
        np.concatenate(levels, axis=1))), int(np.log2(eB)))


def px6_operand(M) -> torch.Tensor:
    """(3, 128, 136) bf16: the three chunks of M (the script's
    ``_split_const_np``), each row padded by 8 zeros (the kernel's row
    stride)."""
    ch = split.split_const(M, 3)
    return torch.nn.functional.pad(torch.stack(ch).float(), (0, 8)).to(
        torch.bfloat16).contiguous()


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def exp_scale(m: torch.Tensor):
    """(up, dn) for a float32 |max| m, by bit arithmetic (the script's
    ``_exp_scale``): with e m's biased exponent clipped to [32, 253],
    up = 2^(153−e), dn = 2^(e−153); |m·up| < 2^27."""
    e = ((m.float().contiguous().view(torch.int32) >> 23) & 0xFF).clamp(32,
                                                                        253)
    return (((280 - e) << 23).view(torch.float32),
            ((e - 26) << 23).view(torch.float32))


def slice_int8(v: torch.Tensor, dims):
    """(dn, [s₀ … s₃]): v = dn · Σᵢ sᵢ · 2^(21−7i), one scale per block
    (the max over ``dims``), the slices integer-valued float32 tensors in
    [−64, 64] (the script's ``_slice_int8``)."""
    m = v.abs().amax(dim=dims, keepdim=True)
    up, dn = exp_scale(m)
    xs = v * up
    out = []
    for i in range(NS):
        sh = 2.0 ** (21 - 7 * i)
        s = torch.round(xs * (1.0 / sh))
        out.append(s)
        if i < NS - 1:
            xs = xs - s * sh
    return dn, out


def _levels(product, A_sl, D_sl):
    """Σ_d 2^(15−7d) · float32(Σ_{i ≤ d} product(Aᵢ, D_{d−i})), the level
    sums exact in float64, added in float32 from d = 0."""
    z = None
    for d in range(LMAX + 1):
        p = None
        for i in range(d + 1):
            t = product(A_sl[i], D_sl[d - i])
            p = t if p is None else p + t
        t = p.float() * (2.0 ** (15 - 7 * d))
        z = t if z is None else z + t
    return z


def _geom(x, Lb=None):
    if x.dim() != 4 or x.shape[2] != TILE or x.shape[3] % TILE:
        raise ValueError(f"x {tuple(x.shape)}: (P, na, 128, W), W a "
                         "multiple of 128")
    W = x.shape[3]
    Lb = Lb or (LB if W % LB == 0 else W)
    if W % Lb or Lb % TILE:
        raise ValueError(f"scale block {Lb} must divide W {W} in tiles")
    return W, Lb


def _const_slices(C, device):
    """The level-3 block of an ozaki operand: its four slices as float64
    (128, 128) tensors."""
    L3 = C[:, OFFS[LMAX] * TILE:].to(device=device, dtype=torch.float64)
    return [L3[:, i * TILE:(i + 1) * TILE] for i in range(NS)]


def ozaki_i8_plain(x, Ca, ea: int, Cb, eb: int, Lb=None) -> torch.Tensor:
    """:func:`ozaki_i8`'s twin, on any device."""
    W, Lb = _geom(x, Lb)
    P, na = x.shape[:2]
    nl, nb = W // Lb, W // TILE
    A_sl, B_sl = _const_slices(Ca, x.device), _const_slices(Cb, x.device)
    xb = x.float().reshape(P, na, TILE, nl, Lb)
    dnx, xs = slice_int8(xb, (2, 4))
    z = _levels(lambda B, s: torch.einsum("os,pasld->paold", B, s.double()),
                A_sl, xs)
    z = z * (dnx * 2.0 ** ea)
    zb = z.reshape(P, na, TILE, nb, TILE)
    dnz, zs = slice_int8(zb, (2, 4))
    y = _levels(lambda B, s: torch.einsum("pasct,ot->pasco", s.double(), B),
                B_sl, zs)
    return (y * (dnz * 2.0 ** eb)).reshape(P, na, TILE, W)


def dual_px6_plain(x, Ac, Bc) -> torch.Tensor:
    """:func:`dual_px6`'s twin, on any device: each chunk product summed
    in float64 and rounded to float32 once, the six added in float32
    smallest first. (A float32 sum of the 128 terms of a product lies
    ~5e-7 of the peak off the f64 product on the CPU, past the scheme's
    own ~1.5e-7: the twin keeps only the scheme's error.)"""
    _geom(x)
    P, na, _, W = x.shape
    A = Ac[..., :TILE].to(x.device).double()
    B = Bc[..., :TILE].to(x.device).double()
    z = split.pair_sum(6, lambda i, d: torch.einsum(
        "os,pasw->paow", A[i], d.double()).float(), x.float())
    zt = z.reshape(P, na, TILE, W // TILE, TILE)
    y = split.pair_sum(6, lambda i, d: torch.einsum(
        "pasct,ot->pasco", d.double(), B[i]).float(), zt)
    return y.reshape(P, na, TILE, W)


def gemm_i8_plain(a, bt, raw: bool = False) -> torch.Tensor:
    """:func:`gemm_i8`'s twin, on any device: the int32 sums from a
    float64 product of integers (exact below 2⁵³), then ``>> 13`` and the
    low 8 bits."""
    c = torch.matmul(a.double(), bt.double().t()).to(torch.int64)
    return c.to(torch.int32) if raw else (c >> 13).to(torch.int8)


def gemm_bf16_plain(a, bt) -> torch.Tensor:
    """:func:`gemm_bf16`'s twin, on any device: float32 products of the
    upcast operands, rounded to bf16."""
    return torch.matmul(a.float(), bt.float().t()).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Wrappers: the twin for a CPU tensor, the kernel for a CUDA tensor
# ---------------------------------------------------------------------------


def ozaki_i8(x, Ca, ea: int, Cb, eb: int, Lb=None) -> torch.Tensor:
    """y = (Ba·x)·Bbᵀ per sub-tile by int8 Ozaki slicing; ``Ca``, ``Cb``
    and their scale exponents from :func:`ozaki_operand`."""
    if not x.is_cuda:
        return ozaki_i8_plain(x, Ca, ea, Cb, eb, Lb)
    W, Lb = _geom(x, Lb)
    P, na = x.shape[:2]
    _check(x, "x", x.shape, x.device)
    for name, C in (("Ca", Ca), ("Cb", Cb)):
        _check(C, name, (TILE, OFFS[-1] * TILE), x.device, torch.int8)
    mx = torch.empty((P * na, W // TILE), dtype=torch.int32, device=x.device)
    y = torch.empty_like(x)
    _launch("ozaki_i8", (x.data_ptr(), mx.data_ptr(), Ca.data_ptr(),
                         Cb.data_ptr(), y.data_ptr(), P * na, W,
                         Lb // TILE, int(ea), int(eb)), x.device)
    return y


def dual_px6(x, Ac, Bc) -> torch.Tensor:
    """y = (Ba·x)·Bbᵀ per sub-tile as six split-bf16 products; ``Ac``,
    ``Bc`` from :func:`px6_operand`."""
    if not x.is_cuda:
        return dual_px6_plain(x, Ac, Bc)
    _geom(x)
    P, na, _, W = x.shape
    _check(x, "x", x.shape, x.device)
    for name, C in (("Ac", Ac), ("Bc", Bc)):
        _check(C, name, (3, TILE, TILE + 8), x.device, torch.bfloat16)
    y = torch.empty_like(x)
    _launch("dual_px6", (x.data_ptr(), Ac.data_ptr(), Bc.data_ptr(),
                         y.data_ptr(), P * na, W), x.device)
    return y


def _gemm_geom(a, bt, dtype):
    M, K = a.shape
    N = bt.shape[0]
    kb = K * a.element_size()
    if M % TILE or N % TILE or kb % 64 or bt.shape[1] != K:
        raise ValueError(f"a {tuple(a.shape)}, bt {tuple(bt.shape)}: M, N "
                         "multiples of 128, K of 64 bytes")
    _check(a, "a", (M, K), a.device, dtype)
    _check(bt, "bt", (N, K), a.device, dtype)
    return M, N, K


def gemm_i8(a, bt, raw: bool = False) -> torch.Tensor:
    """int8 (M, K) · int8 (N, K)ᵀ → int32 sums → ``>> 13`` → int8 (M, N);
    ``raw``: the int32 sums."""
    if not a.is_cuda:
        return gemm_i8_plain(a, bt, raw)
    M, N, K = _gemm_geom(a, bt, torch.int8)
    c = torch.empty((M, N), dtype=torch.int32 if raw else torch.int8,
                    device=a.device)
    _launch("gemm_i8", (a.data_ptr(), bt.data_ptr(), c.data_ptr(), M, N, K,
                        int(raw)), a.device)
    return c


def gemm_bf16(a, bt) -> torch.Tensor:
    """bf16 (M, K) · bf16 (N, K)ᵀ → fp32 sums → bf16 (M, N)."""
    if not a.is_cuda:
        return gemm_bf16_plain(a, bt)
    M, N, K = _gemm_geom(a, bt, torch.bfloat16)
    c = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    _launch("gemm_bf16", (a.data_ptr(), bt.data_ptr(), c.data_ptr(), M, N,
                          K), a.device)
    return c
