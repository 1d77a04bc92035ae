"""Wrapping-integer unit scans: the summed-area-table class of integer
filters, bit-exact, at device-memory speed.

The integer filters the reference ships (summed-area tables, integral
images, box via SAT) are unit-feedback scans once their coefficients are
cast into the image type: order 1, feedback a ∈ {+1, −1}, one integer
feed-forward tap f. For those, wrap-around modulo 2³² is the exact
semantics, so a dimension is a chain of additive scans (JAX package:
``recfilter_tpu/kernels/int_scan.py``):

    a = +1:  y = cumsum(f·x)               (a suffix sum when anticausal)
    a = −1:  y = D · cumsum(D · f·x),      D = diag((−1)^i), i global

int8 and int16 ride the same 32-bit arithmetic: the low k bits of the
mod-2³² result are the mod-2^k result.

:func:`int_unit_dim_pass` runs all unit scans of one axis, routed by the
JAX package's gates: up to 65,536 on the last axis and 4,096 on any other,
one launch of the full-extent ``int_scan`` kernel (``csrc/int_scan.cu``)
for every 8 scans; beyond them, per scan, the segmented route
(:func:`_segmented_unit_scan`): the ``int_seg_carries`` phase (each
chunk's exit value), the carry chain as torch ops on the tiny carries, and
the ``int_seg_fix`` phase (``csrc/int_seg_scan.cu``). A CUDA tensor
launches the kernels; a CPU tensor runs their plain twins, which compute
in int64 and mask to 32 bits explicitly rather than rely on a library
op's overflow. Integer scans have no gradient.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .launch import _check, _launch

INT_DTYPES = (torch.int8, torch.int16, torch.int32)
_MASK = 0xFFFFFFFF
_LANE_MAX = 65536   # full-extent gate on the last axis (the JAX package's
_SUB_MAX = 4096     # VMEM budget / 12 B per element) and on any other axis
_SEG_C = 4096       # the segmented route's largest chunk
_MAX_UNITS = 8      # unit scans per full-extent launch


def unit_scans_of(scan) -> list | None:
    """Decompose an (image-type-cast) scan into chained unit scans
    ``[(f, ±1, causal), ...]``, else None.

    Order 1 with feedback ±1 maps directly. Higher orders qualify when the
    feedback polynomial 1 − Σ aⱼ zʲ factors as (1−z)^m (1+z)^(k−m) — all
    roots ±1, e.g. (2, −1) = double integration — each factor one chained
    scan. Checked by exact integer reconstruction, not root-finding. The
    feed-forward tap must be a single integer; it rides the first factor."""
    fb = np.asarray(scan.feedback, np.float64).reshape(-1)
    ff = np.asarray(scan.feedfwd, np.float64).reshape(-1)
    if ff.shape != (1,):
        return None
    if ff[0] != np.round(ff[0]) or not (-(2 ** 31) <= ff[0] < 2 ** 31):
        return None
    k = fb.shape[0]
    if not 1 <= k <= 8 or np.any(fb != np.round(fb)):
        return None
    target = np.concatenate([[1.0], -fb])
    f, causal = int(ff[0]), bool(scan.causal)
    for m in range(k + 1):
        poly = np.array([1.0])
        for _ in range(m):
            poly = np.convolve(poly, [1.0, -1.0])
        for _ in range(k - m):
            poly = np.convolve(poly, [1.0, 1.0])
        if np.array_equal(poly, target):
            out = [(1, 1, causal)] * m + [(1, -1, causal)] * (k - m)
            out[0] = (f, out[0][1], causal)  # the tap rides ONE factor
            return out
    return None


# ---------------------------------------------------------------------------
# Plain twins: int64 tensors holding values of the ring Z/2³² in [0, 2³²)
# ---------------------------------------------------------------------------


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _MASK


def _wrap(v: torch.Tensor, dtype) -> torch.Tensor:
    """Ring values → ``dtype`` (int8/16/32): the low bits, two's
    complement."""
    bits = torch.iinfo(dtype).bits
    v = v & ((1 << bits) - 1)
    return torch.where(v >= 1 << (bits - 1), v - (1 << bits), v).to(dtype)


def _parity(E: int, axis: int, ndim: int, device, shift: int = 0):
    """(−1)^(i + shift) along ``axis`` of an ``ndim``-D array, broadcastable."""
    i = torch.arange(E, device=device) + shift
    shape = [1] * ndim
    shape[axis] = E
    return (1 - 2 * (i & 1)).reshape(shape)


def _scan_ring(v, unit, axis: int):
    """One unit scan along ``axis`` of ring values ``v``; the parity runs
    from index 0 of ``axis``. Every product and sum stays below 2⁶³
    (|f| < 2³¹, extents < 2³¹) and is masked back to 32 bits."""
    f, sgn, causal = unit
    E = v.shape[axis]
    par = _parity(E, axis, v.ndim, v.device) if sgn < 0 else None
    if par is not None:
        v = (v * par) & _MASK
    if f != 1:
        v = (v * f) & _MASK
    if causal:
        v = torch.cumsum(v, axis) & _MASK
    else:
        v = torch.cumsum(v.flip(axis), axis).flip(axis) & _MASK
    return (v * par) & _MASK if par is not None else v


def unit_scans_plain(x: torch.Tensor, scans, axis: int) -> torch.Tensor:
    """The twin of :func:`int_unit_dim_pass`: ``scans`` in order along
    ``axis`` of ``x``, returned in ``x``'s dtype."""
    v = _u32(x)
    for unit in scans:
        v = _scan_ring(v, unit, axis)
    return _wrap(v, x.dtype)


# ---------------------------------------------------------------------------
# Layouts and the kernels
# ---------------------------------------------------------------------------


def _layout(x: torch.Tensor, axis: int):
    """(layout, P, E, W): 0 = the last axis as (rows P, E); 1 = any other
    axis as (P, E, W)."""
    E = x.shape[axis]
    P = int(np.prod(x.shape[:axis], dtype=np.int64))
    W = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
    return (0, P, E, 1) if axis == x.ndim - 1 else (1, P, E, W)


def _grid_ok(what: str, layout: int, P: int, W: int, n: int = 0) -> None:
    """Raise unless the launch grid holds: (P) or (n, P) blocks on the last
    axis, (W/32, P) or (W/32, n, P) on another; n = 0 is the full-extent
    kernel, n > 0 a segmented phase over n chunks."""
    if layout == 0:
        ok = 0 < P < (2**31 if n == 0 else 65536) and n < 2**31
    else:
        ok = 0 < P < 65536 and n < 65536 and 0 < -(-W // 32) < 2**31
    if not ok:
        raise ValueError(f"{what}: {P} lines x {n} chunks x {W} lanes "
                         "outside the launch grid")


def _full_kernel(x: torch.Tensor, scans, axis: int) -> torch.Tensor:
    """All ``scans`` along ``axis`` in one pass: the ``int_scan`` kernel,
    one launch per 8 scans."""
    layout, P, E, W = _layout(x, axis)
    _check(x, "x", x.shape, x.device, INT_DTYPES)
    _grid_ok("int_scan", layout, P, W)
    y = torch.empty_like(x)
    src = x
    for k in range(0, len(scans), _MAX_UNITS):
        units = np.asarray(scans[k:k + _MAX_UNITS], np.int32).reshape(-1)
        _launch("int_scan", (
            src.data_ptr(), y.data_ptr(), units.ctypes.data,
            layout, P, E, W, x.element_size(), len(units) // 3), x.device)
        src = y
    return y


def _chunk_len(E: int) -> int:
    """The segmented route's chunk C: a multiple of 128 (hence even, so
    a^C = 1) that divides E where one ≤ 4096 does, else 4096."""
    for cand in range(_SEG_C, 255, -128):
        if E % cand == 0:
            return cand
    return _SEG_C


def _chunked(xr, layout: int, C: int):
    """(P, E) → (P, n, C) or (P, E, W) → (P, n, C, W) ring values, the far
    end zero-padded (exact: zero state propagates zero)."""
    E = xr.shape[1]
    n = -(-E // C)
    v = _u32(xr)
    if layout == 0:
        return F.pad(v, (0, n * C - E)).reshape(v.shape[0], n, C)
    return F.pad(v, (0, 0, 0, n * C - E)).reshape(v.shape[0], n, C, -1)


def seg_carries_plain(xr, unit, layout: int, C: int) -> torch.Tensor:
    """Twin of the ``int_seg_carries`` phase on the (P, E[, W]) view: each
    chunk's local-scan exit value (causal: at the end of the zero-padded
    chunk; anticausal: at its start), int32 (P, n[, W])."""
    v = _scan_ring(_chunked(xr, layout, C), unit, 2)
    return _wrap(v[:, :, C - 1] if unit[2] else v[:, :, 0], torch.int32)


def seg_fix_plain(xr, inc, unit, layout: int, C: int) -> torch.Tensor:
    """Twin of the ``int_seg_fix`` phase: each chunk's local scan plus
    a^(steps from entry)·incoming, in ``xr``'s dtype."""
    f, sgn, causal = unit
    v = _scan_ring(_chunked(xr, layout, C), unit, 2)
    corr = _u32(inc).unsqueeze(2)  # (P, n, 1[, W])
    if sgn < 0:  # (−1)^(i+1) from a causal entry, (−1)^(C−i) = (−1)^i else
        corr = corr * _parity(C, 2, v.ndim, v.device, 1 if causal else 0)
    v = ((v + corr) & _MASK).flatten(1, 2)[:, :xr.shape[1]]
    return _wrap(v, xr.dtype)


def _carry_chain(l: torch.Tensor, causal: bool) -> torch.Tensor:
    """Incoming carry of every chunk from the chunk exits ``l`` (P, n[, W])
    int32: with a^C = 1 a plain exclusive (suffix) sum over the chunk axis,
    in int64 masked to 32 bits."""
    v = _u32(l)
    if causal:
        c = torch.cumsum(v, 1) & _MASK
        inc = F.pad(c.narrow(1, 0, c.shape[1] - 1),
                    (0, 0) * (c.ndim - 2) + (1, 0))
    else:
        c = torch.cumsum(v.flip(1), 1).flip(1) & _MASK
        inc = F.pad(c.narrow(1, 1, c.shape[1] - 1),
                    (0, 0) * (c.ndim - 2) + (0, 1))
    return _wrap(inc, torch.int32).contiguous()


def _seg_args(xr, layout: int, C: int, unit):
    f, sgn, causal = unit
    P, E = xr.shape[0], xr.shape[1]
    W = xr.shape[2] if layout == 1 else 1
    return (layout, P, E, W, xr.element_size(), C, int(f), int(sgn),
            int(causal))


def seg_carries(xr, unit, layout: int, C: int) -> torch.Tensor:
    """The ``int_seg_carries`` phase: kernel on a CUDA tensor, else twin."""
    if not xr.is_cuda:
        return seg_carries_plain(xr, unit, layout, C)
    _check(xr, "x", xr.shape, xr.device, INT_DTYPES)
    n = -(-xr.shape[1] // C)
    _grid_ok("int_seg_carries", layout, xr.shape[0],
             xr.shape[2] if layout else 1, n)
    c = torch.empty((xr.shape[0], n) + tuple(xr.shape[2:]),
                    dtype=torch.int32, device=xr.device)
    _launch("int_seg_carries",
            (xr.data_ptr(), c.data_ptr(), *_seg_args(xr, layout, C, unit)),
            xr.device)
    return c


def seg_fix(xr, inc, unit, layout: int, C: int) -> torch.Tensor:
    """The ``int_seg_fix`` phase: kernel on a CUDA tensor, else twin."""
    if not xr.is_cuda:
        return seg_fix_plain(xr, inc, unit, layout, C)
    _check(xr, "x", xr.shape, xr.device, INT_DTYPES)
    n = -(-xr.shape[1] // C)
    _check(inc, "incoming", (xr.shape[0], n) + tuple(xr.shape[2:]),
           xr.device, torch.int32)
    _grid_ok("int_seg_fix", layout, xr.shape[0],
             xr.shape[2] if layout else 1, n)
    y = torch.empty_like(xr)
    _launch("int_seg_fix", (xr.data_ptr(), inc.data_ptr(), y.data_ptr(),
                            *_seg_args(xr, layout, C, unit)), xr.device)
    return y


def _segmented_unit_scan(x: torch.Tensor, unit, axis: int) -> torch.Tensor:
    """One unit scan over an axis past the full-extent gates: chunk exits
    (kernel), the carry chain (torch, tiny), the re-scan of every chunk
    from its incoming carry (kernel)."""
    layout, P, E, W = _layout(x, axis)
    if P == 0 or W == 0:
        return x
    C = _chunk_len(E)
    xr = x.reshape((P, E) if layout == 0 else (P, E, W))
    inc = _carry_chain(seg_carries(xr, unit, layout, C), unit[2])
    return seg_fix(xr, inc, unit, layout, C).reshape(x.shape)


def int_unit_dim_pass(x: torch.Tensor, scans, axis: int) -> torch.Tensor:
    """All unit scans ``[(f, ±1, causal), ...]`` of one axis of an int8,
    int16 or int32 tensor, exact modulo 2^k, returned in ``x``'s dtype.
    Extents past the JAX package's full-extent gates run the segmented
    route, one scan at a time."""
    if x.dtype not in INT_DTYPES:
        raise TypeError(f"int8, int16 or int32 expected, got {x.dtype}")
    E = x.shape[axis]
    if x.numel() == 0:
        return x
    if E < 2:  # extent-1 scans reduce to the feed-forward taps
        prod = 1
        for f, _, _ in scans:
            prod = (prod * f) & _MASK
        prod -= (1 << 32) if prod >= (1 << 31) else 0  # |x·prod| < 2⁶³
        return x if prod == 1 else _wrap(_u32(x) * prod, x.dtype)
    x = x.contiguous()
    if E > (_LANE_MAX if axis == x.ndim - 1 else _SUB_MAX):
        for unit in scans:
            x = _segmented_unit_scan(x, unit, axis)
        return x
    if x.is_cuda:
        return _full_kernel(x, scans, axis)
    return unit_scans_plain(x, scans, axis)
