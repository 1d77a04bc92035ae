"""The banded tile-FIR pass and its plain twin: small-support separable FIR
banks (the box and difference-of-Gaussians filters) in one read and one
write of the lines.

:class:`FirBand` (``csrc/fir_band.cu``) applies a zero-padded FIR bank
along the last axis: out[τ] = Wm·x[τ−1] + W0·x[τ] + Wp·x[τ+1] per 128-wide
tile τ, with W the (T, T) blocks of the banded Toeplitz operator
(:func:`band_blocks`) and zero tiles past either end. A plain pass (one
channel), a bank (1 → C channels, a leading C axis) and a signed contraction
(C → 1, the signs folded into the taps) ride one module; ``rot`` emits each
channel transposed. Lines of any length L run: the twin zero-pads L to the
tile grid and crops, the kernel masks its loads and stores.

``nprod`` is the grade's product count, as the JAX package's
``fir_band_pass`` takes it: at 6 (px6, f32x6) the kernel sums the float32
taps directly in fp32 FMAs; at 1, 3 and 4 (default, px3/f32x3, px4/f32x4)
it sums the JAX package's split-bf16 chunk products — bf16 chunks of x
(split on chip) times bf16 chunks of the taps (split on the host), each
product exact in float32, over :func:`.split.prods`. With ``tap_scale``
(the iterated boxes' (2B+1)^n) a channel whose scaled taps are exact bf16
integers (:func:`exact_band`) has one tap chunk: it takes only the pairs
(0, j), then one multiply by the inverse scale.

A bf16 x (the JAX package's bf16 band: one product whatever the grade)
runs at ``nprod`` 1 on ``fir_band_bf16``: x read as bf16 (its one chunk
is itself), the one bf16 tap chunk, fp32 sums, y bf16, each output
rounded once; the twin is the float32 band at nprod 1 on ``x.float()``,
rounded once.

``forward`` launches the CUDA kernel for a CUDA tensor (through
:class:`.launch._KernelFn`, whose backward is the VJP of the float32 band
product: the pass is linear) and runs the plain PyTorch twin for a CPU
tensor; ``plain`` is the twin — at px6 the JAX package's einsum twin
``_ref``, at the other grades its chunk products in float32
(:func:`.split.pair_sum`) — the reference the kernel is held against. The
kernel sums the taps directly rather than forming the tile GEMMs
(``csrc/fir_band.cu``); both are fp32 sums.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import split
from .launch import _check, _KernelFn, _launch

TILE = 128  # the JAX kernel's tile width, which its gate requires
_RUN = 8    # the kernel's register run: taps are padded to a multiple
_NPAIR = 4  # the most chunk pairs a channel takes below px6 (px4)
# what the kernel stages per block (csrc/fir_band.cu): tap values, and the
# channels whose pair lists it holds below px6
_MAX_TAPS, _MAX_CH = 4096, 64


def band_blocks(taps: np.ndarray, T: int) -> np.ndarray:
    """(Wm, W0, Wp): the (T, T) blocks of the banded Toeplitz operator
    out[o] = Σ_τ taps[τ]·x[o+τ−P] on tiles of width T, as one (3, T, T)
    stack ordered [prev, cur, next]. Requires P, Q ≤ T."""
    taps = np.asarray(taps, np.float64)
    K = len(taps)
    P = (K - 1) // 2
    Q = K - 1 - P
    if P > T or Q > T:
        raise ValueError("FIR support exceeds the one-tile band")
    W = np.zeros((3, T, T), np.float64)
    for o in range(T):
        for t in range(K):
            g = T + o + t - P  # input lane in the 3-tile window
            W[g // T, o, g % T] = taps[t]
    return W


def fir_band_ok(T: int, L: int, taps, q: int) -> bool:
    """The JAX package's static gate: the 128-wide tile, band within one
    tile each way, at least 8 lines and at least one tile of length."""
    taps = np.atleast_2d(np.asarray(taps))
    K = taps.shape[1]
    P = (K - 1) // 2
    return T == TILE and max(P, K - 1 - P) <= T and q >= 8 and L >= T


def _exact_bf16(v) -> bool:
    """True when every entry of ``v`` is exactly bf16-representable (a
    round trip through torch's bfloat16: a value bf16 holds survives any
    rounding path, one it does not hold never returns)."""
    v = np.asarray(v, np.float64)
    back = torch.from_numpy(v).to(torch.bfloat16).double().numpy()
    return bool(np.all(back == v))


def exact_band(taps, tap_scale, C: int):
    """The JAX package's per-channel exact-integer band decision.

    Returns (taps_k, inv_s, exact_flags): for channels whose ``taps·scale``
    snaps to exactly-bf16 integers (the f64 taps carry ~1e-13 convolution
    noise around their rational values m/(2B+1)^n — snap first), taps_k
    holds the scaled integers and inv_s the inverse scale; other channels
    keep their raw taps (inv_s 1.0). None when no channel qualifies or no
    scale was given. Channels are decided independently: DoG's B = 5
    radius takes the reduced pairs though B = 9's numerators exceed bf16's
    exact integers."""
    if tap_scale is None:
        return None
    taps = np.atleast_2d(np.asarray(taps, np.float64))
    s = np.broadcast_to(np.asarray(tap_scale, np.float64), (C,)).copy()
    taps_k = taps.copy()
    inv_s = [1.0] * C
    exact = [False] * C
    for c in range(C):
        t_scaled = taps[c] * s[c]
        t_snap = np.rint(t_scaled)
        close = np.max(np.abs(t_scaled - t_snap)) <= 1e-6 * max(
            1.0, float(np.max(np.abs(t_snap))))
        if close and _exact_bf16(t_snap):
            taps_k[c] = t_snap
            inv_s[c] = float(1.0 / s[c])
            exact[c] = True
    if not any(exact):
        return None
    return taps_k, inv_s, exact


class FirBand(nn.Module):
    """``fir_band_pass``: the banded FIR along the last axis of ``x``.

    ``x``: (q, L), or (C, q, L) with ``contract`` (the channels are summed).
    ``taps``: (C, K) rows — C output channels unless ``contract``; ``signs``
    (C,) multiply the rows. Returns (L, q) / (C, L, q) when ``rot`` else
    (q, L) / (C, q, L); the channel axis only for a bank of C > 1.
    ``nprod`` (6, 4, 3 or 1) and ``tap_scale`` (scalar or per channel,
    read below px6 only): the module docstring. ``pairs[c]`` lists channel
    c's chunk pairs (tap chunk, x chunk), ``inv_s[c]`` its inverse scale;
    ``npair`` is the most pairs a channel takes, the kernel's tap rows per
    channel. ``fits`` says whether the kernel stages the bank (its taps'
    chunks and pair lists); a caller routes a bank that does not fit
    elsewhere, as ``fir.FirPass`` does."""

    def __init__(self, taps, *, T: int = TILE, rot: bool = False,
                 contract: bool = False, signs=None, nprod: int = 6,
                 tap_scale=None):
        super().__init__()
        taps = np.atleast_2d(np.asarray(taps, np.float64))
        if signs is not None:
            taps = taps * np.asarray(signs, np.float64)[:, None]
        if nprod not in (1, 3, 4, 6):
            raise ValueError(f"nprod {nprod}: the band pass runs 6, 4, 3 or "
                             "1 products")
        C, K = taps.shape
        self.T, self.rot, self.contract = int(T), bool(rot), bool(contract)
        self.nprod = int(nprod)
        self.Cin, self.Cout = (C, 1) if contract else (1, C)
        self.P = (K - 1) // 2
        self.Kpad = -(-K // _RUN) * _RUN
        # the twin's band blocks of the float32 product (also the
        # backward's map, at every grade)
        self.register_buffer("W", torch.from_numpy(np.stack(
            [band_blocks(t, self.T) for t in taps]).astype(np.float32)))
        if nprod == 6:
            self.pairs, self.inv_s, self.npair = [[(0, 0)]] * C, [1.0] * C, 1
            self.fits = C * self.Kpad <= _MAX_TAPS
            tk = np.zeros((C, self.Kpad), np.float32)
            tk[:, :K] = taps
            self.register_buffer("taps_k", torch.from_numpy(tk))
            return
        # the JAX package's pairs: generic, or (0, j) on an exact channel
        nc = split.nchunks(nprod)
        exact = exact_band(taps, tap_scale, C) if nc > 1 else None
        gen = split.prods(nprod)
        red = [(0, j) for j in range(nc)]
        taps_s, self.inv_s, flags = exact or (taps, [1.0] * C, [False] * C)
        self.pairs = [red if f else gen for f in flags]
        self.npair = max(len(p) for p in self.pairs)
        self.fits = (C * self.npair * self.Kpad <= _MAX_TAPS
                     and C <= _MAX_CH)
        chunks = [split.split_const(t, nc) for t in taps_s]
        # kernel operands: per channel and pair slot the tap chunk (zero
        # past K), the pair count and x chunks, the inverse scale
        tk = np.zeros((C, self.npair, self.Kpad), np.float32)
        meta = np.zeros((C, 1 + _NPAIR), np.int32)
        for c, pairs in enumerate(self.pairs):
            meta[c, 0] = len(pairs)
            for p, (i, j) in enumerate(pairs):
                tk[c, p, :K] = chunks[c][i].float().numpy()
                meta[c, 1 + p] = j
        self.register_buffer("taps_k", torch.from_numpy(tk))
        self.register_buffer("meta_k", torch.from_numpy(meta))
        self.register_buffer("scale_k", torch.tensor(self.inv_s,
                                                     dtype=torch.float32))
        # the twin's band blocks of each tap chunk
        self.register_buffer("Wc", torch.from_numpy(np.stack(
            [np.stack([band_blocks(ch.double().numpy(), self.T)
                       for ch in cc]) for cc in chunks]).astype(np.float32)))

    def _lines(self, x):
        """(q, L) of ``x``, checking the channel axis of a contraction."""
        if self.contract:
            if x.ndim != 3 or x.shape[0] != self.Cin:
                raise ValueError(f"contraction over {self.Cin} channels "
                                 f"needs x (C, q, L), got {tuple(x.shape)}")
            return x.shape[1:]
        if x.ndim != 2:
            raise ValueError(f"x must be (q, L), got {tuple(x.shape)}")
        return x.shape

    def _band(self, W, x):
        """The band product of the (3, T, T) blocks ``W`` with the lines
        ``x`` (..., L), zero-padded to the tile grid: (..., n·T)."""
        T, L = self.T, x.shape[-1]
        n = -(-L // T)
        Xt = F.pad(x, (0, n * T - L)).reshape(*x.shape[:-1], n, T)
        zt = torch.zeros_like(Xt[..., :1, :])
        prv = torch.cat([zt, Xt[..., :-1, :]], dim=-2)
        nxt = torch.cat([Xt[..., 1:, :], zt], dim=-2)
        t = (torch.einsum("ot,...nt->...no", W[1], Xt)
             + torch.einsum("ot,...nt->...no", W[0], prv)
             + torch.einsum("ot,...nt->...no", W[2], nxt))
        return t.reshape(*x.shape[:-1], n * T)

    def _emit(self, outs, q, L):
        y = [o[..., :L] for o in outs]
        y = y[0] if self.Cout == 1 else torch.stack(y)
        return y.transpose(-1, -2).contiguous() if self.rot else y

    def _twin(self, x):
        """The float32 band product (the JAX package's ``_ref``): linear,
        the backward's map; at px6 the CPU's twin."""
        q, L = self._lines(x)
        outs = []
        for co in range(self.Cout):
            acc = None
            for ci in range(self.Cin):
                t = self._band(self.W[co * self.Cin + ci],
                               x[ci] if self.contract else x)
                acc = t if acc is None else acc + t
            outs.append(acc)
        return self._emit(outs, q, L)

    def _bf16_ok(self, x) -> bool:
        """Whether ``x`` is bf16 (which runs at one product only)."""
        if x.dtype != torch.bfloat16:
            return False
        if self.nprod != 1:
            raise TypeError(f"a bf16 x runs the band at one product, not "
                            f"{self.nprod}")
        return True

    def plain(self, x):
        """The twin the CPU runs: the float32 product at px6; below it each
        channel's chunk pairs in float32 (:func:`.split.pair_sum`), times
        its inverse scale, summed over a contraction's channels; a bf16 x
        that on ``x.float()``, rounded once to bf16."""
        if self._bf16_ok(x):
            return self.plain(x.float()).to(torch.bfloat16)
        if self.nprod == 6:
            return self._twin(x)
        q, L = self._lines(x)
        outs = []
        for co in range(self.Cout):
            acc = None
            for ci in range(self.Cin):
                c = co * self.Cin + ci
                t = split.pair_sum(
                    self.nprod, lambda i, d, c=c: self._band(self.Wc[c, i], d),
                    x[ci] if self.contract else x, pairs=self.pairs[c])
                if self.inv_s[c] != 1.0:
                    t = t * self.inv_s[c]
                acc = t if acc is None else acc + t
            outs.append(acc)
        return self._emit(outs, q, L)

    def _kernel(self, x):
        q, L = self._lines(x)
        bf16 = self._bf16_ok(x)
        _check(x, "x", x.shape, x.device, x.dtype if bf16 else torch.float32)
        _check(self.taps_k, "taps_k", self.taps_k.shape, x.device)
        meta = scale = 0
        if self.nprod != 6:
            _check(self.meta_k, "meta_k", self.meta_k.shape, x.device,
                   torch.int32)
            _check(self.scale_k, "scale_k", self.scale_k.shape, x.device)
            meta, scale = self.meta_k.data_ptr(), self.scale_k.data_ptr()
        if not (0 < -(-q // 32) < 2**31 and 0 < -(-L // 128) < 65536):
            raise ValueError(f"fir_band: {q} lines x {L} positions outside "
                             "the launch grid")
        chan = (self.Cout,) if self.Cout > 1 else ()
        y = torch.empty(chan + ((L, q) if self.rot else (q, L)),
                        device=x.device, dtype=x.dtype)
        args = (x.data_ptr(), self.taps_k.data_ptr(), meta, scale,
                y.data_ptr(), q, L, self.Cin, self.Cout, self.Kpad, self.P,
                int(self.rot))
        if bf16:
            _launch("fir_band_bf16", args + (self.npair,), x.device)
        else:
            _launch("fir_band", args + (self.nprod, self.npair), x.device)
        return y

    def forward(self, x):
        if x.is_cuda:
            return _KernelFn.apply(self, x)
        return self.plain(x)
