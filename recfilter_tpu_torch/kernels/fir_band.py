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

``forward`` launches the CUDA kernel for a CUDA tensor (through
:class:`.launch._KernelFn`, whose backward is the twin's VJP: the pass is
linear) and runs the plain PyTorch twin for a CPU tensor; ``plain`` is the
twin — the JAX package's einsum twin ``_ref`` — the reference the kernel is
held against. The kernel sums the taps directly rather than forming the
tile GEMMs (``csrc/fir_band.cu``); both are fp32 sums.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .launch import _check, _KernelFn, _launch

TILE = 128  # the JAX kernel's tile width, which its gate requires
_RUN = 8    # the kernel's register run: taps are padded to a multiple


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


class FirBand(nn.Module):
    """``fir_band_pass``: the banded FIR along the last axis of ``x``.

    ``x``: (q, L), or (C, q, L) with ``contract`` (the channels are summed).
    ``taps``: (C, K) rows — C output channels unless ``contract``; ``signs``
    (C,) multiply the rows. Returns (L, q) / (C, L, q) when ``rot`` else
    (q, L) / (C, q, L); the channel axis only for a bank of C > 1."""

    def __init__(self, taps, *, T: int = TILE, rot: bool = False,
                 contract: bool = False, signs=None):
        super().__init__()
        taps = np.atleast_2d(np.asarray(taps, np.float64))
        if signs is not None:
            taps = taps * np.asarray(signs, np.float64)[:, None]
        C, K = taps.shape
        self.T, self.rot, self.contract = int(T), bool(rot), bool(contract)
        self.Cin, self.Cout = (C, 1) if contract else (1, C)
        self.P = (K - 1) // 2
        self.Kpad = -(-K // _RUN) * _RUN
        tk = np.zeros((C, self.Kpad), np.float32)
        tk[:, :K] = taps
        self.register_buffer("taps_k", torch.from_numpy(tk))  # kernel operand
        self.register_buffer("W", torch.from_numpy(np.stack(  # twin operand
            [band_blocks(t, self.T) for t in taps]).astype(np.float32)))

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

    def plain(self, x):
        q, L = self._lines(x)
        T = self.T
        n = -(-L // T)
        Xt = F.pad(x, (0, n * T - L)).reshape(*x.shape[:-1], n, T)
        zt = torch.zeros_like(Xt[..., :1, :])
        prv = torch.cat([zt, Xt[..., :-1, :]], dim=-2)
        nxt = torch.cat([Xt[..., 1:, :], zt], dim=-2)
        outs = []
        for co in range(self.Cout):
            acc = None
            for ci in range(self.Cin):
                c = co * self.Cin + ci
                sel = (lambda v, ci=ci: v[ci]) if self.contract else (
                    lambda v: v)
                Wb = self.W[c]
                t = (torch.einsum("ot,qnt->qno", Wb[1], sel(Xt))
                     + torch.einsum("ot,qnt->qno", Wb[0], sel(prv))
                     + torch.einsum("ot,qnt->qno", Wb[2], sel(nxt)))
                acc = t if acc is None else acc + t
            outs.append(acc.reshape(q, n * T)[:, :L])
        y = outs[0] if self.Cout == 1 else torch.stack(outs)
        return y.transpose(-1, -2).contiguous() if self.rot else y

    def _kernel(self, x):
        q, L = self._lines(x)
        _check(x, "x", x.shape, x.device)
        _check(self.taps_k, "taps_k", self.taps_k.shape, x.device)
        if not (0 < -(-q // 32) < 2**31 and 0 < -(-L // 128) < 65536):
            raise ValueError(f"fir_band: {q} lines x {L} positions outside "
                             "the launch grid")
        chan = (self.Cout,) if self.Cout > 1 else ()
        y = torch.empty(chan + ((L, q) if self.rot else (q, L)),
                        device=x.device)
        _launch("fir_band", (
            x.data_ptr(), self.taps_k.data_ptr(), y.data_ptr(),
            q, L, self.Cin, self.Cout, self.Kpad, self.P, int(self.rot)),
            x.device)
        return y

    def forward(self, x):
        if x.is_cuda:
            return _KernelFn.apply(self, x)
        return self.plain(x)
