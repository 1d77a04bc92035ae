"""Banded tile-FIR executor: small-support separable FIR banks (the JAX
package's ``fir.py``).

An n-times-iterated box of radius B is an FIR of K = 2nB+1 taps (K = 55
for DoG's B2 = 9). Tiling the scanned axis by T, the banded Toeplitz
operator is one T×T block per tile plus two narrow edge strips against the
neighbouring tiles. Border semantics are zero padding — the apps' contract
(the reference zero-pads its input margins before filtering) — so this path
matches the brute-force oracle at every pixel.

Routing follows the JAX package's ``fir_pass_last`` exactly, from the shapes
and the precision alone: at a grade with a band-kernel product count
(:data:`BAND_NPROD`: px6 and f32x6 at 6, px4 and f32x4 at 4, px3 and
f32x3 at 3, ``default`` at 1) on float32, where
``kernels.fir_band.fir_band_ok`` holds (T = 128, band within one tile,
≥ 8 lines, L ≥ T) with at least one batch axis — and only one when the
output is rotated — the pass runs :class:`.kernels.fir_band.FirBand` (the
``fir_band`` CUDA kernel on the card, its twin on the CPU) at that count,
``tap_scale`` passed on. A bank the kernel cannot stage (``FirBand.fits``:
more than 4096 tap values over its channels and pairs, or past 64
channels below px6), which the JAX kernel would take, and anything else
take the einsum form: the three
band blocks as einsums over the zero-shifted tiles — fp32 at px6,
``f32x6``, ``highest``, ``high`` and ``f32x9``; at the reduced grades the
JAX package's split einsum, bf16 chunk products in float32 at the grade's
count (``dimfuse.EINSUM_NPROD``).

bf16 (the JAX package's routes at ``cdt`` or ``matmul_dtype`` bf16): a
bf16 image, at every grade, takes the band kernel at one product
(``fir_band_bf16``: bf16 taps, fp32 sums, a bf16 output rounded once) where
the gates above hold, and a float32 image with ``matmul_dtype="bfloat16"``
the float32 ``fir_band`` at one product (x rounded to bf16 on chip, a
float32 output); elsewhere both take the einsum form on bf16-rounded
operands — float32 einsums of bf16 values — the output rounded once to
the image's type. float16 storage raises, naming ROADMAP Queue 1 item 4.

``tap_scale`` (the iterated boxes' (2B+1)^n): below px6 a channel whose
scaled taps are exact bf16 integers takes one tap chunk and the reduced
pairs (:func:`.kernels.fir_band.exact_band`), as in the JAX package. At
px6 the port's kernel sums float32 taps and reads no scale.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dimfuse import EINSUM_NPROD
from .kernels import fir_band, split
from .planner import SPLIT_ITEM, auto_tile_width, check_precision

# the band kernel's product count per grade (the JAX package's map): the
# split einsum's counts and px6's six, without ``high``, whose einsum form
# stays fp32 (as at every count of 6)
BAND_NPROD = {g: n for g, n in {**EINSUM_NPROD, "px6": 6}.items()
              if g != "high"}


def box_taps(B: int, iterations: int) -> np.ndarray:
    """Taps of an ``iterations``-times iterated, zero-padded box of radius
    B: the FIR equivalent of the reference's iterated integral-image
    pipelines. Exact in float64 (small integers / (2B+1)^n); support
    2·n·B+1, centered."""
    one = np.ones(2 * B + 1, np.float64) / float(2 * B + 1)
    taps = one
    for _ in range(iterations - 1):
        taps = np.convolve(taps, one)
    return taps


def fir_oracle(x: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """float64 zero-padded correlation oracle: out[i] = Σ_t taps[t]·x[i+t-P]
    with P = (K-1)//2 — the centered convention of :func:`fir_pass_last`."""
    x = np.asarray(x, np.float64)
    taps = np.asarray(taps, np.float64)
    K = len(taps)
    P = (K - 1) // 2
    axis %= x.ndim
    xp = np.pad(x, [(P, K - 1 - P) if a == axis else (0, 0)
                    for a in range(x.ndim)])
    out = np.zeros_like(x)
    window = [slice(None)] * x.ndim
    for t in range(K):
        window[axis] = slice(t, t + x.shape[axis])
        out += taps[t] * xp[tuple(window)]
    return out


def _align_taps(taps) -> np.ndarray:
    """Stack per-channel taps of differing support into one (C, K) array
    with centers aligned (zero taps only widen the band)."""
    rows = [np.asarray(t, np.float64).ravel() for t in taps]
    Pmax = max((len(t) - 1) // 2 for t in rows)
    Qmax = max(len(t) - 1 - (len(t) - 1) // 2 for t in rows)
    out = np.zeros((len(rows), Pmax + Qmax + 1), np.float64)
    for c, t in enumerate(rows):
        p = (len(t) - 1) // 2
        out[c, Pmax - p: Pmax - p + len(t)] = t
    return out


def _band_mats(taps: np.ndarray, T: int):
    """(W0, Wm, Wp, P, Q): the T×T main block plus the narrow
    neighbour-strip blocks of the banded Toeplitz operator
    out[o] = Σ_t taps[t]·x[o+t-P]. Wm (T×P) multiplies the LAST P lanes of
    the previous tile, Wp (T×Q) the FIRST Q lanes of the next. Requires
    P, Q ≤ T."""
    taps = np.asarray(taps, np.float64)
    K = len(taps)
    P = (K - 1) // 2
    Q = K - 1 - P
    if P > T or Q > T:
        raise ValueError(
            f"FIR support ({K} taps) exceeds tile width {T}; use the IIR "
            f"integral-image pipeline for large radii")
    W0 = np.zeros((T, T), np.float64)
    Wm = np.zeros((T, max(P, 1)), np.float64)
    Wp = np.zeros((T, max(Q, 1)), np.float64)
    for o in range(T):
        for t in range(K):
            g = o + t - P  # input lane relative to this tile's start
            if 0 <= g < T:
                W0[o, g] = taps[t]
            elif g < 0:
                Wm[o, P + g] = taps[t]  # lane T-P+(P+g) of the previous tile
            else:
                Wp[o, g - T] = taps[t]  # lane g-T of the next tile
    return W0, Wm, Wp, P, Q


def _shift_tiles(S, back: bool):
    """Shift the tile axis (-2) so out-tile i sees its neighbour's strip:
    ``back`` pulls from tile i-1 (a zero tile first), else from i+1."""
    zeros = torch.zeros_like(S[..., :1, :])
    if back:
        return torch.cat([zeros, S[..., :-1, :]], dim=-2)
    return torch.cat([S[..., 1:, :], zeros], dim=-2)


def _as_bank(taps) -> np.ndarray:
    if isinstance(taps, (list, tuple)):
        taps = _align_taps(taps)  # ragged per-channel supports
    return np.atleast_2d(np.asarray(taps, np.float64))  # (C, K)


def _bf16_products(matmul_dtype) -> bool:
    """Whether ``matmul_dtype`` asks for bf16 products (None: the grade's)."""
    if matmul_dtype is None or matmul_dtype in ("float32", torch.float32):
        return False
    if matmul_dtype in ("bfloat16", torch.bfloat16):
        return True
    raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}")


class FirPass(nn.Module):
    """:func:`fir_pass_last` for inputs of one ``shape``, its routes and
    matrices built once — one for a float32 x (``band``) and one for a
    bf16 x (``band_bf16``, one product): :class:`.kernels.fir_band.FirBand`
    where the JAX package runs its kernel, else the einsum form.
    ``forward_plain`` runs the band pass's plain twin instead of its
    kernel."""

    def __init__(self, taps, shape, *, tile_width: int = 0,
                 bank: bool = False, contract: bool = False,
                 emit_rot: bool = False, matmul_precision: str = "px6",
                 matmul_dtype=None, tap_scale=None):
        super().__init__()
        assert not (bank and contract)
        check_precision(matmul_precision)
        self.mm_bf16 = _bf16_products(matmul_dtype)
        taps = _as_bank(taps)
        C = taps.shape[0]
        self.shape = tuple(int(s) for s in shape)
        self.bank, self.contract, self.emit_rot = bank, contract, emit_rot
        L = self.shape[-1]
        T = min(tile_width or auto_tile_width(L), L)
        self.T, self.C = T, C
        batch = self.shape[1 if contract else 0:-1]
        nbatch = len(batch)
        qk = int(np.prod(batch, dtype=np.int64))
        ok = (fir_band.fir_band_ok(T, L, taps, qk) and nbatch >= 1
              and (not emit_rot or nbatch == 1))

        def band(nprod):  # None: the einsum form (or the kernel's staging)
            if not (nprod and ok):
                return None
            b = fir_band.FirBand(taps, T=T, rot=emit_rot, contract=contract,
                                 nprod=nprod, tap_scale=tap_scale)
            return b if b.fits else None

        # bf16 products (a bf16 x, or matmul_dtype): one product
        nprod = 1 if self.mm_bf16 else BAND_NPROD.get(matmul_precision, 0)
        self.band = band(nprod)
        self.band_bf16 = self.band if nprod == 1 else band(1)
        if emit_rot and nbatch < 1:
            raise ValueError("emit_rot needs a batch axis to rotate with")
        mats = [_band_mats(t, T) for t in taps]
        self.P, self.Q = mats[0][3], mats[0][4]
        # the einsum form's products: fp32, or at a reduced grade the
        # constants' bf16 chunks (split from float64, float32 tensors);
        # with bf16 products the constants' one bf16 chunk ("*_b")
        self.nsp = nprod if nprod < 6 and not self.mm_bf16 else 0
        nc = split.nchunks(self.nsp) if self.nsp else 1
        for i, name in enumerate(("W0", "Wm", "Wp")):
            W = np.stack([m[i] for m in mats])
            self.register_buffer(name, torch.stack(
                [c.float() for c in split.split_const(W, nc)])
                if self.nsp else torch.from_numpy(W.astype(np.float32)))
            self.register_buffer(f"{name}_b",
                                 split.split_const(W, 1)[0].float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, False)

    def forward_plain(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x, True)

    def _run(self, x, plain):
        if tuple(x.shape) != self.shape:
            raise ValueError(f"input shape {tuple(x.shape)} != the pass's "
                             f"{self.shape}")
        if x.dtype == torch.float16:
            raise NotImplementedError(
                f"{x.dtype} storage: the FIR band pass runs float32 and "
                f"bf16 ({SPLIT_ITEM})")
        bf16 = x.dtype == torch.bfloat16
        if not bf16:
            x = x.to(torch.float32)
        band = self.band_bf16 if bf16 else self.band
        if band is not None:
            C, L = self.C, self.shape[-1]
            xk = x.reshape(C, -1, L) if self.contract else x.reshape(-1, L)
            yk = (band.plain if plain else band)(xk)
            if self.emit_rot:
                return yk  # (C?, L, last batch) — rot is gated to one axis
            chan = (C,) if C > 1 and not self.contract else ()
            return yk.reshape(chan + self.shape[1 if self.contract else 0:])
        return self._einsum(x, bf16 or self.mm_bf16).to(x.dtype)

    def _einsum(self, X, bf16: bool = False):
        """The JAX package's einsum form: einsums of the main block and
        both edge strips over the zero-shifted tiles — fp32, or the split
        einsum's chunk products at a reduced grade, or (``bf16``) float32
        einsums of the bf16-rounded x and constants; a float32 result."""
        if bf16:
            X = X.to(torch.bfloat16).float()
        T, L = self.T, self.shape[-1]
        n = -(-L // T)
        pad = n * T - L
        if pad:
            X = F.pad(X, (0, pad))
        Xt = X.reshape(X.shape[:-1] + (n, T))
        nbatch = Xt.ndim - 2 - (1 if self.contract else 0)
        batch = "abdefg"[:nbatch]
        lhs_b = ("c" if self.contract else "") + batch
        out_c = "c" if self.bank else ""
        if self.emit_rot:
            out = out_c + batch[:-1] + "no" + batch[-1]
        else:
            out = out_c + batch + "no"

        def one(W, strips):
            eq = f"cow,{lhs_b}nw->{out}"
            W = getattr(self, f"{W}_b" if bf16 else W)
            if not (self.bank or self.contract):
                eq, W = eq.replace("cow", "ow"), W[..., 0, :, :]
            if bf16 or not self.nsp:
                return torch.einsum(eq, W, strips)
            return split.pair_sum(self.nsp, lambda i, d: torch.einsum(
                eq, W[i], d), strips)

        P, Q = self.P, self.Q
        Y = one("W0", Xt)
        if P:
            Y = Y + one("Wm", _shift_tiles(Xt[..., T - P:], True))
        if Q:
            Y = Y + one("Wp", _shift_tiles(Xt[..., :Q], False))
        if self.emit_rot:
            Y = Y.reshape(Y.shape[:-3] + (n * T, Y.shape[-1]))
            return Y[..., :L, :] if pad else Y
        Y = Y.reshape(Y.shape[:-2] + (n * T,))
        return Y[..., :L] if pad else Y


def fir_pass_last(x, taps, *, tile_width: int = 0, bank: bool = False,
                  contract: bool = False, emit_rot: bool = False,
                  matmul_precision: str = "px6", matmul_dtype=None,
                  tap_scale=None):
    """Apply a centered zero-padded FIR along the LAST axis of ``x``.

    ``taps``: (K,) plain 1→1; ``bank=True``: (C, K) — C output channels
    from one input, a leading channel axis appears; ``contract=True``:
    (C, K) with x carrying a leading channel axis that is summed away (the
    signs folded into the taps). ``emit_rot`` emits the output with the
    last two spatial axes swapped. Functional :class:`FirPass`."""
    mod = FirPass(taps, x.shape, tile_width=tile_width, bank=bank,
                  contract=contract, emit_rot=emit_rot,
                  matmul_precision=matmul_precision,
                  matmul_dtype=matmul_dtype, tap_scale=tap_scale)
    return mod.to(x.device)(x)


class FirSeparable2D(nn.Module):
    """A C-channel separable FIR bank over (h, w) images with a signed
    cross-channel reduction: out = Σ_c signs[c]·(taps_y[c] ⊗ taps_x[c]) * I.

    The x pass fans 1→C channels and emits rotated ((C, w, h)); the y pass
    finds y last, applies the per-channel y taps with the signs folded in,
    contracts the channels away and emits rotated back to (h, w): two
    passes, one read and one write each. DoG = signs (+1, −1) over the two
    box³ radii; a plain iterated box is C = 1. ``forward_plain`` runs the
    plain twins of both passes. The image is taken as float32, but a bf16
    image stays bf16, as the JAX package's ``fir_separable_2d`` keeps it:
    both passes then run their bf16 routes (``fir_band_bf16``), the
    intermediate bf16."""

    def __init__(self, height: int, width: int, taps_x, taps_y=None,
                 signs=None, *, tile_width: int = 0,
                 matmul_precision: str = "px6", matmul_dtype=None,
                 tap_scale=None):
        super().__init__()
        taps_x = _as_bank(taps_x)
        taps_y = taps_x if taps_y is None else _as_bank(taps_y)
        C = taps_x.shape[0]
        signs = np.ones(C) if signs is None else np.asarray(signs, np.float64)
        kw = dict(tile_width=tile_width, matmul_precision=matmul_precision,
                  matmul_dtype=matmul_dtype, tap_scale=tap_scale)
        self.shape = (int(height), int(width))
        self.x_pass = FirPass(taps_x, self.shape, bank=C > 1, emit_rot=True,
                              **kw)
        mid = ((C,) if C > 1 else ()) + self.shape[::-1]
        self.y_pass = FirPass(taps_y * signs[:, None], mid, contract=C > 1,
                              emit_rot=True, **kw)

    @staticmethod
    def _input(image: torch.Tensor) -> torch.Tensor:
        return (image if image.dtype == torch.bfloat16
                else image.to(torch.float32))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.y_pass(self.x_pass(self._input(image)))

    def forward_plain(self, image: torch.Tensor) -> torch.Tensor:
        return self.y_pass.forward_plain(
            self.x_pass.forward_plain(self._input(image)))


def fir_separable_2d(image, taps_x, taps_y=None, signs=None, *,
                     tile_width: int = 0, matmul_precision: str = "px6",
                     matmul_dtype=None, tap_scale=None):
    """Functional :class:`FirSeparable2D` for a 2-D ``image``."""
    mod = FirSeparable2D(image.shape[-2], image.shape[-1], taps_x, taps_y,
                         signs, tile_width=tile_width,
                         matmul_precision=matmul_precision,
                         matmul_dtype=matmul_dtype, tap_scale=tap_scale)
    return mod.to(image.device)(image)
