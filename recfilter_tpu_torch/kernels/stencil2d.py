"""The standalone 2-D stencil kernel and its plain twin: C channel banks of
shifted taps over an image, every channel from one read.

:class:`Stencil2D` (``csrc/stencil2d.cu``) maps an (H, W) image — float32,
or an int8/16/32 table — to C float32 images,

    out[c] = Σ_(dy, dx, coeff) coeff · y[· + dy, · + dx]

with the JAX package's border rule (``recfilter_tpu/kernels/stencil2d.py``):
positive offsets clamp at the far edges, negative offsets read zero — the
summed-area-table differencing of the box and DoG apps, whose integral
images hold real totals at the far edges and zeros in the zeroed margin.
It is what ``dimfuse`` runs after a filter whose output the 3-touch
executor cannot fuse the bank into (``as_func(stencil2d=...)``).

``forward`` launches the CUDA kernel for a 2-D CUDA tensor (through
:class:`.launch._KernelFn` for a float input: the bank is linear, its
backward the twin's VJP), runs the plain twin :func:`stencil2d_ref` for a
CPU tensor, and raises for a CUDA tensor of another rank: which rank takes
the kernel is the router's choice (``dimfuse.Stencil2DAfter``, the JAX
package's ``_st_fallback``). The result is a tuple of C tensors (views of
one (C, H, W) buffer).

Output type: float32 for an integer table, as the JAX package's twin
``stencil2d_ref`` returns. Its TPU kernel writes the input type instead,
which truncates an integer table's differenced output (ROADMAP Queue 3);
the port does not copy that. A bf16 image (bf16 storage) gives bf16
channels (``stencil2d_bf16``): the float32 products and sums of the float32
path on the widened values, each channel rounded once. The JAX package's
twin takes them in bf16 arithmetic (ROADMAP Queue 3).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .launch import _check, _KernelFn, _launch

_DTYPES = {torch.float32: 0, torch.int32: 1, torch.int16: 2, torch.int8: 3}
# the types the kernels read: those of ``stencil2d``, and bf16
# (``stencil2d_bf16``)
_KTYPES = (*_DTYPES, torch.bfloat16)


def normalize_taps(taps_c):
    """``[[(dy, dx, coeff), ...], ...]`` with int offsets, float coeffs."""
    return [[(int(dy), int(dx), float(c)) for dy, dx, c in taps]
            for taps in taps_c]


def stencil_reach(taps_c):
    """(up, down, left, right): the largest −dy, dy, −dx, dx (≥ 0)."""
    dys = [int(dy) for taps in taps_c for dy, _, _ in taps]
    dxs = [int(dx) for taps in taps_c for _, dx, _ in taps]
    return (max([-d for d in dys] + [0]), max(dys + [0]),
            max([-d for d in dxs] + [0]), max(dxs + [0]))


def shift_mode(y: torch.Tensor, off: int, axis: int, mode: str):
    """``y`` shifted by ``off`` along ``axis``: y[i + off], replicating the
    edge past the array for "clamp", zeros for "zero" (the JAX package's
    ``dimfuse._shift_mode``; the one shift every consumer twin uses)."""
    n = y.shape[axis]
    if off == 0:
        return y
    g = y.movedim(axis, -1)
    lo, hi = max(off, 0), max(-off, 0)
    if mode == "clamp":
        edge = g[..., -1:] if off > 0 else g[..., :1]
        fill = edge.expand(*g.shape[:-1], min(lo + hi, n))
    else:
        fill = g.new_zeros(g.shape[:-1] + (min(lo + hi, n),))
    g = (torch.cat([g[..., lo:], fill], -1)[..., :n] if off > 0
         else torch.cat([fill, g[..., :max(n - hi, 0)]], -1))
    return g.movedim(-1, axis)


def shift2(y: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """The stencil border rule: y[i + off], clamped to the last element
    past the far edge (off > 0), zero before the start (off < 0)."""
    return shift_mode(y, off, axis, "clamp" if off > 0 else "zero")


def stencil2d_ref(y: torch.Tensor, taps_c):
    """The JAX package's ``stencil2d_ref``: each channel's taps over the
    trailing two axes of ``y`` (the row shift, then the column shift of the
    row-shifted array), fp32 product then sum per tap. An integer or bf16
    ``y`` is shifted in its own type and each term taken in float32; a bf16
    ``y``'s channels are rounded once to bf16. Returns a tuple of
    per-channel tensors."""
    nd = y.ndim
    outs = []
    for taps in normalize_taps(taps_c):
        acc = None
        for dy, dx, coeff in taps:
            t = shift2(shift2(y, dy, nd - 2), dx, nd - 1)
            t = t.to(torch.float32) * coeff
            acc = t if acc is None else acc + t
        outs.append(acc.to(torch.bfloat16) if y.dtype == torch.bfloat16
                    else acc)
    return tuple(outs)


class Stencil2D(nn.Module):
    """``stencil(y)`` for ``y`` (H, W): a tuple of C float32 (H, W)
    tensors, bf16 for a bf16 ``y`` (module docstring).

    taps_c : per output channel ``[(dy, dx, coeff), ...]``."""

    def __init__(self, taps_c):
        super().__init__()
        self.taps_c = normalize_taps(taps_c)
        if not self.taps_c or not all(self.taps_c):
            raise ValueError("stencil2d needs at least one tap per channel")
        self.C = len(self.taps_c)
        self.reach = stencil_reach(self.taps_c)
        flat = [t for taps in self.taps_c for t in taps]
        self.register_buffer("taps_k", torch.tensor(flat, dtype=torch.float32))
        self.register_buffer("toff", torch.from_numpy(np.cumsum(
            [0] + [len(t) for t in self.taps_c]).astype(np.int32)))

    def plain(self, y):
        return stencil2d_ref(y, self.taps_c)

    def _twin(self, y):  # the kernel's (C, H, W) output, for the VJP
        return torch.stack(self.plain(y))

    def _kernel(self, y):
        H, W = y.shape
        bf16 = y.dtype == torch.bfloat16
        _check(y, "y", (H, W), y.device, _KTYPES)
        _check(self.taps_k, "taps_k", self.taps_k.shape, y.device)
        _check(self.toff, "toff", self.toff.shape, y.device, torch.int32)
        out = torch.empty((self.C, H, W), device=y.device,
                          dtype=torch.bfloat16 if bf16 else torch.float32)
        hp, hn, dxl, dxr = self.reach
        args = (y.data_ptr(), self.taps_k.data_ptr(), self.toff.data_ptr(),
                out.data_ptr(), H, W, self.C, hp, hn, dxl, dxr)
        if bf16:
            _launch("stencil2d_bf16", args, y.device)
        else:
            _launch("stencil2d", (*args, _DTYPES[y.dtype]), y.device)
        return out

    def forward(self, y):
        if not y.is_cuda:
            return self.plain(y)
        if y.ndim != 2:
            raise ValueError(f"stencil2d kernel takes an (H, W) image, got "
                             f"shape {tuple(y.shape)}")
        if y.dtype not in _KTYPES:
            raise TypeError(f"stencil2d kernel takes {list(_KTYPES)}, got "
                            f"{y.dtype}")
        y = y.contiguous()
        out = (_KernelFn.apply(self, y) if y.is_floating_point()
               else self._kernel(y))
        return tuple(out.unbind(0))
