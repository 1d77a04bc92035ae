"""Launching the port's CUDA kernels: one counter, one launcher, one
autograd rule for all of them.

  * ``SIGNATURES`` — the plain C interface of every ``csrc/<name>.cu``.
  * ``LAUNCHES`` — per-kernel launch counts; :func:`_launch` adds one where
    it launches a kernel and nowhere else, so a run shows which kernels its
    path went through. :func:`reset_launches` zeroes every count.
  * :func:`_check` — what every wrapper verifies before it passes a pointer.
  * :class:`_KernelFn` — the ``torch.autograd.Function`` of the CUDA path:
    forward through ``mod._kernel``, backward through the VJP of the
    module's plain twin ``mod.plain`` (every kernel is a linear map of its
    tensor inputs, so the VJP is taken at zero — :func:`_linear_vjp`).
"""

from __future__ import annotations

import ctypes

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int


def _sig(name: str, n_ptr: int, n_int: int) -> dict:
    """``<name>_launch(n_ptr pointers, n_int ints, stream) -> int`` and
    ``<name>_error_string(int) -> char*``."""
    return {f"{name}_launch": ([_P] * n_ptr + [_I] * n_int + [_P], _I),
            f"{name}_error_string": ([_I], ctypes.c_char_p)}


SIGNATURES = {
    "moments2d": _sig("moments2d", 6, 7),
    "final2d": _sig("final2d", 6, 5),
    "tails": _sig("tails", 3, 6),
    "completion": _sig("completion", 4, 4),
    "rows_tails": _sig("rows_tails", 3, 5),
    "rows_final": _sig("rows_final", 4, 4),
}

LAUNCHES = {name: 0 for name in SIGNATURES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, args, device: torch.device) -> None:
    """Launch kernel ``name`` on ``device``'s current stream; raise on a
    refused launch. Counts the launch."""
    from . import _build

    lib = _build.load(name, SIGNATURES[name])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, stream)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def _check(t: torch.Tensor, name: str, shape, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _linear_vjp(plain, shapes, device, grads):
    """VJP of the linear map ``plain`` (independent of the primal point)."""
    with torch.enable_grad():
        zs = [torch.zeros(s, device=device, requires_grad=True)
              for s in shapes]
        outs = plain(*zs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(outs, zs, grads)


class _KernelFn(torch.autograd.Function):
    """CUDA forward through ``mod._kernel``; backward = twin's VJP."""

    @staticmethod
    def forward(ctx, mod, *inputs):
        ctx.mod = mod
        ctx.shapes = [i.shape for i in inputs]
        ctx.device = inputs[0].device
        return mod._kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_linear_vjp(ctx.mod.plain, ctx.shapes, ctx.device,
                                   grads))
