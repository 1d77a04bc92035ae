"""Launching the port's CUDA kernels: one counter, one launcher, one
autograd rule for all of them.

  * ``SIGNATURES`` — the plain C interface of every ``csrc/<name>.cu``,
    keyed by the kernel (the source file).
  * ``ENTRIES`` — each launch entry point ``<entry>_launch`` and the kernel
    whose library holds it. A kernel has one entry of its own name, except
    ``int_seg_scan``, whose two phases launch separately (``int_seg_carries``
    and ``int_seg_fix``), ``completion`` (the unrotated px6 product), whose
    rotated emit at every grade (with its optional stencil consumer) is a
    source of its own, ``completion_rot`` (its ``nprod`` argument), as is
    the rotated emit that also extracts the next pass's tails,
    ``completion_rot_tails``, and
    ``tails``, whose extra-row form (a stencil's halo bases) is
    ``tails_extra``. The learnable executor's two kernels, whose matrices
    are runtime tensors, are entries of the same sources:
    ``tails_traced`` and ``completion_traced``. The affine epilogue
    ``a·y + Σᵢ bᵢ·auxᵢ + c`` in the store loop of ``final2d``,
    ``completion`` and ``completion_rot`` is an entry of its own for each,
    ``final2d_epi``, ``completion_epi`` and ``completion_rot_epi`` (the aux
    count k ≤ 4 an int, the coefficients a device buffer), so a count
    tells "epilogue in the kernel" from "kernel, then torch ops". The
    HIGHEST grade's 3-touch pair of the ``overlap_k`` backend (any leading
    tile, unpadded carries) is ``moments2d_k`` and ``final2d_k``; the
    ``pallas`` backend's strip passes are ``fused.cu``'s ``dim_pass_rows``
    and ``dim_pass_cols``. The 2-D executor's optional routes have entries
    of their own: ``moments2d_naf`` (``moments2d.cu``: pass 1 with the
    dim-A carry solve inside) and ``bsolve`` (the dim-B carry glue and its
    solve); the headline benchmark's bandwidth probe is ``copy``. The
    reduced precision grades (default, px3, px4) run ``final2d_split``,
    ``completion_split`` (``completion``'s tensor-core kernel at the grade,
    a source of its own so that both build in parallel), the rotated
    entries and ``rows_final`` (their ``nprod`` argument); the
    ``scripts/`` probes' studies are ``split_mm``'s three entries
    (``split_mm``, ``split_mm_tf32``, ``split_mm_fp32``),
    ``ozaki``'s two (``ozaki_i8``, the int8 Ozaki dual completion, and
    ``dual_px6``, its six-product bf16 twin) and ``gemm_pair``'s two
    (``gemm_i8``, ``gemm_bf16``: one GEMM tiling, two products). bf16
    storage (a bf16 image between passes, the JAX package's
    ``dtype="bfloat16"`` mode) has entries of its own in the sources of
    its float forms, so a count tells the two apart: ``moments2d_bf16``
    and ``moments2d_naf_bf16`` (x bf16), ``final2d_split_bf16`` and
    ``final2d_split_epi_bf16`` (x and y bf16, nprod 1), ``rows_tails_bf16``
    (x bf16) and ``rows_final_bf16`` (x and y bf16, nprod 1), ``tails_bf16``
    (x bf16), ``completion_split_bf16``, ``completion_split_epi_bf16``,
    ``completion_rot_bf16``, ``completion_rot_epi_bf16`` and
    ``completion_rot_tails_bf16`` (x and y bf16, nprod 1; the rotated
    entries without a stencil), and the stencil consumers' forms:
    ``final2d_stencil_bf16`` (x and the banks bf16, nprod 1),
    ``tails_extra_bf16`` (x bf16), ``completion_rot_stencil_bf16`` and
    ``completion_rot_stencil_epi_bf16`` (x and y bf16, nprod 1, the
    rotated emit with its stencil) and ``stencil2d_bf16`` (y and the
    banks bf16); ``fir_band_bf16`` (x and y bf16, nprod 1: the FIR band
    on a bf16 image). ``final2d_k_bf16`` is ``final2d_k`` with bf16
    products (``Plan.matmul_dtype="bfloat16"``: x, Z and the image-sized
    constants rounded to bf16, x and y float32).
  * ``LAUNCHES`` — per-entry launch counts; :func:`_launch` adds one where
    it launches a kernel and nowhere else, so a run shows which kernels its
    path went through. :func:`reset_launches` zeroes every count.
  * :func:`_check` — what every wrapper verifies before it passes a pointer.
  * :class:`_KernelFn` — the ``torch.autograd.Function`` of the float
    kernels' CUDA path whose matrices are host constants (module buffers):
    forward through ``mod._kernel``, backward through the VJP of the
    module's plain twin (``mod._twin`` where the module defines one, else
    ``mod.plain``; each such kernel is a linear map of its tensor inputs,
    so the VJP is taken at zero — :func:`_linear_vjp`) in float32, each
    gradient cast to its input's dtype (a bf16 image gets a bf16
    gradient). An input the twin
    does not read — the stencil consumers' halo strips, which the twins
    recompute from the whole output — gets a zero gradient, as in the JAX
    package's VJPs. ``tails_traced`` and ``completion_traced`` take their
    matrices as inputs, so they are bilinear (in the signal and the
    matrices) and a VJP at zero would lose the matrices' gradients: their
    Functions (``completion._TailsTraced``, ``completion._CompletionTraced``)
    save the inputs and take the twins' einsums at the primal point. The
    integer kernels have no gradient.
"""

from __future__ import annotations

import ctypes

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_AUX = 4  # aux pointers an ``*_epi`` entry takes (common.cuh's MAX_AUX)


def _sig(name: str, *entries) -> dict:
    """The C functions of ``csrc/<name>.cu``: for each ``(entry, n_ptr,
    n_int)`` one ``<entry>_launch(n_ptr pointers, n_int ints, stream) ->
    int``, and ``<name>_error_string(int) -> char*``."""
    sig = {f"{e}_launch": ([_P] * n_ptr + [_I] * n_int + [_P], _I)
           for e, n_ptr, n_int in entries}
    sig[f"{name}_error_string"] = ([_I], ctypes.c_char_p)
    return sig


SIGNATURES = {
    "moments2d": _sig("moments2d", ("moments2d", 9, 8),
                      ("moments2d_k", 5, 8), ("moments2d_naf", 7, 7),
                      ("moments2d_bf16", 9, 8), ("moments2d_naf_bf16", 7, 7)),
    "final2d": _sig("final2d", ("final2d", 6, 5), ("final2d_epi", 11, 6),
                    ("final2d_k", 6, 8), ("final2d_k_bf16", 8, 8)),
    "final2d_stencil": _sig("final2d_stencil", ("final2d_stencil", 11, 11),
                            ("final2d_stencil_bf16", 11, 11)),
    "final2d_split": _sig("final2d_split", ("final2d_split", 6, 6),
                          ("final2d_split_epi", 11, 7),
                          ("final2d_split_bf16", 6, 6),
                          ("final2d_split_epi_bf16", 11, 7)),
    "tails": _sig("tails", ("tails", 3, 7), ("tails_extra", 3, 7),
                  ("tails_traced", 3, 3), ("tails_bf16", 3, 7),
                  ("tails_extra_bf16", 3, 7)),
    "completion": _sig("completion", ("completion", 4, 4),
                       ("completion_epi", 9, 5),
                       ("completion_traced", 5, 3)),
    "completion_rot": _sig("completion_rot", ("completion_rot", 7, 10),
                           ("completion_rot_epi", 12, 11),
                           ("completion_rot_bf16", 4, 5),
                           ("completion_rot_epi_bf16", 9, 6),
                           ("completion_rot_stencil_bf16", 7, 10),
                           ("completion_rot_stencil_epi_bf16", 12, 11)),
    "completion_rot_tails": _sig("completion_rot_tails",
                                 ("completion_rot_tails", 6, 8),
                                 ("completion_rot_tails_bf16", 6, 8)),
    "completion_split": _sig("completion_split", ("completion_split", 4, 5),
                             ("completion_split_epi", 9, 6),
                             ("completion_split_bf16", 4, 5),
                             ("completion_split_epi_bf16", 9, 6)),
    "rows_tails": _sig("rows_tails", ("rows_tails", 3, 5),
                       ("rows_tails_bf16", 3, 5)),
    "rows_final": _sig("rows_final", ("rows_final", 4, 5),
                       ("rows_final_bf16", 4, 5)),
    "fir_band": _sig("fir_band", ("fir_band", 5, 9),
                     ("fir_band_bf16", 5, 8)),
    "int_scan": _sig("int_scan", ("int_scan", 3, 6)),
    "int_seg_scan": _sig("int_seg_scan", ("int_seg_carries", 2, 9),
                         ("int_seg_fix", 3, 9)),
    "stencil2d": _sig("stencil2d", ("stencil2d", 4, 8),
                      ("stencil2d_bf16", 4, 7)),
    "fused": _sig("fused", ("dim_pass_rows", 3, 8), ("dim_pass_cols", 3, 10)),
    "bsolve": _sig("bsolve", ("bsolve", 6, 7)),
    "copy": _sig("copy", ("copy", 2, 1)),
    "split_mm": _sig("split_mm", ("split_mm", 5, 9),
                     ("split_mm_tf32", 4, 8), ("split_mm_fp32", 4, 7)),
    "ozaki": _sig("ozaki", ("ozaki_i8", 5, 5), ("dual_px6", 4, 2)),
    "gemm_pair": _sig("gemm_pair", ("gemm_i8", 3, 4), ("gemm_bf16", 3, 3)),
}

ENTRIES = {fn[:-len("_launch")]: lib for lib, sig in SIGNATURES.items()
           for fn in sig if fn.endswith("_launch")}

LAUNCHES = {entry: 0 for entry in ENTRIES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class LaunchError(RuntimeError):
    """A launch its entry refused; ``err`` the CUDA error code it gave."""

    def __init__(self, entry: str, msg: str, err: int):
        super().__init__(f"{entry} kernel launch failed: {msg} ({err})")
        self.err = err


def _launch(entry: str, args, device: torch.device) -> None:
    """Launch entry point ``entry`` on ``device``'s current stream; raise
    :class:`LaunchError` on a refused launch. Counts the launch."""
    from . import _build

    name = ENTRIES[entry]
    lib = _build.load(name, SIGNATURES[name])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{entry}_launch")(*args, stream)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise LaunchError(entry, msg, err)
    LAUNCHES[entry] += 1


def _check(t: torch.Tensor, name: str, shape, device,
           dtype=torch.float32) -> None:
    """Raise unless ``t`` has ``dtype`` (one dtype or a tuple of them),
    ``shape``, lies on ``device`` and is contiguous and 16-byte aligned."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _linear_vjp(plain, shapes, device, grads):
    """VJP of the linear map ``plain`` (independent of the primal point);
    zeros for an input ``plain`` does not read."""
    with torch.enable_grad():
        zs = [torch.zeros(s, device=device, requires_grad=True)
              for s in shapes]
        outs = plain(*zs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        gs = torch.autograd.grad(outs, zs, grads, allow_unused=True)
        return tuple(torch.zeros_like(z) if g is None else g
                     for z, g in zip(zs, gs))


class _KernelFn(torch.autograd.Function):
    """CUDA forward through ``mod._kernel``; backward = twin's VJP."""

    @staticmethod
    def forward(ctx, mod, *inputs):
        ctx.mod = mod
        ctx.shapes = [i.shape for i in inputs]
        ctx.dtypes = [i.dtype for i in inputs]
        ctx.device = inputs[0].device
        return mod._kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        twin = getattr(ctx.mod, "_twin", ctx.mod.plain)
        gs = _linear_vjp(twin, ctx.shapes, ctx.device,
                         tuple(g.float() for g in grads))
        return (None, *(g.to(d) for g, d in zip(gs, ctx.dtypes)))
