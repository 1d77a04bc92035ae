"""Untiled executors: the definitional numpy oracle and the sequential core.

* ``oracle_apply_scan`` / ``oracle_apply`` — plain numpy loops, the
  definitional oracle (float64 for float filters).
* ``apply_scan`` / ``apply_filter`` and :class:`ScanFilter` — the JAX
  package's ``lax.scan`` executor: sequential along the scanned axis,
  vectorised over every other axis (one loop step is one torch op per
  tap, on any device). It is the ``scan`` backend, the route of untiled
  filters, and the fallback wherever the blocked algebra has no tile plan
  (an order above the extent, a clamp border with no dividing tile).
  Integer filters run in their own type and wrap as it wraps (unsigned
  ones in int32, congruent mod 2^32, truncated at the end); float32
  filters accumulate in float64 (the JAX package's ``lax.scan`` in
  float32 sits about 1e-6 of the output peak from the oracle on the
  σ=5 Gaussian, near the 2e-6 bound) and return float32.

Scan semantics (causal):
    v[x] = b0·v[x] + Σ_j a_j · v[x-(j+1)]       updated in place, x ascending
with zero border (out-of-range taps contribute 0) or clamped border
(out-of-range taps clamp to index 0 of the in-place array). Anticausal is
the exact mirror (x ↦ w-1-x). Floating filters run in float64.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from .spec import BorderMode, FilterSpec


def oracle_apply_scan(
    v: np.ndarray,
    axis: int,
    causal: bool,
    feedfwd: float,
    feedback: Sequence[float],
    border: str = BorderMode.ZERO,
) -> np.ndarray:
    """Apply one scan with plain numpy loops (definitional oracle).

    The scanned axis is moved to the front of a C-ordered copy so every
    step reads and writes contiguous rows (4K images stay seconds, not
    minutes); the arithmetic per element is the loop's own."""
    v = np.moveaxis(np.asarray(v), axis, 0)
    if not causal:
        v = v[::-1]
    out = np.array(v, order="C")
    vin = out.copy()
    w = out.shape[0]
    a = list(feedback)
    k = len(a)
    clamp = border == BorderMode.CLAMP
    for x in range(w):
        acc = feedfwd * vin[x]
        for j in range(k):
            if x - j - 1 >= 0:
                acc = acc + a[j] * out[x - j - 1]
            elif clamp:
                # out[0] has not been stored yet when x == 0, so this
                # reads the pre-update value there (evaluate-then-store).
                acc = acc + a[j] * out[0]
        out[x] = acc
    if not causal:
        out = out[::-1]
    return np.moveaxis(out, 0, axis)


def oracle_apply(spec: FilterSpec, x: np.ndarray) -> np.ndarray:
    """Apply every scan of ``spec`` in definition order with the oracle."""
    x = np.asarray(x)
    dtype = np.dtype(spec.dtype)
    if np.issubdtype(dtype, np.integer):
        x = x.astype(dtype)
        for s in spec.scans:
            ff = dtype.type(s.feedfwd)
            fb = [dtype.type(c) for c in s.feedback]
            x = oracle_apply_scan(x, s.axis, s.causal, ff, fb, spec.border)
        return x
    x = x.astype(np.float64)
    for s in spec.scans:
        x = oracle_apply_scan(
            x, s.axis, s.causal, s.feedfwd, s.feedback, spec.border
        )
    return x.astype(dtype)


# ---------------------------------------------------------------------------
# the sequential core (the JAX package's lax.scan executor)
# ---------------------------------------------------------------------------

_INT_TYPES = {torch.int8, torch.int16, torch.int32, torch.int64}


def _coefficients(feedfwd, feedback, dtype: torch.dtype):
    """The scan's coefficients as Python scalars for ``dtype``: cast into
    an integer type as the reference and the oracle cast them (wrapping),
    else floats."""
    if dtype in _INT_TYPES:
        t = np.dtype(str(dtype).replace("torch.", "")).type
        return int(t(feedfwd)), [int(t(c)) for c in feedback]
    return float(feedfwd), [float(c) for c in feedback]


def _scan_rows(x: torch.Tensor, feedfwd, feedback,
               clamp: bool) -> torch.Tensor:
    """One causal scan along axis 0 of ``x`` (any trailing batch axes),
    in ``x``'s type: per step ``y[t] = b0·x[t] + Σ_j a_j·y[t-1-j]``, one
    torch op per tap, every line at once. Zero border: taps before the
    start read zero. Clamp: the first min(k, w) outputs are peeled with
    the JAX package's rule — a tap before the start reads the pre-update
    site value ``x[0]`` at t = 0 and the output ``y[0]`` after it."""
    b0, a = _coefficients(feedfwd, feedback, x.dtype)
    k, w = len(a), x.shape[0]
    ys = []
    for t in range(w):
        y = torch.mul(x[t], b0)
        for j in range(k):
            i = t - j - 1
            if i >= 0:
                src = ys[i]
            elif not clamp:
                continue
            else:
                src = x[0] if t == 0 else ys[0]
            y = torch.add(y, src, alpha=a[j])
        ys.append(y)
    return torch.stack(ys)


def apply_scan(x: torch.Tensor, axis: int, causal: bool, feedfwd, feedback,
               border: str = BorderMode.ZERO) -> torch.Tensor:
    """One scan along ``axis`` of ``x`` (any rank) in ``x``'s type: the
    JAX package's ``scan_core.apply_scan``."""
    v = x.movedim(axis, 0)
    if not causal:
        v = v.flip(0)
    y = _scan_rows(v, feedfwd, feedback, border == BorderMode.CLAMP)
    if not causal:
        y = y.flip(0)
    return y.movedim(0, axis)


# integer filters' working types: their own, except the unsigned ones,
# which wrap in int32 (congruent mod 2^32, truncated at the end — the
# ring homomorphism the JAX package's integer executor relies on)
_INT_WORK = {"int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
             "int64": torch.int64, "uint8": torch.int32,
             "uint16": torch.int32, "uint32": torch.int32}


def _compute_type(dtype: str) -> torch.dtype:
    """The core's working type for a filter of ``dtype``: integers their
    own (unsigned ones int32), float32 float64 (module docstring); others
    raise."""
    if dtype in _INT_WORK:
        return _INT_WORK[dtype]
    if dtype == "float32":
        return torch.float64
    raise NotImplementedError(
        f"dtype {dtype}: the port runs float32 and integer filters only "
        "(ROADMAP Queue 1 item 4: bf16 and float16 storage)")


def work_scans(spec: FilterSpec):
    """``spec``'s scans with each coefficient cast into the filter's
    integer type, as the oracle casts it, then written as the working
    type's two's-complement value (an unsigned coefficient's residue in
    int32's range); a float filter's scans unchanged."""
    if spec.dtype not in _INT_WORK:
        return list(spec.scans)
    t = np.dtype(spec.dtype).type
    bits = torch.iinfo(_INT_WORK[spec.dtype]).bits

    def cast(c):
        v = int(t(c)) % (1 << bits)
        return v - (1 << bits) if v >= 1 << (bits - 1) else v

    return [type(s)(s.axis, s.causal, cast(s.feedfwd),
                    tuple(cast(c) for c in s.feedback)) for s in spec.scans]


def apply_filter(spec: FilterSpec, x: torch.Tensor) -> torch.Tensor:
    """Every scan of ``spec`` in order through the core, on ``x``'s
    device: the JAX package's ``scan_core.apply_filter``."""
    return ScanFilter(spec)(torch.as_tensor(x))


class ScanAxis(nn.Module):
    """``scans`` (all on ``axis``) through the core, in order — the
    fallback of the tiled executors on an axis with no tile plan (the JAX
    package's ``fused_dim_pass`` there). float32 in and out, float64
    inside; ``forward_plain`` is ``forward`` (no kernel)."""

    def __init__(self, scans, axis: int, border: str):
        super().__init__()
        self.scans, self.axis, self.border = list(scans), int(axis), border

    def forward(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        if eaux:
            raise ValueError("ScanAxis takes no epilogue aux arrays")
        y = x.double()
        for s in self.scans:
            y = apply_scan(y, self.axis, s.causal, s.feedfwd, s.feedback,
                           self.border)
        return y.to(x.dtype)

    forward_plain = forward


class ScanFilter(nn.Module):
    """The ``scan`` backend: every scan of ``spec`` in definition order
    through the core. Integer filters in their working type (their own;
    int32 for the unsigned ones; a float input cast through int32, as the
    JAX package casts it), float32 filters in float64, returned in the
    filter's type. ``forward_plain`` is
    ``forward`` (the core launches no kernel)."""

    def __init__(self, spec: FilterSpec):
        super().__init__()
        self.spec = spec.stacked()
        self.work = _compute_type(spec.dtype)
        self.scans = work_scans(self.spec)
        self.out_dtype = getattr(torch, spec.dtype)
        self.ext = tuple(d.extent for d in self.spec.dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x)
        if tuple(x.shape) != self.ext:
            raise ValueError(f"input shape {tuple(x.shape)} != the filter's "
                             f"extents {self.ext}")
        if self.work in _INT_TYPES and x.is_floating_point():
            x = x.to(torch.int32)
        y = x.to(self.work)
        for s in self.scans:
            y = apply_scan(y, s.axis, s.causal, s.feedfwd, s.feedback,
                           self.spec.border)
        return y.to(self.out_dtype)

    forward_plain = forward


class OracleFilter(nn.Module):
    """The ``oracle`` backend: :func:`oracle_apply` (float64 numpy loops)
    on the input, the result a tensor on the input's device."""

    def __init__(self, spec: FilterSpec):
        super().__init__()
        self.spec = spec.stacked()

    def forward(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        y = oracle_apply(self.spec, x.detach().cpu().numpy())
        return torch.from_numpy(np.ascontiguousarray(y)).to(x.device)

    forward_plain = forward
