"""The definitional numpy oracle for the filter semantics.

Scan semantics (causal):
    v[x] = b0·v[x] + Σ_j a_j · v[x-(j+1)]       updated in place, x ascending
with zero border (out-of-range taps contribute 0) or clamped border
(out-of-range taps clamp to index 0 of the in-place array). Anticausal is
the exact mirror (x ↦ w-1-x). Floating filters run in float64.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

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
