"""Test and benchmark harness helpers: ``generate_random_image`` (all ones
by default, so a failure is human-readable — a SAT becomes a ramp) and
``CheckResult`` (max and mean relative-% error against a reference).
Inputs may be numpy arrays or torch tensors on any device."""

from __future__ import annotations

import numpy as np


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch tensor
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def generate_random_image(*extents, dtype=np.float32, lo=1, hi=1, seed=0):
    """All-ones image by default; pass lo/hi for random contents."""
    shape = tuple(int(e) for e in extents)
    if lo == hi:
        return np.full(shape, lo, dtype=dtype)
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(lo, hi + 1, size=shape).astype(dtype)
    return (lo + (hi - lo) * rng.random(shape)).astype(dtype)


class _CheckStats:
    def __init__(self, ref, out, verbose: bool):
        ref, out = _np(ref), _np(out)
        assert ref.shape == out.shape, f"shape mismatch {ref.shape} vs {out.shape}"
        diff = out - ref
        denom = np.sum(np.abs(ref))
        scale = 100.0 / denom if denom > 0 else 100.0
        self.max_error = float(np.max(np.abs(diff)) * scale)
        self.mean_error = float(np.mean(np.abs(diff)) * scale)
        self.verbose = verbose
        self.ref = ref
        self.out = out

    def __repr__(self) -> str:
        lines = []
        if self.verbose and self.ref.size <= 1024:
            lines.append(f"Reference:\n{self.ref}\n")
            lines.append(f"Obtained:\n{self.out}\n")
        lines.append(
            f"Max relative error = {self.max_error:.6e} %\n"
            f"Mean relative error = {self.mean_error:.6e} %"
        )
        return "".join(lines)


def CheckResult(ref, out) -> _CheckStats:
    """Max/mean relative-% error summary."""
    return _CheckStats(ref, out, verbose=False)


def CheckResultVerbose(ref, out) -> _CheckStats:
    """Verbose variant that also prints small arrays."""
    return _CheckStats(ref, out, verbose=True)
