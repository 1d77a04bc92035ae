"""Execution plan: the executor backend and the matmul precision grade.

The port runs the 3-touch 2-D path and the rows pass (``overlap2d``), on
the fp32 CUDA kernels of ``kernels/final2d.py``, and the last-axis passes
(``dimfuse.LastAxisPass``: the last-axis executor, the rotation chain, the
einsum pass on a non-last axis), on those of ``kernels/completion.py``.
The JAX package's precision names are kept: ``px6`` (its default) and
``highest`` both mean true-f32 products, which the fp32 kernels give on
Hopper without the TPU's bf16 chunk splitting. As in the JAX package, the
kernels (and the supertile hierarchy) run at ``px6`` only: at ``highest``
every pass runs its einsum form in float64 and no kernel launches — the
2-D pair and volumes take the rotation chain, a non-last axis the einsum
pass. Every other grade raises.
"""

from __future__ import annotations

import dataclasses

_SUPPORTED_PRECISIONS = ("px6", "highest")

# Grades the JAX package has and the port does not yet: each names the
# ROADMAP item that brings it.
_UNPORTED_PRECISIONS = {
    "px3": "Queue 1 item 4 (px3/px4 precision modes)",
    "px4": "Queue 1 item 4 (px3/px4 precision modes)",
    "default": "Queue 1 item 4 (the 'default' TF32 throughput mode)",
    "high": "Queue 1 item 4 (the 'high' precision mode)",
    "f32x3": "Queue 1 item 4 (the f32x* split-einsum modes)",
    "f32x4": "Queue 1 item 4 (the f32x* split-einsum modes)",
    "f32x6": "Queue 1 item 4 (the f32x* split-einsum modes)",
    "f32x9": "Queue 1 item 11 (integer-exact f32x9 limbs)",
}

_BACKENDS = ("auto", "einsum")


def check_precision(matmul_precision: str) -> None:
    """Raise unless the port runs ``matmul_precision``."""
    if matmul_precision in _SUPPORTED_PRECISIONS:
        return
    if matmul_precision in _UNPORTED_PRECISIONS:
        raise NotImplementedError(
            f"matmul_precision={matmul_precision!r} is not ported yet: "
            f"ROADMAP {_UNPORTED_PRECISIONS[matmul_precision]}")
    raise ValueError(f"unknown matmul_precision {matmul_precision!r}")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Static execution plan for a filter.

    ``backend``: "auto" or "einsum" — both name the fused executors
    (the JAX package's name for its fused per-dimension route).
    ``matmul_precision``: "px6" (default) or "highest".
    ``rotate_emit``: layout chaining for single-dimension filters (the
    reference's ``storage_layout`` directive): nonzero opts into the
    contract that the INPUT carries the scanned dimension as its LAST
    axis, and the result is emitted with the trailing ``rotate_emit`` axes
    rotated one step (``dimfuse.RotatedPass``) — an x-scan filter and a
    y-scan filter with ``rotate_emit=2`` chain with no relayout between
    them. 0 (default) emits in the natural layout."""

    backend: str = "auto"
    matmul_precision: str = "px6"
    rotate_emit: int = 0

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise NotImplementedError(
                f"backend={self.backend!r} is not ported yet: ROADMAP "
                "Queue 1 item 15 (remaining backends)")
        check_precision(self.matmul_precision)
        if int(self.rotate_emit) != self.rotate_emit or self.rotate_emit < 0:
            raise ValueError(f"rotate_emit must be an int ≥ 0, got "
                             f"{self.rotate_emit!r}")

    def with_(self, **kw) -> "Plan":
        return dataclasses.replace(self, **kw)


def default_tile_width(extent: int, platform: str) -> int:
    """Auto tile width: 128 on the TPU and on CUDA (the kernels' tile is
    128 × 128), the reference's 32 elsewhere."""
    t = 128 if platform in ("tpu", "cuda") else 32
    return max(min(t, extent), 1)


def auto_tile_width(extent: int) -> int:
    """:func:`default_tile_width` for the port's platform: the kernels'
    tile of 128 wherever they run (the CPU runs their twins on the same
    tiles), so no card is probed."""
    return default_tile_width(extent, "cuda")
