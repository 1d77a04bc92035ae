"""Host helpers of the slot-padded carry layout.

Carries ride 8-row slots: a dimension with ΣK ≤ 8 carry values per tile
keeps them in one slot, zero-padded. The JAX package chose 8 for the TPU's
sublane quantum; the port keeps the layout so both packages exchange the
same arrays, and the CUDA kernels take it as is.
"""

from __future__ import annotations

import numpy as np

_SLOTS = 8  # carry rows per tile slot


def slots_for(S: int) -> int:
    """Slot-padded carry rows for ΣK = S (a multiple of the slot size)."""
    return -(-int(S) // _SLOTS) * _SLOTS


def _per_tile(M, n: int) -> np.ndarray:
    """(nv, ...) matrix stack -> per-tile (n, ...) float64 (a uniform
    stack broadcasts its one matrix to every tile)."""
    M = np.asarray(M, np.float64)
    return M[np.minimum(np.arange(n), M.shape[0] - 1)]


def _expand_stack(M, n: int) -> np.ndarray:
    """:func:`_per_tile` in float32."""
    return np.asarray(_per_tile(M, n), np.float32)


def pad_solve_matrix(CMfull, n: int, S: int) -> np.ndarray:
    """Embed the (n·S, n·S) combined-solve matrix into the slot-padded
    layout: (n·sl, n·sl) with sl = ⌈S/8⌉·8, zero rows/cols on the pad
    slots — so the solve runs directly on slot-padded tails."""
    CM = np.asarray(CMfull)
    sl = slots_for(S)
    out = np.zeros((n * sl, n * sl), CM.dtype)
    for t in range(n):
        for u in range(n):
            out[t * sl:t * sl + S, u * sl:u * sl + S] = (
                CM[t * S:(t + 1) * S, u * S:(u + 1) * S]
            )
    return out
