"""Closure-matrix algebra for overlapped tiling (host, float64 numpy).

The T×T per-tile impulse-response matrix, the T×k incoming-state
propagation matrix and their products that drive the cross-tile carry
recurrence. These matrices ARE the compute: an intra-tile scan of width T
is ``B @ x``, the incoming-state correction ``R @ s``.

Everything here is float64 numpy, cast to the execution dtype at use. The
JAX package can also build these in a native host library; the port keeps
the numpy path only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def impulse_matrix(
    feedfwd: float,
    feedback: Sequence[float],
    tile_width: int,
    clamp_border: bool = False,
) -> np.ndarray:
    """B ∈ R^{T×T}: zero-incoming-state scan of a tile is ``y = B @ x``.

    ``B[y, x]`` is the response at output position ``y`` to a unit input at
    position ``x``. Lower triangular. With ``clamp_border`` the out-of-range
    taps of the first positions clamp to index 0 — only the globally-first
    tile of a scan uses this variant.
    """
    a = np.asarray(feedback, dtype=np.float64)
    k = a.shape[0]
    T = int(tile_width)
    B = float(feedfwd) * np.eye(T, dtype=np.float64)
    for y in range(T):
        for j in range(k):
            if y - j - 1 >= 0:
                B[y] += a[j] * B[y - j - 1]
            elif clamp_border:
                # In-place serial semantics: at y == 0 the clamped tap reads
                # the pre-update site (the raw input x[0]); at y >= 1 it
                # reads the already-updated output y[0], i.e. row 0 of B.
                if y == 0:
                    B[y, 0] += a[j]
                else:
                    B[y] += a[j] * B[0]
    return B


def state_matrix(feedback: Sequence[float], tile_width: int) -> np.ndarray:
    """R ∈ R^{T×k}: response of a tile to incoming state, ``y += R @ s``.

    ``s[j]`` is the scan value at position ``-1-j`` relative to the tile
    start (the previous tile's last ``k`` outputs, nearest first).
    Feedforward does not apply to state contributions.
    """
    a = np.asarray(feedback, dtype=np.float64)
    k = a.shape[0]
    T = int(tile_width)
    R = np.zeros((T, k), dtype=np.float64)
    for y in range(T):
        if y < k:
            for x in range(k):
                if x + y < k:
                    R[y, x] = a[x + y]
        for j in range(k):
            if y - j - 1 >= 0:
                R[y] += a[j] * R[y - j - 1]
    return R


def tail_projector(tile_width: int, order: int) -> np.ndarray:
    """P ∈ R^{k×T}: extracts outgoing state from a completed tile,
    ``s'[j] = y[T-1-j]``."""
    T, k = int(tile_width), int(order)
    P = np.zeros((k, T), dtype=np.float64)
    for j in range(k):
        P[j, T - 1 - j] = 1.0
    return P


def tail_weight_matrix(feedback: Sequence[float],
                       tile_width: int) -> np.ndarray:
    """W = P @ R ∈ R^{k×k}: carry propagation across one tile."""
    k = len(tuple(feedback))
    return tail_projector(tile_width, k) @ state_matrix(feedback, tile_width)


def antidiagonal(size: int) -> np.ndarray:
    """Anti-diagonal (flip) matrix, used when composing carries between
    scans of opposite causality."""
    return np.eye(size, dtype=np.float64)[::-1].copy()


def carry_chain_matrix(feedback: Sequence[float], tile_width: int,
                       num_tiles: int, prev: bool = True) -> np.ndarray:
    """M (n·k × n·k), block lower triangular: with the local tails
    ``b_i = P·B·x_i`` of every tile stacked, the incoming state of every
    tile is ``s_prev = M·b`` (``prev=True``: ``M[t, i] = W^(t-1-i)`` for
    i < t) or the completed state ``s = M·b`` (``prev=False``:
    ``M[t, i] = W^(t-i)``) — the whole cross-tile recurrence as one
    product."""
    k, n = len(tuple(feedback)), int(num_tiles)
    W = tail_weight_matrix(feedback, tile_width)
    powers = [np.eye(k, dtype=np.float64)]
    for _ in range(n):
        powers.append(W @ powers[-1])
    M = np.zeros((n, k, n, k), dtype=np.float64)
    for t in range(n):
        for i in range(t + 1):
            if not prev:
                M[t, :, i, :] = powers[t - i]
            elif i < t:
                M[t, :, i, :] = powers[t - 1 - i]
    return M.reshape(n * k, n * k)
