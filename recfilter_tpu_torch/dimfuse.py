"""Per-dimension fused-pass matrices and the whole-filter entry point.

For the scans of one dimension, per tile t (natural orientation;
anticausal scans carry anti-diagonal transforms J·B·J, J·R baked into their
matrices host-side):

    yⁱ = Btot_i x_t + Σ_{j≤i} Rhat_{i,j} Nʲ_t
    bⁱ_t = G_i x_t + Σ_{j<i} H_{i,j} Nʲ_t          (local tails of scan i)

    Btot_i   = B_i···B_1
    Rhat_{i,j} = (B_i···B_{j+1}) RN_j,  Rhat_{i,i} = RN_i
    G_i      = Sel_iᵀ Btot_i
    H_{i,j}  = Sel_iᵀ B_i Rhat_{i-1,j}

and Nⁱ = CM_i · stack(bⁱ) solves each scan's cross-tile recurrence with one
precomputed block-Toeplitz matmul. Clamped borders change the matrices of
the globally-first/last tile only; those tiles get per-tile variants.

The device side of the port is the 2-D executor in :mod:`.overlap2d`;
:func:`apply_filter_fused` admits the filters it runs and raises
``NotImplementedError`` for every other one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from . import coeffs
from .spec import FilterSpec, Scan

# Above this tile count the JAX package replaces the quadratic chain matmul
# by an associative scan; the port has only the matmul.
_CHAIN_MATMUL_MAX_TILES = 256


def _scan_base_mats(s: Scan, T: int, clamp: bool):
    """Direction-transformed (natural orientation) per-scan matrices."""
    k = s.order
    B = coeffs.impulse_matrix(s.feedfwd, s.feedback, T)
    Bf = (
        coeffs.impulse_matrix(s.feedfwd, s.feedback, T, clamp_border=True)
        if clamp
        else B
    )
    R = coeffs.state_matrix(s.feedback, T)
    Jk = coeffs.antidiagonal(k)
    Sel = np.zeros((T, k))
    if s.causal:
        RN = R @ Jk  # corr from natural (ascending last-k) prev carry
        for j in range(k):
            Sel[T - k + j, j] = 1.0
    else:
        B = B[::-1, ::-1].copy()
        Bf = Bf[::-1, ::-1].copy()
        RN = R[::-1, :]
        for j in range(k):
            Sel[j, j] = 1.0
    return B, Bf, RN, Sel


def _chain_matrix(s: Scan, T: int, n: int) -> np.ndarray:
    """CM (n·k × n·k): stacked natural local tails b → stacked natural
    incoming vectors N (corr_t = RN · N_t). Direction folded in."""
    k = s.order
    W = coeffs.tail_weight_matrix(s.feedback, T)
    Jk = coeffs.antidiagonal(k)
    powers = [np.eye(k)]
    for _ in range(n):
        powers.append(W @ powers[-1])
    C = np.zeros((n, k, n, k))
    for t in range(n):
        if s.causal:
            for i in range(t):
                C[t, :, i, :] = Jk @ powers[t - 1 - i] @ Jk
        else:
            for i in range(t + 1, n):
                C[t, :, i, :] = powers[i - 1 - t]
    return C.reshape(n * k, n * k)


def combined_solve_matrix(mats: "DimPassMats", n: int) -> np.ndarray:
    """Fold every scan's chain solve AND the cross-scan H-couplings into one
    (n·ΣK × n·ΣK) matrix: N_cat = CMfull · b_raw_cat (interleaved per-tile
    layout, matching the stacked-G tails and concatenated Rhat).

    The per-scan system is block-triangular,
        N_i = CM_i (b_i^raw + Σ_{j<i} Hblk_{ij} N_j),
    so CMfull's rows build up scan by scan."""
    m = len(mats.orders)
    S = sum(mats.orders)
    if m == 1:
        return np.asarray(mats.CM[0])
    offs = np.cumsum([0] + mats.orders)
    rows: list = [None] * m  # rows[i]: (n*k_i, n*S) mapping braw_cat → N_i

    def hblk(i, j):
        Hs = mats.H[i][j]
        ki, kj = mats.orders[i], mats.orders[j]
        out = np.zeros((n * ki, n * kj))
        for t in range(n):
            Ht = Hs[t if Hs.shape[0] > 1 else 0]
            out[t * ki : (t + 1) * ki, t * kj : (t + 1) * kj] = Ht
        return out

    for i in range(m):
        ki = mats.orders[i]
        E = np.zeros((n * ki, n * S))
        for t in range(n):
            E[t * ki : (t + 1) * ki,
              t * S + offs[i] : t * S + offs[i] + ki] = np.eye(ki)
        acc = E
        for j in range(i):
            acc = acc + hblk(i, j) @ rows[j]
        rows[i] = mats.CM[i] @ acc

    full = np.zeros((n * S, n * S))
    for i in range(m):
        ki = mats.orders[i]
        for t in range(n):
            full[t * S + offs[i] : t * S + offs[i] + ki, :] = rows[i][
                t * ki : (t + 1) * ki, :
            ]
    return full


@dataclasses.dataclass
class DimPassMats:
    """Per-dimension fused-pass matrices (float64 numpy).

    ``G[i]`` is (n, k_i, T); ``H[i][j]`` is (n, k_i, k_j); ``CM[i]`` is
    (n·k_i, n·k_i); ``Btot`` is (n, T, T); ``Rhat[j]`` is (n, T, k_j).
    The ``n`` axis carries the edge-tile variants (clamp, pad); for zero
    borders with dividing widths every tile is identical and the n axis is
    collapsed to 1.
    """

    orders: List[int]
    G: List[np.ndarray]
    H: List[List[np.ndarray]]
    CM: List[np.ndarray]
    Btot: np.ndarray
    Rhat: List[np.ndarray]
    uniform: bool  # True → n axis collapsed (no per-tile variants)


def prepare_dim_pass(
    scans: Sequence[Scan], T: int, n: int, clamp: bool, pad_slots: int = 0,
    build_cm: bool = True,
) -> DimPassMats:
    m = len(scans)
    base = [_scan_base_mats(s, T, clamp) for s in scans]

    # Pad projector for the last tile: ``pad_slots`` trailing positions are
    # zero padding, and a causal scan propagates real values into them — a
    # later scan must see zeros there (the zero-border contract). Replacing
    # B with B·Z for the last tile zeroes those slots between scans; on the
    # raw input x the pad is genuinely zero, so the extra Z is harmless.
    Z = np.eye(T)
    if pad_slots:
        Z[np.arange(T - pad_slots, T), np.arange(T - pad_slots, T)] = 0.0

    def mats_for_tile(t: int):
        out = []
        for s, (B, Bf, RN, Sel) in zip(scans, base):
            edge = (t == 0) if s.causal else (t == n - 1)
            Bt = Bf if (clamp and edge) else B
            if pad_slots and t == n - 1:
                Bt = Bt @ Z
            out.append((Bt, RN, Sel))
        return out

    # Representative tiles: interior (a middle tile when one exists) plus
    # the tiles whose matrices differ — first/last for clamp, last for pad.
    if not clamp and not pad_slots:
        tiles = [0]
    else:
        special = set()
        if clamp:
            special |= {0, n - 1}
        if pad_slots:
            special.add(n - 1)
        interior = {t for t in range(n) if t not in special}
        tiles = sorted(special | ({min(interior)} if interior else set()))

    per_tile = {t: mats_for_tile(t) for t in tiles}

    def build(tile_mats):
        Btot_i = [None] * m
        Rhat_i = [[None] * m for _ in range(m)]
        G = [None] * m
        H = [[None] * m for _ in range(m)]
        acc = np.eye(T)
        for i, (B, RN, Sel) in enumerate(tile_mats):
            for j in range(i):
                Rhat_i[i][j] = B @ Rhat_i[i - 1][j]
            Rhat_i[i][i] = RN
            acc = B @ acc
            Btot_i[i] = acc
            G[i] = Sel.T @ acc
            for j in range(i):
                H[i][j] = Sel.T @ (B @ Rhat_i[i - 1][j])
        return G, H, Btot_i[m - 1], Rhat_i[m - 1]

    built = {t: build(mats) for t, mats in per_tile.items()}

    if not clamp and not pad_slots:
        G1, H1, Btot1, Rhat1 = built[0]
        return DimPassMats(
            orders=[s.order for s in scans],
            G=[g[None] for g in G1],
            H=[[h[None] if h is not None else None for h in row] for row in H1],
            CM=[_chain_matrix(s, T, n) if build_cm else None for s in scans],
            Btot=Btot1[None],
            Rhat=[r[None] for r in Rhat1],
            uniform=True,
        )

    interior_reps = [t for t in tiles if t not in (0, n - 1)] or [tiles[0]]
    interior_t = interior_reps[0]

    def stack(select):
        rows = []
        for t in range(n):
            key = t if t in built else interior_t
            rows.append(select(built[key]))
        return np.stack(rows)

    G = [stack(lambda b, i=i: b[0][i]) for i in range(m)]
    H = [
        [
            (stack(lambda b, i=i, j=j: b[1][i][j]) if j < i else None)
            for j in range(m)
        ]
        for i in range(m)
    ]
    Btot = stack(lambda b: b[2])
    Rhat = [stack(lambda b, j=j: b[3][j]) for j in range(m)]
    return DimPassMats(
        orders=[s.order for s in scans],
        G=G,
        H=H,
        CM=[_chain_matrix(s, T, n) if build_cm else None for s in scans],
        Btot=Btot,
        Rhat=Rhat,
        uniform=False,
    )


# ---------------------------------------------------------------------------
# Whole-filter entry point
# ---------------------------------------------------------------------------


def fused_filter_module(spec: FilterSpec, matmul_precision: str = "px6"):
    """The executor module for ``spec``: a :class:`.overlap2d.Fused2DPx`
    sized to the spec's two trailing extents, or ``NotImplementedError``
    naming what the port does not run yet."""
    from . import overlap2d
    from .planner import check_precision

    check_precision(matmul_precision)
    if spec.dtype != "float32":
        raise NotImplementedError(
            f"dtype {spec.dtype}: the port runs float32 filters only "
            "(ROADMAP Queue 1 items 4 and 11: bf16 storage, integer-exact)")
    if spec.tuple_width:
        raise NotImplementedError(
            "Tuple filters are not ported yet (ROADMAP Queue 1 item 7)")
    groups = spec.scans_by_axis()
    nd = spec.ndim
    if set(groups) != {nd - 2, nd - 1}:
        raise NotImplementedError(
            f"scans on axes {sorted(groups)} of a {nd}-D filter: the port "
            "runs filters that scan exactly the two trailing axes "
            "(ROADMAP Queue 1 items 6 and 8: 1-D, non-trailing axes, "
            "volumes)")
    # Like the JAX package's 2-D px executor, the kernels' 128 × 128 tile
    # replaces the split widths (tiling never changes the result).
    ax_a, ax_b = nd - 2, nd - 1
    return overlap2d.Fused2DPx(
        [spec.scans[i] for i in groups[ax_a]],
        [spec.scans[i] for i in groups[ax_b]],
        spec.dims[ax_a].extent, spec.dims[ax_b].extent, spec.border)


def apply_filter_fused(spec: FilterSpec, x, matmul_precision: str = "px6"):
    """Run ``spec`` on the tensor ``x`` (on ``x``'s device) through the
    3-touch 2-D executor. Only trailing-2-D float32 filters run; every
    other filter raises ``NotImplementedError``."""
    mod = fused_filter_module(spec, matmul_precision).to(x.device)
    return mod(x)

