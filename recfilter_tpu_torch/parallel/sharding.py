"""Segment-level carry-exchange matrices (host, float64 numpy).

Ported copies of the host builders of ``recfilter_tpu.parallel.sharding``
(not imports: that package imports jax). They are the overlapped-tiling
algebra with "tile" = "segment": the in-chip hierarchical chain
(:func:`..dimfuse.hierarchical_dim_pass`) uses them with the supertiles of
one signal as segments. Running segments on several devices, the
``torch.distributed`` part of that module, is ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import numpy as np

from .. import coeffs
from ..spec import BorderMode


def _apply_scan_cols(M: np.ndarray, scan, border: str) -> np.ndarray:
    """Apply ``scan`` down the columns of a (seg, q) block — host-side, used
    to evolve segment-level correction columns. The clamped scan is the
    linear map Bf, so clamped evolution of a correction column is just the
    clamped scan applied to it."""
    from .. import scan_core

    return scan_core.oracle_apply_scan(
        M, 0, scan.causal, scan.feedfwd, list(scan.feedback), border
    )


def _clamp_col(scan, eff: int, total: int = 0) -> np.ndarray:
    """v = (Bf − B)·e_edge: the segment-level clamp response column.

    Every clamp contribution is proportional to the edge sample, so
    Bf − B = v·e_edgeᵀ is rank-1 and the clamped local pass equals the
    zero-border local pass plus ``v ⊗ x[edge]``.

    ``eff`` is the effective (unpadded) length; with ``total > eff`` the
    column zero-extends over the padded slots of a non-dividing segment.
    """
    e = np.zeros((eff, 1), dtype=np.float64)
    e[0 if scan.causal else eff - 1, 0] = 1.0
    vc = _apply_scan_cols(e, scan, BorderMode.CLAMP)
    vz = _apply_scan_cols(e, scan, BorderMode.ZERO)
    v = (vc - vz)[:, 0]
    if total > eff:
        v = np.concatenate([v, np.zeros(total - eff)])
    return v


def _evolve_cols(M: np.ndarray, scan, clamp_edge: bool, eff: int):
    """Evolve correction columns through one scan, clamped at the effective
    edge when ``clamp_edge``: Bf·M = B·M + v ⊗ M[edge] (rank-1 identity)."""
    out = _apply_scan_cols(M, scan, BorderMode.ZERO)
    if clamp_edge:
        v = _clamp_col(scan, eff, total=M.shape[0])
        edge = 0 if scan.causal else eff - 1
        out = out + v[:, None] * M[edge]
    return out


def _segment_exchange_mats(scans, seg: int, D: int, clamp: bool = False,
                           pad: int = 0, build_cm: bool = True):
    """Segment-level matrices for the carry exchange — the dimfuse algebra
    with "tile" = "segment", built column-wise (never a seg×seg matrix):
    per-scan natural correction columns Rhat (seg, k_i) evolved through the
    later scans, cross-scan couplings H, and per-scan chain matrices.

    With ``clamp``, the globally-first/last segments get distinct
    variants: correction columns evolve through the CLAMPED scan on the
    scan's edge segment. ``pad`` is the zero padding on the globally-last
    segment; padded slots behave exactly like zero-input samples, so only
    the clamp edge position moves.

    Returns ``(orders, H, CMs, Rcats)``: ``H[i][j]`` is (1|D, k_i, k_j);
    ``CMs[i]`` is the (D·k_i)² chain matrix (None unless ``build_cm``);
    ``Rcats`` is stacked (1|3, seg, ΣK) — [first, interior, last] under
    clamp or pad.
    """
    from .. import dimfuse

    m = len(scans)
    orders = [s.order for s in scans]
    # natural correction columns of each scan (the same for every variant)
    RNs = []
    for s in scans:
        R = coeffs.state_matrix(s.feedback, seg)
        RNs.append(R @ coeffs.antidiagonal(s.order) if s.causal
                   else R[::-1, :])

    def build(dev):
        # dev: 0 (globally first), None (interior), D-1 (globally last)
        eff = seg - pad if dev == D - 1 else seg
        cols = [None] * m  # RN_i evolved through scans applied so far
        H = [[None] * m for _ in range(m)]
        for i, s in enumerate(scans):
            k = s.order
            edge = (dev == 0) if s.causal else (dev is not None
                                                and dev == D - 1)

            def proj(M):
                # Pad projector (dimfuse's Z at segment level): zero the
                # padded slots between scans so a later scan sees the
                # zero-border contract there.
                if dev == D - 1 and pad:
                    M = M.copy()
                    M[eff:, :] = 0.0
                return M

            for j in range(i):
                evolved = proj(_evolve_cols(cols[j], s, clamp and edge, eff))
                if s.causal:
                    H[i][j] = evolved[seg - k:, :]  # (k_i, k_j)
                else:
                    H[i][j] = evolved[:k, :]
                cols[j] = evolved
            cols[i] = proj(RNs[i])
        Rcat = np.concatenate(cols, axis=1)  # (seg, ΣK)
        return H, Rcat

    # The per-scan (D·k)² chain matrices feed the dense combined solve
    # only; the Kogge–Stone route past ΣK=8 solves via k×k transfer
    # matrices instead and skips this quadratic-in-D host build.
    CMs = ([dimfuse._chain_matrix(s, seg, D) for s in scans]
           if build_cm else None)

    if not clamp and not pad:
        H1, Rcat = build(None)
        H = [
            [(H1[i][j][None] if j < i else None) for j in range(m)]
            for i in range(m)
        ]
        return orders, H, CMs, Rcat[None]

    built = {0: build(0), None: build(None), D - 1: build(D - 1)}

    def h_stack(i, j):
        return np.stack(
            [built[d if d in (0, D - 1) else None][0][i][j] for d in range(D)]
        )

    H = [
        [(h_stack(i, j) if j < i else None) for j in range(m)]
        for i in range(m)
    ]
    Rcats = np.stack(
        [built[0][1], built[None][1], built[D - 1][1]]
    )  # (3, seg, ΣK): [first, interior, last]
    return orders, H, CMs, Rcats


def _combined_solve(orders, H, CMs, D: int) -> np.ndarray:
    """Fold the per-scan chains + H couplings into one (D·ΣK)² matrix."""
    from .. import dimfuse

    return dimfuse.combined_solve_matrix(
        dimfuse.DimPassMats(orders=list(orders), G=[], H=H, CM=CMs,
                            Btot=None, Rhat=[], uniform=False), D)
