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

:func:`fused_filter_module` routes a filter as the JAX package's
``apply_filter_fused`` does, in its order:

  0. integer filters: the exact executor :class:`IntUnitPass` — unit
     axes on the wrapping ``int_scan``/``int_seg_scan`` kernels, any other
     axis (or a clamp border) as signed mantissa limbs through the tiled
     pass at ``f32x9``, the sequential core past its gain gate and for
     int64;
  1. scans on exactly the two trailing axes, at px6, px4, px3 or
     ``default``, where its gates hold (:func:`.overlap2d.fused2d_decline`):
     the 3-touch 2-D executor :class:`.overlap2d.Fused2DPx` at the grade;
  2. scans on exactly the three trailing axes (volumes), at the same
     grades, where the rows gates hold: the rows pass
     :class:`.overlap2d.FusedRowsPx` on the leading one, then
     :class:`.overlap2d.Fused2DPx` on the trailing pair, both at the grade
     — or, where the pair declines, the rest of this list on the pair;
  3. any trailing group of 2–5 axes with a tile plan on each: the rotation
     chain :class:`RotationChain`, one rotated :class:`LastAxisPass` per
     axis, the next pass's tails extracted by the previous pass's
     completion kernel where the gates allow;
  4. every other filter, one scanned axis after another in order of first
     appearance (:class:`StagedPass`): :class:`.overlap2d.FusedRowsPx` on
     each axis but the last where its gates hold at px6, px4 or px3 (and
     no epilogue rides that final pass), else :class:`FusedAxisPass` (the
     axis moved last, one rotated :class:`LastAxisPass`); on the last axis
     :class:`FusedLastAxis`, this module's port of the JAX package's
     ``fused_dim_pass`` — the supertile hierarchy
     (:class:`HierarchicalPass`) for audio-scale tile counts, else one
     tiled pass (:class:`LastAxisPass`) on the ``tails``/``completion``
     kernels where their gates hold, else its einsum form. A filter that
     scans one axis alone is that one stage.

The routes are decided by gate functions before any module is built, so
nothing is caught and no fallback hides a failure. An axis with no tile
plan (an order above the extent, a clamp border with no dividing tile)
runs the sequential core (:class:`.scan_core.ScanAxis`), as the JAX
package runs its ``lax.scan`` core there. Where the port has no
counterpart of the JAX package's route (other dtypes and precisions, the
routes of 3 and 4 without a kernel at the reduced grades px3, px4 and
``default``), it raises ``NotImplementedError`` naming the ROADMAP item.

Storage types, as the JAX package's ``apply_filter_fused`` has them: a
bf16 filter runs routes 1–4 at one product whatever the grade
(:func:`.planner.storage_nprod`; no structural rule), the image in bf16
between passes (``dtype=torch.bfloat16`` on :class:`.overlap2d.Fused2DPx`,
:class:`.overlap2d.FusedRowsPx`, :class:`RotationChain`,
:class:`FusedAxisPass`, :class:`FusedLastAxis` and :class:`LastAxisPass`,
whose kernels read and write bf16; the stencil consumers too: a fused
``stencil2d`` bank, a rotated emit's fused stencil, a ``stencil2d`` bank
after the filter, and the stencil fallbacks, the last in float32 on the
bf16 output, rounded once); where a pass's kernels do not apply it takes
its einsum form on bf16-rounded operands with float32 sums, the carries in
float64, the output rounded once (:class:`LastAxisPass`), and an axis with
no tile plan runs the sequential core in float32, cast back (the JAX
package's einsum and ``lax.scan`` forms at ``cdt`` bf16); the supertile
hierarchy is float32 only, as in the JAX package, so a bf16 signal past
256 tiles takes the einsum form. A float16 filter runs the float32 routes
on its input cast to float32 and casts the output back
(:class:`Float16Storage`).

The JAX package's consumers ride these routes: an elementwise
``epilogue(y, *eaux)`` reaches the final stage; a ``stencil2d`` bank
fuses into the 2-D executor, or runs on the output of any other route
(:class:`Stencil2DAfter`). :class:`RotatedPass` is ``apply_filter_rotated``
(``Plan.rotate_emit``): a single-dimension filter emitted with its
trailing axes rotated, on :class:`LastAxisPass`'s rotated kernel route,
with a shifted-tap ``stencil`` fused into the rotated completion. The
stencil always reads the filter output and the epilogue the stencil's.

The device side's carry glue (solves, chains, corrections) runs in float64
torch: the carries amplify rounding, and fp32 glue misses the px6 bound
(see :mod:`.overlap2d`). Signal-sized products run in float32, tails sums
in float64.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import coeffs
from .epilogue import kernel_form
from .kernels import completion as kc
from .kernels.completion import _f32, _f64
from .kernels import split as ksplit
from .kernels.split import NPROD
from .kernels.stencil2d import Stencil2D, shift_mode as _shift_mode
from .parallel import sharding as sh
from .planner import SPLIT_GRADES, refuse_split, storage_nprod
from .scan_core import ScanAxis
from .spec import BorderMode, FilterSpec, Scan

# Above this tile count the quadratic chain matmul is replaced by the
# supertile hierarchy or, failing its gates, an associative scan.
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
# Tile plans and carry solves (host builders, numpy)
# ---------------------------------------------------------------------------


def _plan_tiles(w: int, tile_width: int, kmax: int, clamp: bool):
    """Resolve (T, n, pad) for one dimension, or None when the blocked
    algebra cannot apply (order exceeds any legal tile; clamp with no exact
    divisor)."""
    T = int(min(max(tile_width, kmax), w))
    n = -(-w // T)
    pad = n * T - w
    # Zero padding at the end is exact for ZERO borders in both directions.
    # For CLAMP the globally-last tile's matrices assume the edge sits at
    # the tile's end, so clamp requires T | w; fall back to a divisor.
    if clamp and pad:
        for cand in range(T, kmax - 1, -1):
            if w % cand == 0:
                T, n, pad = cand, w // cand, 0
                break
    if T < kmax or (clamp and pad):
        return None
    return T, n, pad


def banded_solve_blocks(CMfull: np.ndarray, n: int, S: int,
                        tol: float = 1e-9, max_band: int = 16):
    """Block-banded form of the combined solve matrix, or None.

    Tile-to-tile carry influence decays like |pole|^T per tile, so for
    stable (non-integrator) filters the (n·S)² chain matrix is effectively
    block-banded. Returns [(offset d, blocks (n, S, S))] where block t maps
    tile t-d's raw tails into tile t's carries; offsets whose largest block
    falls below ``tol``·max are dropped (≤ f32 noise). Below 64 tiles, and
    for integrators (poles on the unit circle, whose band is as wide as n),
    returns None and the caller keeps the dense matmul — the JAX package's
    rule, measured on its TPU.
    """
    CM = np.asarray(CMfull).reshape(n, S, n, S)
    norms = np.abs(CM).max(axis=(1, 3))  # (n_to, n_from)
    scale = float(norms.max())
    if scale == 0.0:
        return [(0, np.zeros((n, S, S)))]
    offsets = []
    for d in range(-(n - 1), n):
        diag = [norms[t, t - d] for t in range(max(0, d), min(n, n + d))]
        if diag and max(diag) > tol * scale:
            offsets.append(d)
    if n < 64 or len(offsets) > min(max_band, n // 4):
        return None
    out = []
    for d in offsets:
        blocks = np.zeros((n, S, S))
        for t in range(n):
            i = t - d
            if 0 <= i < n:
                blocks[t] = CM[t, :, i, :]
        out.append((d, blocks))
    return out


def _ks_powers(feedback, seg: int, D: int) -> np.ndarray:
    """W^(2^i) for the Kogge–Stone steps over D segments (W: the transfer
    of a carry across one segment of ``seg`` samples)."""
    W = np.asarray(coeffs.tail_weight_matrix(feedback, seg), np.float64)
    out, sh = [], 1
    while sh < D:
        out.append(W)
        W = W @ W
        sh *= 2
    return np.stack(out) if out else np.zeros((0,) + W.shape)


# ---------------------------------------------------------------------------
# Carry solves (torch, float64)
# ---------------------------------------------------------------------------


def _bands_span(bands):
    dmax = max(max(d for d, _ in bands), 0)
    dmin = min(min(d for d, _ in bands), 0)
    return dmax, dmin


def _banded_solve_apply(bands, braw_t, S: int):
    """Banded solve on slot-padded transposed tails (..., n, sl, q):
    N_t = Σ_d B_d[t] · b_{t−d} — one (n,S,S)×(n,S,q) product per offset
    instead of the dense (n·sl)² matmul; leading axes are a batch.
    ``bands``: [(d, blocks (n,S,S))] with torch blocks."""
    n, slots, q = braw_t.shape[-3:]
    b = braw_t[..., :S, :]
    dmax, dmin = _bands_span(bands)
    bpad = F.pad(b, (0, 0, 0, 0, dmax, -dmin)) if dmax or dmin else b
    N = None
    for d, blocks in bands:
        t = torch.einsum("nab,...nbq->...naq", blocks,
                         bpad.narrow(-3, dmax - d, n))
        N = t if N is None else N + t
    return F.pad(N, (0, 0, 0, slots - S)) if S < slots else N


def _banded_solve_apply_nat(bands, braw):
    """:func:`_banded_solve_apply` on natural-layout tails (..., n, S)."""
    n = braw.shape[-2]
    dmax, dmin = _bands_span(bands)
    bpad = F.pad(braw, (0, 0, dmax, -dmin)) if dmax or dmin else braw
    N = None
    for d, blocks in bands:
        t = torch.einsum("nab,...nb->...na", blocks,
                         bpad.narrow(-2, dmax - d, n))
        N = t if N is None else N + t
    return N


def affine_scan(A, s):
    """Inclusive scan of the affine maps v ↦ A_t·v + s_t along axis 1 of
    ``s`` (a, n, k), ``A`` (n, k, k): v_t = A_t·v_{t-1} + s_t from
    v_{-1} = 0, in log₂ n Hillis–Steele steps — the JAX package's
    ``jax.lax.associative_scan`` over (W, b) pairs. Differentiable in both
    (the learnable executor's W is a runtime tensor)."""
    n = s.shape[1]
    off = 1
    while off < n:
        # element t absorbs element t - off: (A_t A_{t-off}, A_t s_{t-off} + s_t)
        s = torch.cat([s[:, :off], s[:, off:] + torch.einsum(
            "nij,anj->ani", A[off:], s[:, :-off])], dim=1)
        A = torch.cat([A[:off], A[off:] @ A[:-off]], dim=0)
        off *= 2
    return s


def _chain_solve_assoc(b, causal: bool, W, Jk):
    """Solve one scan's cross-tile recurrence with a log-depth associative
    scan over (W, b) affine pairs (:func:`affine_scan`).

    ``b`` is (a, n, k) natural local tails, ``W`` the k×k transfer of a
    carry across one tile, ``Jk`` the k×k flip; returns the natural
    incoming vectors N (a, n, k) — ``b_stacked @ CMᵀ`` without the
    quadratic chain matrix."""
    n, k = b.shape[1], b.shape[2]
    # causal: s_t = W s_{t-1} + Jk b_t, N_t = Jk s_{t-1}; anticausal: the
    # same recurrence over reversed tiles with identity converters
    s = torch.einsum("ij,anj->ani", Jk, b) if causal else b.flip(1)
    s = affine_scan(W.expand(n, k, k), s)
    s_prev = F.pad(s[:, :-1], (0, 0, 1, 0))
    if causal:
        return torch.einsum("ij,anj->ani", Jk, s_prev)
    return s_prev.flip(1)


def _chain_prefix_axis(b, causal: bool, Wpows, Jk):
    """Kogge–Stone carry-chain solve over a segment axis: zero-filled
    shifts along axis -2 of ``b`` (..., D, k) (the zero fill IS the
    zero-state boundary condition), log₂ D products against the k×k
    transfer powers ``Wpows`` (:func:`_ks_powers`) — no (D·k)² matrix.
    Returns the natural incoming vectors N (..., D, k)."""
    D = b.shape[-2]

    def shift(a, s):
        # causal: recv_d = a_{d-s}; anticausal: recv_d = a_{d+s}
        if causal:
            return F.pad(a[..., :D - s, :], (0, 0, s, 0))
        return F.pad(a[..., s:, :], (0, 0, 0, s))

    # causal: u_d = Jk b_d, inclusive s_d = Σ_{i≤d} W^{d-i} u_i,
    # N_d = Jk s_{d-1}; anticausal: inclusive from the right, N_d = s_{d+1}
    s_ = torch.einsum("ij,...j->...i", Jk, b) if causal else b
    sh = 1
    for Wp in Wpows:
        s_ = s_ + torch.einsum("ij,...j->...i", Wp, shift(s_, sh))
        sh *= 2
    s_prev = shift(s_, 1)
    if causal:
        return torch.einsum("ij,...j->...i", Jk, s_prev)
    return s_prev


# ---------------------------------------------------------------------------
# Consumers: the shifted-tap stencil and the elementwise epilogue
# ---------------------------------------------------------------------------


def apply_stencil(y, axis: int, taps, start: str = "zero",
                  end: str = "clamp"):
    """Shifted-tap consumer y[i] = Σ c_k·y[i + d_k] along ``axis``, border
    modes per direction (``start`` for d < 0, ``end`` for d > 0) — the
    global-shift twin of the in-kernel stencil."""
    out = None
    for d, c in taps:
        t = y if d == 0 else _shift_mode(y, int(d), axis,
                                         end if d > 0 else start)
        t = float(c) * t
        out = t if out is None else out + t
    return out


def _per_slice(taps) -> bool:
    return (bool(taps) and isinstance(taps[0], (list, tuple))
            and bool(taps[0]) and isinstance(taps[0][0], (list, tuple)))


def _stencil_taps_for(stencil, slice_idx=None):
    """The taps list: shared ``[(off, coeff), ...]`` or, per slice of the
    leading axis, ``[[(off, coeff), ...], ...]`` (DoG's dual radius; with
    no slice index, slice 0's)."""
    taps = stencil["taps"]
    if _per_slice(taps):
        return taps[0 if slice_idx is None else slice_idx]
    return taps


def _stencil_fallback(y, stencil, axis: int):
    """A (possibly per-slice) stencil as global shifts — wherever the
    in-kernel fusion's gates fail. Per-slice taps index the FIRST array
    axis (a negative ``axis`` stays valid under that slicing)."""
    start = stencil.get("start", "zero")
    end = stencil.get("end", "clamp")
    if not _per_slice(stencil["taps"]):
        return apply_stencil(y, axis, stencil["taps"], start, end)
    return torch.stack([
        apply_stencil(y[p], axis, _stencil_taps_for(stencil, p), start, end)
        for p in range(y.shape[0])])


def _stencil_reach(taps):
    """(hlo, hhi): forward reach (rows needed from the NEXT tile's head)
    and backward reach (rows from the PREVIOUS tile's tail)."""
    hhi, hlo = kc.stencil_reach(taps)
    return hlo, hhi


def _stencil_extra_rows(mats, taps, T: int):
    """Per-tile (nv, hlo + hhi, T) Btot row stack for the tails kernel's
    extra rows — the x-dependent part of the halo strips."""
    hlo, hhi = _stencil_reach(taps)
    B = np.asarray(mats.Btot)
    return np.concatenate([B[:, :hlo, :], B[:, T - hhi:, :]], axis=1)


def _stencil_halo(halo_base, Nt, Rrows, hlo: int, hhi: int):
    """The neighbour halo strips of the in-kernel stencil, in float64:
    halo rows of z_t = (Btot rows)·x_t + (Rcat rows)·N_t — the first term
    came out of the tails kernel (``halo_base`` (n, He, q), its extra
    rows), the second is a carry-sized einsum here (``Rrows`` (n, He, S),
    the per-tile Rcat rows; ``Nt`` (n, sl, q) the solved carries). Returns
    float32 (prev (n, hhi, q), nxt (n, hlo, q)), those present: prev[t] is
    tile t−1's tail, nxt[t] tile t+1's head, zeros past either end. (The
    JAX package quantizes them to 8-row blocks, a TPU constraint.)"""
    S = Rrows.shape[-1]
    halo = halo_base + torch.einsum("nhs,nsq->nhq", Rrows, Nt[:, :S])
    head, tail = halo[:, :hlo], halo[:, hlo:]
    out = []
    if hhi:
        out.append(torch.cat([torch.zeros_like(tail[:1]), tail[:-1]]))
    if hlo:
        out.append(torch.cat([head[1:], torch.zeros_like(head[:1])]))
    return [h.float().contiguous() for h in out]


def _aux_like(a, y):
    """An epilogue aux array on y's device in y's type — float32 where y
    is bf16 (bf16 storage keeps the aux arrays float32)."""
    dt = torch.float32 if y.dtype == torch.bfloat16 else y.dtype
    return torch.as_tensor(a).to(device=y.device, dtype=dt)


def _storage_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x for an executor storing ``dtype``: a float32 executor takes
    float32 only; a bf16 one casts its input to bf16, as the JAX package's
    ``x.astype(cdt)`` does (no copy for a bf16 input)."""
    if dtype == torch.bfloat16:
        return x.to(torch.bfloat16)
    if x.dtype != dtype:
        raise TypeError(f"expected {str(dtype).replace('torch.', '')} "
                        f"input, got {x.dtype}")
    return x


def _retile_aux(a, y, nat_axis: int, pad: int, tile_shape):
    """An epilogue aux array from the pass's natural output layout into
    its tile layout: pad the scanned axis like the pass input, then
    reshape to ``tile_shape``."""
    a = _aux_like(a, y)
    if pad:
        a = F.pad(a.movedim(nat_axis, -1), (0, pad)).movedim(-1, nat_axis)
    return a.reshape(tile_shape)


def _kernel_epilogue_aux(rot: bool, lead, n: int, T: int, rows, PR: int,
                         pad: int, eaux, y):
    """``eaux`` re-laid into the completion kernel's flat output layout:
    (n·T, PR) rotated, else (PR, n·T)."""
    P = int(np.prod(lead, dtype=np.int64)) if lead else 1
    if rot:
        tshape = (P, n, T) + tuple(rows)
        return tuple(_retile_aux(a, y, len(lead), pad, tshape)
                     .reshape(n * T, PR) for a in eaux)
    tshape = (P,) + tuple(rows) + (n, T)
    return tuple(_retile_aux(a, y, -1, pad, tshape).reshape(PR, n * T)
                 for a in eaux)


def _epilogue(fn, y, eaux):
    """``fn(y, *eaux)`` with the aux arrays on y's device and type."""
    return fn(y, *(_aux_like(a, y) for a in eaux))


# ---------------------------------------------------------------------------
# The split-einsum grades
# ---------------------------------------------------------------------------

# bf16 products of the einsum form's signal-sized products, per grade: the
# JAX package's ``_split_passes`` (f32x3, f32x4, f32x6; px3 and px4 where
# a pass leaves its kernels), ``high`` as TPU HIGH (three bf16 products),
# ``default`` as one. px6, ``highest`` and f32x9 run those products in
# float64 (f32x9's nine products are exact wherever float64 is).
EINSUM_NPROD = {"f32x3": 3, "high": 3, "f32x4": 4, "f32x6": 6, "px3": 3,
                "px4": 4, "default": 1}


def _split_einsum(eq: str, Mc: torch.Tensor, X: torch.Tensor,
                  nprod: int) -> torch.Tensor:
    """The JAX package's ``_split_einsum`` on a per-tile matrix stack
    (:func:`.kernels.completion.tile_einsum`): Σ over the ``nprod`` chunk
    pairs of :func:`.kernels.split.prods`, smallest level first, of
    constant chunk i (``Mc[i]``, its (1|3) variants, split from float64)
    times data chunk j (X split in float32, exact). The chunk products run
    as float32 products of bf16-exact values — exact products, float32
    sums, the arithmetic of a bf16 product with float32 accumulation (on
    the card a float32 GEMM, TF32 off) — and never round to bf16."""
    Xs = [d.float() for d in ksplit.split_data(X, ksplit.nchunks(nprod))]
    y = None
    for i, j in ksplit.prods(nprod):
        t = kc.tile_einsum(eq, Mc[i], Xs[j])
        y = t if y is None else y + t
    return y


# ---------------------------------------------------------------------------
# The last-axis executor
# ---------------------------------------------------------------------------


class LastAxisPass(nn.Module):
    """All ``scans`` of the last axis of float32 arrays (..., w), tiled by
    ``plan`` = (T, n, pad): the JAX package's ``_last_axis_pass_t``, with
    ``rot_axes=1`` (in-place emit; for a bare signal, the einsum branch of
    its ``fused_dim_pass``) or ``rot_axes ≥ 2`` (the rotated emit: the
    trailing ``rot_axes`` axes rotated one step, the scanned axis landing
    at position ``-rot_axes``).

    Kernel route, where the JAX package takes its kernel branch (px6,
    n ≤ 256 and ``completion_ok``, which needs ≥ 8 lines — so a bare
    signal never takes it — and, rotated, no leading group P > 1):
    ``tails`` kernel → banded or dense solve → ``completion`` kernel
    (``completion_rot`` rotated). A rotated pass with a leading group
    P > 1 runs that pipeline once per leading slice (no epilogue). A
    ``stencil`` consumer (``{"taps", "start", "end"}``, taps shared or per
    leading slice) rides the rotated kernel route where pad = 0 and its
    reach fits a tile: the tails kernel also emits the halo base rows, the
    halo strips complete in float64 (:func:`_stencil_halo`), and the
    rotated completion combines them with each tile before the write.
    Otherwise the einsum form: natural-layout tails, the solve (banded,
    dense, or the associative chain past 256 tiles), and the completion
    product — on the ``completion`` kernel where the JAX package's fallback
    takes it (256 < n ≤ 512) — and the stencil as global shifts after
    (:func:`_stencil_fallback`). The ``epilogue(y, *eaux)`` reads the
    stencil's output. Where :func:`.epilogue.affine_form` reads it as
    ``a·y + Σᵢ bᵢ·auxᵢ + c`` (k ≤ 4) and the completion kernel runs (with
    the stencil fused, where there is one), the kernel applies it before
    its write (``completion_epi``, ``completion_rot_epi``; eaux re-laid by
    :func:`_kernel_epilogue_aux`): ``epilogue_route``, fixed when the pass
    is built, is ``"kernel"`` where a completion kernel carries the form.
    Otherwise (``"torch"``), and on a call whose lines the kernel declines,
    it runs as torch ops: on the kernel's flat
    output, in the tile layout on the einsum form (:func:`_retile_aux`),
    or after a stencil fallback. The einsum form's
    products run in float64 (no TF32 can reach them on the card).
    ``forward(x, True)`` runs every kernel's plain twin instead.

    At the reduced grades (px3, px4, default: ``planner.SPLIT_GRADES``)
    the pass runs the same routes at the grade's product count (one at
    ``default``; :meth:`_split_nprod`) — ``tails`` (fp64 sums, as at px6),
    the solve, then, unrotated, ``completion_split`` (an affine epilogue
    in its store, ``completion_split_epi``), rotated, the rotated
    completions at the grade
    (``CompletionPass(nprod=)``: ``completion_rot``, its fused stencil and
    epilogue, ``completion_rot_tails``) — and, where the kernels' gates
    fail (fewer than 8 lines, tiles other than 128, ΣK > 56), its einsum
    form at the grade's products (the JAX package's split einsum). At
    ``default`` a rotated pass takes its kernels only where the JAX
    package finds a structural win (a fused stencil, tails chained out or
    in), else its einsum form. More than 256 tiles have no split form and
    raise ``NotImplementedError`` naming ROADMAP Queue 1 item 4, except
    where a rotated pass's completion kernel runs (at most 512 tiles).
    At the split-einsum grades (f32x3, f32x4, f32x6, ``high``) no kernel
    is built and the einsum form's tails and completion products are
    :func:`_split_einsum`'s chunk products (``nsp`` of them,
    :data:`EINSUM_NPROD`), float64 where a rotated pass has a leading
    group (as the JAX package keeps HIGHEST there); the solve and the
    carry injection stay float64. At ``f32x9`` the products are float64
    and the solve dense (no band dropped).

    bf16 storage (``dtype=torch.bfloat16``): one product on every kernel
    route whatever the grade (the JAX package's ``_kernel_nprod``, no
    structural rule), x padded and tiled in bf16, ``tails`` and the
    completion kernels reading and writing bf16 (the carries and their
    solve as at float32; an epilogue's aux arrays float32, a torch-route
    epilogue's output rounded to bf16). Where the kernels' gates fail —
    tiles other than 128, more than 256 tiles or ΣK > 56 at build time,
    fewer than 8 lines or a rotated leading group with an epilogue at the
    call — the einsum form runs as the JAX package's at ``cdt`` bf16: the
    tails and completion products on the bf16 x and the bf16-rounded
    constants (``G_b``, ``B_b``) with float32 sums, the solve and the
    carry injection in float64 (the JAX package rounds those to bf16: the
    port keeps every carry as its bf16 kernels do, ROADMAP Queue 3), the
    epilogue and a stencil fallback in float32, the output rounded once
    to bf16 (past 256 tiles the completion kernel still takes it where
    the float32 pass's would). A stencil fuses as at float32 (``tails_extra_bf16``,
    ``completion_rot_stencil_bf16`` and ``_epi_bf16``: the taps and the
    epilogue on the float32 accumulators, rounded once); where it cannot
    fuse, its fallback and the epilogue after it run in float32 on the
    bf16 output and round once.

    Tails chaining (a rotation chain's passes, :class:`RotationChain`):
    ``next_tails = (Gcat2, n2, T2)`` names the next pass, which scans this
    pass's line axis; where the rotated completion kernel runs (kernel
    route, per-slice route, or the einsum form's kernel completion) and
    :func:`.kernels.completion.next_tails_ok` holds, it is
    ``completion_rot_tails``, which also emits the next pass's tails
    (padded output lines sliced off). ``tails_in=True`` says that the
    previous pass of a chain may hand this one its tails (a structural win
    at ``default``). :meth:`run` takes the previous pass's
    tails as ``tails_in`` — the kernel and per-slice routes then skip their
    ``tails`` launch (slice p's tails are lines p·R..(p+1)·R, and the
    per-slice extracted tails concatenate P-major), the einsum form ignores
    them, as in the JAX package — and returns ``(y, tails_out)``, None
    where no tails were extracted. ``took_tails_in`` records whether the
    last call used ``tails_in``."""

    def __init__(self, scans: Sequence[Scan], plan, clamp: bool,
                 matmul_precision: str, rot_axes: int = 1, stencil=None,
                 epilogue=None, next_tails=None, tails_in: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        T, n, pad = plan
        self.T, self.n, self.pad = T, n, pad
        self.dtype = dtype
        bf16 = dtype == torch.bfloat16
        self.rot, self.nrow = rot_axes >= 2, max(rot_axes - 1, 1)
        self.stencil, self.epilogue = stencil, epilogue
        self.affine = kernel_form(epilogue)
        self.causal = [s.causal for s in scans]
        mats = prepare_dim_pass(scans, T, n, clamp, pad_slots=pad,
                                build_cm=n <= _CHAIN_MATMUL_MAX_TILES)
        self.orders = list(mats.orders)
        S = self.S = int(sum(self.orders))
        self.sl = kc.slots_for(S)
        Gcat = np.concatenate([np.asarray(g) for g in mats.G], axis=1)
        Rcat = np.concatenate([np.asarray(r) for r in mats.Rhat], axis=2)
        self.Gcat = Gcat  # host rows, for the previous pass of a chain
        self.took_tails_in = False

        # einsum-form operands: (1|3) variants [interior, first, last]
        self.register_buffer("G_v", _f64(kc._variants3(Gcat)))
        self.register_buffer("B_v", _f64(kc._variants3(mats.Btot)))
        self.register_buffer("R_v", _f64(kc._variants3(Rcat)))

        self.offsets = None  # band offsets when the solve is banded
        if n <= _CHAIN_MATMUL_MAX_TILES:
            CMfull = combined_solve_matrix(mats, n)
            # f32x9 (the integer limbs) solves drop-free: dense, as the
            # JAX package's nine-product solve
            bands = (None if matmul_precision == "f32x9"
                     else banded_solve_blocks(CMfull, n, S))
            if bands is not None:
                self.offsets = [d for d, _ in bands]
                self.register_buffer(
                    "bands", _f64(np.stack([b for _, b in bands])))
            else:
                self.register_buffer(
                    "CMp", _f64(kc.pad_solve_matrix(CMfull, n, S)))
        else:
            # associative chain per scan, with the cross-scan couplings
            for i, s in enumerate(scans):
                self.register_buffer(f"W{i}", _f64(
                    coeffs.tail_weight_matrix(s.feedback, T)))
                self.register_buffer(f"J{i}", _f64(
                    coeffs.antidiagonal(s.order)))
                for j in range(i):
                    self.register_buffer(f"H{i}_{j}", _f64(
                        kc._variants3(mats.H[i][j])))

        # the kernels, where the static part of the JAX package's gates
        # holds (the line count is checked per call)
        self.tails = self.completion = None
        self.st_tails = self.st_comp = None
        self.grade = matmul_precision
        # the einsum form's signal-sized products (tails and completion)
        # at a split grade: bf16 chunks of the constants' variants, split
        # from float64 (float32 tensors, bf16-exact)
        self.nsp = EINSUM_NPROD.get(matmul_precision, 0)
        if self.nsp:
            nc = ksplit.nchunks(self.nsp)
            for name, M in (("G_c", Gcat), ("B_c", mats.Btot)):
                self.register_buffer(name, torch.stack([
                    c.float() for c in ksplit.split_const(
                        kc._variants3(M), nc)]))
        nprod = NPROD.get(matmul_precision, 0)
        if bf16:
            # one product on the kernels; the einsum form's image-sized
            # products on bf16-rounded constants, float32 sums
            nprod, self.nsp = 1, 0
            for name, M in (("G_b", Gcat), ("B_b", mats.Btot)):
                self.register_buffer(name, _f32(kc._variants3(M)).to(
                    torch.bfloat16).float())
        elif matmul_precision in SPLIT_GRADES:
            nprod = self._split_nprod(stencil is not None
                                      or next_tails is not None or tails_in)
        self.nprod = nprod
        if nprod and kc.completion_ok(T, 8, n, S):
            if n <= _CHAIN_MATMUL_MAX_TILES:
                self.tails = kc.TailsPass(Gcat, n)
            # the epilogue rides the completion where no stencil precedes
            # it (a stencil fused in the kernel: st_comp below)
            self.completion = kc.CompletionPass(
                mats.Btot, Rcat, n, rot=self.rot,
                affine=self.affine if stencil is None else None,
                nprod=nprod)
            if (stencil is not None and self.rot and pad == 0
                    and n <= _CHAIN_MATMUL_MAX_TILES):
                self._fuse_stencil(mats, Gcat, Rcat, stencil)
        carrier = self.completion if stencil is None else self.st_comp
        self.epilogue_route = None if epilogue is None else (
            "kernel" if self.affine is not None and carrier is not None
            else "torch")
        # the rotated completion that also extracts the next pass's tails
        self.completion_nt = None
        if (self.completion is not None and next_tails is not None
                and self.rot and stencil is None and epilogue is None):
            Gcat2, n2, T2 = next_tails
            if kc.next_tails_ok(n2 * T2, self.sl, n2, np.shape(Gcat2)[1],
                                T2):
                self.completion_nt = kc.CompletionPass(
                    mats.Btot, Rcat, n, rot=True, next_tails=(Gcat2, n2),
                    nprod=self.nprod)

    def _split_nprod(self, structural: bool) -> int:
        """The kernels' product count at a reduced grade — the JAX
        package's ``_kernel_nprod``: at ``default`` a rotated pass takes
        its kernels (one product) only where they are a structural win — a
        fused stencil, or tails chained out (``next_tails``) or in
        (``tails_in``: a chain pass after one that chains them) — else 0,
        the einsum form, as the JAX package's einsum pass; the unrotated
        pass takes ``completion_split`` at every grade. Past 256 tiles the
        pass raises ``NotImplementedError`` (the associative chain and the
        supertile hierarchy have no split form), except a rotated pass
        whose completion kernel runs (at most 512 tiles: the einsum form's
        tails and solve, then ``completion_rot`` at the grade)."""
        T, n, S, p = self.T, self.n, self.S, self.grade
        nprod = NPROD[p]
        if self.rot and p == "default" and not structural:
            nprod = 0
        if n > _CHAIN_MATMUL_MAX_TILES and not (
                self.rot and nprod and kc.completion_ok(T, 8, n, S)):
            refuse_split(p, f"the einsum form of a last-axis pass ({n} tiles "
                         f"of {T}, ΣK = {S}; the supertile hierarchy past "
                         f"{_CHAIN_MATMUL_MAX_TILES} tiles)")
        return nprod

    def _fuse_stencil(self, mats, Gcat, Rcat, stencil):
        """The stencil's kernels, one tails + rotated completion pair per
        distinct tap set (per leading slice, or shared) — where every
        set's reach fits one tile (a wider reach takes the fallback)."""
        T, n = self.T, self.n
        sets = (stencil["taps"] if _per_slice(stencil["taps"])
                else [stencil["taps"]])
        if any(max(_stencil_reach(t)) > T for t in sets):
            return
        mode = dict(start=stencil.get("start", "zero"),
                    end=stencil.get("end", "clamp"))
        Rn = kc._per_tile(Rcat, n)
        self.st_tails, self.st_comp, self.st_reach = (
            nn.ModuleList(), nn.ModuleList(), [])
        for i, taps in enumerate(sets):
            hlo, hhi = _stencil_reach(taps)
            self.st_tails.append(kc.TailsPass(
                Gcat, n, extra_rows=_stencil_extra_rows(mats, taps, T)))
            self.st_comp.append(kc.CompletionPass(
                mats.Btot, Rcat, n, rot=True, stencil=dict(taps=taps,
                                                           **mode),
                affine=self.affine, nprod=self.nprod))
            self.register_buffer(f"st_R{i}", _f64(np.concatenate(
                [Rn[:, :hlo], Rn[:, T - hhi:]], axis=1)))
            self.st_reach.append((hlo, hhi))

    def forward(self, x: torch.Tensor, plain: bool = False,
                eaux=()) -> torch.Tensor:
        return self.run(x, plain, eaux)[0]

    def _nt(self, q: int):
        """The next-tails completion for q lines, or None."""
        c = self.completion_nt
        if c is None or not kc.next_tails_ok(q, self.sl, c.n2, c.S2, kc.TILE):
            return None
        return c

    def _cut_tails(self, t2):
        """Extracted next-pass tails without this pass's padded output
        lines (the lines are (n·T, ra), a-minor)."""
        if t2 is None or not self.pad:
            return t2
        n2, sl, nT = t2.shape[0], t2.shape[1], self.n * self.T
        return (t2.reshape(n2, sl, nT, -1)[:, :, :nT - self.pad]
                .reshape(n2, sl, -1))

    def run(self, x: torch.Tensor, plain: bool = False, eaux=(),
            tails_in=None):
        """The pass on ``x``: ``(y, tails_out)`` (class docstring)."""
        T, n, pad, S = self.T, self.n, self.pad, self.S
        if pad:
            x = F.pad(x, (0, pad))
        nrow, rot = self.nrow, self.rot
        rows = tuple(x.shape[-1 - nrow:-1])
        lead = tuple(x.shape[:-1 - nrow])
        P = int(np.prod(lead, dtype=np.int64)) if lead else 1
        R = int(np.prod(rows, dtype=np.int64)) if rows else 1
        X = x.reshape(-1, n, T).contiguous()
        q = X.shape[0]
        kernel = (self.tails is not None and (P == 1 or not rot)
                  and kc.completion_ok(T, q, n, S))
        slices = (not kernel and self.tails is not None and rot and P > 1
                  and self.epilogue is None and kc.completion_ok(T, R, n, S))
        bf16 = self.dtype == torch.bfloat16
        fused = False
        t_out = None
        self.took_tails_in = False
        kaux = None  # eaux in the completion kernel's output layout

        def epi_aux(comp):
            """The aux arrays for ``comp`` where it applies the epilogue."""
            nonlocal kaux
            if comp.affine is None:
                return ()
            kaux = self._kernel_aux(eaux, lead, rows, q, X)
            return kaux

        # Y in the route's layout: "kernel" (q, n, T), or (n·T, q) rotated;
        # "slices" (P, n·T, R); "tile" (P, *rows, n, T) or (P, n, T, *rows)
        if kernel:
            layout = "kernel"
            if self.st_comp is not None:
                Y, fused = self._stencil_slice(X, 0, plain, epi_aux), True
            else:
                Y, t_out = self._kernel_slice(X, plain, tails_in,
                                              self._nt(q), epi_aux)
                t_out = self._cut_tails(t_out)
        elif slices:
            # per leading slice (DoG's dual radius, RGB planes): the P = 1
            # pipeline on each, restacked
            layout, fused = "slices", self.st_comp is not None
            ys, ts = [], []
            for p in range(P):
                Xp = X[p * R:(p + 1) * R]
                if fused:
                    ys.append(self._stencil_slice(Xp, p, plain))
                    continue
                y_p, t_p = self._kernel_slice(
                    Xp, plain, None if tails_in is None
                    else tails_in[:, :, p * R:(p + 1) * R], self._nt(R))
                ys.append(y_p)
                ts.append(self._cut_tails(t_p))
            Y = torch.stack(ys)
            if ts and ts[0] is not None:
                t_out = torch.cat(ts, dim=2)  # P-major lines
        else:
            # the JAX package keeps a rotated pass with a leading group at
            # HIGHEST (its split einsums lose there): float64 here
            nsp = 0 if rot and P > 1 else self.nsp
            braw = (_split_einsum("nst,pnt->pns", self.G_c, X, nsp).double()
                    if nsp else
                    kc.tile_einsum("nst,pnt->pns", self.G_b,
                                   X.float()).double() if bf16 else
                    kc.tile_einsum("nst,pnt->pns", self.G_v, X.double()))
            N = (self._solve_nat(braw) if n <= _CHAIN_MATMUL_MAX_TILES
                 else self._solve_assoc(braw))  # (q, n, S) natural
            del braw
            if (self.completion is not None and (P == 1 or not rot)
                    and kc.completion_ok(T, q, n, S)):
                layout = "kernel"
                Nt = F.pad(N.permute(1, 2, 0), (0, 0, 0, self.sl - S))
                Nt = Nt.float().contiguous()
                comp = self._nt(q)
                if comp is not None:
                    Y, t_out = (comp.plain if plain else comp)(X, Nt)
                    t_out = self._cut_tails(t_out)
                else:
                    comp = self.completion
                    Y = (comp.plain if plain else comp)(X, Nt,
                                                        *epi_aux(comp))
            else:
                layout = "tile"
                # float64 products (true f32 grade whatever the matmul
                # settings on the card), or the grade's split products, or
                # at bf16 storage the bf16 products in float32 (the output
                # rounded once, below); the carry injection in float64 at
                # every grade
                Y = (_split_einsum("nos,pns->pno", self.B_c, X, nsp).double()
                     if nsp else
                     kc.tile_einsum("nos,pns->pno", self.B_b,
                                    X.float()).double() if bf16 else
                     kc.tile_einsum("nos,pns->pno", self.B_v, X.double()))
                Y = (Y + kc.tile_einsum("nou,pnu->pno", self.R_v, N)).float()
                Y = (Y.reshape(P, R, n, T).permute(0, 2, 3, 1)
                     .reshape((P, n, T) + rows) if rot
                     else Y.reshape((P,) + rows + (n, T)))
            del N
        deferred = self.stencil is not None and not fused
        if self.epilogue is not None and not deferred and kaux is None:
            if layout == "kernel":
                # a bf16 output: the epilogue's arithmetic in float32 on
                # the kernel's rounded values, rounded once more
                Yf = (Y if rot else Y.reshape(q, n * T)).float()
                Y = _epilogue(self.epilogue, Yf, _kernel_epilogue_aux(
                    rot, lead, n, T, rows, q, pad, eaux, Y)).to(Y.dtype)
            else:
                nat = len(lead) if rot else -1
                Y = _epilogue(self.epilogue, Y, [
                    _retile_aux(a, Y, nat, pad, Y.shape) for a in eaux])
        y = Y.reshape(lead + (n * T,) + rows if rot
                      else lead + rows + (n * T,))
        ax = (-1 - nrow) if rot else -1
        if pad:
            y = y.narrow(ax, 0, n * T - pad)
        if deferred:
            # the stencil reads the filter output, the epilogue the
            # stencil's (the consumer-order contract); a bf16 output in
            # float32, rounded once
            yd = _stencil_fallback(y.float(), self.stencil, ax)
            if self.epilogue is not None:
                yd = _epilogue(self.epilogue, yd, eaux)
            y = yd.to(y.dtype)
        # the einsum form's float32 output at bf16 storage, rounded once
        return y.to(self.dtype), t_out

    def _kernel_aux(self, eaux, lead, rows, q: int, X):
        """``eaux`` in the completion kernel's output layout, contiguous:
        (n·T, q) rotated, else (q, n, T)."""
        n, T = self.n, self.T
        shape = (n * T, q) if self.rot else (q, n, T)
        return tuple(a.reshape(shape).contiguous()
                     for a in _kernel_epilogue_aux(self.rot, lead, n, T,
                                                   rows, q, self.pad, eaux,
                                                   X))

    def _kernel_slice(self, X, plain, tails_in=None, comp_nt=None,
                      epi_aux=lambda comp: ()):
        """(tails →) solve → completion on (q, n, T): ((q, n, T) or the
        rotated (n·T, q), the next pass's tails or None). With ``tails_in``
        (the previous pass's extraction) the tails launch is skipped;
        ``epi_aux(comp)`` gives the aux arrays of the completion's affine
        epilogue."""
        if tails_in is None:
            tails = self.tails.plain if plain else self.tails
            braw = tails(X)
        else:
            braw, self.took_tails_in = tails_in, True
        Nt = self._solve_t(braw.double()).float()
        if comp_nt is not None:
            return (comp_nt.plain if plain else comp_nt)(X, Nt)
        comp = self.completion
        return (comp.plain if plain else comp)(X, Nt, *epi_aux(comp)), None

    def _stencil_slice(self, X, i: int, plain, epi_aux=lambda comp: ()):
        """The fused stencil route on (q, n, T) with tap set ``i`` (the
        slice's, or the shared set): the rotated (n·T, q) stencil output
        (then the affine epilogue, its aux from ``epi_aux(comp)``)."""
        i = i if len(self.st_comp) > 1 else 0
        tails, comp = self.st_tails[i], self.st_comp[i]
        braw_t = (tails.plain if plain else tails)(X).double()
        sl = self.sl
        Nt = self._solve_t(braw_t[:, :sl])
        hlo, hhi = self.st_reach[i]
        halos = _stencil_halo(braw_t[:, sl:], Nt, getattr(self, f"st_R{i}"),
                              hlo, hhi)
        return (comp.plain if plain else comp)(X, Nt.float().contiguous(),
                                              *halos, *epi_aux(comp))

    def _solve_t(self, braw_t):
        if self.offsets is not None:
            return _banded_solve_apply(list(zip(self.offsets, self.bands)),
                                       braw_t, self.S)
        n, sl, q = braw_t.shape
        return (self.CMp @ braw_t.reshape(n * sl, q)).reshape(n, sl, q)

    def _solve_nat(self, braw):
        if self.offsets is not None:
            return _banded_solve_apply_nat(
                list(zip(self.offsets, self.bands)), braw)
        q, n, S = braw.shape
        bp = F.pad(braw, (0, self.sl - S)).reshape(q, n * self.sl)
        return (bp @ self.CMp.T).reshape(q, n, self.sl)[..., :S]

    def _solve_assoc(self, braw):
        offs = np.cumsum([0] + self.orders)
        Ns = []
        for i, causal in enumerate(self.causal):
            b = braw[..., offs[i]:offs[i + 1]]
            for j in range(i):
                b = b + kc.tile_einsum("noj,anj->ano",
                                       getattr(self, f"H{i}_{j}"), Ns[j])
            Ns.append(_chain_solve_assoc(b, causal, getattr(self, f"W{i}"),
                                         getattr(self, f"J{i}")))
        return torch.cat(Ns, dim=-1)


# The hierarchy's supertile: 256 tiles of 128, the kernel-eligible maximum.
_SEG = _CHAIN_MATMUL_MAX_TILES * 128


def _hierarchy_ok(w: int, scans: Sequence[Scan],
                  matmul_precision: str) -> bool:
    """The JAX package's gates of ``hierarchical_dim_pass``: ΣK ≤ 64; px
    precision; 2 ≤ n_sup ≤ 512 supertiles at ΣK ≤ 8 (the dense level-2
    solve), ≤ 4096 past it (the Kogge–Stone chain); and an effective last
    supertile longer than kmax + 1. The hierarchy runs at px6 only in the
    port (the reduced grades have no split form of it)."""
    S = sum(s.order for s in scans)
    kmax = max(s.order for s in scans)
    if S > 64 or NPROD.get(matmul_precision, 0) != 6:
        return False
    n_sup = -(-w // _SEG)
    if n_sup < 2 or n_sup > (512 if S <= 8 else 4096):
        return False
    return _SEG - (n_sup * _SEG - w) > kmax + 1


class HierarchicalPass(nn.Module):
    """Audio-scale pass via a TWO-LEVEL chain, for float32 arrays (..., w)
    with every scan on the last axis: the JAX package's
    ``hierarchical_dim_pass``.

    Level 1: the signal is cut into n_sup supertiles of 32,768 samples, and
    each scan runs a zero-state local pass (:class:`LastAxisPass`, tile
    128, 256 tiles) with the supertiles as LINES — the kernels get
    lead·n_sup lines. Under clamp the scan's edge supertile takes the
    rank-1 clamp response ``v ⊗ x[edge]``; the padded slots of the last
    supertile are zeroed before a later scan reads them. Level 2: the
    supertile boundary carries are solved with the segment-level exchange
    algebra (:mod:`.parallel.sharding`) — one dense (n_sup·ΣK)² matmul at
    ΣK ≤ 8, per-scan Kogge–Stone chains with the cross-scan couplings past
    it — and a rank-ΣK correction (with clamp/pad edge deltas on the
    first/last supertiles) closes every supertile. Construct only where
    :func:`_hierarchy_ok` holds."""

    def __init__(self, scans: Sequence[Scan], w: int, border: str,
                 matmul_precision: str):
        super().__init__()
        seg = _SEG
        self.w, self.n_sup = w, -(-w // seg)
        self.pad = self.n_sup * seg - w
        self.clamp = border == BorderMode.CLAMP
        self.scans = list(scans)
        self.S = int(sum(s.order for s in scans))
        self.locals = nn.ModuleList(
            LastAxisPass([s], (128, _CHAIN_MATMUL_MAX_TILES, 0), False,
                         matmul_precision) for s in scans)
        if self.clamp:
            for i, s in enumerate(scans):
                self.register_buffer(f"v{i}", _f64(sh._clamp_col(
                    s, seg if s.causal else seg - self.pad, total=seg)))
        orders, H, CMs, Rcats = sh._segment_exchange_mats(
            scans, seg, self.n_sup, self.clamp, self.pad,
            build_cm=self.S <= 8)
        self.orders = orders
        if self.S <= 8:
            self.register_buffer("CM2", _f64(
                sh._combined_solve(orders, H, CMs, self.n_sup)))
        else:
            for i, s in enumerate(scans):
                self.register_buffer(f"Wp{i}", _f64(
                    _ks_powers(s.feedback, seg, self.n_sup)))
                self.register_buffer(f"J{i}", _f64(
                    coeffs.antidiagonal(s.order)))
                for j in range(i):
                    self.register_buffer(f"H{i}_{j}", _f64(
                        kc._variants3(H[i][j])))
        self.register_buffer("Rcats", _f64(Rcats))  # (1|3, seg, S)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        seg, n_sup, pad, S = _SEG, self.n_sup, self.pad, self.S
        lead = x.shape[:-1]
        y = F.pad(x, (0, pad)) if pad else x
        y = y.reshape(-1, n_sup, seg)
        cs = []
        for i, (s, loc) in enumerate(zip(self.scans, self.locals)):
            k = s.order
            if self.clamp:
                e_seg = 0 if s.causal else n_sup - 1
                e_pos = 0 if s.causal else seg - 1 - pad
                x_edge = y[:, e_seg, e_pos].double()
            y = loc(y, plain)
            if self.clamp:
                upd = (y[:, e_seg].double() + getattr(self, f"v{i}")
                       * x_edge[:, None]).float()
                y = torch.cat([y[:, :e_seg], upd[:, None],
                               y[:, e_seg + 1:]], dim=1)
            if pad and i < len(self.scans) - 1:
                # a later scan must read zeros in the padded slots; after
                # the last scan they are sliced off unread
                y = torch.cat([y[:, :-1], F.pad(y[:, -1:, :seg - pad],
                                                (0, pad))], dim=1)
            cs.append(y[..., seg - k:] if s.causal else y[..., :k])
        ccat = torch.cat(cs, dim=-1).double()  # (p, n_sup, S)

        if S <= 8:
            p = ccat.shape[0]
            N = (ccat.reshape(p, n_sup * S) @ self.CM2.T).reshape(
                p, n_sup, S)
        else:
            offs = np.cumsum([0] + self.orders)
            Ns = []
            for i, s in enumerate(self.scans):
                b = ccat[..., offs[i]:offs[i + 1]]
                for j in range(i):
                    b = b + kc.tile_einsum("nok,lnk->lno",
                                           getattr(self, f"H{i}_{j}"), Ns[j])
                Ns.append(_chain_prefix_axis(
                    b, s.causal, getattr(self, f"Wp{i}"),
                    getattr(self, f"J{i}")))
            N = torch.cat(Ns, dim=-1)

        # rank-S correction: interior columns on every supertile, plus
        # edge deltas on the first/last supertiles under clamp/pad
        # (Rcats is [first, interior, last])
        R = self.Rcats
        Rint = R[0 if R.shape[0] == 1 else 1]
        corr = torch.einsum("ts,lns->lnt", Rint, N)
        if R.shape[0] == 3:
            corr = torch.cat([
                corr[:, :1] + torch.einsum("ts,ls->lt", R[0] - Rint,
                                           N[:, 0])[:, None],
                corr[:, 1:-1],
                corr[:, -1:] + torch.einsum("ts,ls->lt", R[2] - Rint,
                                            N[:, -1])[:, None]], dim=1)
        y = (y + corr.float()).reshape(*lead, n_sup * seg)
        return y[..., :self.w] if pad else y


class FusedLastAxis(nn.Module):
    """Executor for filters whose scans all lie on the last axis of
    float32 arrays (..., w) — 1-D signals, with channels on any leading
    axes: the JAX package's ``fused_dim_pass`` for the last axis.

    Routing follows the JAX package: above 256 tiles the supertile
    hierarchy (:class:`HierarchicalPass`) where its gates hold, else one
    :class:`LastAxisPass`. ``forward`` runs the CUDA kernels for CUDA
    tensors (their plain twins for CPU tensors); ``forward_plain`` runs the
    twins on any device — the all-PyTorch reference for the kernel path.
    Every host matrix is built once, here, as a buffer.

    ``epilogue(y, *eaux)``: an elementwise consumer of the output
    (``forward(x, *eaux)``, the aux arrays in the output's layout); with
    one the hierarchy is declined, as in the JAX package. With no tile
    plan the sequential core runs (``self.body`` a
    :class:`.scan_core.ScanAxis`), then the epilogue. ``dtype``: the
    storage type, float32 or bf16 (:class:`LastAxisPass`; at bf16 the
    core runs on the input in float32, the epilogue too, and the output
    is cast back, and the hierarchy, float32 only, is declined); the input
    is cast to it."""

    def __init__(self, scans: Sequence[Scan], w: int, tile_width: int,
                 border: str, matmul_precision: str = "px6",
                 epilogue=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        clamp = border == BorderMode.CLAMP
        plan = _plan_tiles(w, tile_width, max(s.order for s in scans), clamp)
        self.w, self.epilogue, self.dtype = w, epilogue, dtype
        bf16 = dtype == torch.bfloat16
        if plan is None:
            self.body = ScanAxis(scans, -1, border)
        elif (epilogue is None and plan[1] > _CHAIN_MATMUL_MAX_TILES
                and not bf16 and _hierarchy_ok(w, scans, matmul_precision)):
            self.body = HierarchicalPass(scans, w, border, matmul_precision)
        else:
            self.body = LastAxisPass(scans, plan, clamp, matmul_precision,
                                     epilogue=epilogue, dtype=dtype)

    def forward(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        return self._run(x, False, eaux)

    def forward_plain(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        return self._run(x, True, eaux)

    def _run(self, x, plain, eaux):
        x = self._checked(x)
        if isinstance(self.body, ScanAxis):
            return _core_run(self.body, x, self.epilogue, eaux)
        if isinstance(self.body, HierarchicalPass):
            return self.body(x, plain)
        return self.body(x, plain, eaux)

    def _checked(self, x):
        x = _storage_input(x, self.dtype)
        if x.ndim < 1 or x.shape[-1] != self.w:
            raise ValueError(f"input shape {tuple(x.shape)} does not end in "
                             f"the filter's extent {self.w}")
        return x


class FusedAxisPass(nn.Module):
    """Executor for the scans of one axis that is NOT the last, of float32
    arrays of ``shape``: the JAX package's einsum ``fused_dim_pass`` there
    (where the rows pass declines the axis, at ``highest``, or with an
    epilogue on a final non-last pass). The axis moves last and one
    :class:`LastAxisPass` with the rotated emit (``rot_axes = ndim − axis``)
    puts it straight back — on the ``tails``/``completion_rot`` kernels
    where their gates hold, else its einsum form. Past 256 tiles, without
    an epilogue, the supertile hierarchy runs on the moved axis where its
    gates hold (the JAX package's ``hierarchical_dim_pass`` moves it the
    same way). ``forward_plain`` runs the kernels' twins. ``dtype``: the
    storage type, as :class:`FusedLastAxis`'s."""

    def __init__(self, scans: Sequence[Scan], axis: int, shape,
                 tile_width: int, border: str, matmul_precision: str = "px6",
                 epilogue=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        nd = len(shape)
        axis = axis % nd
        if axis == nd - 1:
            raise ValueError("the last axis runs FusedLastAxis")
        w = int(shape[axis])
        clamp = border == BorderMode.CLAMP
        plan = _plan_tiles(w, tile_width, max(s.order for s in scans), clamp)
        self.axis, self.ndim, self.w = axis, nd, w
        self.epilogue, self.dtype = epilogue, dtype
        bf16 = dtype == torch.bfloat16
        if plan is None:
            self.body = ScanAxis(scans, axis, border)
        elif (epilogue is None and plan[1] > _CHAIN_MATMUL_MAX_TILES
                and not bf16 and _hierarchy_ok(w, scans, matmul_precision)):
            self.body = HierarchicalPass(scans, w, border, matmul_precision)
        elif nd - axis > 6:
            raise NotImplementedError(
                f"scans on axis {axis} of a {nd}-D array: more than 5 "
                "trailing axes take the JAX package's 'ansb' einsum form, "
                "not ported (ROADMAP Queue 1 item 8)")
        else:
            self.body = LastAxisPass(scans, plan, clamp, matmul_precision,
                                     rot_axes=nd - axis, epilogue=epilogue,
                                     dtype=dtype)

    def forward(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        return self._run(x, False, eaux)

    def forward_plain(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        return self._run(x, True, eaux)

    def _run(self, x, plain, eaux):
        x = _storage_input(x, self.dtype)
        if x.ndim != self.ndim or x.shape[self.axis] != self.w:
            raise ValueError(f"input shape {tuple(x.shape)}: expected "
                             f"{self.ndim} axes, {self.w} on axis "
                             f"{self.axis}")
        if isinstance(self.body, ScanAxis):
            return _core_run(self.body, x, self.epilogue, eaux)
        xm = x.movedim(self.axis, -1)
        if isinstance(self.body, HierarchicalPass):
            return self.body(xm, plain).movedim(-1, self.axis)
        return self.body(xm, plain, eaux)  # the rotated emit moves it back


def _core_run(core, x, epilogue, eaux):
    """The sequential core on ``x`` in float32, then the epilogue, the
    output in x's type: a bf16 x runs float32 and is rounded once, as the
    JAX package's ``fused_dim_pass`` casts its core's input and output."""
    y = core(x.float())
    if epilogue is not None:
        y = _epilogue(epilogue, y, eaux)
    return y.to(x.dtype)


def fused_dim_pass(x, axis: int, scans: Sequence[Scan], tile_width: int,
                   border: str = BorderMode.ZERO,
                   matmul_precision: str = "px6"):
    """Apply all ``scans`` (same dimension, on ``axis``) to the float32
    tensor ``x`` — functional :class:`FusedLastAxis` on the last axis,
    :class:`FusedAxisPass` on any other."""
    from .planner import check_precision

    check_precision(matmul_precision)
    mod = dim_pass_module(scans, axis, x.shape, tile_width, border,
                          matmul_precision)
    return mod.to(x.device)(x)


def dim_pass_module(scans: Sequence[Scan], axis: int, shape,
                    tile_width: int, border: str = BorderMode.ZERO,
                    matmul_precision: str = "px6") -> nn.Module:
    """The module :func:`fused_dim_pass` runs on an array of ``shape``:
    :class:`FusedLastAxis` on the last axis, :class:`FusedAxisPass` on any
    other."""
    nd = len(shape)
    if axis % nd == nd - 1:
        return FusedLastAxis(scans, shape[-1], tile_width, border,
                             matmul_precision)
    return FusedAxisPass(scans, axis, shape, tile_width, border,
                         matmul_precision)


def hierarchical_dim_pass(x, axis: int, scans: Sequence[Scan], border: str,
                          matmul_precision: str):
    """Functional :class:`HierarchicalPass` on ``axis`` (moved last and
    back), or None where the JAX package's gates decline the hierarchy."""
    from .planner import check_precision

    check_precision(matmul_precision)
    refuse_split(matmul_precision, "the supertile hierarchy")
    axis = axis % x.ndim
    if not _hierarchy_ok(x.shape[axis], scans, matmul_precision):
        return None
    mod = HierarchicalPass(scans, x.shape[axis], border, matmul_precision)
    return mod.to(x.device)(x.movedim(axis, -1)).movedim(-1, axis)


# ---------------------------------------------------------------------------
# Whole-filter entry point
# ---------------------------------------------------------------------------


# The JAX package's tile width for a scanned axis that ``split`` left out
# (``apply_filter_fused(tile_default=32)``).
_TILE_DEFAULT = 32


class StagedPass(nn.Module):
    """Executors run one after another on the output of the last — the
    volume route (``route="volume"``: rows pass, then the trailing pair)
    and the per-axis staged loop (``route="staged"``). ``forward_plain``
    runs every stage's plain twins."""

    def __init__(self, stages: Sequence[nn.Module], route: str):
        super().__init__()
        self.stages = nn.ModuleList(stages)
        self.route = route

    def forward(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        for stage in self.stages[:-1]:
            x = stage(x)
        return self.stages[-1](x, *eaux)  # the epilogue's aux: final stage

    def forward_plain(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        for stage in self.stages[:-1]:
            x = stage.forward_plain(x)
        return self.stages[-1].forward_plain(x, *eaux)


class Stencil2DAfter(nn.Module):
    """A filter, then a 2-D stencil bank on its output (the JAX package's
    ``_st_fallback``): the ``stencil2d`` kernel on a 2-D output
    (:class:`.kernels.stencil2d.Stencil2D`), its twin on any other rank.
    Returns a tuple of per-channel tensors, bf16 after a bf16 filter (the
    taps in float32, each channel rounded once)."""

    def __init__(self, body: nn.Module, stencil2d):
        super().__init__()
        self.body, self.bank = body, Stencil2D(stencil2d)

    def forward(self, x: torch.Tensor):
        y = self.body(x)
        return self.bank(y) if y.ndim == 2 else self.bank.plain(y)

    def forward_plain(self, x: torch.Tensor):
        return self.bank.plain(self.body.forward_plain(x))


def chain_plans(shape, groups, tiles, clamp: bool):
    """{axis: (T, n, pad)} for each scanned axis of a rotation chain — tiled
    by its split width or 32, as the JAX package's chain tiles them — or
    None where one axis has no tile plan."""
    plans = {}
    for ax, scans in groups.items():
        plans[ax] = _plan_tiles(shape[ax], tiles[ax] or _TILE_DEFAULT,
                                max(s.order for s in scans), clamp)
        if plans[ax] is None:
            return None
    return plans


class RotationChain(nn.Module):
    """Executor for filters whose scans lie on exactly the trailing ``Ds``
    axes, 2 ≤ Ds ≤ 5, of float32 arrays of ``shape``: the JAX package's
    rotation chain (``apply_filter_fused``'s ``2 ≤ Ds ≤ 5`` branch).

    The last axis goes first. Each pass is one :class:`LastAxisPass` with
    ``rot_axes = Ds``: its rotated emit moves the scanned axis to position
    ``-Ds`` and brings the next scanned axis last, so every pass scans the
    last axis and after Ds passes the axis order is restored. Each axis is
    tiled by its split width or 32 (:func:`chain_plans`). The epilogue goes
    to the final pass only (its aux arrays in the filter's own layout).

    Tails chaining, at the px grades (the JAX package's ``fuse_tails``;
    at ``default`` too, where it is the structural win that puts a pass on
    its kernels): a non-final pass is asked for the next pass's tails where
    the next pass has pad 0, 128-wide tiles, ΣK ≤ 8 and at most 512 tiles
    — the JAX package's chaining gate — and, where this pass's completion
    kernel can emit them too (128-wide tiles, ΣK ≤ 8, at most 512 tiles),
    that next pass is told it may receive them
    (``LastAxisPass(tails_in=True)``). Where its kernel emits them (the port's kernel gate,
    :func:`.kernels.completion.next_tails_ok`; the JAX package's
    ``_tails_gate`` also needs its TPU line block to hold whole next-pass
    extents, so on some line counts it reads the tails instead), the next
    pass takes them as ``tails_in`` and skips its ``tails`` launch.
    ``tails_in_taken`` lists, per pass of the last call, whether it did. At
    ``highest`` every pass runs its einsum form and no kernel launches.
    ``forward_plain`` runs every kernel's twin. ``dtype``: the storage
    type; at bf16 every pass on its kernels at one product, tails chained
    as at the px grades (the JAX package's bf16 chain keeps the in-kernel
    chain), the input cast to bf16."""

    def __init__(self, groups, shape, tiles, border: str,
                 matmul_precision: str = "px6", epilogue=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nd, Ds = len(shape), len(groups)
        order = [nd - 1 - i for i in range(Ds)]
        if not 2 <= Ds <= 5 or set(groups) != set(order):
            raise ValueError(f"a rotation chain scans the trailing 2-5 axes, "
                             f"not {sorted(groups)} of {nd}")
        clamp = border == BorderMode.CLAMP
        plans = chain_plans(shape, groups, tiles, clamp)
        if plans is None:
            raise ValueError(
                f"{tuple(shape)}: an axis with no tile plan; "
                "fused_filter_module runs the per-axis loop there "
                "(StagedPass, the sequential core on that axis), as the JAX "
                "package's apply_filter_fused does")
        fuse = (dtype == torch.bfloat16
                or NPROD.get(matmul_precision, 0) > 0)

        def order_of(i):
            return sum(s.order for s in groups[order[i]])

        def asks(i):  # pass i asks for pass i + 1's tails
            if not fuse or i + 1 >= Ds:
                return False
            T2, n2, pad2 = plans[order[i + 1]]
            return pad2 == 0 and T2 == 128 and order_of(i + 1) <= 8 and (
                n2 <= 512)

        def hands(i):  # ... and its completion kernel can emit them
            T, n, _ = plans[order[i]]
            return asks(i) and T == 128 and order_of(i) <= 8 and n <= 512

        passes = [None] * Ds
        for i in reversed(range(Ds)):  # the next pass first: its tail rows
            ax, final, nt = order[i], i == Ds - 1, None
            if asks(i):
                nxt, (T2, n2, _) = passes[i + 1], plans[order[i + 1]]
                nt = (nxt.Gcat, n2, T2)
            passes[i] = LastAxisPass(
                groups[ax], plans[ax], clamp, matmul_precision,
                rot_axes=Ds, epilogue=epilogue if final else None,
                next_tails=nt, tails_in=i > 0 and hands(i - 1), dtype=dtype)
        self.passes = nn.ModuleList(passes)
        self.axes, self.shape, self.dtype = order, tuple(shape), dtype

    @property
    def tails_in_taken(self) -> List[bool]:
        return [p.took_tails_in for p in self.passes]

    def forward(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        return self._run(x, False, eaux)

    def forward_plain(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        return self._run(x, True, eaux)

    def _run(self, x, plain, eaux):
        x = _storage_input(x, self.dtype)
        if tuple(x.shape) != self.shape:
            raise ValueError(f"input shape {tuple(x.shape)} != the filter's "
                             f"extents {self.shape}")
        tails = None
        for i, p in enumerate(self.passes):
            final = i == len(self.passes) - 1
            x, tails = p.run(x, plain, eaux if final else (), tails_in=tails)
        return x


_INT_DTYPES = {"int8": torch.int8, "int16": torch.int16,
               "int32": torch.int32, "int64": torch.int64,
               "uint8": torch.uint8, "uint16": torch.uint16,
               "uint32": torch.uint32}
# the integer types the unit kernels take in their own type
_UNIT_DTYPES = ("int8", "int16", "int32")


def _int_cast_scans(spec: FilterSpec) -> List[Scan]:
    """Coefficients cast into the image type, as the reference and the
    integer oracle do (int16 coefficients wrap at int16): float-valued
    Scans with exactly integral coefficients."""
    t = np.dtype(spec.dtype).type
    return [Scan(s.axis, s.causal, float(int(t(s.feedfwd))),
                 tuple(float(int(t(c))) for c in s.feedback))
            for s in spec.scans]


def _int_abs_gain(scans: Sequence[Scan], extent: int, border: str) -> float:
    """Worst-case growth of one dimension pass: ∏ over the scans of
    ``Σ|h_s|`` (``+ max|clamp column|`` under a clamp border), each from
    the scan's signed impulse response in float64 — the entrywise-absolute
    operator-norm bound of the JAX package's ``_int_abs_gain``, which
    bounds every intermediate of the blocked algebra; ``inf`` from 2^23."""
    from .scan_core import oracle_apply_scan

    g = 1.0
    for s in scans:
        e = np.zeros((extent, 1), np.float64)
        e[0 if s.causal else extent - 1, 0] = 1.0
        h = oracle_apply_scan(e, 0, s.causal, s.feedfwd, list(s.feedback),
                              BorderMode.ZERO)
        gs = float(np.abs(h).sum())
        if border == BorderMode.CLAMP:
            hc = oracle_apply_scan(e, 0, s.causal, s.feedfwd,
                                   list(s.feedback), BorderMode.CLAMP)
            gs += float(np.abs(hc - h).max())
        g *= max(gs, 1.0)
        if not np.isfinite(g) or g >= 2 ** 23:
            return float("inf")
    return g


def _int_limbs(v: torch.Tensor, lb: int, nl: int) -> List[torch.Tensor]:
    """Split the int32 ``v`` into ``nl`` signed limbs of ``lb`` bits,
    v = Σᵢ limbᵢ·2^(lb·i) exactly (two's-complement low bits with the
    borrow carried up; no intermediate overflows) — the JAX package's
    ``_int_limbs``."""
    half, mask = 1 << (lb - 1), (1 << lb) - 1
    out = []
    for _ in range(nl - 1):
        low = v & mask
        out.append((low ^ half) - half)
        v = (v >> lb) + (low >= half).to(torch.int32)
    out.append(v)
    return out


def int_exact_plan(spec: FilterSpec):
    """The JAX package's ``apply_filter_int_exact`` plan, or None where it
    returns None (the caller then runs the sequential core):
    ``[(axis, routes)]`` per scanned axis in order of first appearance,
    ``routes`` either ``[("unit", units)]`` — every scan a unit chain
    (:func:`.kernels.int_scan.unit_scans_of`) under a zero border — or
    limb chunks ``[("limb", ids, lb, nl), ...]``: consecutive scans whose
    gain product stays under 2^21 (:func:`_int_abs_gain`), each run on
    ``nl`` limbs of ``lb = 23 − ⌈log₂ gain⌉`` bits covering the value's
    bits so far (the type's width, growing by ⌈log₂ gain⌉ a chunk, 32
    after a unit axis). None for types wider than 32 bits, a scan whose
    gain reaches 2^21, a chunk left fewer than 2 limb bits, or a limb
    chunk past 256 tiles (the JAX package does not audit its associative
    solver). The JAX package also plans a limb fallback for a unit axis,
    for the unit kernel's declining; its kernel declines no extent the
    port's gates admit, and neither does the port's, so none is kept."""
    dtype = np.dtype(spec.dtype)
    if dtype.itemsize > 4:
        return None
    scans = _int_cast_scans(spec)
    tiles = spec.tile_widths or (0,) * spec.ndim
    clamp = spec.border == BorderMode.CLAMP
    bits = dtype.itemsize * 8
    plan = []
    for ax, ids in spec.scans_by_axis().items():
        extent = spec.dims[ax].extent
        units = _int_units(spec, ids)
        if units is not None:
            plan.append((ax, [("unit", units)]))
            bits = 32
            continue
        chunks, chunk, gc = [], [], 1.0
        for i in ids:
            gi = _int_abs_gain([scans[i]], extent, spec.border)
            if not np.isfinite(gi) or gi >= 2 ** 21:
                return None
            if chunk and gc * gi >= 2 ** 21:
                chunks.append((chunk, gc))
                chunk, gc = [], 1.0
            chunk.append(i)
            gc *= gi
        chunks.append((chunk, gc))
        routes = []
        for chunk, gc in chunks:
            lg = max(int(np.ceil(np.log2(gc))), 0)
            lb = 23 - lg
            if lb < 2:
                return None
            T = min(tiles[ax] or _TILE_DEFAULT, extent)
            p = _plan_tiles(extent, T, max(scans[i].order for i in chunk),
                            clamp)
            if p is not None and p[1] > _CHAIN_MATMUL_MAX_TILES:
                return None
            routes.append(("limb", tuple(chunk), lb, -(-min(bits, 32) // lb)))
            bits = min(bits + lg, 32)
        plan.append((ax, routes))
    return plan


class IntUnitPass(nn.Module):
    """The exact integer executor of int8/16/32 and uint8/16/32 filters:
    the JAX package's ``apply_filter_int_exact``, bit exact modulo 2^k,
    planned by :func:`int_exact_plan` (``self.plan``; ``self.route`` is
    ``"exact"``), one stage per scanned axis in order of first appearance:

      * a unit axis (summed-area tables, integral images): one
        :func:`.kernels.int_scan.int_unit_dim_pass` (the ``int_scan``
        kernel, or the segmented ``int_seg_scan`` phases past its gates);
      * a limb axis (a clamp border, a scan that is not a unit chain):
        each chunk of scans splits the int32 values into signed limbs
        (:func:`_int_limbs`), runs every limb through the tiled dimension
        pass at ``f32x9`` (:func:`dim_pass_module`: the einsum form, its
        products and solves in float64 — exact for integers below 2⁵³,
        wherever the JAX package's nine bf16 products are exact below
        2^23, which the gain gate guarantees), rounds, and recombines
        with wrapping shifts.

    Where the plan is None (a type wider than 32 bits, int64 among them;
    a gain past the gate), ``self.route`` is ``"core"``: the sequential
    core (:class:`.scan_core.ScanFilter`) on the tensor's own device, as
    the JAX package falls back to its ``scan_core.apply_filter``.

    The array runs in int32 (the JAX package's type) except on a plan of
    unit axes only, where int8/16/32 stay in their own type: the low k
    bits of a wrapping integer-linear map depend only on the low k bits
    of its input. ``forward_plain`` runs the plain twin of each kernel;
    the limb passes launch none. An ``epilogue(y, *eaux)`` reads the
    integer result, as in the JAX package."""

    def __init__(self, spec: FilterSpec, epilogue=None):
        super().__init__()
        from .scan_core import ScanFilter

        self.dtype = _INT_DTYPES[spec.dtype]
        self.ext = tuple(d.extent for d in spec.dims)
        self.epilogue = epilogue
        self.plan = int_exact_plan(spec)
        self.route = "core" if self.plan is None else "exact"
        self.core = ScanFilter(spec) if self.plan is None else None
        self.limbs = nn.ModuleList()
        scans = _int_cast_scans(spec)
        tiles = spec.tile_widths or (0,) * spec.ndim
        for ax, routes in self.plan or ():
            for r in routes:
                if r[0] == "limb":
                    self.limbs.append(dim_pass_module(
                        [scans[i] for i in r[1]], ax, self.ext,
                        min(tiles[ax] or _TILE_DEFAULT, self.ext[ax]),
                        spec.border, "f32x9"))
        self.own_type = (spec.dtype in _UNIT_DTYPES and not len(self.limbs))

    def forward(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        return self._run(x, False, eaux)

    def forward_plain(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        return self._run(x, True, eaux)

    def _run(self, x, plain, eaux):
        from .kernels import int_scan

        if tuple(x.shape) != self.ext:
            raise ValueError(f"input shape {tuple(x.shape)} != the filter's "
                             f"extents {self.ext}")
        if self.core is not None:
            x = self.core(x)
        else:
            unit = int_scan.unit_scans_plain if plain \
                else int_scan.int_unit_dim_pass
            x = _int_input(x, self.dtype if self.own_type else torch.int32)
            limbs = iter(self.limbs)
            for ax, routes in self.plan:
                for r in routes:
                    x = (unit(x, r[1], ax) if r[0] == "unit"
                         else _limb_pass(x, next(limbs), r[2], r[3], plain))
            x = x.to(self.dtype)
        if self.epilogue is not None:
            x = self.epilogue(x, *(torch.as_tensor(a).to(x.device)
                                   for a in eaux))
        return x


def _limb_pass(x, mod, lb: int, nl: int, plain: bool):
    """One limb chunk on the int32 ``x``: each limb through ``mod`` (a
    tiled pass at ``f32x9``), rounded, recombined mod 2^32."""
    acc = None
    for i, limb in enumerate(_int_limbs(x, lb, nl)):
        y = mod.forward_plain(limb.float()) if plain else mod(limb.float())
        t = torch.round(y).to(torch.int64) << (lb * i)
        acc = t if acc is None else acc + t
    acc = acc & 0xFFFFFFFF
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def _int_units(spec: FilterSpec, ids):
    """The unit scans of ``spec``'s scans ``ids`` under a zero border, or
    None."""
    from .kernels import int_scan

    if spec.border != BorderMode.ZERO:
        return None
    scans = _int_cast_scans(spec)
    units = [int_scan.unit_scans_of(scans[i]) for i in ids]
    return None if None in units else [u for us in units for u in us]


def _int_input(x, dtype):
    """``x`` in the integer type ``dtype`` (a float input through int32,
    as the JAX package casts it), contiguous."""
    if x.is_floating_point():
        x = x.to(torch.int32)
    return x.to(dtype).contiguous()


def fused_filter_module(spec: FilterSpec, matmul_precision: str = "px6",
                        epilogue=None, stencil2d=None) -> nn.Module:
    """The executor module for ``spec``, routed as the module docstring
    says, or ``NotImplementedError`` naming what the port does not run
    yet. Integer filters take :class:`IntUnitPass`, as the JAX package
    sends them to its exact integer executor. The kernels'
    128 × 128 tile replaces the split widths on the 2-D and rows
    executors, as in the JAX package (tiling never changes the result);
    the rotation chain and the einsum passes tile each axis by its split
    width, or 32.

    The consumers of the JAX package's ``apply_filter_fused``:
    ``epilogue(y, *eaux)`` — an elementwise combine the module applies to
    the filter output (``forward(x, *eaux)``, the aux arrays in the
    output's layout), handed to the final stage; ``stencil2d`` — per
    channel 2-D shifted-tap banks ``[[(dy, dx, coeff), ...], ...]`` over
    the trailing two axes (the module then returns a tuple of channels):
    fused into the 3-touch executor's final kernel where its gates hold,
    else run on the filter's output (:class:`Stencil2DAfter`) — after the
    rotation chain where the 3-touch executor declines the bank."""
    from . import overlap2d
    from .planner import check_precision

    check_precision(matmul_precision)
    if stencil2d is not None and epilogue is not None:
        raise ValueError("stencil2d is mutually exclusive with epilogue")

    def with_bank(body):
        return body if stencil2d is None else Stencil2DAfter(body, stencil2d)

    if spec.dtype in _INT_DTYPES:
        return with_bank(IntUnitPass(spec, epilogue))
    if spec.dtype == "float16":  # the float32 route, cast in and out
        return Float16Storage(fused_filter_module(
            dataclasses.replace(spec, dtype="float32"), matmul_precision,
            epilogue=epilogue, stencil2d=stencil2d))
    if spec.dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"dtype {spec.dtype}: the port runs float32, bf16, float16 and "
            "integer filters (ROADMAP Queue 1 item 4)")
    spec = spec.stacked()  # a Tuple's components ride a leading axis
    groups = spec.scans_by_axis()
    nd, Ds = spec.ndim, len(groups)
    tiles = spec.tile_widths or (0,) * nd
    clamp = spec.border == BorderMode.CLAMP
    ext = [d.extent for d in spec.dims]

    def scans(ax):
        return [spec.scans[i] for i in groups[ax]]

    # the JAX package runs its 3-touch and rows kernels at the px grades
    # (px6, px4, px3, and default where they are a structural win: the
    # 2-D pair and volumes); at "highest" and the split-einsum grades the
    # chain and the per-axis loop run einsum passes. At the reduced grades
    # (px3, px4, default) the kernels with a split-bf16 form run —
    # final2d_split, rows_final, completion_split, the rotated completions
    # (a chain's and the per-axis loop's passes; at default only where
    # LastAxisPass finds a structural win) — and every other route raises
    # (planner.refuse_split)
    # bf16 storage: one product on every kernel route (the JAX package's
    # _kernel_nprod), the einsum forms on bf16 operands
    nprod = storage_nprod(spec.dtype, matmul_precision)
    bf16 = spec.dtype == "bfloat16"
    store = torch.bfloat16 if bf16 else torch.float32
    px = nprod > 0
    pair2d = (px and Ds == 2 and set(groups) == {nd - 2, nd - 1}
              and overlap2d.fused2d_decline(
                  scans(nd - 2), scans(nd - 1), ext[-2], ext[-1],
                  spec.border, stencil2d) is None)
    if pair2d:
        return overlap2d.Fused2DPx(
            scans(nd - 2), scans(nd - 1), ext[-2], ext[-1], spec.border,
            epilogue=epilogue, stencil2d=stencil2d, nprod=nprod, dtype=store)
    pre = None  # the volume route's rows pass, where its pair declines
    if (px and Ds == 3 and stencil2d is None
            and set(groups) == set(range(nd - 3, nd))
            and overlap2d._rows_decline(ext[-3], ext[-2] * ext[-1],
                                        scans(nd - 3)) is None):
        pre = overlap2d.FusedRowsPx(scans(nd - 3), ext[-3], ext[-2:],
                                    spec.border, nprod, dtype=store)
        if overlap2d.fused2d_decline(scans(nd - 2), scans(nd - 1), ext[-2],
                                     ext[-1], spec.border) is None:
            return StagedPass([pre, overlap2d.Fused2DPx(
                scans(nd - 2), scans(nd - 1), ext[-2], ext[-1], spec.border,
                epilogue=epilogue, nprod=nprod, dtype=store)], "volume")
        # the trailing pair declines: the chain (or the loop) on the rest
        groups = {ax: ids for ax, ids in groups.items() if ax != nd - 3}
        Ds = 2
    gscans = {ax: scans(ax) for ax in groups}
    if (2 <= Ds <= 5 and set(groups) == set(range(nd - Ds, nd))
            and chain_plans(ext, gscans, tiles, clamp) is not None):
        body = RotationChain(gscans, ext, tiles, spec.border,
                             matmul_precision, epilogue, dtype=store)
        return with_bank(body if pre is None
                         else StagedPass([pre, body], "volume"))
    stages = [] if pre is None else [pre]
    axes = list(groups)
    for ax in axes:
        final = ax == axes[-1]
        epi = epilogue if final else None
        if ax == nd - 1:
            stages.append(FusedLastAxis(scans(ax), ext[ax],
                                        tiles[ax] or _TILE_DEFAULT,
                                        spec.border, matmul_precision, epi,
                                        dtype=store))
        elif ((nprod > 1 or bf16) and (epilogue is None or not final)
              and overlap2d._rows_decline(
                  ext[ax], int(np.prod(ext[ax + 1:], dtype=np.int64)),
                  scans(ax)) is None):
            # not at float32 default: there the JAX package runs the einsum
            # pass (its non-structural _kernel_nprod), as FusedAxisPass does
            stages.append(overlap2d.FusedRowsPx(scans(ax), ext[ax],
                                                ext[ax + 1:], spec.border,
                                                nprod, dtype=store))
        else:  # its rotated kernels; at default its einsum form
            stages.append(FusedAxisPass(scans(ax), ax, ext,
                                        tiles[ax] or _TILE_DEFAULT,
                                        spec.border, matmul_precision, epi,
                                        dtype=store))
    if len(stages) == 1:
        return with_bank(stages[0])
    return with_bank(StagedPass(stages,
                                "staged" if pre is None else "volume"))


class StorageCast(nn.Module):
    """A storage type the executor ``body`` computes in float32: ``body``
    on the input cast to float32, its output (each channel of a stencil
    bank) cast to ``dtype`` — the JAX package's ``cdt`` for float16 on
    every route, and for bf16 on the backends other than the fused
    executors (``api.backend_module``)."""

    def __init__(self, body: nn.Module, dtype: torch.dtype):
        super().__init__()
        self.body, self.dtype = body, dtype

    def _out(self, y):
        if isinstance(y, tuple):
            return tuple(c.to(self.dtype) for c in y)
        return y.to(self.dtype)

    def forward(self, x: torch.Tensor, *eaux):
        return self._out(self.body(x.float(), *eaux))

    def forward_plain(self, x: torch.Tensor, *eaux):
        return self._out(self.body.forward_plain(x.float(), *eaux))


class Float16Storage(StorageCast):
    """float16 storage on the fused executors: :class:`StorageCast` to
    float16."""

    def __init__(self, body: nn.Module):
        super().__init__(body, torch.float16)


def apply_filter_fused(spec: FilterSpec, x, matmul_precision: str = "px6",
                       epilogue=None, eaux=(), stencil2d=None):
    """Run ``spec`` on the tensor ``x`` (on ``x``'s device) through
    :func:`fused_filter_module`'s executor."""
    mod = fused_filter_module(spec, matmul_precision, epilogue=epilogue,
                              stencil2d=stencil2d).to(x.device)
    return mod(x, *eaux)


class RotatedPass(nn.Module):
    """The layout-chained executor of a SINGLE-dimension filter: the JAX
    package's ``apply_filter_rotated`` (``Plan.rotate_emit``).

    The input carries the spec's one scanned dimension as its LAST axis
    (whatever its nominal position); the output is emitted with the
    trailing ``rot_axes`` axes rotated one step — the scanned axis lands at
    position ``-rot_axes`` — so an x-scan filter and a y-scan filter, both
    with ``rot_axes=2``, chain with no relayout between them and restore
    the natural order. ``rot_axes=1`` emits in place.

    ``stencil`` — a shifted-tap consumer along the scanned axis of the
    output, ``{"taps": [(offset, coeff), ...], "start": "zero"|"clamp",
    "end": "zero"|"clamp"}`` (taps may be a per-slice list of lists over
    the leading axis): fused into the rotated completion kernel where the
    gates hold, else global shifts (:class:`LastAxisPass`).
    ``epilogue(y, *eaux)`` reads the stencil's output; ``forward(x,
    *eaux)`` takes the aux arrays in the ROTATED output layout.

    Routes, in the JAX package's order: integer filters run the
    sequential core on the last axis (the JAX package's
    ``scan_core.apply_scan``; a unit chain of int8/16/32 under a zero
    border takes the bit-equal :func:`.kernels.int_scan.int_unit_dim_pass`
    instead), then move it explicitly; a bare 1-D signal runs the one-axis executor
    (the supertile hierarchy where it applies), then the stencil as
    shifts; a dimension with no tile plan runs the sequential core
    (:class:`.scan_core.ScanAxis`, the JAX package's ``lax.scan``), then
    moves the axis, then the stencil as shifts and the epilogue;
    everything else runs :class:`LastAxisPass` with the rotated emit. A
    bf16 filter runs that pass on its bf16 kernels or its einsum form (the
    input cast to bf16, a bf16 output, a stencil fused as at float32); the
    core runs in float32 with its consumers, the output cast to bf16, and
    the hierarchy (float32 only, as in the JAX package) is declined."""

    def __init__(self, spec: FilterSpec, rot_axes: int = 2,
                 matmul_precision: str = "px6", epilogue=None,
                 stencil=None):
        super().__init__()
        from .planner import check_precision

        check_precision(matmul_precision)
        spec = spec.stacked()  # a Tuple's components ride a leading axis
        groups = spec.scans_by_axis()
        if len(groups) != 1:
            raise ValueError(
                "the rotated executor requires a single scanned dimension; "
                f"{spec.name} scans {len(groups)}")
        (axis,) = groups
        scans = [spec.scans[i] for i in groups[axis]]
        self.rot_axes, self.w = int(rot_axes), spec.dims[axis].extent
        self.epilogue, self.stencil = epilogue, stencil
        self.units = self.hier = self.core = self.int_core = None
        if spec.dtype in _INT_DTYPES:
            from .scan_core import _compute_type, work_scans

            self.dtype = _INT_DTYPES[spec.dtype]
            if spec.dtype in _UNIT_DTYPES:
                self.units = _int_units(spec, groups[axis])
            if self.units is None:  # the sequential core, in its type
                self.int_core = (_compute_type(spec.dtype), [
                    work_scans(spec)[i] for i in groups[axis]], spec.border)
            return
        if spec.dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"{spec.dtype} filter: the rotated executor runs float32, "
                "bf16 and integer filters (ROADMAP Queue 1 item 4)")
        bf16 = spec.dtype == "bfloat16"
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        clamp = spec.border == BorderMode.CLAMP
        T = (spec.tile_widths or (0,) * spec.ndim)[axis] or _TILE_DEFAULT
        plan = _plan_tiles(self.w, T, max(s.order for s in scans), clamp)
        if plan is None:  # the sequential core, then the rotated emit
            self.core = ScanAxis(scans, -1, spec.border)
            return
        # a bare signal: the one-axis executor, its hierarchy included
        # (declined with an epilogue that the stencil does not precede)
        if (self.rot_axes == 1 and plan[1] > _CHAIN_MATMUL_MAX_TILES
                and (epilogue is None or stencil is not None) and not bf16
                and _hierarchy_ok(self.w, scans, matmul_precision)):
            self.hier = HierarchicalPass(scans, self.w, spec.border,
                                         matmul_precision)
        self.body = LastAxisPass(scans, plan, clamp, matmul_precision,
                                 rot_axes=self.rot_axes, stencil=stencil,
                                 epilogue=epilogue, dtype=self.dtype)

    def forward(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        return self._run(x, False, eaux)

    def forward_plain(self, x: torch.Tensor, *eaux) -> torch.Tensor:
        return self._run(x, True, eaux)

    def _run(self, x, plain, eaux):
        if not 1 <= self.rot_axes <= min(x.ndim, 6):
            raise ValueError(f"rot_axes {self.rot_axes} out of range for "
                             f"ndim {x.ndim}")
        if x.shape[-1] != self.w:
            raise ValueError(f"last axis has {x.shape[-1]} elements, the "
                             f"scanned dimension {self.w}")
        if self.units is not None:
            from .kernels import int_scan

            x = _int_input(x, self.dtype)
            y = (int_scan.unit_scans_plain if plain
                 else int_scan.int_unit_dim_pass)(x, self.units, x.ndim - 1)
            y = y.movedim(-1, -self.rot_axes).contiguous()
            return self._consume(y, -self.rot_axes, eaux)
        if self.int_core is not None:
            from .scan_core import apply_scan

            work, scans, border = self.int_core
            y = _int_input(x, work)
            for s in scans:
                y = apply_scan(y, -1, s.causal, s.feedfwd, s.feedback,
                               border)
            y = y.to(self.dtype).movedim(-1, -self.rot_axes).contiguous()
            return self._consume(y, -self.rot_axes, eaux)
        x = _storage_input(x, self.dtype)
        if self.core is not None:  # float32, cast back once at the end
            y = self.core(x.float()).movedim(-1, -self.rot_axes)
            return self._consume(y, -self.rot_axes, eaux).to(x.dtype)
        if self.hier is not None and x.ndim == 1:
            return self._consume(self.hier(x, plain), -1, eaux)
        return self.body(x, plain, eaux)

    def _consume(self, y, axis, eaux):
        """The stencil as shifts, then the epilogue."""
        if self.stencil is not None:
            y = _stencil_fallback(y, self.stencil, axis)
        if self.epilogue is not None:
            y = _epilogue(self.epilogue, y, eaux) if y.is_floating_point() \
                else self.epilogue(y, *(torch.as_tensor(a).to(y.device)
                                        for a in eaux))
        return y


def apply_filter_rotated(spec: FilterSpec, x, rot_axes: int = 2,
                         matmul_precision: str = "px6", epilogue=None,
                         eaux=(), stencil=None):
    """Functional :class:`RotatedPass` on ``x``'s device."""
    mod = RotatedPass(spec, rot_axes, matmul_precision, epilogue,
                      stencil).to(x.device)
    return mod(x, *eaux)
