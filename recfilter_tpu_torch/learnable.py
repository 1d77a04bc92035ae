"""Differentiable recursive filters: runtime coefficients, trainable by
gradient — the port of ``recfilter_tpu.learnable``.

The blocked algebra of the static executors, rebuilt from coefficient
tensors (``torch.Tensor``s with ``requires_grad``) on every call:

  * the impulse matrix B and the state matrix R come from one triangular
    solve each, ``L·B = b0·I (+ the clamp taps)`` and ``L·R = direct`` with
    ``L = I − Σ_j a_j·S^{j+1}`` (S the down-shift) — where the JAX package
    runs a 128-step ``lax.scan`` — in float64, cast to float32 once where a
    kernel takes them (the static path's precedent; the JAX package builds
    them in float32 and misses its own px6 bound on the σ=5 Gaussian);
  * the cross-tile carries: a dense solve from W powers (built by
    doubling) up to 128 tiles, the log-depth associative scan over (W, b)
    affine pairs past it (``dimfuse.affine_scan``), in float64;
  * at 128-wide tiles, ΣK ≤ 8, ≤ 512 tiles and ≥ 8 lines (the JAX gate),
    the tails and the completion run on the ``tails_traced`` and
    ``completion_traced`` CUDA kernels, which take the matrices as runtime
    tensors and give the matrices' gradients through their autograd
    Functions (``kernels.completion``); elsewhere (clamp and pad tile
    variants, other tile widths, audio-scale tile counts) einsums in
    float64.

:class:`LearnableRecFilter` makes any filter spec a trainable layer
(coefficient fitting, IIR deconvolution with numerator taps, learned
separable blurs); :func:`params_from_jax` carries the JAX package's
parameters across.

    model = LearnableRecFilter(spec, tile_width=128)        # on the card
    opt = torch.optim.Adam(model.parameters(), 2e-2)
    loss = ((model(x) - target) ** 2).mean()
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import dimfuse
from .api import resolve_device
from .kernels.completion import TILE, completion_traced, tails_traced
from .spec import BorderMode, FilterSpec

_SLOTS8 = 8  # carry rows the traced kernels take (one slot)
_DENSE_SOLVE_MAX = 128  # tile counts solved densely (the JAX branch point)


def _f64(v, device) -> torch.Tensor:
    """``v`` (a tensor, keeping its graph, or a number) as float64."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float64)
    return torch.tensor(v, dtype=torch.float64, device=device)


def _feedback_system(a: torch.Tensor, T: int) -> torch.Tensor:
    """L = I − Σ_j a_j·S^{j+1} (T, T): ``L[y, x] = c[y − x]`` with c = (1,
    −a_1, …, −a_k, 0, …) and zeros above the diagonal — the windows of one
    zero-led vector (a strided view, not a gather: the backward of a
    gather scatters T² entries into k + 1 bins, serially on the card)."""
    col = torch.cat([a.new_ones(1), -a, a.new_zeros(T)])[:T]
    return torch.cat([a.new_zeros(T - 1), col]).unfold(0, T, 1).flip(1)


def _solve(L, rhs):
    return torch.linalg.solve_triangular(L, rhs, upper=False,
                                         unitriangular=True)


def impulse_matrix_t(feedfwd, feedback, tile_width: int,
                     clamp: bool = False) -> torch.Tensor:
    """Runtime-coefficient twin of ``coeffs.impulse_matrix`` (the JAX
    package's ``impulse_matrix_jnp``): B (T, T) float64, differentiable in
    ``feedfwd`` (b0) and ``feedback`` (a, (k,)).

    The zero border is the triangular system ``L·B = b0·I``. Under a clamp
    border the off-the-top taps read the raw input x[0] at row 0 and row 0
    of B (= (b0 + Σa)·e_0) below it, so they add to column 0 of the right
    side: Σ_j a_j at row 0, (Σ_{j ≥ y} a_j)·(b0 + Σa) at rows 1 ≤ y < k."""
    a = torch.as_tensor(feedback)
    a = _f64(a, a.device)
    b0 = _f64(feedfwd, a.device)
    T, k = int(tile_width), a.shape[0]
    eye = torch.eye(T, dtype=torch.float64, device=a.device)
    rhs = b0 * eye
    if clamp:
        suf = a.flip(0).cumsum(0).flip(0)  # Σ_{j ≥ y} a_j
        col = torch.cat([suf[:1], suf[1:] * (b0 + suf[0])])[:T]
        rhs = rhs + F.pad(col, (0, T - col.shape[0]))[:, None] * eye[0]
    return _solve(_feedback_system(a, T), rhs)


def state_matrix_t(feedback, tile_width: int) -> torch.Tensor:
    """Runtime-coefficient twin of ``coeffs.state_matrix`` (the JAX
    package's ``state_matrix_jnp``): R (T, k) float64 from ``L·R = direct``,
    ``direct[y, x] = a[x + y]`` for x + y < k."""
    a = torch.as_tensor(feedback)
    a = _f64(a, a.device)
    T, k = int(tile_width), a.shape[0]
    direct = torch.cat([a, a.new_zeros(T)]).unfold(0, k, 1)[:T]
    return _solve(_feedback_system(a, T), direct)


def blocked_scan_learnable(x, feedfwd, feedback, tile_width: int,
                           clamp: bool = False) -> torch.Tensor:
    """Causal blocked scan of x (L, w) with runtime coefficients (the JAX
    package's ``blocked_scan_learnable``): per-tile B·x, the carries by an
    associative scan over (W, b) pairs, then R·s. Float64 inside; returns
    x's dtype."""
    L, w = x.shape
    a = torch.as_tensor(feedback)
    k = a.shape[0]
    T = int(min(tile_width, w))
    n = -(-w // T)
    B = impulse_matrix_t(feedfwd, a, T)
    R = state_matrix_t(a, T)
    PB, W = B.flip(0)[:k], R.flip(0)[:k]  # P·B (rows T−1, T−2, …), P·R
    xt = F.pad(x.double(), (0, n * T - w)).reshape(L, n, T)
    b = torch.einsum("kt,lnt->lnk", PB, xt)
    if clamp:
        Bf = impulse_matrix_t(feedfwd, a, T, clamp=True)
        b = _put_tile(b, 0, torch.einsum("kt,lt->lk", Bf.flip(0)[:k],
                                         xt[:, 0]))
    s = dimfuse.affine_scan(W.expand(n, k, k), b)
    s_prev = F.pad(s[:, :-1], (0, 0, 1, 0))  # tile t starts from tile t−1's
    y = (torch.einsum("ts,lns->lnt", B, xt)
         + torch.einsum("tk,lnk->lnt", R, s_prev))
    if clamp:
        y = _put_tile(y, 0, torch.einsum("ts,ls->lt", Bf, xt[:, 0]))
    return y.reshape(L, n * T)[:, :w].to(x.dtype)


def apply_scan_learnable(x, axis: int, causal: bool, feedfwd, feedback,
                         tile_width: int = 32,
                         border: str = BorderMode.ZERO) -> torch.Tensor:
    """One differentiable scan along ``axis``."""
    x = x.movedim(axis, -1)
    shape = x.shape
    if not causal:
        x = x.flip(-1)
    y = blocked_scan_learnable(x.reshape(-1, shape[-1]), feedfwd, feedback,
                               tile_width, clamp=border == BorderMode.CLAMP)
    y = y.reshape(shape)
    if not causal:
        y = y.flip(-1)
    return y.movedim(-1, axis)


def fir_apply(x, taps, causal: bool, axis: int = -1) -> torch.Tensor:
    """Differentiable FIR along ``axis``: ``u[i] = Σ_m taps[m]·x[i ∓ m]``
    (− causal, + anticausal), zero beyond the borders. ``taps`` (M+1,) is
    the numerator B(z) of a full B(z)/A(z) model."""
    taps = torch.as_tensor(taps)
    x = x.movedim(axis, -1)
    w = x.shape[-1]
    u = taps[0] * x
    for m in range(1, taps.shape[0]):
        if causal:
            shifted = F.pad(x, (m, 0))[..., :w]
        else:
            shifted = F.pad(x, (0, m))[..., m:m + w]
        u = u + taps[m] * shifted
    return u.movedim(-1, axis)


def _put_tile(v, t: int, row):
    """``v`` (L, n, ...) with tile t replaced by ``row`` (L, ...), out of
    place."""
    return torch.cat([v[:, :t], row.unsqueeze(1), v[:, t + 1:]], dim=1)


def _dim_mats_learnable(params, T: int, pad_slots: int = 0,
                        clamp_edges: tuple = ()):
    """The matrices of one fused dimension pass for ONE tile variant, from
    runtime coefficients (the JAX package's ``_dim_mats_learnable``): per
    scan (B, RN, sel, W, k, causal) in the natural-order carry convention,
    and the compositions G (tail rows), H (couplings), Btot and Rhat, all
    float64.

    ``pad_slots``: the last-tile variant, each scan's B projected onto the
    first T − pad positions so the zero pad stays zero between scans.
    ``clamp_edges`` ⊆ {"first", "last"}: the image edges this tile touches
    under a clamp border (a causal scan clamps at the first tile, an
    anticausal one at the last)."""
    base = []
    for causal, b0, a in params:
        a = torch.as_tensor(a)
        k = int(a.shape[0])
        use_clamp = ("first" in clamp_edges and causal) or (
            "last" in clamp_edges and not causal)
        B = impulse_matrix_t(b0, a, T, clamp=use_clamp)
        R = state_matrix_t(a, T)
        W = R.flip(0)[:k]  # P·R: a carry across one tile
        if causal:
            RN = R.flip(1)  # R·J_k: the ascending last-k previous carry
            sel = lambda M, k=k: M[T - k:]
        else:
            B = B.flip((0, 1))
            RN = R.flip(0)
            sel = lambda M, k=k: M[:k]
        if pad_slots:
            z = torch.ones(T, dtype=B.dtype, device=B.device)
            z[T - pad_slots:] = 0.0
            B = B * z[None, :]
        base.append((B, RN, sel, W, k, bool(causal)))

    m = len(base)
    Rhat = [[None] * m for _ in range(m)]
    G, H = [None] * m, [[None] * m for _ in range(m)]
    acc = None
    for i, (B, RN, sel, _, _, _) in enumerate(base):
        for j in range(i):
            Rhat[i][j] = B @ Rhat[i - 1][j]
            H[i][j] = sel(Rhat[i][j])
        Rhat[i][i] = RN
        acc = B if acc is None else B @ acc
        G[i] = sel(acc)
    return base, G, H, acc, Rhat[m - 1]


def _w_powers(W, n: int) -> torch.Tensor:
    """(n, k, k) with P[d] = W^d, by doubling: P[m:2m] = W^m·P[:m], one
    batched product per step."""
    P = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)[None]
    Wm = W
    while P.shape[0] < n:
        P = torch.cat([P, Wm @ P])
        Wm = Wm @ Wm
    return P[:n]


def _chain_solve_learnable(b, W, k: int, causal: bool) -> torch.Tensor:
    """The cross-tile solve with a runtime W (the JAX package's
    ``_chain_solve_learnable``): ``b`` (L, n, k) natural local tails →
    the incoming vectors N (L, n, k). Up to 128 tiles (the JAX package's
    branch point) a dense solve from the powers of W (one (n·k)² product):
    fewer ops than the scan, which the host-bound training step feels;
    past it the associative scan (``dimfuse._chain_solve_assoc``, whose
    (W, b) recurrence is the JAX branch's), linear in n where the dense
    window grows as n²."""
    n = b.shape[1]
    Jk = torch.eye(k, dtype=W.dtype, device=W.device).flip(0)
    if n > _DENSE_SOLVE_MAX:
        return dimfuse._chain_solve_assoc(b, causal, W, Jk)
    bt = b.flip(2) if causal else b.flip(1)
    # tile t receives W^{t−u−1}·b_u from every u < t: M[t, :, :, u] =
    # v[n + t − u − 1] over v = (n zeros, W^0 .. W^{n−1}), as windows
    v = torch.cat([W.new_zeros((n,) + W.shape), _w_powers(W, n)])
    M = v.unfold(0, n, 1)[:n].flip(-1)  # (n, k, k, n)
    s_prev = torch.einsum("tiju,luj->lti", M, bt)
    return s_prev.flip(2) if causal else s_prev.flip(1)


def traced_carries(braw_t, base, H) -> torch.Tensor:
    """The kernel route's carry solves: the tails (n, 8, L) of
    ``tails_traced`` → the incoming carries in the slot-padded layout
    (n, 8, L) float32 that ``completion_traced`` reads (float64 inside,
    the H couplings between scans)."""
    n, _, L = braw_t.shape
    braw = braw_t.permute(2, 0, 1).double()  # (L, n, 8)
    offs = np.cumsum([0] + [b[4] for b in base])
    Ns = []
    for i, (_, _, _, W, k, causal) in enumerate(base):
        b = braw[..., offs[i]:offs[i + 1]]
        for j in range(i):
            b = b + torch.einsum("ko,lno->lnk", H[i][j], Ns[j])
        Ns.append(_chain_solve_learnable(b, W, k, causal))
    if offs[-1] < _SLOTS8:
        Ns.append(Ns[0].new_zeros(L, n, _SLOTS8 - int(offs[-1])))
    return torch.cat(Ns, dim=-1).permute(1, 2, 0).float().contiguous()


def _kernel_route(X, base, G, H, Btot, Rhat, plain: bool):
    """Tails on ``tails_traced``, the solves in float64, the completion on
    ``completion_traced``: X (L, n, 128) float32 → Y (L, n, 128)."""
    X = X.contiguous()
    braw_t = tails_traced(X, torch.cat(G).float(), plain)
    # one scan's Btot is its B as solve_triangular returns it (column-major)
    return completion_traced(X, Btot.float().contiguous(),
                             torch.cat(Rhat, 1).float(),
                             traced_carries(braw_t, base, H), plain)


def fused_dim_learnable(x, params, tile_width: int, clamp: bool = False,
                        plain: bool = False) -> torch.Tensor:
    """All scans of one dimension in one fused pass with runtime
    coefficients (the JAX package's ``fused_dim_learnable``).

    ``x`` (..., w) has the scanned dimension last; ``params`` lists
    ``(causal, b0, a)`` per scan. One stacked-G product for all local
    tails, per-scan solves with the H couplings, one completion. A clamp
    border uses first/last-tile variants and needs a tile width dividing w;
    raises ValueError where ``dimfuse._plan_tiles`` finds no plan (an
    order past the width; a clamp border with no tile width in [kmax, T]
    dividing w), as the JAX package does.

    Routes as the JAX package: 128-wide tiles, ΣK ≤ 8, ≤ 512 tiles, no
    tile variant, float32 and ≥ 8 lines run the ``tails_traced`` and
    ``completion_traced`` kernels on a CUDA tensor (``plain``: their
    twins), the twins on a CPU tensor; everything else the float64 einsum
    form."""
    shape = x.shape
    w = shape[-1]
    kmax = max(int(torch.as_tensor(a).shape[0]) for _, _, a in params)
    plan = dimfuse._plan_tiles(w, tile_width, kmax, clamp)
    if plan is None:
        raise ValueError(f"no fused tile plan for w={w}, order {kmax}, tile "
                         f"width {tile_width}" + (" (clamp)" if clamp else ""))
    T, n, pad = plan
    X = F.pad(x.reshape(-1, w), (0, pad)).reshape(-1, n, T)
    L = X.shape[0]
    base, G, H, Btot, Rhat = _dim_mats_learnable(params, T)
    # per-tile overrides (tile, mats): first/last under clamp, last with pad
    overrides = []
    if clamp:
        if n == 1:
            overrides.append((0, _dim_mats_learnable(
                params, T, clamp_edges=("first", "last"))))
        else:
            overrides.append((0, _dim_mats_learnable(
                params, T, clamp_edges=("first",))))
            overrides.append((n - 1, _dim_mats_learnable(
                params, T, pad_slots=pad, clamp_edges=("last",))))
    elif pad:
        overrides.append((n - 1, _dim_mats_learnable(params, T,
                                                     pad_slots=pad)))

    S = sum(b[4] for b in base)
    if (not overrides and T == TILE and n <= 512 and S <= _SLOTS8
            and X.dtype == torch.float32 and L >= 8):
        Y = _kernel_route(X, base, G, H, Btot, Rhat, plain)
    else:
        X64 = X.double()
        N = []
        for i, (_, _, _, W, k, causal) in enumerate(base):
            b = torch.einsum("kt,lnt->lnk", G[i], X64)
            for j in range(i):
                b = b + torch.einsum("ko,lno->lnk", H[i][j], N[j])
            for t, (_, Gv, Hv, _, _) in overrides:
                bl = torch.einsum("kt,lt->lk", Gv[i], X64[:, t])
                for j in range(i):
                    bl = bl + torch.einsum("ko,lo->lk", Hv[i][j], N[j][:, t])
                b = _put_tile(b, t, bl)
            N.append(_chain_solve_learnable(b, W, k, causal))
        Y = torch.einsum("ts,lns->lnt", Btot, X64)
        for j in range(len(base)):
            Y = Y + torch.einsum("tk,lnk->lnt", Rhat[j], N[j])
        for t, (_, _, _, Btv, Rhv) in overrides:
            yl = torch.einsum("ts,ls->lt", Btv, X64[:, t])
            for j in range(len(base)):
                yl = yl + torch.einsum("tk,lk->lt", Rhv[j], N[j][:, t])
            Y = _put_tile(Y, t, yl)
        Y = Y.to(x.dtype)
    return Y.reshape(L, n * T)[:, :w].reshape(shape)


class LearnableRecFilter(nn.Module):
    """A recursive filter whose coefficients are trainable parameters (the
    JAX package's ``LearnableRecFilter``).

    ``init_params()`` builds ``{scan_i: {"b0": (), "a": (k,)}}`` from the
    spec (``{"b": (fir_taps + 1,)}`` numerator taps in place of b0 when
    ``fir_taps`` is set) as an ``nn.ParameterDict`` of float64 parameters;
    the module holds one as ``params``. Float64, where the JAX package
    keeps float32: a recursive filter is sensitive to its feedback
    coefficients — the σ=5 Gaussian's DC gain b0/(1 − Σa) has
    1 − Σa ≈ 0.0227, so a rounded to float32 moves the output by ~8e-6 of
    its peak, past the px6 bound — and the parameters are few. ``apply(params, x)`` runs the filter with any such
    parameters (functional form; it shadows ``nn.Module.apply``),
    ``forward(x)`` with its own, ``forward_plain(x)`` with the kernels'
    twins in place of the kernels.

    ``fused=True`` groups the scans of each axis into one
    :func:`fused_dim_learnable` pass: all numerator FIRs of the axis first,
    then every IIR (LTI operators along one axis commute). An axis with no
    fused plan (a clamp border with no dividing tile width) runs the
    per-scan blocked path, as with ``fused=False``.

    The parameters and the computation live on ``device``: the card unless
    the caller asks for the CPU (``device="cpu"``); a tensor given to
    ``apply`` is moved there as float32."""

    def __init__(self, spec: FilterSpec, tile_width: int = 32,
                 fir_taps: int = 0, fused: bool = True, *, device="cuda"):
        super().__init__()
        self.spec = spec
        self.tile_width = int(tile_width)
        self.fir_taps = int(fir_taps)
        self.fused = bool(fused)
        self.device = resolve_device(device)
        self.params = self.init_params()

    def init_params(self) -> nn.ParameterDict:
        out = nn.ParameterDict()
        for i, s in enumerate(self.spec.scans):
            p = {"a": torch.tensor(s.feedback, dtype=torch.float64,
                                   device=self.device)}
            if self.fir_taps:
                b = torch.zeros(self.fir_taps + 1, dtype=torch.float64,
                                device=self.device)
                b[0] = s.feedfwd
                p["b"] = b
            else:
                p["b0"] = torch.tensor(s.feedfwd, dtype=torch.float64,
                                       device=self.device)
            out[f"scan{i}"] = nn.ParameterDict(p)
        return out

    @staticmethod
    def _scan_param(params, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        p = params[f"scan{i}"]
        if "b" in p:
            return p["b"], p["a"]
        return p["b0"].reshape(1), p["a"]

    def apply(self, params, x, plain: bool = False) -> torch.Tensor:
        """Per scanned axis, the numerator FIRs first in scan order, then
        the IIR scans in scan order (mixed-causality FIR/IIR pairs do not
        commute at finite borders, so this placement is part of the model,
        the same in the fused and per-scan paths); FIRs zero-extend."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        clamp = self.spec.border == BorderMode.CLAMP
        for axis, ids in self.spec.scans_by_axis().items():
            pl = []
            for i in ids:
                b, a = self._scan_param(params, i)
                causal = self.spec.scans[i].causal
                if b.shape[0] > 1:
                    x = fir_apply(x, b, causal, axis)
                    b0 = torch.ones((), dtype=torch.float64,
                                    device=self.device)
                else:
                    b0 = b[0]
                pl.append((causal, b0, a))
            kmax = max(int(a.shape[0]) for _, _, a in pl)
            if self.fused and dimfuse._plan_tiles(
                    x.shape[axis], self.tile_width, kmax, clamp) is not None:
                x = fused_dim_learnable(x.movedim(axis, -1), pl,
                                        self.tile_width, clamp=clamp,
                                        plain=plain).movedim(-1, axis)
            else:
                for causal, b0, a in pl:
                    x = apply_scan_learnable(x, axis, causal, b0, a,
                                             tile_width=self.tile_width,
                                             border=self.spec.border)
        return x

    def forward(self, x) -> torch.Tensor:
        return self.apply(self.params, x)

    def forward_plain(self, x) -> torch.Tensor:
        return self.apply(self.params, x, plain=True)


def params_from_jax(tree: Dict[str, Dict[str, np.ndarray]],
                    device="cuda") -> nn.ParameterDict:
    """The JAX package's ``{scan_i: {"b0" | "b": array, "a": array}}``
    (numpy arrays) as the port's parameters: an ``nn.ParameterDict`` of
    float64 parameters (the same values) on ``device``, for
    ``LearnableRecFilter.apply`` or as a module's ``params``."""
    dev = resolve_device(device)
    return nn.ParameterDict({
        name: nn.ParameterDict({
            key: nn.Parameter(torch.tensor(np.asarray(v), dtype=torch.float64,
                                           device=dev))
            for key, v in p.items()})
        for name, p in tree.items()})
