"""The rotated emit at the reduced grades against the JAX package.

``CompletionPass(rot=True, nprod)`` — its split twin, the arithmetic of the
``completion_rot``, ``completion_rot_epi`` and ``completion_rot_tails``
kernels — at nprod 1, 3, 4 and 6 against the JAX package's
``completion_pass(rot=True, nprod=…)`` (Pallas interpret mode on the CPU,
as its own tests run) on the same seeded numpy inputs: uniform, clamp and
pad variant stacks, a stencil reaching both neighbour tiles under zero and
clamp borders, an affine epilogue with one and two aux arrays, and the next
pass's tails at ra = 1 (images) and ra = 2 (volumes). Then
``fused_filter_module`` at px3, px4 and ``default`` on the routes this
slice opens — 2-D rotation chains (zero, clamp), a chained volume, a volume
whose trailing pair declines after its rows pass, and a y-only filter on
``FusedAxisPass`` — against the f64 oracle and the JAX package's
``apply_filter_fused`` at the grade, and at ``default`` which passes take
the kernels, against the JAX package's structural rule (spied).

Bounds: the grade's bound of the float64 reference's peak (px6 2e-6, px4
8e-5, px3 1e-4, ``default`` 3e-2: ``tests/test_dimfuse.py:454``,
``tests/test_overlap2d.py:438``), and twice it of the JAX package's output
(at ``default`` the JAX package takes one product on the carry rows where
the port takes three: ``kernels/split.py``); the split twin without a
stencil or an epilogue also lies within ``split_exact``'s per-output bound
of its exact chunk sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import completion as jc

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.epilogue import Affine
from recfilter_tpu_torch.kernels import completion as tc

T = 128
NPRODS = [1, 3, 4, 6]
BOUND = {6: 2e-6, 4: 8e-5, 3: 1e-4, 1: 3e-2}
GRADES = {"px3": 3, "px4": 4, "default": 1}


def _stack(kind, rows, cols, n, rng, scale=1.0):
    """A per-tile matrix stack: one matrix ("uniform"), first and last
    tiles of their own ("clamp"), or the last alone ("pad")."""
    M = [rng.standard_normal((rows, cols)) * scale for _ in range(3)]
    if kind == "uniform":
        return M[0][None]
    first = M[1] if kind == "clamp" else M[0]
    return np.stack([first] + [M[0]] * (n - 2) + [M[2]])


def _inputs(kind, n, q, S, seed):
    rng = np.random.default_rng(seed)
    Btot = _stack(kind, T, T, n, rng, 0.1)
    Rcat = _stack(kind, T, S, n, rng, 0.5)
    x = rng.standard_normal((q, n, T)).astype(np.float32)
    N = np.zeros((n, 8, q), np.float32)
    N[:, :S] = rng.standard_normal((n, S, q))
    return Btot, Rcat, x, N, rng


def _f64(Btot, Rcat, x, N):
    """The rotated product in float64, (n·T, q)."""
    n, q, S = x.shape[1], x.shape[0], Rcat.shape[-1]
    idx = np.minimum(np.arange(n), Btot.shape[0] - 1)
    y = (np.einsum("nos,qns->noq", Btot[idx], x.astype(np.float64))
         + np.einsum("nou,nuq->noq", Rcat[np.minimum(np.arange(n),
                                                     Rcat.shape[0] - 1)],
                     N[:, :S].astype(np.float64)))
    return y.reshape(n * T, q)


def _near(got, ref, want, nprod):
    """``got`` within the grade's bound of ``ref``'s peak, twice it of the
    JAX package's ``want``."""
    got = np.asarray(got, np.float64)
    lim = BOUND[nprod] * np.abs(ref).max()
    assert got.shape == ref.shape == want.shape
    assert np.abs(got - ref).max() <= lim
    assert np.abs(got - want).max() <= 2 * lim


def _jax(x, Btot, Rcat, N, nprod, **kw):
    return jc.completion_pass(jnp.asarray(x), Btot, Rcat, jnp.asarray(N),
                              rot=True, nprod=nprod, interpret=True,
                              carries_transposed=True, **kw)


# ------------------------------------------------------- the split twin

@pytest.mark.parametrize("kind", ["uniform", "clamp", "pad"])
@pytest.mark.parametrize("nprod", NPRODS)
def test_rot_twin_matches_jax(nprod, kind):
    """No consumer: the split twin against the JAX kernel at the grade and
    the float64 product, and within ``split_exact``'s bound of its exact
    chunk sum at every output."""
    n, q = 3, 72
    Btot, Rcat, x, N, _ = _inputs(kind, n, q, 6, nprod + len(kind))
    mod = tc.CompletionPass(Btot, Rcat, n, rot=True, nprod=nprod)
    xt, Nt = torch.from_numpy(x), torch.from_numpy(N)
    got = mod.split_plain(xt, Nt)
    want = np.asarray(_jax(x, Btot, Rcat, N, nprod)).reshape(n * T, q)
    _near(got, _f64(Btot, Rcat, x, N), want, nprod)
    assert torch.equal(mod(xt, Nt), got if nprod < 6 else mod._twin(xt, Nt))
    ref, bound = mod.split_exact(xt, Nt)
    assert ref.shape == got.shape
    assert ((got.double() - ref).abs() <= bound).all()


@pytest.mark.parametrize("border", ["zero", "clamp"])
@pytest.mark.parametrize("nprod", NPRODS)
def test_rot_stencil_twin_matches_jax(nprod, border):
    """A stencil reaching 3 rows back and 5 ahead (both neighbour tiles)
    under a zero or clamp border at both ends, on halo strips cut from the
    float64 product: the twin (the kernel's per-tile form) against the
    JAX kernel and the float64 stencil of the float64 product."""
    n, q = 3, 40
    taps = [(-3, 0.5), (0, 1.0), (5, -0.25)]
    Btot, Rcat, x, N, _ = _inputs("clamp", n, q, 4, 20 + nprod)
    st = {"taps": taps, "start": border, "end": border}
    mod = tc.CompletionPass(Btot, Rcat, n, rot=True, stencil=st,
                            nprod=nprod)
    y64 = torch.from_numpy(_f64(Btot, Rcat, x, N))
    Y = y64.reshape(n, T, q).float()
    hp, hn = mod.hp, mod.hn
    prev = torch.cat([torch.zeros(1, hp, q), Y[:-1, T - hp:]])
    nxt = torch.cat([Y[1:, :hn], torch.zeros(1, hn, q)])
    got = mod.split_plain(torch.from_numpy(x), torch.from_numpy(N), prev,
                          nxt)
    ref = tc._stencil_flat(y64, taps, border, border).numpy()
    jp = np.zeros((n, 8, q), np.float32)
    jp[:, 8 - hp:] = prev.numpy()
    jn = np.zeros((n, 8, q), np.float32)
    jn[:, :hn] = nxt.numpy()
    want = np.asarray(_jax(x, Btot, Rcat, N, nprod, stencil=dict(
        taps=taps, prev=jnp.asarray(jp), nxt=jnp.asarray(jn), start=border,
        end=border))).reshape(n * T, q)
    _near(got, ref, want, nprod)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("nprod", NPRODS)
def test_rot_epilogue_twin_matches_jax(nprod, k):
    """The affine epilogue a·y + Σᵢ bᵢ·auxᵢ + c with k aux arrays in the
    rotated layout: the twin against the JAX kernel's epilogue and the
    float64 form."""
    n, q = 3, 48
    Btot, Rcat, x, N, rng = _inputs("pad", n, q, 6, 30 + nprod + k)
    coef = [(2.0,), (-1.0, 0.5)][k - 1]
    aff = Affine(0.75, coef, 0.125)
    aux = [rng.standard_normal((n * T, q)).astype(np.float32)
           for _ in range(k)]
    mod = tc.CompletionPass(Btot, Rcat, n, rot=True, affine=aff,
                            nprod=nprod)
    got = mod.split_plain(torch.from_numpy(x), torch.from_numpy(N),
                          *map(torch.from_numpy, aux))
    ref = 0.75 * _f64(Btot, Rcat, x, N) + 0.125 + sum(
        b * a.astype(np.float64) for b, a in zip(coef, aux))

    def epi(y, *a):
        out = 0.75 * y + 0.125
        for b, v in zip(coef, a):
            out = out + b * v
        return out

    want = np.asarray(_jax(x, Btot, Rcat, N, nprod, epilogue=epi, eaux=tuple(
        jnp.asarray(a) for a in aux))).reshape(n * T, q)
    _near(got, ref, want, nprod)


@pytest.mark.parametrize("ra", [1, 2], ids=["image", "volume"])
@pytest.mark.parametrize("nprod", NPRODS)
def test_rot_next_tails_twin_matches_jax(nprod, ra):
    """``next_tails``: the output and the next pass's tails (float64 sums
    of the output, the port's rule; the JAX package splits them at the
    grade) against the JAX kernel and the float64 tails of the float64
    product; the pad slots zero."""
    n, n2, S2 = 3, 2, 5
    q = ra * n2 * T
    Btot, Rcat, x, N, rng = _inputs("clamp", n, q, 6, 40 + nprod + ra)
    G2 = _stack("clamp", S2, T, n2, rng, 0.1)
    mod = tc.CompletionPass(Btot, Rcat, n, rot=True, next_tails=(G2, n2),
                            nprod=nprod)
    y, t2 = mod.split_plain(torch.from_numpy(x), torch.from_numpy(N))
    yj, tj = _jax(x, Btot, Rcat, N, nprod, next_tails=(G2, n2, T))
    y64 = _f64(Btot, Rcat, x, N)
    _near(y, y64, np.asarray(yj).reshape(n * T, q), nprod)
    Gp = np.zeros((n2, 8, T))
    Gp[:, :S2] = G2
    t64 = np.einsum("cst,rct->csr", Gp, y64.reshape(-1, n2, T))
    _near(t2, t64, np.asarray(tj).reshape(n2, 8, -1), nprod)
    assert not t2[:, S2:].any()


# -------------------------------------------- the routes through the API

def _spec(m, shape, scans, border="zero", tiles=None):
    names = "zyx"[-len(shape):]
    return m.FilterSpec("R", tuple(m.Dim(a, e) for a, e in zip(names, shape)),
                        tuple(scans), border=border,
                        tile_widths=tiles or (128,) * len(shape))


def _gauss(m, axis, causal=True):
    w = rft.gaussian_weights(5.0, 3)
    return m.Scan(axis, causal, float(w[0]), tuple(float(c) for c in w[1:]))


def _chain2d(border):
    # ΣK = 12 on x: the 3-touch executor declines; x hands y its tails
    return lambda m: _spec(m, (256, 256), tuple(
        _gauss(m, 1, c) for c in (True, False, True, False)) + (
        _gauss(m, 0), _gauss(m, 0, False)), border)


CASES = {
    "chain-zero": (_chain2d("zero"), ["RotationChain"]),
    "chain-clamp": (_chain2d("clamp"), ["RotationChain"]),
    # the rows pass declines z (40): the chain on all three axes, x then
    # y chained, z on 32-wide tiles (no kernel)
    "volume-chained": (lambda m: _spec(m, (40, 128, 256), (
        _gauss(m, 0), _gauss(m, 1), _gauss(m, 2)), tiles=(0, 128, 128)),
        ["RotationChain"]),
    # the rows pass declines y (200): FusedAxisPass
    "y-only": (lambda m: _spec(m, (200, 128), (
        _gauss(m, 0), _gauss(m, 0, False)), tiles=(128, 0)),
        ["FusedAxisPass"]),
}


def _passes(mod):
    """The port's last-axis passes, in order."""
    parts = list(mod.stages) if isinstance(mod, tdf.StagedPass) else [mod]
    out = []
    for p in parts:
        if isinstance(p, tdf.RotationChain):
            out += list(p.passes)
        elif isinstance(p, tdf.FusedAxisPass):
            out.append(p.body)
    return out


@pytest.mark.parametrize("grade", list(GRADES))
@pytest.mark.parametrize("case", list(CASES))
def test_routes_match_jax_and_oracle_at_the_grades(case, grade,
                                                   monkeypatch):
    """Each filter at the grade through ``fused_filter_module``: the
    stages named, every rotated kernel at the grade, within the grade's
    bound of the f64 oracle and twice it of the JAX package; the passes
    that take the rotated kernels are those on which the JAX package runs
    its rotated ``completion_pass`` (spied) — at ``default`` only where
    the JAX package's structural rule finds a win."""
    make, stages = CASES[case]
    js, ts = make(jspec), make(tspec)
    x = np.random.default_rng(len(case)).standard_normal(
        [d.extent for d in js.dims]).astype(np.float32)
    calls = []  # per JAX pass, the product count of its rotated kernel
    orig_pass, orig = jdf._last_axis_pass_t, jc.completion_pass

    def pass_spy(*a, **k):
        calls.append(0)
        return orig_pass(*a, **k)

    def spy(*a, **k):
        if k.get("rot"):
            calls[-1] = k.get("nprod")
        return orig(*a, **k)

    monkeypatch.setattr(jdf, "_last_axis_pass_t", pass_spy)
    monkeypatch.setattr(jc, "completion_pass", spy)
    want = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(x),
                                             tile_default=32,
                                             matmul_precision=grade))
    mod = tdf.fused_filter_module(ts, grade)
    parts = list(mod.stages) if isinstance(mod, tdf.StagedPass) else [mod]
    assert [type(p).__name__ for p in parts] == stages
    kernels = [p.nprod if p.completion is not None else 0
               for p in _passes(mod)]
    assert kernels == calls
    assert set(kernels) <= {0, GRADES[grade]}
    got = mod(torch.from_numpy(x)).numpy().astype(np.float64)
    oracle = jsc.oracle_apply(js, x.astype(np.float64))
    lim = BOUND[GRADES[grade]] * np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= lim
    assert np.abs(got - want).max() <= 2 * lim


def _declined(m):
    # 128 × 16 × 128: the rows pass on z, then the chain on the pair (y
    # below one tile: the 3-touch executor declines it)
    return _spec(m, (128, 16, 128), (_gauss(m, 0), _gauss(m, 2),
                                     _gauss(m, 2, False), _gauss(m, 1)))


def _pair(m):
    # one z slice of the declined volume's pair: the same chain
    return _spec(m, (16, 128), (_gauss(m, 1), _gauss(m, 1, False),
                                _gauss(m, 0)))


@pytest.mark.parametrize("grade", list(GRADES))
def test_declined_volume_matches_jax_and_oracle_at_the_grades(grade,
                                                              monkeypatch):
    """A volume whose trailing pair declines after its rows pass (128 × 16
    × 128): the rows pass at the grade, then the chain on the pair, once
    per z slice; the whole call within the grade's bound of the f64
    oracle. The JAX package runs that chain slice by slice (a Python loop
    of interpret-mode kernels, minutes on the CPU), so the chain stage is
    held to the JAX package on its input's first two slices, each the 2-D
    filter of the pair (the same chain, one slice): within twice the bound,
    the same passes on the rotated kernels (spied), the whole call at
    ``default`` (no kernel there) to the JAX package's."""
    js, ts = _declined(jspec), _declined(tspec)
    x = np.random.default_rng(9).standard_normal(
        [d.extent for d in js.dims]).astype(np.float32)
    mod = tdf.fused_filter_module(ts, grade)
    assert [type(p).__name__ for p in mod.stages] == ["FusedRowsPx",
                                                      "RotationChain"]
    assert mod.stages[0].final.nprod == GRADES[grade]
    mid = mod.stages[0](torch.from_numpy(x))  # the call, stage by stage
    got = mod.stages[1](mid).numpy().astype(np.float64)
    oracle = jsc.oracle_apply(js, x.astype(np.float64))
    lim = BOUND[GRADES[grade]] * np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= lim
    if grade == "default":
        want = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(x),
                                                 tile_default=32,
                                                 matmul_precision=grade))
        assert np.abs(got - want).max() <= 2 * lim
    jp, tp = _pair(jspec), _pair(tspec)
    pair = tdf.fused_filter_module(tp, grade)
    assert [p.nprod if p.completion is not None else 0
            for p in pair.passes] == [
        p.nprod if p.completion is not None else 0
        for p in mod.stages[1].passes]
    for z in range(2):
        calls = []
        orig_pass, orig = jdf._last_axis_pass_t, jc.completion_pass

        def pass_spy(*a, **k):
            calls.append(0)
            return orig_pass(*a, **k)

        def spy(*a, **k):
            if k.get("rot"):
                calls[-1] = k.get("nprod")
            return orig(*a, **k)

        monkeypatch.setattr(jdf, "_last_axis_pass_t", pass_spy)
        monkeypatch.setattr(jc, "completion_pass", spy)
        xs = mid[z].numpy()
        want = np.asarray(jdf.apply_filter_fused(jp, jnp.asarray(xs),
                                                 tile_default=32,
                                                 matmul_precision=grade))
        monkeypatch.undo()
        assert calls == [p.nprod if p.completion is not None else 0
                         for p in pair.passes]
        assert np.abs(got[z] - want).max() <= 2 * lim
