"""The port's learnable (training) path (``recfilter_tpu_torch.learnable``
and the traced kernels of ``kernels/completion.py``) against the JAX
package's ``recfilter_tpu.learnable``.

Same numpy-seeded inputs through both. The JAX side runs its Pallas kernels
in interpret mode, as its own tests do (``tests/test_learnable.py:323``);
on the CPU the port's traced wrappers run their plain twins. Bounds: the
matrix builders within 1e-6 of the peak of the JAX package's float32
builders (the port builds in float64) and 1e-12 of the port's static f64
``coeffs``; every executor route within 1e-5 of the peak; coefficient
gradients at rtol = atol = 1e-4 of ``jax.grad``; five Adam steps within
1e-4 (relative) of optax's ``adam`` losses. The CUDA kernels themselves are
held to these twins on a card by ``tests/test_torch_cuda.py``.
"""

import contextlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recfilter_tpu import learnable as jl
from recfilter_tpu import scan_core as jsc
from recfilter_tpu.kernels import completion as jc
from recfilter_tpu.spec import Dim as JDim
from recfilter_tpu.spec import FilterSpec as JSpec
from recfilter_tpu.spec import Scan as JScan

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import coeffs as tco
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import learnable as tl
from recfilter_tpu_torch.kernels import completion as tc
from recfilter_tpu_torch.kernels import launch as tlaunch
from recfilter_tpu_torch.spec import Dim, FilterSpec, Scan

CPU = torch.device("cpu")
GAUSS = [float(c) for c in rft.gaussian_weights(5.0, 3)]
BUILDERS = [(1.0, [1.0], 12), (1.2, [0.8, -0.3], 12),
            (0.9, [0.6, 0.25, -0.1], 12), (GAUSS[0], GAUSS[1:], 128)]


def _close(got, want, bound=1e-5):
    """max|got − want| ≤ bound·max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= bound, f"{err:.3e} > {bound:g} of the peak"


def _grads_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=1e-4, atol=1e-4)


def _t64(v):
    return torch.tensor(v, dtype=torch.float64)


def _specs(name, extents, scans, border="zero"):
    """The same filter as a JAX and a port FilterSpec; ``scans`` lists
    (axis, causal, b0, a)."""
    names = "vwzyx"[-len(extents):]
    j = JSpec(name, tuple(JDim(n, e) for n, e in zip(names, extents)),
              tuple(JScan(ax, c, b0, tuple(a)) for ax, c, b0, a in scans),
              border=border)
    t = FilterSpec(name, tuple(Dim(n, e) for n, e in zip(names, extents)),
                   tuple(Scan(ax, c, b0, tuple(a)) for ax, c, b0, a in scans),
                   border=border)
    return j, t


def _scan_params(scans):
    """(causal, b0, a) per scan as JAX arrays and as port tensors."""
    pj = [(c, jnp.asarray(b0, jnp.float32), jnp.asarray(a, jnp.float32))
          for c, b0, a in scans]
    pt = [(c, torch.tensor(b0, dtype=torch.float32),
           torch.tensor(a, dtype=torch.float32)) for c, b0, a in scans]
    return pj, pt


# ---------------------------------------------------------------------------
# the matrix builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("feedfwd,feedback,T", BUILDERS)
@pytest.mark.parametrize("clamp", [False, True])
def test_impulse_matrix_matches_jax_and_static(feedfwd, feedback, T, clamp):
    got = tl.impulse_matrix_t(_t64(feedfwd), _t64(feedback), T, clamp)
    assert got.dtype == torch.float64 and got.shape == (T, T)
    _close(got, tco.impulse_matrix(feedfwd, feedback, T, clamp), 1e-12)
    _close(got, jl.impulse_matrix_jnp(jnp.asarray(feedfwd),
                                      jnp.asarray(feedback), T, clamp), 1e-6)


@pytest.mark.parametrize("feedfwd,feedback,T", BUILDERS)
def test_state_matrix_matches_jax_and_static(feedfwd, feedback, T):
    got = tl.state_matrix_t(_t64(feedback), T)
    assert got.dtype == torch.float64 and got.shape == (T, len(feedback))
    _close(got, tco.state_matrix(feedback, T), 1e-12)
    _close(got, jl.state_matrix_jnp(jnp.asarray(feedback), T), 1e-6)


# ---------------------------------------------------------------------------
# the per-scan path, the FIR taps, the carry solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_apply_scan_matches_jax(causal, border):
    x = np.random.default_rng(0).standard_normal((4, 20)).astype(np.float32)
    want = jax.jit(lambda v: jl.apply_scan_learnable(
        v, 1, causal, jnp.asarray(0.9), jnp.asarray([0.6, 0.25]),
        tile_width=6, border=border))(jnp.asarray(x))
    got = tl.apply_scan_learnable(torch.from_numpy(x), 1, causal,
                                  torch.tensor(0.9), torch.tensor([0.6, 0.25]),
                                  tile_width=6, border=border)
    assert got.dtype == torch.float32
    _close(got, want)
    _close(got, jsc.oracle_apply_scan(x.astype(np.float64), 1, causal, 0.9,
                                      [0.6, 0.25], border))


@pytest.mark.parametrize("causal", [True, False])
def test_fir_apply_matches_jax(causal):
    x = np.random.default_rng(5).standard_normal((3, 12)).astype(np.float32)
    taps = np.asarray([0.8, -0.3, 0.1], np.float32)
    want = jl.fir_apply(jnp.asarray(x), jnp.asarray(taps), causal, 1)
    got = tl.fir_apply(torch.from_numpy(x), torch.from_numpy(taps), causal, 1)
    _close(got, want)


@pytest.mark.parametrize("n", [5, 130])  # dense solve; associative scan
@pytest.mark.parametrize("causal", [True, False])
def test_chain_solve_matches_jax(n, causal):
    rng = np.random.default_rng(n)
    k = 3
    b = rng.standard_normal((6, n, k))
    W = 0.3 * rng.standard_normal((k, k))
    want = jax.jit(lambda b_, W_: jl._chain_solve_learnable(
        b_, W_, k, causal))(jnp.asarray(b, jnp.float32),
                            jnp.asarray(W, jnp.float32))
    got = tl._chain_solve_learnable(torch.from_numpy(b), torch.from_numpy(W),
                                    k, causal)
    assert got.dtype == torch.float64
    _close(got, want)


# ---------------------------------------------------------------------------
# the fused pass: the kernel route and the einsum route
# ---------------------------------------------------------------------------

TWO = [(True, 0.8, [0.5, 0.2]), (False, 0.9, [0.4])]
THREE = [(True, 1.0, [0.5, 0.25]), (False, 1.1, [0.4]),
         (True, 0.9, [0.3, 0.1, -0.05])]


def _spy(monkeypatch, name, calls):
    orig = getattr(tl, name)

    def spy(*a, **kw):
        calls.append(name)
        return orig(*a, **kw)
    monkeypatch.setattr(tl, name, spy)


def test_fused_kernel_route_matches_jax(monkeypatch):
    """48 × 256 at T = 128: the JAX kernel route (Pallas, interpret mode)
    against the port's, which calls both traced wrappers once."""
    x = np.random.default_rng(9).standard_normal((48, 256)).astype(np.float32)
    pj, pt = _scan_params(TWO)
    want = jax.jit(lambda v: jl.fused_dim_learnable(v, pj, 128))(
        jnp.asarray(x))
    calls = []
    _spy(monkeypatch, "tails_traced", calls)
    _spy(monkeypatch, "completion_traced", calls)
    got = tl.fused_dim_learnable(torch.from_numpy(x), pt, 128)
    assert calls == ["tails_traced", "completion_traced"], \
        "kernel route did not engage"
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("w,tile,clamp", [(26, 7, False), (24, 6, True),
                                          (24, 24, True), (256, 64, False)])
def test_fused_einsum_route_matches_jax(w, tile, clamp, monkeypatch):
    """Pad variants, clamp first/last variants, one clamp tile, and the
    plain einsum form (T = 64): no traced kernel."""
    x = np.random.default_rng(w + tile).standard_normal((5, w)
                                                        ).astype(np.float32)
    pj, pt = _scan_params(THREE)
    want = jax.jit(lambda v: jl.fused_dim_learnable(v, pj, tile,
                                                    clamp=clamp))(
        jnp.asarray(x))
    calls = []
    _spy(monkeypatch, "tails_traced", calls)
    got = tl.fused_dim_learnable(torch.from_numpy(x), pt, tile, clamp=clamp)
    assert calls == []
    _close(got, want)
    want64 = x.astype(np.float64)
    for c, b0, a in THREE:
        want64 = jsc.oracle_apply_scan(want64, 1, c, b0, a,
                                       "clamp" if clamp else "zero")
    _close(got, want64)


def test_fused_clamp_nondividing_raises():
    x = np.zeros((4, 23), np.float32)
    pj, pt = _scan_params(TWO)
    with pytest.raises(ValueError):
        jl.fused_dim_learnable(jnp.asarray(x), pj, 4, clamp=True)
    with pytest.raises(ValueError):
        tl.fused_dim_learnable(torch.from_numpy(x), pt, 4, clamp=True)
    assert tdf._plan_tiles(23, 4, 2, True) is None
    assert tdf._plan_tiles(24, 5, 2, True) == (4, 6, 0)


# ---------------------------------------------------------------------------
# the traced kernels' twins against the JAX kernels, and their autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,q", [(2, 37), (6, 8), (8, 20)])
def test_traced_twins_match_jax_kernels(S, q):
    rng = np.random.default_rng(S * 10 + q)
    n, T = 3, 128
    x = rng.standard_normal((q, n, T)).astype(np.float32)
    G = rng.standard_normal((S, T)).astype(np.float32)
    Btot = (0.1 * rng.standard_normal((T, T))).astype(np.float32)
    Rcat = rng.standard_normal((T, S)).astype(np.float32)
    N = np.zeros((n, 8, q), np.float32)
    N[:, :S] = rng.standard_normal((n, S, q))
    got = tc.tails_traced(torch.from_numpy(x), torch.from_numpy(G))
    assert got.shape == (n, 8, q) and not got[:, S:].any()
    _close(got, jc.tails_pass_traced(jnp.asarray(x), jnp.asarray(G),
                                     interpret=True))
    got = tc.completion_traced(*map(torch.from_numpy, (x, Btot, Rcat, N)))
    assert got.shape == x.shape
    _close(got, jc.completion_pass_traced(
        jnp.asarray(x), jnp.asarray(Btot), jnp.asarray(Rcat), jnp.asarray(N),
        interpret=True))


def test_traced_backward_is_the_twins_vjp():
    """The Functions' backward (the twins' einsums at the saved inputs)
    equals autograd through the twins: the maps are bilinear, so the
    matrices get their gradients."""
    rng = np.random.default_rng(4)
    q, n, T, S = 11, 2, 128, 5
    x, G, Btot, Rcat = (torch.from_numpy(rng.standard_normal(s)
                                         .astype(np.float32))
                        for s in ((q, n, T), (S, T), (T, T), (T, S)))
    N = torch.zeros(n, 8, q)
    N[:, :S] = torch.from_numpy(rng.standard_normal((n, S, q))
                                .astype(np.float32))
    for fn, plain, ins in ((tc.tails_traced, tc.tails_traced_plain, [x, G]),
                           (tc.completion_traced, tc.completion_traced_plain,
                            [x, Btot, Rcat, N])):
        ins = [i.clone().requires_grad_() for i in ins]
        out = fn(*ins)
        ct = torch.from_numpy(rng.standard_normal(out.shape)
                              .astype(np.float32))
        got = torch.autograd.grad(out, ins, ct)
        want = torch.autograd.grad(plain(*ins), ins, ct)
        for g, w in zip(got, want):
            _close(g, w)


def test_cpu_tensors_run_the_twins():
    """On the CPU the traced wrappers run their twins and launch nothing;
    the module lives on the device it was given."""
    spec = _specs("L", (16, 256), [(1, True, 0.8, [0.5, 0.2])])[1]
    m = tl.LearnableRecFilter(spec, tile_width=128, device="cpu")
    assert all(p.device == CPU for p in m.parameters())
    tlaunch.reset_launches()
    y = m(np.ones((16, 256), np.float32))
    assert y.device == CPU and y.dtype == torch.float32
    assert not any(tlaunch.LAUNCHES.values())
    assert torch.equal(y, m.forward_plain(np.ones((16, 256), np.float32)))


# ---------------------------------------------------------------------------
# LearnableRecFilter, gradients, training
# ---------------------------------------------------------------------------

FILTERS = {
    "3-D fused, mixed orders": (
        (2, 18, 22), [(2, True, 1.0, (0.5, 0.2)), (2, False, 1.1, (0.4,)),
                      (1, True, 0.9, (0.6,))], "zero", dict(tile_width=6)),
    "per-scan": (
        (2, 18, 22), [(2, True, 1.0, (0.5, 0.2)), (1, False, 0.9, (0.6,))],
        "zero", dict(tile_width=6, fused=False)),
    "clamp 2-D": (
        (18, 24), [(1, True, 1.0, (0.5, 0.2)), (1, False, 1.1, (0.4,)),
                   (0, True, 0.9, (0.6,)), (0, False, 0.9, (0.3, 0.1))],
        "clamp", dict(tile_width=6)),
    "clamp, no dividing tile": (
        (4, 23), [(1, True, 1.0, (0.5, 0.2)), (1, False, 1.1, (0.4,))],
        "clamp", dict(tile_width=4)),
    "numerator taps": (
        (8, 32), [(1, True, 1.0, (0.25,))], "zero",
        dict(tile_width=8, fir_taps=1)),
    "Gaussian on the kernel route": (
        (16, 256), [(1, True, GAUSS[0], GAUSS[1:]),
                    (1, False, GAUSS[0], GAUSS[1:])], "zero",
        dict(tile_width=128)),
}


def _models(label):
    extents, scans, border, kw = FILTERS[label]
    js, ts = _specs(label.replace(" ", ""), extents, scans, border)
    return (jl.LearnableRecFilter(js, **kw),
            tl.LearnableRecFilter(ts, device="cpu", **kw), extents)


def _jax_params(mj, label):
    """The JAX model's start, nudged off the spec so numerator taps and
    every coefficient carry gradient."""
    p = jax.tree_util.tree_map(np.asarray, mj.init_params())
    if "b" in p["scan0"]:
        p["scan0"]["b"] = np.asarray([1.0, -0.6], np.float32)
    return p


@pytest.mark.parametrize("label", list(FILTERS))
def test_learnable_filter_matches_jax(label):
    mj, mt, extents = _models(label)
    x = np.random.default_rng(4).standard_normal(extents).astype(np.float32)
    pj = _jax_params(mj, label)
    want = jax.jit(mj.apply)(jax.tree_util.tree_map(jnp.asarray, pj),
                             jnp.asarray(x))
    got = mt.apply(tl.params_from_jax(pj, device="cpu"), x)
    _close(got.detach(), want)


@pytest.mark.parametrize("label", ["Gaussian on the kernel route",
                                   "clamp 2-D", "numerator taps"])
def test_coefficient_gradients_match_jax_grad(label):
    mj, mt, extents = _models(label)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(extents).astype(np.float32)
    ct = rng.standard_normal(extents).astype(np.float32)
    pj = _jax_params(mj, label)
    gj = jax.jit(jax.grad(lambda p: (mj.apply(p, jnp.asarray(x)) * ct)
                          .sum()))(jax.tree_util.tree_map(jnp.asarray, pj))
    pt = tl.params_from_jax(pj, device="cpu")
    (mt.apply(pt, x) * torch.from_numpy(ct)).sum().backward()
    for name, p in pj.items():
        for key in p:
            _grads_close(pt[name][key].grad, gj[name][key])


def test_adam_steps_match_optax():
    """Five Adam steps (lr 2e-2) from the same perturbed start, the target
    the spec's own filter: torch.optim.Adam against optax.adam."""
    mj, mt, extents = _models("Gaussian on the kernel route")
    x = np.random.default_rng(8).standard_normal(extents).astype(np.float32)
    target_j = jax.jit(mj.apply)(mj.init_params(), jnp.asarray(x))
    target_t = mt(x).detach()
    start = jax.tree_util.tree_map(np.asarray, mj.init_params())
    for p in start.values():
        p["a"] = p["a"] * np.float32(0.9)

    def loss_j(p):
        return ((mj.apply(p, jnp.asarray(x)) - target_j) ** 2).mean()

    opt = optax.adam(2e-2)

    @jax.jit
    def step(p, state):
        loss, g = jax.value_and_grad(loss_j)(p)
        upd, state = opt.update(g, state)
        return optax.apply_updates(p, upd), state, loss

    pj = jax.tree_util.tree_map(jnp.asarray, start)
    state = opt.init(pj)
    losses_j = []
    for _ in range(5):
        pj, state, loss = step(pj, state)
        losses_j.append(float(loss))

    mt.params = tl.params_from_jax(start, device="cpu")
    topt = torch.optim.Adam(mt.parameters(), 2e-2)
    losses_t = []
    for _ in range(5):
        topt.zero_grad()
        loss = ((mt(x) - target_t) ** 2).mean()
        loss.backward()
        topt.step()
        losses_t.append(loss.item())
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]


def test_float64_parameters_hold_px6():
    """The σ=5 Gaussian at 256² (x and y, the kernel route's twins) within
    the px6 bound 2e-6 of the f64 oracle from the float64 parameters; the
    same coefficients rounded to float32 — the JAX package's parameters —
    miss it: the DC gain b0/(1 − Σa), 1 − Σa ≈ 0.0227, amplifies their
    rounding."""
    img = (np.random.default_rng(0).standard_normal((256, 256)) * 0.01
           ).astype(np.float32)
    scans = [(ax, c, GAUSS[0], GAUSS[1:]) for ax in (1, 0)
             for c in (True, False)]
    spec = _specs("G", (256, 256), scans)[1]
    want = rft.oracle_apply(spec, img.astype(np.float64))
    m = tl.LearnableRecFilter(spec, tile_width=128, device="cpu")
    errs = []
    for dtype in (torch.float64, torch.float32):
        params = {k: {n: v.detach().to(dtype) for n, v in p.items()}
                  for k, p in m.params.items()}
        got = m.apply(params, img).numpy()
        errs.append(np.abs(got - want).max() / np.abs(want).max())
    assert errs[0] <= 2e-6 < errs[1], errs


def test_params_from_jax():
    tree = {"scan0": {"b0": np.float32(0.7), "a": np.asarray([0.6, -0.1])},
            "scan1": {"b": np.asarray([1.0, -0.6]), "a": np.asarray([0.25])}}
    p = tl.params_from_jax(tree, device="cpu")
    assert set(p) == {"scan0", "scan1"}
    for name, sub in tree.items():
        assert set(p[name]) == set(sub)
        for key, v in sub.items():
            assert p[name][key].dtype == torch.float64
            assert p[name][key].requires_grad
            np.testing.assert_array_equal(p[name][key].detach().numpy(),
                                          np.asarray(v))
    assert p["scan0"]["b0"].shape == ()


def test_system_id_demo_runs_on_the_cpu(monkeypatch):
    from recfilter_tpu_torch.demos import system_id

    monkeypatch.setattr(sys, "argv", ["system_id", "--samples", "512",
                                      "--steps", "101", "--device", "cpu"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        system_id.main()
    lines = out.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines[:2]] == [["step", "0"],
                                                    ["step", "100"]]
    assert lines[2].startswith("final loss")
    assert lines[3].startswith("true    b0=+0.3000")
    assert lines[4].startswith("learned b0=")
