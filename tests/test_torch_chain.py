"""The port's rotation chain against the JAX package's: the next-pass
tails form of the rotated completion, ``dimfuse.RotationChain`` (2-D, a
leading channel group, volumes, 4-D), ``highest`` on a trailing pair, the
einsum pass on a non-last axis, a gradient, and the B-spline apps.

Same seeded numpy inputs through the JAX package (px6, Pallas interpret
mode, as its own tests run it) and through the port's plain twins on the
CPU. The JAX package's 2-D and volume routes take its 3-touch executor
first; ``_OVERLAP_PX_2D`` is switched off with ``monkeypatch`` where its
chain is the reference, as ``tests/test_dimfuse.py``'s ``old_px_chain``
fixture does. Bounds: against the JAX package 1e-5 of the peak (its px6
products are f32 grade; the port sums its glue in float64), against the
f64 oracle 2e-6 of the peak (the px6 bound of ``tests/test_dimfuse.py``);
the kernel-level twin rtol = 2e-5, atol = 2e-6 of the peak, as the port's
other kernel tests; gradients rtol = atol = 1e-4. The CUDA kernel itself
is held to these twins on a card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import apps as japps
from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import completion as jc

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import apps as tapps
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.kernels import completion as tc

T = 128


def _img(*shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _near(got, want, bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * np.abs(want).max()


def _twin_close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())


def _spec(mod, shape, scans, border="zero", tiles=None):
    names = "vwzyx"[-len(shape):]
    return mod.FilterSpec("C", tuple(mod.Dim(n, e) for n, e in
                                     zip(names, shape)),
                          tuple(mod.Scan(*s) for s in scans), border=border,
                          tile_widths=tiles or (T,) * len(shape))


def _chain(ts, precision="px6"):
    """The port's rotation chain on ``ts``'s scanned (trailing) axes."""
    groups = {ax: [ts.scans[i] for i in ids]
              for ax, ids in ts.scans_by_axis().items()}
    return tdf.RotationChain(groups, [d.extent for d in ts.dims],
                             ts.tile_widths, ts.border, precision)


# ------------------------------------------------------- the next tails

def _stack(kind, rows, cols, n, rng, scale=1.0):
    M = [rng.standard_normal((rows, cols)) * scale for _ in range(3)]
    if kind == "uniform":
        return M[0][None]
    first = M[1] if kind == "clamp" else M[0]
    return np.stack([first] + [M[0]] * (n - 2) + [M[2]])


@pytest.mark.parametrize("ra", [1, 2], ids=["image", "volume"])
@pytest.mark.parametrize("kind,kind2", [("uniform", "uniform"),
                                        ("clamp", "clamp"),
                                        ("pad", "uniform")])
def test_next_tails_twin_matches_jax(ra, kind, kind2):
    """``CompletionPass(rot=True, next_tails=)``'s twin against
    ``completion_pass(next_tails=)``: the rotated output and the next
    pass's tails (n2, 8, n·T·ra) — images (q = n2·128) and volumes
    (q = ra·n2·128), per-tile variants on both sides."""
    n, n2, S, S2 = 4, 3, 6, 5
    rng = np.random.default_rng(ra * 10 + len(kind))
    q = ra * n2 * T
    x = rng.standard_normal((q, n, T)).astype(np.float32)
    Btot = _stack(kind, T, T, n, rng, 0.1)
    Rcat = _stack(kind, T, S, n, rng)
    G2 = _stack(kind2, S2, T, n2, rng, 0.1)
    N = np.zeros((n, 8, q), np.float32)
    N[:, :S] = rng.standard_normal((n, S, q))
    yj, tj = jc.completion_pass(x, Btot, Rcat, N, rot=True, nprod=6,
                                interpret=True, carries_transposed=True,
                                next_tails=(G2, n2, T))
    assert tj is not None and tj.shape == (n2, 8, n * T, ra)
    assert tc.next_tails_ok(q, 8, n2, S2, T)
    mod = tc.CompletionPass(Btot, Rcat, n, rot=True, next_tails=(G2, n2))
    y, t2 = mod(torch.from_numpy(x), torch.from_numpy(N))
    assert y.shape == (n * T, q) and t2.shape == (n2, 8, n * T * ra)
    _twin_close(y.numpy(), np.asarray(yj).reshape(n * T, q))
    _twin_close(t2.numpy(), np.asarray(tj).reshape(n2, 8, -1))
    assert not t2[:, S2:].any()  # pad slots are zeros
    # the twin is the tails module on the emitted output, line for line
    want = tc.TailsPass(G2, n2).plain(y.reshape(-1, n2, T))
    assert torch.equal(t2, want)


def test_next_tails_gate_and_refusals():
    rng = np.random.default_rng(3)
    B, R = _stack("uniform", T, T, 2, rng), _stack("uniform", T, 6, 2, rng)
    G2 = _stack("uniform", 6, T, 2, rng)
    assert tc.next_tails_ok(512, 8, 2, 6, T)
    assert not tc.next_tails_ok(384, 8, 2, 6, T)  # not whole extents
    assert not tc.next_tails_ok(512, 16, 2, 6, T)  # multi-slot pass
    assert not tc.next_tails_ok(512, 8, 2, 9, T)  # multi-slot next pass
    assert not tc.next_tails_ok(512, 8, 2, 6, 64)  # next tiles not 128
    with pytest.raises(ValueError):
        tc.CompletionPass(B, R, 2, rot=False, next_tails=(G2, 2))
    with pytest.raises(ValueError):
        tc.CompletionPass(B, _stack("uniform", T, 12, 2, rng), 2, rot=True,
                          next_tails=(G2, 2))
    mod = tc.CompletionPass(B, R, 2, rot=True, next_tails=(G2, 2))
    with pytest.raises(ValueError):  # on the card: q must be 256·k
        mod._kernel(torch.zeros(300, 2, T), torch.zeros(2, 8, 300))


def test_next_tails_backward_is_the_twins_vjp():
    """The CUDA path's backward (the twin's VJP at zero) carries the
    cotangents of both outputs, as autograd through the twin does."""
    from recfilter_tpu_torch.kernels import launch as tl

    rng = np.random.default_rng(5)
    n, n2 = 2, 2
    mod = tc.CompletionPass(_stack("clamp", T, T, n, rng, 0.1),
                            _stack("clamp", T, 6, n, rng), n, rot=True,
                            next_tails=(_stack("clamp", 6, T, n2, rng), n2))
    q = n2 * T
    ins = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           .requires_grad_() for s in ((q, n, T), (n, 8, q))]
    outs = mod.plain(*ins)
    cts = tuple(torch.from_numpy(rng.standard_normal(o.shape)
                                 .astype(np.float32)) for o in outs)
    want = torch.autograd.grad(outs, ins, cts)
    got = tl._linear_vjp(mod.plain, [i.shape for i in ins],
                         torch.device("cpu"), cts)
    for g, w in zip(got, want):
        _twin_close(g.numpy(), w.numpy())


# ------------------------------------------------------------ the chain

def _count_jax_tails(monkeypatch):
    """Per call of the JAX package's ``_last_axis_pass_t``, the number of
    ``tails_pass`` calls it made."""
    per_pass, cur = [], [0]
    orig_t, orig_p = jc.tails_pass, jdf._last_axis_pass_t

    def tails(*a, **k):
        cur[0] += 1
        return orig_t(*a, **k)

    def one_pass(*a, **k):
        cur[0] = 0
        out = orig_p(*a, **k)
        per_pass.append(cur[0])
        return out

    monkeypatch.setattr(jc, "tails_pass", tails)
    monkeypatch.setattr(jdf, "_last_axis_pass_t", one_pass)
    return per_pass


def _count_port_tails(chain, monkeypatch):
    """Per pass of the port's chain, the ``tails`` module calls it made."""
    counts = {id(p.tails): 0 for p in chain.passes}
    orig = tc.TailsPass.forward

    def fwd(self, x):
        counts[id(self)] = counts.get(id(self), 0) + 1
        return orig(self, x)

    monkeypatch.setattr(tc.TailsPass, "forward", fwd)
    return lambda: [counts[id(p.tails)] for p in chain.passes]


CHAIN = {
    # tests/test_dimfuse.py::test_px_tails_chaining_two_dims
    "2d-zero": ((256, 384), [(1, True, 0.9, (0.6, 0.2)),
                             (0, False, 1.05, (0.4, 0.15))], "zero"),
    "2d-clamp": ((256, 384), [(1, True, 0.9, (0.6, 0.2)),
                              (0, False, 1.05, (0.4, 0.15))], "clamp"),
    # ...::test_px_tails_chaining_leading_channel: P = 3, per slice
    "rgb-zero": ((3, 256, 384), [(2, True, 0.9, (0.6, 0.2)),
                                 (1, False, 1.05, (0.4, 0.15))], "zero"),
    "rgb-clamp": ((3, 256, 384), [(2, True, 0.9, (0.6, 0.2)),
                                  (1, False, 1.05, (0.4, 0.15))], "clamp"),
    # ...::test_px_tails_chaining_volume: x → y in the volume regime
    "volume": ((128, 256, 128), [(2, True, 1.0, (0.5,)),
                                 (1, True, 0.9, (0.4, 0.1)),
                                 (0, False, 1.05, (0.3,))], "zero"),
    # 4-D: x → y chained (ra = 32), z and t on the einsum form
    "4-d": ((4, 8, 128, 128), [(3, True, 0.9, (0.5,)),
                               (2, False, 1.0, (0.4, 0.1)),
                               (1, True, 1.0, (0.3,)),
                               (0, False, 0.8, (0.5,))], "clamp"),
}


@pytest.mark.parametrize("case", list(CHAIN))
def test_rotation_chain_matches_jax(case, monkeypatch):
    """The port's chain against the JAX package's (its 3-touch executor
    off): the same passes, the same tails reads per pass (both chaining
    gates agree on these shapes), within 1e-5 of the JAX package and
    2e-6 of the f64 oracle; chained equals unchained within the bound."""
    shape, scans, border = CHAIN[case]
    ts, js = (_spec(m, shape, scans, border) for m in (tspec, jspec))
    x = _img(*shape, seed=len(case) + len(shape))
    chain = _chain(ts)
    per_pass = _count_jax_tails(monkeypatch)
    monkeypatch.setattr(jdf, "_OVERLAP_PX_2D", False)
    want = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(x),
                                             matmul_precision="px6"))
    port_reads = _count_port_tails(chain, monkeypatch)
    got = chain(torch.from_numpy(x)).numpy()
    reads = port_reads()
    assert len(per_pass) == len(chain.passes)
    assert [r > 0 for r in reads] == [r > 0 for r in per_pass]
    assert sum(chain.tails_in_taken) >= 1
    assert [not t for t in chain.tails_in_taken[1:]] == [
        r > 0 or p.tails is None for r, p in zip(reads[1:],
                                                 chain.passes[1:])]
    oracle = jsc.oracle_apply(js, x.astype(np.float64))
    _near(got, want, 1e-5)
    _near(got, oracle, 2e-6)
    for p in chain.passes:  # unchained: every pass reads its own tails
        p.completion_nt = None
    _near(chain(torch.from_numpy(x)).numpy(), got, 2e-6)
    assert not any(chain.tails_in_taken)


def test_router_takes_the_chain_where_the_jax_package_does(monkeypatch):
    """Through ``fused_filter_module``: a clamp image that is not a
    multiple of 128 takes the chain (spied on the JAX side), with the JAX
    package's tails reads. (Volumes whose depth the rows gates decline:
    ``tests/test_torch_rows.py``'s converted refusal cases.)"""
    cases = [((200, 384), [(1, True, 0.9, (0.6, 0.2)),
                           (0, False, 1.05, (0.4, 0.15))], "clamp")]
    for shape, scans, border in cases:
        ts, js = (_spec(m, shape, scans, border) for m in (tspec, jspec))
        x = _img(*shape, seed=len(shape))
        mod = tdf.fused_filter_module(ts)
        assert isinstance(mod, tdf.RotationChain)
        per_pass = _count_jax_tails(monkeypatch)
        want = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(x),
                                                 matmul_precision="px6"))
        reads = _count_port_tails(mod, monkeypatch)
        got = mod(torch.from_numpy(x)).numpy()
        assert [r > 0 for r in reads()] == [r > 0 for r in per_pass]
        _near(got, want, 1e-5)
        _near(got, jsc.oracle_apply(js, x.astype(np.float64)), 2e-6)


def test_chaining_gates_disagree(monkeypatch):
    """A 5 × 640 × 128 volume: x's 3,200 lines hold five whole extents of
    y (640 = 5 tiles), so the port's gate chains; the JAX package's gate
    declines (its TPU line block, 1,664 lines, does not tile 3,200), and
    it reads y's tails with ``tails_pass`` instead. The values agree to
    summation order."""
    shape = (5, 640, 128)
    scans = [(2, True, 1.0, (0.5,)), (1, False, 0.9, (0.4, 0.1)),
             (0, True, 1.05, (0.3,))]
    ts, js = (_spec(m, shape, scans) for m in (tspec, jspec))
    q = shape[0] * shape[1]
    Lb, qp = jc._block_geom(q, T, 6, 0)
    assert jc._tails_gate(True, q, qp, Lb, (np.zeros((1, 3, T)), 5, T)) == (
        0, 0)
    assert tc.next_tails_ok(q, 8, 5, 3, T)
    x = _img(*shape, seed=9)
    mod = tdf.fused_filter_module(ts)
    assert isinstance(mod, tdf.RotationChain)
    per_pass = _count_jax_tails(monkeypatch)
    want = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(x),
                                             matmul_precision="px6"))
    reads = _count_port_tails(mod, monkeypatch)
    got = mod(torch.from_numpy(x)).numpy()
    assert per_pass == [1, 1, 0] and reads() == [1, 0, 0]
    assert mod.tails_in_taken == [False, True, False]
    _near(got, want, 1e-5)
    _near(got, jsc.oracle_apply(js, x.astype(np.float64)), 2e-6)


def test_highest_on_a_trailing_pair_is_the_einsum_chain():
    """At ``highest`` both packages run the chain's einsum passes (the
    JAX package's nprod = 0 skips its 3-touch executor): no kernel module
    is built, no tails chain, within the bounds."""
    scans = [(1, True, 0.9, (0.6, 0.2)), (1, False, 0.8, (0.3,)),
             (0, False, 1.05, (0.4, 0.15))]
    ts, js = (_spec(m, (256, 200), scans, "clamp") for m in (tspec, jspec))
    mod = tdf.fused_filter_module(ts, "highest")
    assert isinstance(mod, tdf.RotationChain)
    assert all(p.tails is None and p.completion is None for p in mod.passes)
    x = _img(256, 200, seed=3)
    got = mod(torch.from_numpy(x)).numpy()
    assert not any(mod.tails_in_taken)
    want = jdf.apply_filter_fused(js, jnp.asarray(x),
                                  matmul_precision="highest")
    _near(got, want, 1e-5)
    _near(got, jsc.oracle_apply(js, x.astype(np.float64)), 2e-6)


@pytest.mark.parametrize("shape,axis,precision", [
    ((2, 200, 128), 1, "px6"),      # per leading slice, pad 56
    ((200, 3, 128), 0, "px6"),      # the kernel route, rot_axes = 3
    ((2, 200, 128), 1, "highest"),  # the einsum form
    ((40000, 2), 0, "px6"),         # 313 tiles: the hierarchy, moved
], ids=["slices", "rot3", "highest", "hierarchy"])
def test_einsum_pass_on_a_non_last_axis(shape, axis, precision):
    """``fused_dim_pass`` on a non-last axis against the JAX package's
    (the axis moved last, a rotated pass moving it back)."""
    x = _img(*shape, seed=sum(shape))
    scans = [(axis, True, 0.9, (0.5, -0.1)), (axis, False, 1.1, (0.4,))]
    js, ts = ([m.Scan(*s) for s in scans] for m in (jspec, tspec))
    got = tdf.fused_dim_pass(torch.from_numpy(x), axis, ts, 128, "zero",
                             precision).numpy()
    want = jdf.fused_dim_pass(jnp.asarray(x), axis, js, 128, "zero",
                              matmul_precision=precision)
    _near(got, want, 1e-5)
    spec = _spec(jspec, shape, scans)
    _near(got, jsc.oracle_apply(spec, x.astype(np.float64)), 2e-6)
    mod = tdf.FusedAxisPass(ts, axis, shape, 128, "zero", precision)
    assert isinstance(mod.body, tdf.HierarchicalPass) == (shape[0] == 40000)


def test_chain_gradient_matches_jax(monkeypatch):
    """torch.autograd through the chained twins (the next-pass tails
    carry the gradient into the first pass) against jax.grad through the
    JAX package's chain, for sum(y²)."""
    shape, scans, border = CHAIN["2d-clamp"]
    ts, js = (_spec(m, shape, scans, border) for m in (tspec, jspec))
    x = _img(*shape, seed=11)
    monkeypatch.setattr(jdf, "_OVERLAP_PX_2D", False)
    g_jax = np.asarray(jax.grad(lambda v: jnp.sum(jdf.apply_filter_fused(
        js, v, matmul_precision="px6") ** 2))(jnp.asarray(x)))
    chain = _chain(ts)
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad((chain(xt) ** 2).sum(), xt)
    assert chain.tails_in_taken == [False, True]
    np.testing.assert_allclose(g.numpy(), g_jax, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("which", ["bicubic", "biquintic_overlapped",
                                   "biquintic_cascaded"])
def test_bspline_apps_match_jax_and_the_oracle(which):
    """The B-spline prefilters at 384 × 200 (clamp; 200 rows take 100-row
    tiles): the overlapped filters on the rotation chain, the cascade's
    stages on the last-axis executor and the einsum pass on y."""
    w, h = 384, 200
    img = _img(h, w, seed=21, scale=1.0)
    build_t, build_j = getattr(tapps, which), getattr(japps, which)
    if which == "biquintic_cascaded":
        got = tapps.run_cascade(build_t(w, h, 128), img, device="cpu")
        want = img
        for f in build_j(w, h, 128):
            want = f.realize(jnp.asarray(want))
        spec = japps.biquintic_overlapped(w, h, 128).spec
    else:
        F = build_t(w, h)  # the default tile: 128
        assert isinstance(F.as_func(device="cpu"), tdf.RotationChain)
        got = F.realize(img, device="cpu")
        Fj = build_j(w, h, 128)
        want, spec = Fj.realize(jnp.asarray(img)), Fj.spec
    _near(got.numpy(), np.asarray(want), 1e-5)
    _near(got.numpy(), jsc.oracle_apply(spec, img.astype(np.float64)),
          2e-6)


def test_bspline_builders_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal applies without it")
    for F in (tapps.bicubic(256, 200), tapps.biquintic_overlapped(256, 200)):
        with pytest.raises(RuntimeError, match="cuda"):
            F.as_func()
    assert len(tapps.biquintic_cascaded(256, 200)) == 2
    assert rft.apps.bicubic is tapps.bicubic
