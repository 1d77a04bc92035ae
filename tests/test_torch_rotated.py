"""The rotated emit and its fused consumers against the JAX package.

Same numpy inputs through ``recfilter_tpu`` (px6, Pallas interpret mode on
the CPU, as its own tests run) and ``recfilter_tpu_torch`` (the plain twins
on the CPU): ``TailsPass(extra_rows)`` and ``CompletionPass(rot=True,
stencil)`` against ``tails_pass``/``completion_pass``; ``RotatedPass``
(``apply_filter_rotated``, ``Plan.rotate_emit``) at ``rot_axes`` 1 and 2,
zero and clamp, the stencil's start/end grid, with an epilogue, and the
per-slice branch; the box ×2/×3/×6 SAT apps and the DoG SAT app.

Bounds (each test states its own):
  * kernel-level twins against the JAX kernels: 1e-5 of the peak (fp32
    sums in another order; the JAX px6 split products are f32 grade);
  * the fused stencil against its global-shift fallback: 2e-6 of the peak
    (``tests/test_dimfuse.py:962``);
  * the port against the JAX executor: 2e-5 of the producer's peak — the
    differencing consumer cancels the integrator's magnitude, so f32
    error scales with the producer (``tests/test_dimfuse.py:988``);
  * the SAT apps: the JAX apps within 1e-3 of the peak, the box SATs
    against the FIR variant at rtol = 1e-3, atol = 1e-4
    (``tests/test_fir.py:112``), the DoG against the six-stage f64 oracle
    at 1e-2 of the peak (``tests/test_apps.py:314``);
  * gradients of the integrator pipelines against an f64 autograd oracle
    of the same linear map: 1e-3 of its peak — the adjoint of a 2nd-order
    integral amplifies f32 rounding (the JAX package's own gradients sit
    6.4e-4 of the peak from that oracle on the per-slice case, the port's
    3.3e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import spec as jspec
from recfilter_tpu.apps import box as jbox
from recfilter_tpu.apps import dog as jdog
from recfilter_tpu.kernels import completion as jc

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.apps import box as tbox
from recfilter_tpu_torch.apps import dog as tdog
from recfilter_tpu_torch.kernels import completion as tc

T = 128
GRID = [("zero", "clamp"), ("clamp", "zero"), ("zero", "zero"),
        ("clamp", "clamp")]
TAPS = [(10, 0.25), (-1, -2.0), (-12, 1.0)]


def _img(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _peak_near(got, want, bound, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    assert np.abs(got - want).max() <= bound * scale


def _spec(mod, dims, scans, tiles, border="zero", dtype="float32"):
    return mod.FilterSpec("ST", tuple(mod.Dim(n, e) for n, e in dims),
                          tuple(mod.Scan(*s) for s in scans), border=border,
                          dtype=dtype, tile_widths=tiles)


def _mats(scans, n, clamp=False):
    ts = [tspec.Scan(*s) for s in scans]
    m = tdf.prepare_dim_pass(ts, T, n, clamp)
    cat = lambda ms, ax: np.concatenate([np.asarray(a) for a in ms], axis=ax)
    return m, cat(m.G, 1), cat(m.Rhat, 2)


INTEGRATOR = [(1, True, 1.0, (2.0, -1.0))]  # the 2nd-order integral


# --------------------------------------------------------------- kernels


@pytest.mark.parametrize("clamp", [False, True])
def test_tails_extra_rows_match_jax(clamp):
    """TailsPass(extra_rows) against tails_pass(extra_rows): the slot rows
    and the He halo base rows, 1e-5 of the peak."""
    n, q = 3, 40
    m, Gcat, _ = _mats([(1, True, 0.8, (0.3, 0.1)),
                        (1, False, 0.9, (0.2,))], n, clamp)
    E = tdf._stencil_extra_rows(m, TAPS, T)
    x = _img(q, n, T, seed=1)
    got = tc.TailsPass(Gcat, n, extra_rows=E)(torch.from_numpy(x)).numpy()
    want = np.asarray(jc.tails_pass(jnp.asarray(x), Gcat, nprod=6,
                                    interpret=True, extra_rows=E))
    assert got.shape == (n, 8 + E.shape[1], q)
    _peak_near(got, want[:, :got.shape[1]], 1e-5)


@pytest.mark.parametrize("start,end", GRID)
@pytest.mark.parametrize("taps", [TAPS, [(3, 1.0), (0, -0.5)]])
def test_completion_rot_stencil_matches_jax(start, end, taps):
    """CompletionPass(rot=True, stencil) against completion_pass(rot=True,
    stencil) on the same halo strips, 1e-5 of the peak; the per-tile
    twin on the strips (:func:`_stencil_rows`, what the kernel computes)
    equals the global-shift twin."""
    n, q = 3, 24
    m, _, Rcat = _mats(INTEGRATOR, n)
    x, N = _img(q, n, T, seed=2), _img(n, 8, q, seed=3)
    N[:, 2:] = 0.0
    st = {"taps": taps, "start": start, "end": end}
    flat = tc.CompletionPass(m.Btot, Rcat, n, rot=True)
    comp = tc.CompletionPass(m.Btot, Rcat, n, rot=True, stencil=st)
    xt, Nt = torch.from_numpy(x), torch.from_numpy(N)
    yf = flat(xt, Nt)
    hp, hn = comp.hp, comp.hn
    Y = yf.reshape(n, T, q)
    prev = torch.cat([torch.zeros(1, hp, q), Y[:-1, T - hp:]])
    nxt = torch.cat([Y[1:, :hn], torch.zeros(1, hn, q)])
    halos = [h for h, r in ((prev, hp), (nxt, hn)) if r]
    got = comp(xt, Nt, *halos)
    rows = tc._stencil_rows(yf, prev, nxt, taps, n, start, end)
    _peak_near(rows, got, 1e-6)
    # the JAX kernel's strips: 8-row quanta, top-/bottom-aligned
    jp = jn = None
    if hp:
        jp = np.zeros((n, -(-hp // 8) * 8, q), np.float32)
        jp[:, jp.shape[1] - hp:] = prev.numpy()
    if hn:
        jn = np.zeros((n, -(-hn // 8) * 8, q), np.float32)
        jn[:, :hn] = nxt.numpy()
    want = jc.completion_pass(
        jnp.asarray(x), m.Btot, Rcat, jnp.asarray(N), rot=True, nprod=6,
        interpret=True, carries_transposed=True,
        stencil=dict(taps=taps, prev=None if jp is None else jnp.asarray(jp),
                     nxt=None if jn is None else jnp.asarray(jn),
                     start=start, end=end))
    _peak_near(got.numpy(), np.asarray(want).reshape(n * T, q), 1e-5)


def test_completion_rot_end_defaults_to_zero():
    """``completion_pass`` defaults a stencil's border modes to "zero";
    the rotated pass's stencil ``end`` defaults to "clamp"."""
    m, _, Rcat = _mats(INTEGRATOR, 2)
    comp = tc.CompletionPass(m.Btot, Rcat, 2, rot=True,
                             stencil={"taps": TAPS})
    assert (comp.start, comp.end) == ("zero", "zero")
    spec = _spec(tspec, [("y", 16), ("x", 256)], INTEGRATOR, (0, T))
    body = tdf.RotatedPass(spec, 2, stencil={"taps": TAPS}).body
    assert body.st_comp[0].end == "clamp"


# ------------------------------------------------------ apply_filter_rotated


def _rotated_pair(dims, scans, tiles, border="zero", **kw):
    ts = _spec(tspec, dims, scans, tiles, border)
    js = _spec(jspec, dims, scans, tiles, border)
    return ts, js


@pytest.mark.parametrize("start,end", GRID)
@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_rotated_stencil_matches_fallback_and_jax(start, end, border):
    """The fused stencil route (rot_axes = 2: tails with extra rows, f64
    halo strips, the rotated completion) against the plain pass then the
    global-shift stencil (2e-6 of the peak) and against the JAX package
    (2e-5 of the producer's peak); the halo strips the route completes
    equal the plain output's rows."""
    ts, js = _rotated_pair([("y", 64), ("x", 256)], INTEGRATOR, (0, T),
                           border)
    x = _img(64, 256, seed=40) * 0.01
    st = {"taps": TAPS, "start": start, "end": end}
    mod = tdf.RotatedPass(ts, 2, stencil=st)
    assert mod.body.st_comp is not None  # the fused route
    seen = []
    orig = tdf._stencil_halo

    def spy(*a):
        seen.append(orig(*a))
        return seen[-1]

    tdf._stencil_halo = spy
    try:
        got = mod(torch.from_numpy(x))
    finally:
        tdf._stencil_halo = orig
    assert len(seen) == 1 and got.shape == (256, 64)
    plain = tdf.RotatedPass(ts, 2)(torch.from_numpy(x))
    want = tdf.apply_stencil(plain, -2, TAPS, start, end)
    _peak_near(got, want, 2e-6)
    prev, nxt = seen[0]
    Y = plain.reshape(2, T, 64)
    _peak_near(prev[1], Y[0, T - 12:], 1e-6, np.abs(plain.numpy()).max())
    _peak_near(nxt[0], Y[1, :10], 1e-6, np.abs(plain.numpy()).max())
    jout = np.asarray(jdf.apply_filter_rotated(
        js, jnp.asarray(x), rot_axes=2, matmul_precision="px6", stencil=st))
    _peak_near(got, jout, 2e-5, np.abs(plain.numpy()).max())


@pytest.mark.parametrize("rot_axes,shape", [(1, (3, 200)), (1, (1000,)),
                                            (2, (40, 200)),
                                            (3, (2, 24, 256))])
@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_rotated_pass_matches_jax(rot_axes, shape, border):
    """RotatedPass without consumers against apply_filter_rotated: in
    place, rotated by two and by three (padded and clamp tile plans),
    and a bare signal; 2e-5 of the peak."""
    names = "zyx"[-len(shape):] if len(shape) > 1 else "x"
    dims = list(zip(names, shape))
    w3 = tuple(rft.gaussian_weights(3.0, 3))
    scans = [(len(shape) - 1, True, w3[0], w3[1:]),
             (len(shape) - 1, False, w3[0], w3[1:])]
    tiles = (0,) * (len(shape) - 1) + (T,)
    ts, js = _rotated_pair(dims, scans, tiles, border)
    x = _img(*shape, seed=len(shape))
    got = tdf.apply_filter_rotated(ts, torch.from_numpy(x), rot_axes)
    want = jdf.apply_filter_rotated(js, jnp.asarray(x), rot_axes=rot_axes,
                                    matmul_precision="px6")
    _peak_near(got, np.asarray(want), 2e-5)


@pytest.mark.parametrize("stencil", [None, {"taps": TAPS}])
@pytest.mark.parametrize("shape", [(48, 256), (48, 300)])
def test_rotated_epilogue_matches_jax(stencil, shape):
    """An epilogue reading the stencil's output (or the filter's), its aux
    array in the ROTATED layout: fused route, padded plan (the stencil's
    fallback with the epilogue deferred past it). Against the f64 oracle
    of the same composite, 2e-5 of the producer's peak; against the JAX
    package, 1e-4 of it — its px6 pass with a padded last tile sits
    6.4e-5 of the peak from the oracle on this 2nd-order integral (the
    port's 4.6e-6)."""
    ts, js = _rotated_pair([("y", shape[0]), ("x", shape[1])], INTEGRATOR,
                           (0, T))
    x = _img(*shape, seed=5) * 0.01
    aux = _img(shape[1], shape[0], seed=6)
    epi = lambda o, a: 2.0 * a - o  # noqa: E731
    got = tdf.apply_filter_rotated(ts, torch.from_numpy(x), 2, epilogue=epi,
                                   eaux=(torch.from_numpy(aux),),
                                   stencil=stencil)
    want = jdf.apply_filter_rotated(js, jnp.asarray(x), rot_axes=2,
                                    matmul_precision="px6", epilogue=epi,
                                    eaux=(jnp.asarray(aux),),
                                    stencil=stencil)
    z = torch.from_numpy(rft.oracle_apply(ts, x.astype(np.float64)).T.copy())
    if stencil is not None:
        z_st = tdf.apply_stencil(z, -2, TAPS, "zero", "clamp")
    oracle = epi(z if stencil is None else z_st,
                 torch.from_numpy(aux.astype(np.float64)))
    zscale = float(z.abs().max())
    _peak_near(got, oracle, 2e-5, zscale)
    _peak_near(got, np.asarray(want), 1e-4, zscale)


def test_rotated_per_slice_stencil_and_gradient():
    """Per-slice taps over a leading channel axis (the DoG dual radius)
    through the per-slice branch: against the per-slice global-shift
    fallback at 2e-5 of the producer's peak, against the JAX package
    likewise; the gradient of (y·ct).sum() against JAX's (1e-4 of its
    peak). The strips get zero gradients, the twin carries the whole
    consumer."""
    dims = [("c", 2), ("y", 48), ("x", 256)]
    ts, js = _rotated_pair(dims, [(2, True, 1.0, (2.0, -1.0))], (0, 0, T))
    x = _img(2, 48, 256, seed=41) * 0.01
    taps = [[(6, 1.0), (-1, -2.0), (-8, 1.0)],
            [(10, 1.0), (-1, -2.0), (-12, 1.0)]]
    st = {"taps": taps, "start": "zero", "end": "clamp"}
    mod = tdf.RotatedPass(ts, 2, stencil=st)
    assert len(mod.body.st_comp) == 2
    xt = torch.from_numpy(x).requires_grad_()
    got = mod(xt)
    plain = tdf.RotatedPass(ts, 2)(torch.from_numpy(x)).detach()
    want = torch.stack([tdf.apply_stencil(plain[p], -2, taps[p], "zero",
                                          "clamp") for p in range(2)])
    zscale = np.abs(plain.numpy()).max()
    _peak_near(got.detach(), want, 2e-5, zscale)
    run = lambda v: jdf.apply_filter_rotated(  # noqa: E731
        js, v, rot_axes=2, matmul_precision="px6", stencil=st)
    _peak_near(got.detach(), np.asarray(run(jnp.asarray(x))), 2e-5, zscale)
    ct = torch.from_numpy(_img(2, 256, 48, seed=42))
    (g,) = torch.autograd.grad(got, xt, ct)
    xd = torch.from_numpy(x.astype(np.float64)).requires_grad_()
    z = xd.cumsum(-1).cumsum(-1).transpose(-1, -2)
    yd = torch.stack([tdf.apply_stencil(z[p], -2, taps[p], "zero", "clamp")
                      for p in range(2)])
    (gref,) = torch.autograd.grad(yd, xd, ct.double())
    _peak_near(g, gref, 1e-3)
    jg = jax.grad(lambda v: (run(v) * ct.numpy()).sum())(jnp.asarray(x))
    _peak_near(np.asarray(jg), gref, 1e-3)


def test_rotated_integer_and_bare_signal_routes():
    """An int32 filter runs the unit scans then the explicit move (and the
    stencil as shifts), as the JAX package does; a bare 1-D signal takes
    the one-axis executor, then the stencil."""
    ts, js = _rotated_pair([("y", 32), ("x", 256)], [(1, True, 1.0, (1.0,))],
                           (0, T))
    ts = tspec.FilterSpec("I", ts.dims, ts.scans, dtype="int32",
                          tile_widths=ts.tile_widths)
    js = jspec.FilterSpec("I", js.dims, js.scans, dtype="int32",
                          tile_widths=js.tile_widths)
    x = np.random.default_rng(7).integers(-99, 99, (32, 256)).astype(np.int32)
    st = {"taps": [(2, 1.0), (-3, -1.0)]}
    got = tdf.apply_filter_rotated(ts, torch.from_numpy(x), 2, stencil=st)
    want = jdf.apply_filter_rotated(js, jnp.asarray(x), rot_axes=2,
                                    stencil=st)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the bare signal against the f64 oracle, 2e-5 of the producer's peak
    # (the JAX package's einsum route with fp32 glue sits 2e-3 of it away
    # on this 2nd-order integral of 5000 samples: ROADMAP Queue 3)
    sig = _spec(tspec, [("x", 5000)], [(0, True, 1.0, (2.0, -1.0))], (T,))
    s = _img(5000, seed=8) * 0.01
    got = tdf.apply_filter_rotated(sig, torch.from_numpy(s), 1, stencil=st)
    z = torch.from_numpy(rft.oracle_apply(sig, s.astype(np.float64)))
    want = tdf.apply_stencil(z, -1, st["taps"], "zero", "clamp")
    _peak_near(got, want, 2e-5, float(z.abs().max()))


def test_rotated_pass_refuses_as_the_jax_package():
    """Two scanned dimensions, an out-of-range rot_axes and a wrong extent
    raise ValueError. A plan the tiles cannot take (a
    1-sample signal under an order-2 scan), which the port refused before
    the sequential core, runs the core as the JAX package's
    ``apply_filter_rotated`` does: equal to it and to the oracle. A
    non-unit integer scan, which the port refused before, runs the
    sequential core as the JAX package does, bit-equal to it."""
    two = _spec(tspec, [("y", 256), ("x", 256)],
                [(0, True, 1.0, (0.5,)), (1, True, 1.0, (0.5,))], (T, T))
    with pytest.raises(ValueError):
        tdf.RotatedPass(two, 2)
    one = _spec(tspec, [("y", 8), ("x", 256)], INTEGRATOR, (0, T))
    with pytest.raises(ValueError):
        tdf.RotatedPass(one, 3)(torch.zeros(8, 256))
    with pytest.raises(ValueError):
        tdf.RotatedPass(one, 2)(torch.zeros(8, 255))
    tiny = _spec(tspec, [("x", 1)], [(0, True, 1.0, (0.5, 0.1))], (T,))
    jtiny = _spec(jspec, [("x", 1)], [(0, True, 1.0, (0.5, 0.1))], (T,))
    one_sample = np.array([0.75], np.float32)
    got = tdf.RotatedPass(tiny, 1)(torch.from_numpy(one_sample)).numpy()
    np.testing.assert_allclose(got, np.asarray(jdf.apply_filter_rotated(
        jtiny, jnp.asarray(one_sample), 1)), rtol=1e-6)
    np.testing.assert_allclose(got, rft.oracle_apply(tiny, one_sample),
                               rtol=1e-6)
    nonunit = tspec.FilterSpec("I", one.dims, (tspec.Scan(1, True, 1.0,
                                                          (2.0,)),),
                               dtype="int32", tile_widths=(0, T))
    jnonunit = jspec.FilterSpec("I", one.dims, (jspec.Scan(1, True, 1.0,
                                                           (2.0,)),),
                                dtype="int32", tile_widths=(0, T))
    xi = np.random.default_rng(9).integers(-99, 99, (8, 256)).astype(
        np.int32)
    got = tdf.RotatedPass(nonunit, 2)(torch.from_numpy(xi)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdf.apply_filter_rotated(
        jnonunit, jnp.asarray(xi), 2)))
    np.testing.assert_array_equal(got, rft.oracle_apply(nonunit, xi).T)


def test_api_routes_the_consumers_as_the_jax_package():
    """``as_func`` with ``Plan.rotate_emit`` builds the rotated executor;
    its ValueErrors are the JAX package's (``api.py:353-361, 423-426``)."""
    F = rft.RecFilter("R")
    x, y = rft.Dim("x", 256), rft.Dim("y", 64)
    F[y, x] = _img(64, 256)
    F.add_filter(+x, [1.0, 2.0, -1.0])
    F.split(x, T)
    with pytest.raises(ValueError, match="rotate_emit"):
        F.as_func(stencil={"taps": TAPS}, device="cpu")
    with pytest.raises(ValueError, match="exclusive"):
        F.as_func(epilogue=lambda o: o, stencil2d=[[(0, 0, 1.0)]],
                  device="cpu")
    F.set_plan(rotate_emit=2)
    assert F.plan.rotate_emit == 2
    with pytest.raises(ValueError, match="rotate_emit"):
        F.as_func(stencil2d=[[(0, 0, 1.0)]], device="cpu")
    mod = F.as_func(stencil={"taps": TAPS}, device="cpu")
    assert isinstance(mod, tdf.RotatedPass)
    out = F.realize(device="cpu")
    assert tuple(out.shape) == (256, 64)
    with pytest.raises(ValueError):
        F.set_plan(rotate_emit=-1)


# ------------------------------------------------------------------- apps


W = 256


def _margined(seed, margin, zero_mean=False, w=W):
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((w, w)) if zero_mean
           else rng.random((w, w))).astype(np.float32)
    img[:margin] = img[-margin:] = 0
    img[:, :margin] = img[:, -margin:] = 0
    return img


@pytest.mark.parametrize("which", ["order2", "box3", "box6"])
def test_box_sat_apps_match_jax_and_fir(which):
    """box ×2/×3/×6 in SAT form against the JAX apps (1e-3 of the peak)
    and, where the zeroed margin defines the result (short of the far
    margin, where the clamped 2nd-order integrals are the reference's own
    semantics), against the n-fold box oracle at rtol = 1e-3, atol = 1e-4
    (``tests/test_fir.py:112``), at 128² with zero-mean input as that
    test's small image: f32 2nd-order integrals cancel digits as they
    grow (a [0, 1) image at 256² misses the bound by 5×)."""
    B, w = 3, 128
    it = {"order2": 2, "box3": 3, "box6": 6}[which]
    pad = it * (B + 1) + 1
    img = _margined(it, pad, zero_mean=True, w=w)
    if which == "order2":
        mod = tbox.box_filter_order_2(w, w, B, T, device="cpu")[0]
        jfn = jbox.box_filter_order_2(w, w, B, T)[0]
    elif which == "box3":
        mod = tbox.box_filter_3(w, w, B, T, variant="sat", device="cpu")
        jfn = jbox.box_filter_3(w, w, B, T, variant="sat")
    else:
        mod = tbox.box_filter_6(w, w, B, T, variant="sat", device="cpu")
        jfn = jbox.box_filter_6(w, w, B, T, variant="sat")
    got = mod(torch.from_numpy(img)).numpy()
    _peak_near(got, np.asarray(jfn(jnp.asarray(img))), 1e-3)
    v = slice(0, w - pad)
    np.testing.assert_allclose(got[v, v], tbox.box_oracle(img, B, it)[v, v],
                               rtol=1e-3, atol=1e-4)


def _dog_oracle(img, B1, B2):
    """The six-stage SAT pipeline untiled in float64 (``tests/
    test_apps.py``'s oracle), in torch so that it also differentiates:
    cumsum integrals and shifts — clamped past the far edge, zero before
    the start, the apps' own rule (on a zeroed margin the test's clamp at
    the start gives the same values, but not the same gradient)."""
    def shift(f, off, ax):
        idx = torch.arange(f.shape[ax]).add(off)
        g = f.index_select(ax, idx.clamp(0, f.shape[ax] - 1))
        keep = (idx >= 0).to(f.dtype)
        return g * (keep[:, None] if ax == 0 else keep)

    def diff_xy(f, B):
        g = shift(f, B, 0) - shift(f, -B - 1, 0)
        return (shift(g, B, 1) - shift(g, -B - 1, 1)) / (2 * B + 1) ** 2

    def ddiff(f, B, ax):
        n = float(2 * B + 1)
        return (shift(f, 2 * B, ax) - 2.0 * shift(f, -1, ax)
                + shift(f, -2 * B - 2, ax)) / (n * n)

    s = img.cumsum(1).cumsum(0)
    g = []
    for B in (B1, B2):
        b2 = ddiff(diff_xy(s, B).cumsum(1).cumsum(1), B, 1)
        g.append(ddiff(b2.cumsum(0).cumsum(0), B, 0))
    return g[0] - g[1]


def test_dog_sat_app_matches_jax_and_the_oracle():
    """The DoG SAT pipeline (the stencil2d-fused SAT, four rotated
    stencil passes, the subtraction as an epilogue) against the JAX app
    (1e-3 of the peak) and the f64 six-stage oracle (1e-2 of the peak,
    ``tests/test_apps.py:314``); its gradient against the oracle's
    (1e-3 of the peak)."""
    B1, B2 = 5, 9
    img = _margined(23, 2 * (B2 + 1) + 1)
    mod = tdog.difference_of_gaussians(W, W, B1, B2, T, variant="sat",
                                       device="cpu")
    xt = torch.from_numpy(img).requires_grad_()
    got = mod(xt)
    jfn = jdog.difference_of_gaussians(W, W, B1, B2, T, variant="sat")
    xd = torch.from_numpy(img.astype(np.float64)).requires_grad_()
    want = _dog_oracle(xd, B1, B2)
    scale = float(want.abs().max())
    _peak_near(got.detach(), np.asarray(jfn(jnp.asarray(img))), 1e-3, scale)
    _peak_near(got.detach(), want.detach(), 1e-2)
    ct = torch.from_numpy(_img(W, W, seed=24))
    (g,) = torch.autograd.grad(got, xt, ct)
    (gref,) = torch.autograd.grad(want, xd, ct.double())
    _peak_near(g, gref, 1e-3)
