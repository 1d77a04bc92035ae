"""The 2-D stencil consumers against the JAX package: the standalone bank
(``stencil2d``), the bank fused into the 3-touch executor's final kernel
(``Moments2D`` edge rows, ``Final2DStencil``, ``Fused2DPx(stencil2d=)``),
the epilogue on the 2-D path, and the routing of ``as_func(stencil2d=)``.

Same numpy inputs through ``recfilter_tpu`` (px6, Pallas interpret mode on
the CPU, as its own tests run) and ``recfilter_tpu_torch`` (the plain twins
on the CPU). Bounds (each test states its own): kernel-level twins against
the JAX kernels 1e-5 of the peak (fp32 sums in another order); the fused
bank against the f64 SAT + shift oracle 2e-5 of the peak
(``tests/test_overlap2d.py:523``); the epilogue path against the JAX
executor at its rtol = 2e-5, atol = 2e-6·peak; gradients 1e-4 of the peak
(``tests/test_overlap2d.py``'s gradient bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import final2d as jk2d
from recfilter_tpu.kernels import stencil2d as jst

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import overlap2d as to2
from recfilter_tpu_torch import scan_core as tsc
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.kernels import final2d as tk2d
from recfilter_tpu_torch.kernels import split as tsplit
from recfilter_tpu_torch.kernels import stencil2d as tst

T = 128
SOBEL = [[(-1, -1, -1.0), (0, -1, -2.0), (1, -1, -1.0), (-1, 1, 1.0),
          (0, 1, 2.0), (1, 1, 1.0)],
         [(-1, -1, -1.0), (-1, 0, -2.0), (-1, 1, -1.0), (1, -1, 1.0),
          (1, 0, 2.0), (1, 1, 1.0)]]


def _img(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _peak_near(got, want, bound, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() if scale is None else scale
    assert np.abs(got - want).max() <= bound * scale


def _corner_taps(B):
    s = 1.0 / float((2 * B + 1) ** 2)
    return [(B, B, s), (B, -B - 1, -s), (-B - 1, B, -s), (-B - 1, -B - 1, s)]


def _shift_np(f, off, ax):
    """f[i + off] along ``ax``: edge past the far end, zero before 0."""
    n = f.shape[ax]
    lo, hi = max(off, 0), max(-off, 0)
    pads = [(0, 0)] * f.ndim
    pads[ax] = (hi, lo)
    g = np.pad(f, pads, mode="edge" if off > 0 else "constant")
    return np.take(g, np.arange(lo, lo + n), axis=ax)


def _stencil_np(y, taps_c):
    return [sum(c * _shift_np(_shift_np(y, dy, y.ndim - 2), dx, y.ndim - 1)
                for dy, dx, c in taps) for taps in taps_c]


def _spec(mod, h, w, scans, dtype="float32", border="zero"):
    return mod.FilterSpec("S2", (mod.Dim("y", h), mod.Dim("x", w)),
                          tuple(mod.Scan(*s) for s in scans), border=border,
                          dtype=dtype, tile_widths=(T, T))


SAT = [(1, True, 1.0, (1.0,)), (0, True, 1.0, (1.0,))]


# ------------------------------------------------------ the standalone bank


@pytest.mark.parametrize("bank", [SOBEL, [_corner_taps(3), _corner_taps(7)],
                                  [[(40, -40, 1.0), (-3, 50, 0.5)]]])
def test_stencil2d_twin_matches_jax(bank):
    """stencil2d_ref and the module's CPU path against the JAX kernel
    (interpret mode) on a float image, 1e-6 of the peak, and the numpy
    shift oracle."""
    y = _img(96, 200, seed=1)
    got = tst.Stencil2D(bank)(torch.from_numpy(y))
    want = jst.stencil2d_pass(jnp.asarray(y), bank, interpret=True)
    if want is None:  # no row block divides H: its caller takes the twin
        want = jst.stencil2d_ref(jnp.asarray(y), bank)
    want = want if isinstance(want, tuple) else (want,)
    assert isinstance(got, tuple) and len(got) == len(bank)
    for g, w, o in zip(got, want, _stencil_np(y.astype(np.float64), bank)):
        _peak_near(g, np.asarray(w), 1e-6)
        _peak_near(g, o, 1e-6)


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.int8])
def test_stencil2d_integer_table_gives_float32(dtype):
    """An integer table: the port's output is float32, as the JAX twin's
    (``stencil2d_ref``: a float, float32 without x64) — 1e-6 of the peak
    from it; its TPU kernel writes the input type instead (int32 out of
    interpret mode here), which truncates the differenced, scaled output
    (ROADMAP Queue 3)."""
    info = np.iinfo(dtype)
    y = np.random.default_rng(2).integers(info.min // 2, info.max // 2,
                                          (64, 136)).astype(dtype)
    bank = [_corner_taps(2)]
    (got,) = tst.Stencil2D(bank)(torch.from_numpy(y))
    (ref,) = jst.stencil2d_ref(jnp.asarray(y), bank)
    assert got.dtype == torch.float32
    assert np.issubdtype(np.asarray(ref).dtype, np.floating)
    _peak_near(got, np.asarray(ref), 1e-6)
    if dtype == np.int32:
        k = jst.stencil2d_pass(jnp.asarray(y), bank, interpret=True)
        assert np.asarray(k).dtype == np.int32  # the reference's kernel


# -------------------------------------------------- the fused final kernel


def _mats(clamp):
    w3 = rft.gaussian_weights(3.0, 3)
    a = [tspec.Scan(0, True, w3[0], tuple(w3[1:])),
         tspec.Scan(0, False, w3[0], tuple(w3[1:]))]
    b = [tspec.Scan(1, True, 0.9, (0.6, 0.25, -0.1))]
    ma = tdf.prepare_dim_pass(a, T, 3, clamp)
    mb = tdf.prepare_dim_pass(b, T, 2, clamp)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    return ma, mb, cat(ma.G, 1), cat(mb.G, 1), cat(ma.Rhat, 2), cat(mb.Rhat, 2)


@pytest.mark.parametrize("clamp", [False, True])
def test_moments_edge_rows_and_final_stencil_match_jax(clamp):
    """Moments2D(edge=) against moments2d_px(edge_mats=) and
    Final2DStencil against final2d_px(stencil2d=) on the same carries and
    halo strips: 1e-5 of the peak."""
    ma, mb, Ga, Gb, Ra, Rb = _mats(clamp)
    p, na, nb, h8 = 2, 3, 2, 16
    bank = [_corner_taps(5), _corner_taps(7)]
    x = _img(p, na, T, nb * T, seed=3)
    NA_t, NB_t = _img(p, na, 8, nb * T, seed=4), _img(p, na, nb * 8, T,
                                                       seed=5)
    mom = tk2d.Moments2D(Ga, Gb, ma.Btot, na, nb, edge=(ma.Btot, h8))
    outs = mom(torch.from_numpy(x))
    jout = jk2d.moments2d_px(jnp.asarray(x), Ga, Gb, nprod=6, interpret=True,
                             edge_mats=(ma.Btot, h8), term1_mats=ma.Btot)
    for g, w in zip(outs[2:], jout[2:4]):
        _peak_near(g, np.asarray(w), 1e-5)
    _peak_near(outs[0], np.asarray(jout[0]), 1e-5)
    fin = tk2d.Final2DStencil(ma.Btot, Ra, mb.Btot, Rb, na, nb, bank, h8)
    # the strips the JAX kernel reads: the neighbour tiles' edge rows of
    # the completed output (the port's twin recomputes that output whole)
    Y = fin.final.plain(*(torch.from_numpy(v) for v in (x, NA_t, NB_t)))
    z = torch.zeros_like(Y[:, :1, :h8])
    top = torch.cat([z, Y[:, :-1, T - h8:]], 1).numpy()
    bot = torch.cat([Y[:, 1:, :h8], z], 1).numpy()
    got = fin(*(torch.from_numpy(v) for v in (x, NA_t, NB_t, top, bot)))
    want = jk2d.final2d_px(
        jnp.asarray(x), ma.Btot, Ra, mb.Btot, Rb, jnp.asarray(NA_t),
        jnp.asarray(NB_t), nprod=6, interpret=True,
        stencil2d={"taps_c": bank, "h8": h8}, halo_top=jnp.asarray(top),
        halo_bot=jnp.asarray(bot))
    assert got.shape == (2, p, na, T, nb * T)
    for g, w in zip(got, want):
        _peak_near(g, np.asarray(w), 1e-5)


def test_fused_2d_stencil_consumer_vs_jax_and_oracle():
    """``stencil2d=`` on the 3-touch executor (dual-radius 4-corner bank,
    256 × 2560): against ``apply_filter_fused(stencil2d=)`` and the f64 SAT
    + shift oracle at every region, 2e-5 of the peak; the halo strips the
    glue completes equal the rows of the whole output."""
    H, W = 256, 2560
    ts, js = _spec(tspec, H, W, SAT), _spec(jspec, H, W, SAT)
    x = _img(H, W, seed=40) * 0.01
    banks = [_corner_taps(5), _corner_taps(9)]
    mod = tdf.fused_filter_module(ts, stencil2d=banks)
    assert isinstance(mod, to2.Fused2DPx) and mod.h8 == 16
    out = mod(torch.from_numpy(x))
    assert isinstance(out, tuple) and len(out) == 2
    jout = jdf.apply_filter_fused(js, jnp.asarray(x), matmul_precision="px6",
                                  stencil2d=banks)
    sat = x.astype(np.float64).cumsum(1).cumsum(0)
    for got, jw, want in zip(out, jout, _stencil_np(sat, banks)):
        _peak_near(got, want, 2e-5)
        _peak_near(got, np.asarray(jw), 2e-5, np.abs(want).max())
    X4 = mod.tile(torch.from_numpy(x))
    NA_t, NB_t, ht, hb = mod._carries(X4)
    top, bot = mod.halo_strips(ht, hb, NA_t, NB_t)
    Y = torch.from_numpy(sat).reshape(1, 2, T, W)
    scale = float(Y.abs().max())
    _peak_near(top[:, 1], Y[:, 0, T - 16:], 1e-6, scale)
    _peak_near(bot[:, 0], Y[:, 1, :16], 1e-6, scale)
    assert not top[:, 0].any() and not bot[:, 1].any()


def test_fused_2d_stencil_gradient_matches_jax():
    """The gradient of the bank-fused composite (the twin recomputes the
    output whole; the strips get zero gradients) against JAX's, 1e-4."""
    H = W = 128
    scans = [(1, True, 1.0, (0.8,)), (0, True, 1.0, (0.7,))]
    ts, js = _spec(tspec, H, W, scans), _spec(jspec, H, W, scans)
    banks = [_corner_taps(3)]
    x, ct = _img(H, W, seed=11), _img(H, W, seed=12)
    xt = torch.from_numpy(x).requires_grad_()
    (y,) = tdf.fused_filter_module(ts, stencil2d=banks)(xt)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(ct))
    jg = jax.grad(lambda v: (jdf.apply_filter_fused(
        js, v, matmul_precision="px6", stencil2d=banks)[0] * ct).sum())(
        jnp.asarray(x))
    _peak_near(g, np.asarray(jg), 1e-4)


# ------------------------------------------------------ epilogue and routes


@pytest.mark.parametrize("h,w,border", [(256, 384, "zero"),
                                        (256, 256, "clamp"),
                                        (200, 300, "zero")])
def test_epilogue_on_the_2d_path_matches_jax(h, w, border):
    """An elementwise epilogue (the unsharp-mask combine 2·a − o, aux the
    image) on the 3-touch executor, padded extents included: against
    ``apply_filter_fused(epilogue=)`` at rtol = 2e-5, atol = 2e-6·peak."""
    w3 = tuple(rft.gaussian_weights(3.0, 3))
    scans = [(1, True, w3[0], w3[1:]), (1, False, w3[0], w3[1:]),
             (0, True, w3[0], w3[1:]), (0, False, w3[0], w3[1:])]
    ts = _spec(tspec, h, w, scans, border=border)
    js = _spec(jspec, h, w, scans, border=border)
    x = _img(h, w, seed=h + w)
    epi = lambda o, a: 2.0 * a - o  # noqa: E731
    mod = tdf.fused_filter_module(ts, epilogue=epi)
    got = mod(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    want = np.asarray(jdf.apply_filter_fused(
        js, jnp.asarray(x), matmul_precision="px6", epilogue=epi,
        eaux=(jnp.asarray(x),)))
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())
    plain = mod.forward_plain(torch.from_numpy(x), torch.from_numpy(x))
    np.testing.assert_array_equal(plain.numpy(), got)


def test_stencil2d_routes_as_the_jax_package():
    """Off the 3-touch executor the bank runs on the filter's output
    (``Stencil2DAfter``): a y-only filter (the rows pass) and an integer
    SAT, against the JAX package; where the executor declines the bank
    (padded extents, a reach past 128), the rotation chain runs and the
    bank after it, as in the JAX package."""
    H, W = 256, 384
    w3 = tuple(rft.gaussian_weights(5.0, 3))
    yonly = [(0, True, w3[0], w3[1:]), (0, False, w3[0], w3[1:])]
    x = _img(H, W, seed=13)
    for scans, dtype, xin in ((yonly, "float32", x),
                              (SAT, "int32", (x * 100).astype(np.int32))):
        ts = _spec(tspec, H, W, scans, dtype=dtype)
        js = _spec(jspec, H, W, scans, dtype=dtype)
        mod = tdf.fused_filter_module(ts, stencil2d=SOBEL)
        assert isinstance(mod, tdf.Stencil2DAfter)
        got = mod(torch.from_numpy(xin))
        want = jdf.apply_filter_fused(js, jnp.asarray(xin),
                                      matmul_precision="px6",
                                      stencil2d=SOBEL)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            _peak_near(g, np.asarray(w), 1e-5)
    for h, w, bank in ((200, 256, SOBEL), (256, 256,
                                           [[(0, 129, 1.0)]])):
        mod = tdf.fused_filter_module(_spec(tspec, h, w, SAT),
                                      stencil2d=bank)
        assert isinstance(mod, tdf.Stencil2DAfter)
        assert isinstance(mod.body, tdf.RotationChain)
        xin = _img(h, w, seed=h)
        got = mod(torch.from_numpy(xin))
        want = jdf.apply_filter_fused(_spec(jspec, h, w, SAT),
                                      jnp.asarray(xin),
                                      matmul_precision="px6", stencil2d=bank)
        for g, w_ in zip(got, want):
            _peak_near(g, np.asarray(w_), 1e-5)
    with pytest.raises(ValueError):
        tdf.fused_filter_module(_spec(tspec, H, W, SAT), stencil2d=SOBEL,
                                epilogue=lambda o: o)


def test_stencil2d_after_a_batched_filter_runs_the_twin():
    """A filter with a leading batch axis (an x-only scan over (2, H, W))
    routes its bank to ``Stencil2DAfter``, which takes the twin for a
    non-2-D output, as the JAX package's ``_st_fallback`` does: against
    ``apply_filter_fused(stencil2d=)`` (1e-5 of the peak) and the f64
    bank over the port's own filter output (1e-6)."""
    P, H, W = 2, 128, 256

    def spec(mod):
        return mod.FilterSpec(
            "S3", (mod.Dim("c", P), mod.Dim("y", H), mod.Dim("x", W)),
            (mod.Scan(2, True, 0.5, (0.5,)),), border="zero",
            dtype="float32", tile_widths=(0, 0, T))

    mod = tdf.fused_filter_module(spec(tspec), stencil2d=SOBEL)
    assert isinstance(mod, tdf.Stencil2DAfter)
    x = _img(P, H, W, seed=21)
    got = mod(torch.from_numpy(x))
    want = jdf.apply_filter_fused(spec(jspec), jnp.asarray(x),
                                  matmul_precision="px6", stencil2d=SOBEL)
    y = mod.body(torch.from_numpy(x)).double().numpy()
    for g, w, o in zip(got, want, _stencil_np(y, SOBEL)):
        assert g.shape == (P, H, W)
        _peak_near(g, np.asarray(w), 1e-5)
        _peak_near(g, o, 1e-6)


# ------------------------------------------------------- the reduced grades

GRADE_BOUNDS = {"px3": 1e-4, "px4": 8e-5, "default": 3e-2}


@pytest.mark.parametrize("grade", list(GRADE_BOUNDS))
def test_fused_bank_and_epilogue_at_the_grades(grade):
    """At px3, px4 and ``default`` the σ=5 Gaussian at 256² carries the
    Sobel bank fused (``Final2DStencil`` at the grade) and an affine
    epilogue in its final kernel (``Final2DSplit(affine=)``,
    ``epilogue_route == "kernel"``): within the grade's bound of the bank
    (the combine) over the f64 oracle, the bank within twice it of
    ``apply_filter_fused`` at the grade (the epilogue's twin is held to
    the JAX kernel in ``tests/test_torch_precision.py``)."""
    H = W = 256
    w3 = tuple(rft.gaussian_weights(5.0, 3))
    scans = [(1, True, w3[0], w3[1:]), (1, False, w3[0], w3[1:]),
             (0, True, w3[0], w3[1:]), (0, False, w3[0], w3[1:])]
    ts, js = _spec(tspec, H, W, scans), _spec(jspec, H, W, scans)
    x = _img(H, W, seed=41)
    bound = GRADE_BOUNDS[grade]
    y64 = tsc.oracle_apply(ts, x.astype(np.float64))
    mod = tdf.fused_filter_module(ts, grade, stencil2d=SOBEL)
    assert isinstance(mod.final, tk2d.Final2DStencil)
    assert mod.final.nprod == tsplit.NPROD[grade]
    got = mod(torch.from_numpy(x))
    jout = jdf.apply_filter_fused(js, jnp.asarray(x), matmul_precision=grade,
                                  stencil2d=SOBEL)
    for g, jw, want in zip(got, jout, _stencil_np(y64, SOBEL)):
        _peak_near(g, want, bound)
        _peak_near(g, np.asarray(jw), 2 * bound, np.abs(want).max())
    epi = lambda o, a: 2.0 * a - o  # noqa: E731
    mod = tdf.fused_filter_module(ts, grade, epilogue=epi)
    assert mod.epilogue_route == "kernel" and mod.final.affine is not None
    got = mod(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    _peak_near(got, 2.0 * x - y64, bound)


def _bounded_image(n, m, seed, rad=4):
    """The SAT apps' well-conditioned input (``chip_smoke.bounded_image``):
    the 2nd y- and x-difference of a box-summed integer field, zero in the
    m-pixel margins, so every integral the apps take stays bounded."""
    r = np.random.default_rng(seed).integers(-8, 8, (n, n), endpoint=True)
    for ax in (0, 1):
        c = np.concatenate([np.zeros_like(r[:1]) if ax == 0
                            else np.zeros_like(r[:, :1]), r.cumsum(ax)],
                           axis=ax)
        i = np.arange(n)
        r = (np.take(c, np.minimum(i + rad + 1, n), axis=ax)
             - np.take(c, np.maximum(i - rad, 0), axis=ax))
    r[:m] = r[n - m - 2:] = 0
    r[:, :m] = r[:, n - m - 2:] = 0
    for ax in (0, 0, 1, 1):
        r = np.diff(r, axis=ax, prepend=0)
    return r.astype(np.float32)


def _ddiff_np(f, B, ax):
    n = float(2 * B + 1)
    return (_shift_np(f, 2 * B, ax) - 2.0 * _shift_np(f, -1, ax)
            + _shift_np(f, -2 * B - 2, ax)) / (n * n)


def _dog_oracle(img, B1, B2):
    """The six-stage SAT DoG untiled in float64 (``tests/test_apps.py``'s
    oracle)."""
    s = img.astype(np.float64).cumsum(1).cumsum(0)
    g = []
    for B in (B1, B2):
        d = _shift_np(s, B, 0) - _shift_np(s, -B - 1, 0)
        b = (_shift_np(d, B, 1) - _shift_np(d, -B - 1, 1)) / (2 * B + 1) ** 2
        b2 = _ddiff_np(b.cumsum(1).cumsum(1), B, 1)
        g.append(_ddiff_np(b2.cumsum(0).cumsum(0), B, 0))
    return g[0] - g[1]


@pytest.mark.parametrize("grade", list(GRADE_BOUNDS))
def test_dog_sat_at_the_grades(grade):
    """The DoG SAT app at 256² (its SAT with the dual-radius 4-corner bank
    fused on ``Final2DStencil`` at the grade, then the rotated passes at
    the grade) on the bounded input: within the grade's bound of the f64
    six-stage oracle and twice it of the JAX app at the same grade (the
    process-wide default there). At ``default`` both packages miss the
    bound (the port 3.85e-2, the JAX package 4.02e-2 of the peak): one
    bf16 product on the 2nd-order integrals loses 2^-9 of values whose
    differences cancel their leading digits, as C3 at px3 and px4
    (ROADMAP Queue 3). There the port is held to twice the JAX package's
    own error on the same input."""
    from recfilter_tpu import planner as jplanner
    from recfilter_tpu.apps import dog as jdog
    from recfilter_tpu_torch.apps import dog as tdog

    n, bound = 256, GRADE_BOUNDS[grade]
    img = _bounded_image(n, 21, seed=42)
    mod = tdog.difference_of_gaussians(n, n, 5, 9, T, variant="sat",
                                       device="cpu", matmul_precision=grade)
    assert isinstance(mod.sat_box.final, tk2d.Final2DStencil)
    assert mod.sat_box.final.nprod == tsplit.NPROD[grade]
    got = mod(torch.from_numpy(img)).numpy()
    want = _dog_oracle(img, 5, 9)
    old = jplanner._DEFAULT_MATMUL_PRECISION[0]
    try:
        jplanner.set_default_matmul_precision(grade)
        jw = np.asarray(jdog.difference_of_gaussians(
            n, n, 5, 9, T, variant="sat")(jnp.asarray(img)))
    finally:
        jplanner.set_default_matmul_precision(old)
    peak = np.abs(want).max()
    jerr = np.abs(jw - want).max() / peak
    if grade == "default":  # the SAT cancellation (docstring)
        assert jerr > bound
        _peak_near(got, want, 2 * jerr)
    else:
        _peak_near(got, want, bound)
    _peak_near(got, jw, 2 * bound, peak)


@pytest.mark.parametrize("grade", list(GRADE_BOUNDS))
def test_box3_sat_at_the_grades(grade):
    """The box ×3 SAT app (C2's form: the order-1 box on ``fir_band`` with
    its exact tap scale, then the 2nd-order x and y integrals on the rotated
    passes and their double differences) at 256² on the bounded input, at
    the grade (the JAX app at the same process-wide default). Both packages
    miss every grade's bound of the f64 formulation oracle here (the port
    2.4e-4 at px3 and px4, 0.20 at ``default``; the JAX package 1.4e-4 and
    0.19): the float32 integrals' rounding, which the differences cancel
    against, is the SAT cancellation of ROADMAP Queue 3. So the port is
    held to twice the JAX package's own error jerr on the same input, and
    to the JAX app within 3·jerr (that bound and the JAX package's own
    jerr from the oracle, by the triangle inequality)."""
    from recfilter_tpu import planner as jplanner
    from recfilter_tpu.apps import box as jbox
    from recfilter_tpu_torch import fir as tfir
    from recfilter_tpu_torch.apps import box as tbox

    n, B, bound = 256, 5, GRADE_BOUNDS[grade]
    img = _bounded_image(n, 19, seed=43)
    mod = tbox.box_filter_3(n, n, B, T, variant="sat", device="cpu",
                            matmul_precision=grade)
    fir1 = mod.stages[0]
    assert isinstance(fir1, tfir.FirSeparable2D)
    assert fir1.x_pass.band.nprod == tsplit.NPROD[grade]
    got = mod(torch.from_numpy(img)).numpy()
    b1 = tfir.fir_oracle(tfir.fir_oracle(img, tfir.box_taps(B, 1), 1),
                         tfir.box_taps(B, 1), 0).astype(np.float64)
    want = _ddiff_np(_ddiff_np(b1.cumsum(1).cumsum(1), B, 1)
                     .cumsum(0).cumsum(0), B, 0)
    old = jplanner._DEFAULT_MATMUL_PRECISION[0]
    try:
        jplanner.set_default_matmul_precision(grade)
        jw = np.asarray(jbox.box_filter_3(n, n, B, T, variant="sat")(
            jnp.asarray(img)))
    finally:
        jplanner.set_default_matmul_precision(old)
    peak = np.abs(want).max()
    jerr = np.abs(jw - want).max() / peak
    assert jerr > bound  # the SAT cancellation (docstring)
    # an output of zeros, 1.0 of the peak from the oracle, misses both
    assert 3 * jerr < 1.0
    _peak_near(got, want, 2 * jerr)
    _peak_near(got, jw, 3 * jerr, peak)
