"""Every ``Plan.backend`` of the port against the JAX package.

Each backend through ``RecFilter.as_func(device="cpu")`` against the JAX
package's ``realize()`` (Pallas in interpret mode) and the f64 oracle; the
blocked algebra (``tiling.py``, the cases of ``tests/test_tiling.py``) and
the sequential core (``scan_core.py``) against their JAX counterparts; the
routes that raised before the core; the schedule directives and their
log; the consumers and Tuple filters on the non-einsum backends.
Tolerances: float filters within the px6 bound 2e-6 of the oracle's peak
and 1e-5 of the peak from the JAX package (whose float32 sums and glue sit
up to 1e-5 from the oracle: its ``lax.scan`` core ~9.8e-6 on the σ=5
Gaussian at 256²); integers bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recfilter_tpu as jrf
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import tiling as jt
from recfilter_tpu.spec import Dim, FilterSpec, Scan

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import scan_core as tsc
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch import tiling as tt

W3 = rft.gaussian_weights(5.0, 3)
BACKENDS = ["pallas", "overlap", "overlap_k", "blocked", "scan", "oracle"]


def _img(*shape, seed=0, scale=0.01):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _gauss(rf, h, w, img, clamp=False, tiles=(128, 128)):
    x, y = rf.Dim("x", w), rf.Dim("y", h)
    F = rf.RecFilter("G")
    if clamp:
        F.set_clamped_image_border()
    F[y, x] = img
    for d in (+x, -x, +y, -y):
        F.add_filter(d, W3)
    F.split(x, tiles[1], y, tiles[0])
    return F


def _audio(rf, n, img, tile=128):
    t = rf.Dim("t", n)
    F = rf.RecFilter("A")
    F[t] = img
    F.add_filter(+t, W3)
    F.add_filter(-t, W3)
    F.split(t, tile)
    return F


FILTERS = {
    "gauss-256": (lambda rf, img: _gauss(rf, 256, 256, img), (256, 256)),
    "gauss-clamp-200x300": (lambda rf, img: _gauss(rf, 200, 300, img, True),
                            (200, 300)),
    "audio-3000": (lambda rf, img: _audio(rf, 3000, img), (3000,)),
}


def _both(case, backend, **plan):
    build, shape = FILTERS[case]
    img = _img(*shape)
    Ft, Fj = build(rft, img), build(jrf, img)
    Ft.set_plan(backend=backend, **plan)
    Fj.set_plan(backend=backend, interpret=True, **plan)
    return Ft, Fj, img


def _held(got, want, oracle, bound=2e-6):
    peak = np.abs(oracle).max()
    assert got.shape == oracle.shape
    assert np.abs(got - oracle).max() <= bound * peak
    assert np.abs(got - want).max() <= 1e-5 * peak


@pytest.mark.parametrize("case", list(FILTERS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_each_backend_matches_jax_realize(case, backend):
    Ft, Fj, img = _both(case, backend)
    got = Ft.as_func(device="cpu")(torch.from_numpy(img)).numpy()
    want = np.asarray(Fj.realize(jnp.asarray(img)))
    _held(got, want, jsc.oracle_apply(Fj.spec, img.astype(np.float64)))


# --- the blocked algebra: the cases of tests/test_tiling.py ---------------

RTOL = 2e-5


@pytest.mark.parametrize("tile", [4, 5, 8, 16])
@pytest.mark.parametrize("feedfwd,feedback", [
    (1.0, [1.0]), (1.2, [0.8, -0.3]), (0.9, [0.6, 0.25, -0.1])])
@pytest.mark.parametrize("causal", [True, False])
def test_single_scan_tiled(tile, feedfwd, feedback, causal):
    x = _img(3, 16, scale=1.0)
    got = tt.tiled_apply_scan(torch.from_numpy(x), 1, causal, feedfwd,
                              feedback, tile).numpy()
    want = np.asarray(jt.tiled_apply_scan(x, 1, causal, feedfwd, feedback,
                                          tile))
    oracle = jsc.oracle_apply_scan(x.astype(np.float64), 1, causal, feedfwd,
                                   feedback)
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("clamp", [False, True])
def test_blocked_scan_last_axis(clamp):
    """The causal blocked scan along the last axis of a 2-D array, clamp
    border and a tile that does not divide the extent included."""
    x = _img(5, 23, seed=2, scale=1.0)
    got = tt.blocked_scan_last_axis(torch.from_numpy(x), 0.9,
                                    [0.6, 0.25, -0.1], 5, clamp).numpy()
    want = np.asarray(jt.blocked_scan_last_axis(x, 0.9, [0.6, 0.25, -0.1],
                                                5, clamp))
    oracle = jsc.oracle_apply_scan(x.astype(np.float64), 1, True, 0.9,
                                   [0.6, 0.25, -0.1],
                                   "clamp" if clamp else "zero")
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("width", [13, 16, 20])
def test_non_dividing_width(width):
    x = _img(4, width, seed=1, scale=1.0)
    got = tt.tiled_apply_scan(torch.from_numpy(x), 1, True, 1.0,
                              [0.5, 0.25], 6).numpy()
    want = np.asarray(jt.tiled_apply_scan(x, 1, True, 1.0, [0.5, 0.25], 6))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(
        got, jsc.oracle_apply_scan(x.astype(np.float64), 1, True, 1.0,
                                   [0.5, 0.25]), rtol=1e-6, atol=1e-6)


_GXY = [(0.5, 0.25), (0.5, 0.125), (0.5, 0.0625), (0.5, 0.125),
        (0.5, 0.250), (0.5, 0.0625), (0.5, 0.125)]
_G2 = rft.gaussian_weights(2.0, 3)
TILED = {
    # label: (extents, scans (axis, causal, b0, feedback), tiles, border)
    "repeated-causal": ((16, 16), [(0, True, 1.0, (0.5, 0.25, 0.0625))] * 4,
                        (4, 4), "zero"),
    "repeated-anticausal": ((16, 16),
                            [(0, False, 1.0, (0.5, 0.25, 0.0625))] * 4,
                            (4, 4), "zero"),
    "causal-anticausal-1d": ((16, 16), [(0, True, 1.0, (0.5, 0.25, 0.0625)),
                                        (0, False, 1.0, (0.4, 0.2, 0.05))],
                             (4, 0), "zero"),
    "causal-xy": ((16, 16), [(0, True, 1.0, (0.5, 0.25)),
                             (1, True, 1.0, (0.4, 0.2))], (4, 4), "zero"),
    "generic-xy": ((16, 16), [(0 if i < 4 else 1, i % 2 == 0, 1.0, w)
                              for i, w in enumerate(_GXY)], (4, 4), "zero"),
    "generic-xyz": ((12, 12, 12),
                    [(a, c, 1.0, w) for a, w1, w2 in
                     ((0, (0.5, 0.25), (0.5, 0.125)),
                      (1, (0.5, 0.0625), (0.5, 0.125)),
                      (2, (0.5, 0.25), (0.5, 0.0625)))
                     for c, w in ((True, w1), (False, w2))],
                    (4, 4, 4), "zero"),
    "clamped-causal": ((20, 8), [(0, True, 0.9, (0.6, 0.25, -0.1))], (5, 0),
                       "clamp"),
    "clamped-anticausal": ((20, 8), [(0, False, 0.9, (0.6, 0.25, -0.1))],
                           (5, 0), "clamp"),
    "clamped-2d-gaussian": ((24, 24), [(a, c, _G2[0], tuple(_G2[1:]))
                                       for a in (0, 1)
                                       for c in (True, False)],
                            (8, 8), "clamp"),
}


@pytest.mark.parametrize("case", list(TILED))
def test_blocked_filter_matches_jax(case):
    ext, scans, tiles, border = TILED[case]
    dims = [f"d{i}" for i in range(len(ext))]
    js = FilterSpec("B", tuple(Dim(d, e) for d, e in zip(dims, ext)),
                    tuple(Scan(*s) for s in scans), border=border,
                    tile_widths=tiles)
    ts = tspec.FilterSpec("B", tuple(tspec.Dim(d, e) for d, e in
                                     zip(dims, ext)),
                          tuple(tspec.Scan(*s) for s in scans),
                          border=border, tile_widths=tiles)
    x = _img(*ext, seed=len(case), scale=1.0)
    got = tt.apply_filter(ts, torch.from_numpy(x)).numpy()
    want = np.asarray(jt.apply_filter(js, x))
    oracle = jsc.oracle_apply(js, x.astype(np.float64)).astype(np.float64)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_tile_width_invariance():
    """Any tile width gives the same output (float64 products: to 1e-6)."""
    img = _img(32, 4, seed=10, scale=1.0)
    outs = []
    for t in (2, 4, 8, 16, 32):
        spec = tspec.FilterSpec(
            "TI", (tspec.Dim("x", 32), tspec.Dim("y", 4)),
            (tspec.Scan(0, True, 1.1, (0.7, -0.2)),
             tspec.Scan(0, False, 1.0, (0.5,))), tile_widths=(t, 0))
        outs.append(tt.apply_filter(spec, torch.from_numpy(img)).numpy())
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_blocked_refuses_other_float_types(dtype):
    """The JAX package's float64 and bfloat16 blocked paths: the port runs
    float32 only and says so (item 4)."""
    spec = tspec.FilterSpec("F", (tspec.Dim("x", 16), tspec.Dim("y", 8)),
                            (tspec.Scan(0, True, 1.0, (0.5, 0.25)),),
                            dtype=dtype, tile_widths=(4, 0))
    with pytest.raises(NotImplementedError, match="item 4"):
        tt.BlockedFilter(spec)


# --- the sequential core ------------------------------------------------------

SCANS_F = [(1, True, 0.9, (0.5, 0.25, 0.1)), (0, False, 1.1, (0.3,)),
           (1, False, 0.7, (0.2, 0.1))]
SCANS_I = [(1, True, 3, (2, -1, 5)), (0, False, 1, (1,)), (1, False, -2, (7, 1))]


@pytest.mark.parametrize("dtype", ["float32", "int8", "int16", "int32"])
@pytest.mark.parametrize("border", ["zero", "clamp"])
@pytest.mark.parametrize("w", [2, 7, 64])
def test_scan_core_matches_jax(dtype, border, w):
    """``scan_core.apply_filter`` against the JAX package's: floats to the
    oracle (1e-6) and JAX (1e-5); integers bit-equal, wrapping as the type
    wraps (coefficients 3, 5, 7 overflow int8 within a few steps); widths
    below the order peel every output under a clamp border."""
    scans = SCANS_F if dtype == "float32" else SCANS_I
    js = FilterSpec("S", (Dim("y", 5), Dim("x", w)),
                    tuple(Scan(*a) for a in scans), border=border,
                    dtype=dtype)
    ts = tspec.FilterSpec("S", (tspec.Dim("y", 5), tspec.Dim("x", w)),
                          tuple(tspec.Scan(*a) for a in scans),
                          border=border, dtype=dtype)
    rng = np.random.default_rng(w)
    x = (rng.standard_normal((5, w)).astype(np.float32) if dtype == "float32"
         else rng.integers(-100, 100, (5, w)).astype(dtype))
    got = tsc.apply_filter(ts, torch.from_numpy(x)).numpy()
    want = np.asarray(jsc.apply_filter(js, jnp.asarray(x)))
    oracle = jsc.oracle_apply(js, x)
    assert got.dtype == np.dtype(dtype)
    if dtype == "float32":
        peak = np.abs(oracle).max()
        assert np.abs(got - oracle).max() <= 1e-6 * peak
        assert np.abs(got - want).max() <= 1e-5 * peak
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle)


# --- the routes that raised before the core -------------------------------

def test_prime_clamp_and_untiled_filters_match_jax():
    """A prime clamp extent (1009: no tile plan) on the default backend,
    and an untiled 2-D filter (``auto`` → ``scan``), through the API
    against the JAX package's ``realize()`` and the oracle."""
    sig = _img(4, 1009, seed=11, scale=0.1)
    img = _img(40, 24, seed=12, scale=0.1)
    for build, x in (
            (lambda rf: _clamped_1d(rf, sig), sig),
            (lambda rf: _untiled_2d(rf, img), img)):
        Ft, Fj = build(rft), build(jrf)
        mod = Ft.as_func(device="cpu")
        got = mod(torch.from_numpy(x)).numpy()
        want = np.asarray(Fj.realize(jnp.asarray(x)))
        _held(got, want, jsc.oracle_apply(Fj.spec, x.astype(np.float64)))


def _clamped_1d(rf, sig):
    c, t = rf.Dim("c", 4), rf.Dim("t", 1009)
    F = rf.RecFilter("P")
    F.set_clamped_image_border()
    F[c, t] = sig
    F.add_filter(+t, [0.9, 0.5, 0.1])
    F.add_filter(-t, [0.9, 0.5, 0.1])
    F.split(t, 128)
    return F


def _untiled_2d(rf, img):
    x, y = rf.Dim("x", 24), rf.Dim("y", 40)
    F = rf.RecFilter("U")
    F[y, x] = img
    for d in (+x, -y):
        F.add_filter(d, W3)
    return F


# --- schedules -----------------------------------------------------------------

def _sat(rf):
    w = 16
    x, y = rf.Dim("x", w), rf.Dim("y", w)
    F = rf.RecFilter("SAT")
    F[y, x] = np.ones((w, w), np.float32)
    F.add_filter(+x, [1.0, 1.0])
    F.add_filter(+y, [1.0, 1.0])
    F.split(x, 4, y, 4)
    return F


def _schedule(F):
    F.intra_schedule(1).compute_locally().unroll(F.inner_scan()).gpu_threads(
        F.inner(0), F.inner(1)).gpu_blocks(F.outer(0), F.outer(1))
    F.inter_schedule().compute_globally().unroll(F.outer_scan())
    F.intra_schedule(2).vectorize(F.inner(0), 32).unroll(F.inner(0), 4)
    return F.print_schedule()


def test_schedule_log_matches_jax():
    """The JAX package's ``test_schedule_handles_record_and_map`` on the
    port: the same directives, recorded in the same order with the same
    Plan effects (``compute_locally`` → ``pallas``, ``vectorize(width)``
    → ``line_block``, ``unroll(factor)`` → ``unroll``); each no-op says
    what does its job on the card, where the JAX log names Mosaic/XLA."""
    Ft, Fj = _sat(rft), _sat(jrf)
    lt, lj = _schedule(Ft), _schedule(Fj)
    directive = [ln.split("  #")[0] for ln in lt.splitlines()]
    assert directive == [ln.split("  #")[0] for ln in lj.splitlines()]
    for f in ("backend", "line_block", "unroll"):
        assert getattr(Ft.plan, f) == getattr(Fj.plan, f)
    assert Ft.plan.backend == "pallas" and Ft.plan.line_block == 32
    assert "-> Plan.backend='pallas'" in lt
    assert "no-op" in lt and "Mosaic" not in lt and "XLA" not in lt
    assert "CUDA kernel" in lt
    assert all("  # " in ln for ln in lt.splitlines())
    with pytest.raises(RuntimeError):
        Ft.full_schedule()
    got = Ft.realize(device="cpu").numpy()
    np.testing.assert_array_equal(got, np.ones((16, 16)).cumsum(1).cumsum(0))
    U = rft.RecFilter("U")
    x = rft.Dim("x", 8)
    U[x] = np.ones(8, np.float32)
    U.add_filter(+x, [1.0, 1.0])
    U.full_schedule().compute_locally()
    assert "no-op" in U.print_schedule()
    with pytest.raises(RuntimeError):
        U.intra_schedule()
    U.auto_schedule(4)
    assert U.spec.tile_widths == (4,) and U.plan.backend == "auto"
    rft.RecFilter.set_max_threads_per_cuda_warp(64)  # parity shims
    rft.RecFilter.set_vectorization_width(8)
    with pytest.raises(ValueError):
        rft.RecFilter.set_max_threads_per_cuda_warp(48)
    with pytest.raises(ValueError):
        rft.RecFilter.set_vectorization_width(12)


# --- consumers and Tuples on the other backends ---------------------------

SOBEL = [[(-1, -1, -1.0), (0, -1, -2.0), (1, -1, -1.0), (-1, 1, 1.0),
          (0, 1, 2.0), (1, 1, 1.0)]]


@pytest.mark.parametrize("backend", ["pallas", "overlap_k", "scan"])
def test_stencil2d_and_epilogue_after_the_filter(backend):
    """On a non-einsum backend a ``stencil2d`` bank and an epilogue run
    after the filter (``Stencil2DAfter``, ``EpilogueAfter``), as the JAX
    package's ``_executor`` runs them: against its ``as_func`` results."""
    img = _img(128, 256, seed=13)
    Ft, Fj = (_gauss(rf, 128, 256, img) for rf in (rft, jrf))
    Ft.set_plan(backend=backend)
    Fj.set_plan(backend=backend, interpret=True)
    oracle = jsc.oracle_apply(Fj.spec, img.astype(np.float64))
    peak = np.abs(oracle).max()
    mod = Ft.as_func(stencil2d=SOBEL, device="cpu")
    assert type(mod).__name__ == "Stencil2DAfter"
    (got,) = mod(torch.from_numpy(img))
    (want,) = Fj.as_func(stencil2d=SOBEL)(jnp.asarray(img))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4 * peak

    def epi(y, a):
        return 2.0 * a - y

    mod = Ft.as_func(epilogue=epi, device="cpu")
    assert type(mod).__name__ == "EpilogueAfter"
    got = mod(torch.from_numpy(img), torch.from_numpy(img)).numpy()
    want = np.asarray(Fj.as_func(epilogue=epi)(jnp.asarray(img),
                                               jnp.asarray(img)))
    _held(got, want, 2.0 * img - oracle)


def test_tuple_filter_on_pallas():
    """A Tuple filter (two components) under ``pallas``: plain and with a
    staged (non-linear) combine, against the JAX package."""
    a, b = _img(128, 128, seed=14), _img(128, 128, seed=15)
    Fs = []
    for rf in (rft, jrf):
        x, y = rf.Dim("x", 128), rf.Dim("y", 128)
        F = rf.RecFilter("T")
        F[y, x] = (a, b)
        for d in (+x, -x, +y, -y):
            F.add_filter(d, W3)
        F.split(x, 128, y, 128)
        Fs.append(F)
    Ft, Fj = Fs
    Ft.set_plan(backend="pallas")
    Fj.set_plan(backend="pallas", interpret=True)
    mod = Ft.as_func(device="cpu")
    assert type(mod.body).__name__ == "StripFilter"
    got = mod((torch.from_numpy(a), torch.from_numpy(b)))
    want = Fj.as_func()((jnp.asarray(a), jnp.asarray(b)))
    for g, w, img in zip(got, want, (a, b)):
        one = jsc.oracle_apply(_gauss(jrf, 128, 128, img).spec,
                               img.astype(np.float64))
        _held(g.numpy(), np.asarray(w), one)
    prod = Ft.as_func(epilogue=lambda u, v: u * v, device="cpu")
    assert prod.tuple_route == "staged"
    got = prod((torch.from_numpy(a), torch.from_numpy(b))).numpy()
    want = np.asarray(Fj.as_func(epilogue=lambda u, v: u * v)(
        (jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_unknown_backend_and_plan_fields_raise():
    with pytest.raises(ValueError, match="unknown backend"):
        rft.Plan(backend="tpu")
    with pytest.raises(ValueError):
        rft.Plan(line_block=-1)
    with pytest.raises(ValueError):
        rft.Plan(unroll=0)
    with pytest.raises(ValueError):
        rft.Plan(matmul_dtype="float16")
    assert rft.Plan(backend="blocked").with_(line_block=8).line_block == 8
