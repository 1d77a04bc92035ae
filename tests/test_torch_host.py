"""The port's host builders (numpy, float64) against the JAX package's.

Same inputs through both packages; every matrix the executor builds must
agree to 1e-12 (both are float64 numpy; the JAX package may build its
impulse matrices in its native host library, which sums in another order).
"""

import numpy as np
import pytest

from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import iir as jiir
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import planner as jplanner
from recfilter_tpu import spec as jspec
from recfilter_tpu.utils import testing as jtesting
from recfilter_tpu.kernels import completion as jcomp
from recfilter_tpu.kernels import final2d as jk2d

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import iir as tiir
from recfilter_tpu_torch import planner as tplanner
from recfilter_tpu_torch import scan_core as tsc
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.kernels import completion as tcomp
from recfilter_tpu_torch.kernels import final2d as tk2d
from recfilter_tpu_torch.utils import testing as ttesting

TOL = 1e-12
T = 128
N = 3  # tiles: interior, first and last all occur


def _scan_sets(jmod):
    """Two scan sets built with ``jmod``'s own Scan type: the headline
    Gaussian pair and mixed orders/directions (ΣK = 6 each)."""
    w3 = jiir.gaussian_weights(5.0, 3)
    return {
        "gauss3": [jmod.Scan(0, True, w3[0], tuple(w3[1:])),
                   jmod.Scan(0, False, w3[0], tuple(w3[1:]))],
        "mixed": [jmod.Scan(0, True, 0.9, (0.6, 0.25, -0.1)),
                  jmod.Scan(0, False, 1.1, (0.5, 0.2)),
                  jmod.Scan(0, True, 1.0, (0.4,))],
    }


BORDERS = {"zero": (False, 0), "clamp": (True, 0), "pad": (False, 50)}


def _both(scans_name, border):
    clamp, pad = BORDERS[border]
    js = _scan_sets(jspec)[scans_name]
    ts = _scan_sets(tspec)[scans_name]
    return (jdf.prepare_dim_pass(js, T, N, clamp, pad_slots=pad),
            tdf.prepare_dim_pass(ts, T, N, clamp, pad_slots=pad))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=TOL)


@pytest.mark.parametrize("border", list(BORDERS))
@pytest.mark.parametrize("scans_name", ["gauss3", "mixed"])
def test_prepare_dim_pass_matches(scans_name, border):
    jm, tm = _both(scans_name, border)
    assert tm.orders == jm.orders and tm.uniform == jm.uniform
    _close(jm.Btot, tm.Btot)
    for i in range(len(jm.orders)):
        _close(jm.G[i], tm.G[i])
        _close(jm.Rhat[i], tm.Rhat[i])
        _close(jm.CM[i], tm.CM[i])
        for j in range(i):
            _close(jm.H[i][j], tm.H[i][j])


@pytest.mark.parametrize("border", list(BORDERS))
@pytest.mark.parametrize("scans_name", ["gauss3", "mixed"])
def test_solve_matrices_match(scans_name, border):
    jm, tm = _both(scans_name, border)
    S = sum(jm.orders)
    jcm = jdf.combined_solve_matrix(jm, N)
    tcm = tdf.combined_solve_matrix(tm, N)
    _close(jcm, tcm)
    _close(jcomp.pad_solve_matrix(jcm, N, S),
           tcomp.pad_solve_matrix(tcm, N, S))
    assert tcomp.slots_for(S) == jcomp.slots_for(S)


@pytest.mark.parametrize("border", list(BORDERS))
@pytest.mark.parametrize("scans_name", ["gauss3", "mixed"])
def test_variants_and_slot_padding_match(scans_name, border):
    jm, tm = _both(scans_name, border)
    _close(jk2d._variants3(jm.Btot), tk2d._variants3(tm.Btot))
    jR = np.concatenate([np.asarray(r) for r in jm.Rhat], axis=2)
    tR = np.concatenate([np.asarray(r) for r in tm.Rhat], axis=2)
    _close(jk2d._pad_slots(jR), tk2d._pad_slots(tR))
    _close(jcomp._expand_stack(jR, N), tcomp._expand_stack(tR, N))


@pytest.mark.parametrize("sigma,order", [(1.0, 1), (2.5, 2), (5.0, 3),
                                         (16.0, 3)])
def test_iir_weights_match(sigma, order):
    np.testing.assert_allclose(tiir.gaussian_weights(sigma, order),
                               jiir.gaussian_weights(sigma, order),
                               rtol=0, atol=TOL)
    assert tiir.gaussian_box_filter(3, sigma) == \
        jiir.gaussian_box_filter(3, sigma)
    assert tiir.integral_image_coeff(order) == jiir.integral_image_coeff(order)
    a, b = [0.5, -0.1], [0.3]
    assert tiir.overlap_feedback_coeff(a, b) == \
        jiir.overlap_feedback_coeff(a, b)


@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_oracle_apply_matches(border):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 19, 23))
    scans = [(2, True, 0.9, (0.6, 0.25, -0.1)), (1, False, 1.1, (0.5, 0.2)),
             (2, False, 1.0, (0.4,))]

    def spec(mod):
        return mod.FilterSpec(
            "O", (mod.Dim("c", 2), mod.Dim("y", 19), mod.Dim("x", 23)),
            tuple(mod.Scan(*s) for s in scans), border=border,
            dtype="float64")

    want = jsc.oracle_apply(spec(jspec), x)
    got = tsc.oracle_apply(spec(tspec), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_spec_json_from_jax_round_trips():
    w3 = jiir.gaussian_weights(5.0, 3)
    jf = jspec.FilterSpec(
        "G", (jspec.Dim("y", 300), jspec.Dim("x", 200)),
        (jspec.Scan(1, True, w3[0], tuple(w3[1:])),
         jspec.Scan(0, False, 1.0, (0.5,))),
        border="clamp", tile_widths=(128, 128))
    tf = tspec.spec_from_json(jspec.spec_to_json(jf))
    assert tspec.spec_to_json(tf) == jspec.spec_to_json(jf)
    assert tf.scans[0].feedback == jf.scans[0].feedback
    np.testing.assert_array_equal(tf.feedback_coeff(), jf.feedback_coeff())


def test_spec_from_arrays_rebuilds_the_jax_filter():
    """A JAX filter's per-scan arrays rebuild the identical port spec,
    including zero-padded rows of lower-order scans."""
    jf = jspec.FilterSpec(
        "M", (jspec.Dim("y", 256), jspec.Dim("x", 256)),
        (jspec.Scan(1, True, 0.9, (0.6, 0.25, -0.1)),
         jspec.Scan(1, False, 1.1, (0.5, 0.2)),
         jspec.Scan(0, True, 1.0, (0.4,))),
        border="zero", tile_widths=(128, 128))
    tf = rft.spec_from_arrays(
        [rft.Dim(d.name, d.extent) for d in jf.dims],
        [s.axis for s in jf.scans], [s.causal for s in jf.scans],
        jf.feedfwd_coeff(), jf.feedback_coeff(), jf.border, jf.tile_widths,
        name="M")
    assert tspec.spec_to_json(tf) == jspec.spec_to_json(jf)
    with pytest.raises(ValueError):
        rft.spec_from_arrays([rft.Dim("x", 8)], [0, 0], [True],
                             [1.0], [[0.5]])


def test_default_tile_width_matches():
    # (not parametrized by platform: a "tpu" test id is skipped by conftest)
    for platform in ("tpu", "cpu"):
        for extent in (1, 64, 128, 4096):
            assert tplanner.default_tile_width(extent, platform) == \
                jplanner.default_tile_width(extent, platform)
    assert tplanner.default_tile_width(4096, "cuda") == 128


@pytest.mark.parametrize("lo,hi", [(1, 1), (-2, 3)])
def test_testing_helpers_match(lo, hi):
    want = jtesting.generate_random_image(5, 7, lo=lo, hi=hi, seed=4)
    got = ttesting.generate_random_image(5, 7, lo=lo, hi=hi, seed=4)
    np.testing.assert_array_equal(got, want)
    out = got + 1e-3 * np.arange(35).reshape(5, 7)
    j, t = jtesting.CheckResult(want, out), ttesting.CheckResult(want, out)
    assert (t.max_error, t.mean_error) == (j.max_error, j.mean_error)
    assert repr(t) == repr(j)


@pytest.mark.parametrize("w,tile,kmax,clamp", [
    (10_000_000, 1000, 29, False), (1_000_001, 1000, 3, True),
    (70_001, 50, 3, True), (300_005, 128, 4, True), (40, 128, 3, False),
    (100, 128, 200, False), (4099, 128, 2, True)])
def test_plan_tiles_matches(w, tile, kmax, clamp):
    assert tdf._plan_tiles(w, tile, kmax, clamp) == \
        jdf._plan_tiles(w, tile, kmax, clamp)


@pytest.mark.parametrize("border", list(BORDERS))
@pytest.mark.parametrize("scans_name", ["gauss3", "mixed"])
def test_banded_solve_blocks_match(scans_name, border):
    """At 64 tiles the banded form engages for these decaying filters;
    both packages keep the same offsets and blocks."""
    clamp, pad = BORDERS[border]
    n = 64
    jm = jdf.prepare_dim_pass(_scan_sets(jspec)[scans_name], T, n, clamp,
                              pad_slots=pad)
    tm = tdf.prepare_dim_pass(_scan_sets(tspec)[scans_name], T, n, clamp,
                              pad_slots=pad)
    S = sum(jm.orders)
    jb = jdf.banded_solve_blocks(jdf.combined_solve_matrix(jm, n), n, S)
    tb = tdf.banded_solve_blocks(tdf.combined_solve_matrix(tm, n), n, S)
    assert jb is not None and [d for d, _ in tb] == [d for d, _ in jb]
    for (_, a), (_, b) in zip(jb, tb):
        _close(a, b)
    # below 64 tiles both keep the dense solve
    assert tdf.banded_solve_blocks(tdf.combined_solve_matrix(
        tdf.prepare_dim_pass(_scan_sets(tspec)[scans_name], T, N, clamp,
                             pad_slots=pad), N), N, S) is None


@pytest.mark.parametrize("clamp,pad", [(False, 0), (True, 0), (False, 37),
                                       (True, 37)])
@pytest.mark.parametrize("scans_name", ["gauss3", "mixed"])
def test_segment_exchange_mats_match(scans_name, clamp, pad):
    """The supertile level-2 builders of ``parallel.sharding`` (segment
    length 256, 5 segments) equal the JAX package's."""
    from recfilter_tpu.parallel import sharding as jsh
    from recfilter_tpu_torch.parallel import sharding as tsh

    seg, D = 256, 5
    js, ts = _scan_sets(jspec)[scans_name], _scan_sets(tspec)[scans_name]
    jo, jH, jCM, jR = jsh._segment_exchange_mats(js, seg, D, clamp, pad)
    to, tH, tCM, tR = tsh._segment_exchange_mats(ts, seg, D, clamp, pad)
    assert to == jo
    _close(jR, tR)
    for i in range(len(jo)):
        _close(jCM[i], tCM[i])
        for j in range(i):
            _close(jH[i][j], tH[i][j])
    _close(jsh._combined_solve(jo, jH, jCM, D),
           tsh._combined_solve(to, tH, tCM, D))
    for s_j, s_t in zip(js, ts):
        _close(jsh._clamp_col(s_j, seg - pad, total=seg),
               tsh._clamp_col(s_t, seg - pad, total=seg))
        M = np.random.default_rng(1).standard_normal((seg, 3))
        _close(jsh._evolve_cols(M, s_j, True, seg - pad),
               tsh._evolve_cols(M, s_t, True, seg - pad))
        _close(jsh._apply_scan_cols(M, s_j, "zero"),
               tsh._apply_scan_cols(M, s_t, "zero"))
