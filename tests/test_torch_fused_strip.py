"""The ``pallas`` backend's strip passes against the JAX package.

``kernels/fused.py``'s twins (the tile loop the ``dim_pass_rows`` /
``dim_pass_cols`` kernels run) against the JAX package's Pallas kernels
in interpret mode, ``StripFilter`` against ``fused.apply_filter``, and
both against the f64 oracle. Tolerances: the builders at 1e-12; the twins
sum in float64 and sit within 1e-6 of a pass's peak from the oracle,
while the JAX kernels sum in float32 and sit 1e-6 to 5e-6 from it (checked
below), so twin and JAX are held to 1e-5 of the peak; whole filters to
the px6 bound 2e-6 of the oracle; integers bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recfilter_tpu as jrf
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import fused as jf
from recfilter_tpu.planner import Plan as JPlan

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch import tiling as ttl
from recfilter_tpu_torch.kernels import fused as tf

W3 = rft.gaussian_weights(5.0, 3)
G3 = (float(W3[0]), tuple(float(c) for c in W3[1:]))
# (causal, b0, feedback) per scan of one axis
AXIS_SCANS = {
    "causal": [(True, *G3)],
    "anticausal": [(False, *G3)],
    "mixed-orders": [(True, *G3), (False, 1.1, (0.5, 0.2)),
                     (True, 0.9, (0.4,))],
}


def _mats(mod, scans, T, clamp):
    K = max(len(fb) for _, _, fb in scans)
    return [mod.prepare_scan_mats(b0, fb, c, T, K, clamp)
            for c, b0, fb in scans]


def _pass_oracle(x, axis, scans, border, w_real):
    """The f64 oracle of one strip pass on the first ``w_real`` entries of
    ``axis`` (the pad is zero and re-zeroed between scans)."""
    v = np.take(x.astype(np.float64), np.arange(w_real), axis=axis)
    for c, b0, fb in scans:
        v = jsc.oracle_apply_scan(v, axis, c, b0, fb, border)
    return v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("K", [3, 5])
def test_prepare_scan_mats_matches_jax(causal, clamp, K):
    a = jf.prepare_scan_mats(G3[0], G3[1], causal, 16, K, clamp)
    b = tf.prepare_scan_mats(G3[0], G3[1], causal, 16, K, clamp)
    assert (a.causal, a.order, a.has_edge) == (b.causal, b.order, b.has_edge)
    for f in ("B", "B_edge", "RN"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=0,
                                   atol=1e-12)
    # the JAX selector picks the rows the port's tile loop reads as the
    # carry: the last K of a tile (causal), the first K (anticausal)
    rows = list(range(16 - K, 16)) if causal else list(range(K))
    np.testing.assert_array_equal(a.Sel, np.eye(16)[:, rows])
    # _dim_pass_mats: one axis's scans (mixed orders) at that axis's K
    scans = [(causal, *G3), (not causal, 1.1, (0.5, 0.2))]
    ja, Kj = jf._dim_pass_mats(_axis_spec(jspec, scans, clamp), [0, 1], 16)
    ta, Kt = tf._dim_pass_mats(_axis_spec(tspec, scans, clamp), [0, 1], 16)
    assert Kj == Kt == 3
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b.RN, a.RN, rtol=0, atol=1e-12)
        np.testing.assert_allclose(b.B_edge, a.B_edge, rtol=0, atol=1e-12)


def _axis_spec(mod, scans, clamp):
    return mod.FilterSpec("A", (mod.Dim("x", 64),),
                          tuple(mod.Scan(0, c, b0, fb) for c, b0, fb in scans),
                          border="clamp" if clamp else "zero")


# a clamp border never meets a pad (apply_dim takes the blocked algebra)
@pytest.mark.parametrize("case", list(AXIS_SCANS))
@pytest.mark.parametrize("clamp,pad", [(False, 0), (True, 0), (False, 37)])
def test_row_twin_matches_jax(case, clamp, pad):
    """DimPassRows' twin against ``fused.dim_pass_rows`` (interpret) on
    (L, n·128) with ``w_real`` = n·128 − pad."""
    scans, T, n, L = AXIS_SCANS[case], 128, 3, 24
    border = "clamp" if clamp else "zero"
    x = (np.random.default_rng(1).standard_normal((L, n * T)) * 0.01
         ).astype(np.float32)
    w_real = n * T - pad
    x[:, w_real:] = 0.0
    got = tf.DimPassRows(_mats(tf, scans, T, clamp), T, n, w_real).plain(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jf.dim_pass_rows(jnp.asarray(x),
                                       _mats(jf, scans, T, clamp), T, True,
                                       w_real=w_real))
    oracle = _pass_oracle(x, 1, scans, border, w_real)
    peak = np.abs(oracle).max()
    assert np.abs(got[:, :w_real] - oracle).max() <= 1e-6 * peak
    assert np.abs(want[:, :w_real] - oracle).max() <= 1e-5 * peak  # JAX
    assert np.abs(got - want).max() <= 1e-5 * peak


@pytest.mark.parametrize("case", list(AXIS_SCANS))
@pytest.mark.parametrize("clamp,T,pad", [(False, 8, 0), (True, 8, 0),
                                         (False, 32, 5), (True, 40, 0)])
def test_col_twin_matches_jax(case, clamp, T, pad):
    """DimPassCols' twin against ``fused.dim_pass_cols`` (interpret) on
    (outer = 3, n·T, 20 lines)."""
    scans, n, outer, L = AXIS_SCANS[case], 4, 3, 20
    border = "clamp" if clamp else "zero"
    x = (np.random.default_rng(2).standard_normal((outer, n * T, L)) * 0.01
         ).astype(np.float32)
    w_real = n * T - pad
    x[:, w_real:] = 0.0
    got = tf.DimPassCols(_mats(tf, scans, T, clamp), T, n, w_real).plain(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jf.dim_pass_cols(jnp.asarray(x),
                                       _mats(jf, scans, T, clamp), T, True,
                                       w_real=w_real))
    oracle = _pass_oracle(x, 1, scans, border, w_real)
    peak = np.abs(oracle).max()
    assert np.abs(got[:, :w_real] - oracle).max() <= 1e-6 * peak
    assert np.abs(want[:, :w_real] - oracle).max() <= 1e-5 * peak  # JAX
    assert np.abs(got - want).max() <= 1e-5 * peak


def _gauss_spec(mod, dims, axes, tiles, border="zero", times=1):
    scans = tuple(mod.Scan(ax, c, *G3) for ax in axes for _ in range(times)
                  for c in (True, False))
    return mod.FilterSpec("G", tuple(mod.Dim(nm, e) for nm, e in dims),
                          scans, border=border, tile_widths=tiles)


STRIP_FILTERS = {
    # label: (dims, scanned axes, tiles, border, routes)
    "2-D": ([("y", 256), ("x", 256)], (1, 0), (128, 128), "zero",
            ["rows", "cols"]),
    "2-D ragged": ([("y", 200), ("x", 300)], (0, 1), (48, 128), "zero",
                   ["cols", "rows"]),
    "2-D clamp": ([("y", 256), ("x", 256)], (1, 0), (64, 128), "clamp",
                  ["rows", "cols"]),
    "3-D middle axis": ([("c", 3), ("y", 96), ("x", 40)], (1,), (0, 32, 0),
                        "zero", ["cols"]),
    "3-D all axes": ([("z", 24), ("y", 40), ("x", 64)], (0, 1, 2),
                     (8, 16, 64), "zero", ["cols", "cols", "rows"]),
}


@pytest.mark.parametrize("case", list(STRIP_FILTERS))
def test_strip_filter_matches_jax(case):
    """StripFilter (the pallas backend) against ``fused.apply_filter`` in
    interpret mode and the oracle, with the routes the JAX package takes
    on the TPU (128 on the last axis, the split rounded to 8 elsewhere)."""
    dims, axes, tiles, border, routes = STRIP_FILTERS[case]
    ts = _gauss_spec(tspec, dims, axes, tiles, border)
    js = _gauss_spec(jspec, dims, axes, tiles, border)
    x = (np.random.default_rng(3).standard_normal([e for _, e in dims])
         * 0.01).astype(np.float32)
    mod = tf.StripFilter(ts)
    assert mod.routes == routes
    got = mod(torch.from_numpy(x)).numpy()
    want = np.asarray(jf.apply_filter(js, JPlan(backend="pallas",
                                                interpret=True),
                                      jnp.asarray(x)))
    oracle = jsc.oracle_apply(js, x.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    assert np.abs(got - want).max() <= 1e-5 * peak


@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_apply_dim_and_apply_filter_match_jax(border):
    """The functional forms: ``apply_dim`` on the middle axis of a 3-D
    array (the column pass over (lead, h, trail)) and ``apply_filter``,
    against the JAX package's ``fused.apply_dim`` / ``apply_filter``
    (interpret)."""
    dims, axes, tiles = [("c", 2), ("y", 64), ("x", 24)], (1,), (0, 16, 0)
    ts = _gauss_spec(tspec, dims, axes, tiles, border)
    js = _gauss_spec(jspec, dims, axes, tiles, border)
    x = (np.random.default_rng(6).standard_normal((2, 64, 24)) * 0.01
         ).astype(np.float32)
    got = tf.apply_dim(torch.from_numpy(x), ts, 1, [0, 1], 16).numpy()
    want = np.asarray(jf.apply_dim(jnp.asarray(x), js, 1, [0, 1], 16, True))
    oracle = jsc.oracle_apply(js, x.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    assert np.abs(got - want).max() <= 1e-5 * peak
    got = tf.apply_filter(ts, torch.from_numpy(x)).numpy()
    assert np.abs(got - oracle).max() <= 2e-6 * peak


def test_clamp_with_pad_takes_the_blocked_algebra(monkeypatch):
    """A clamp border on an extent the tile does not divide: every scan of
    that axis through ``tiling.BlockedScan`` (a spy counts them), as the
    JAX package's ``apply_dim`` takes ``tiling.tiled_apply_scan``; the
    dividing axis keeps its strip kernel."""
    calls = []
    fwd = ttl.BlockedScan.forward

    def spy(self, x):
        calls.append(self.axis)
        return fwd(self, x)

    monkeypatch.setattr(ttl.BlockedScan, "forward", spy)
    dims = [("y", 256), ("x", 200)]
    ts = _gauss_spec(tspec, dims, (1, 0), (128, 128), "clamp")
    js = _gauss_spec(jspec, dims, (1, 0), (128, 128), "clamp")
    x = (np.random.default_rng(4).standard_normal((256, 200)) * 0.01
         ).astype(np.float32)
    mod = tf.StripFilter(ts)
    assert mod.routes == ["blocked", "cols"]
    got = mod(torch.from_numpy(x)).numpy()
    assert calls == [1, 1]
    want = np.asarray(jf.apply_filter(js, JPlan(backend="pallas",
                                                interpret=True),
                                      jnp.asarray(x)))
    oracle = jsc.oracle_apply(js, x.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    assert np.abs(got - want).max() <= 1e-5 * peak


@pytest.mark.parametrize("lb,un", [(8, 1), (16, 4), (0, 100), (40, 2)])
def test_plan_knobs_line_block_and_unroll(lb, un):
    """Plan.line_block and Plan.unroll change no result (the JAX package's
    ``test_plan_knobs_line_block_and_unroll``), through the API."""
    x_d, y_d = rft.Dim("x", 16), rft.Dim("y", 24)
    img = np.random.default_rng(7).standard_normal((24, 16)).astype(
        np.float32)
    F = rft.RecFilter("K5")
    F[y_d, x_d] = img
    F.add_filter(+x_d, [0.9, 0.6, 0.25])
    F.add_filter(-x_d, [1.1, 0.5, 0.2])
    F.split(x_d, 4)
    F.set_plan(backend="pallas", line_block=lb, unroll=un)
    got = F.realize(device="cpu").numpy()
    want = rft.oracle_apply(F.spec, img.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_line_block_picker():
    """A request is quantised down to 16, 32 or 64 and clamped to the lines
    there are; the automatic choice is the largest block within 5 % of the
    fewest waves × lines per block (one block per SM at 128-row tiles:
    4096 lines run as 128 blocks of 32), and never exceeds what shared
    memory holds."""
    assert tf.pick_line_block(4096, 1, 128, 3, True, request=24) == 16
    assert tf.pick_line_block(4096, 1, 128, 3, True, request=40) == 32
    assert tf.pick_line_block(4096, 1, 128, 3, True, request=10**6) == 64
    assert tf.pick_line_block(20, 1, 128, 3, True, request=64) == 32
    assert tf.pick_line_block(4096, 1, 128, 3, True) == 32
    assert tf.pick_line_block(1080, 1, 128, 3, False) == 16
    assert tf.pick_line_block(65536, 1, 128, 3, True) == 64
    assert tf.pick_line_block(4096, 256, 128, 3, False) == 64
    for T, K in ((128, 3), (128, 32), (8, 8)):
        for rows in (True, False):
            lb = tf.pick_line_block(10**6, 1, T, K, rows)
            assert tf._smem(T, K, rows, lb) <= 232448


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32"])
def test_integers_take_the_core_bit_exact(dtype):
    """Integer filters under pallas run the sequential core in their own
    type: bit-equal to the JAX package's pallas executor and to numpy,
    wrapping as the type wraps (a coefficient of 3 overflows)."""
    info = np.iinfo(dtype)
    img = np.random.default_rng(5).integers(info.min // 2, info.max // 2,
                                            (24, 20)).astype(dtype)
    Fs = []
    for mod in (rft, jrf):
        x, y = mod.Dim("x", 20), mod.Dim("y", 24)
        F = mod.RecFilter("I")
        F[y, x] = img
        F.add_filter(+x, [1, 1])
        F.add_filter(-y, [3, 2])
        F.split(x, 8, y, 8)
        Fs.append(F)
    Ft, Fj = Fs
    got = Ft.set_plan(backend="pallas").realize(device="cpu").numpy()
    want = np.asarray(Fj.set_plan(backend="pallas", interpret=True).realize(
        jnp.asarray(img)))
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jsc.oracle_apply(Fj.spec, img))
