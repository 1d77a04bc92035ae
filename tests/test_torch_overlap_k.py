"""The ``overlap`` / ``overlap_k`` backends against the JAX package.

The HIGHEST pair's twins (``moments2d_k`` / ``final2d_k``) against the JAX
package's ``moments2d`` / ``final2d`` in interpret mode at 1e-6 of the
peak; ``OverlapFilter`` against ``overlap2d.apply_filter_overlap`` (with
and without kernels) at 1e-5 of the peak — the JAX package's float32 glue
sits up to ~5e-6 from the f64 oracle on the σ=5 Gaussian, the port's
float64 glue within the px6 bound 2e-6 (both checked); the routes against
the JAX package's, read by spies on its executors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recfilter_tpu as jrf
from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import overlap2d as jo
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import final2d as jk

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import overlap2d as to
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.kernels import final2d as tk

W3 = rft.gaussian_weights(5.0, 3)
G3 = (float(W3[0]), tuple(float(c) for c in W3[1:]))


def _pair_mats(Ta, K, na, nb, clamp):
    reps = K // 6
    a = [tspec.Scan(0, c, *G3) for _ in range(reps) for c in (True, False)]
    b = [tspec.Scan(1, c, 0.9, (0.6, 0.25, -0.1)) for _ in range(reps)
         for c in (True, False)]
    ma = tdf.prepare_dim_pass(a, Ta, na, clamp)
    mb = tdf.prepare_dim_pass(b, 128, nb, clamp)
    return ma, mb, to._cat_mats(ma), to._cat_mats(mb)


@pytest.mark.parametrize("Ta", [32, 128])
@pytest.mark.parametrize("K", [6, 12])
@pytest.mark.parametrize("clamp", [False, True])
def test_highest_pair_twins_match_jax(Ta, K, clamp):
    """Moments2DK / Final2DK's twins against ``moments2d`` / ``final2d``
    (interpret): 1e-6 of the peak (the moments twin sums in float64, the
    JAX kernel in float32)."""
    p, na, nb = 2, 3, 2
    ma, mb, (Ga, Ra), (Gb, Rb) = _pair_mats(Ta, K, na, nb, clamp)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((p, na, Ta, nb * 128)).astype(np.float32)
    want = jk.moments2d(jnp.asarray(x), Ga, Gb, True)
    got = tk.Moments2DK(Ga, Gb, na, nb)(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max()
    NA = rng.standard_normal((p, na, K, nb * 128)).astype(np.float32)
    NB = rng.standard_normal((p, na, nb, Ta, K)).astype(np.float32)
    want = np.asarray(jk.final2d(jnp.asarray(x), ma.Btot, Ra, mb.Btot, Rb,
                                 jnp.asarray(NA), jnp.asarray(NB), True))
    got = tk.Final2DK(ma.Btot, Ra, mb.Btot, Rb, na, nb)(
        torch.from_numpy(x), torch.from_numpy(NA), torch.from_numpy(NB))
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def _spec(mod, dims, axes, tiles, border="zero", times=1, coeff=G3):
    scans = tuple(mod.Scan(ax, c, *coeff) for ax in axes
                  for _ in range(times) for c in (True, False))
    return mod.FilterSpec("O", tuple(mod.Dim(nm, e) for nm, e in dims),
                          scans, border=border, tile_widths=tiles)


SAT = (1.0, (1.0,))
OVERLAP = {
    # label: (dims, scanned axes in order, tiles, border, coefficients)
    "sat": ([("y", 96), ("x", 256)], (1, 0), (32, 128), "zero", SAT),
    "gauss": ([("y", 256), ("x", 256)], (1, 0), (128, 128), "zero", G3),
    "gauss-clamp": ([("y", 256), ("x", 256)], (0, 1), (64, 128), "clamp",
                    G3),
    "non-dividing": ([("y", 200), ("x", 300)], (1, 0), (0, 128), "zero", G3),
    "batch-axis": ([("c", 2), ("y", 128), ("x", 256)], (1, 2), (0, 32, 128),
                   "zero", G3),
    "3-D": ([("z", 24), ("y", 40), ("x", 128)], (0, 1, 2), (8, 16, 128),
            "zero", G3),
}


@pytest.mark.parametrize("case", list(OVERLAP))
@pytest.mark.parametrize("kernels,precision", [(False, "highest"),
                                               (True, "px6"),
                                               (True, "highest")])
def test_apply_filter_overlap_matches_jax(case, kernels, precision):
    dims, axes, tiles, border, coeff = OVERLAP[case]
    ts = _spec(tspec, dims, axes, tiles, border, coeff=coeff)
    js = _spec(jspec, dims, axes, tiles, border, coeff=coeff)
    x = (np.random.default_rng(1).standard_normal([e for _, e in dims])
         * 0.01).astype(np.float32)
    got = to.apply_filter_overlap(ts, torch.from_numpy(x),
                                  use_kernels=kernels,
                                  matmul_precision=precision).numpy()
    want = np.asarray(jo.apply_filter_overlap(
        js, jnp.asarray(x), use_kernels=kernels, interpret=True,
        matmul_precision=precision))
    oracle = jsc.oracle_apply(js, x.astype(np.float64))
    peak = np.abs(oracle).max()
    assert got.shape == want.shape
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    assert np.abs(want - oracle).max() <= 1e-5 * peak  # the JAX side
    assert np.abs(got - want).max() <= 1e-5 * peak


def test_fused_nd_pass_matches_jax():
    """``fused_nd_pass`` on a 3-D filter (every axis's carries from one
    read), and its refusal of a clamp border with pad, as the JAX
    package's."""
    dims = [("z", 20), ("y", 24), ("x", 32)]
    groups = [(0, G3, 8), (1, (0.9, (0.6, 0.25, -0.1)), 16), (2, G3, 16)]
    x = (np.random.default_rng(2).standard_normal((20, 24, 32)) * 0.01
         ).astype(np.float32)
    js = _spec(jspec, dims, (0, 1, 2), (0, 0, 0))
    tg = [(ax, [tspec.Scan(ax, c, *co) for c in (True, False)], T)
          for ax, co, T in groups]
    jg = [(ax, [jspec.Scan(ax, c, *co) for c in (True, False)], T)
          for ax, co, T in groups]
    got = to.fused_nd_pass(torch.from_numpy(x), tg).numpy()
    want = np.asarray(jo.fused_nd_pass(jnp.asarray(x), jg))
    spec = jspec.FilterSpec("N", js.dims, tuple(s for _, sc, _ in jg
                                                for s in sc))
    oracle = jsc.oracle_apply(spec, x.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    assert np.abs(got - want).max() <= 1e-5 * peak
    assert to.fused_nd_pass(torch.from_numpy(x), tg, "clamp") is None
    assert jo.fused_nd_pass(jnp.asarray(x), jg, "clamp") is None


def _port_routes(mod):
    out = []
    for st in mod.stages:
        body = st.body if isinstance(st, to._Swapped) else st
        name = type(body).__name__
        out.append(f"{name}({body.route})"
                   if name in ("StagedPass", "OverlapND") else name)
    return out


ROUTES = {
    # label: (h, w, clamp, times, precision, port route, JAX calls)
    "px": (256, 256, False, 1, "px6", ["Fused2DPx"], ["fused_2d_px"]),
    "highest": (256, 256, False, 1, "highest", ["Fused2DK"],
                ["kernel_path"]),
    # the JAX package's map sends only px3, px4 and px6 to its px pair
    "default": (256, 256, False, 1, "default", ["Fused2DK"],
                ["kernel_path"]),
    "carries-over-8": (256, 256, False, 2, "px6", ["Fused2DK"],
                       ["fused_2d_px:None", "kernel_path"]),
    "clamp-with-pad": (200, 256, True, 1, "px6",
                       ["StagedPass(pair-fallback)"],
                       ["fused_2d_px:None", "fused_dim_pass",
                        "fused_dim_pass"]),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_overlap_k_routes_as_the_jax_package(case, monkeypatch):
    """The pair's route under ``overlap_k``, against the JAX package's
    (spies on ``fused_2d_px``, ``_fused_2d_kernel_path`` and
    ``dimfuse.fused_dim_pass``): px6 → the px pair (``Fused2DPx``);
    ``highest``, ``default`` or more than 8 carries → the HIGHEST pair
    (``Fused2DK``); a clamp border with pad → two dimension passes."""
    h, w, clamp, times, precision, route, calls = ROUTES[case]
    seen = []
    for name, label in ((("fused_2d_px", "fused_2d_px"),
                         ("_fused_2d_kernel_path", "kernel_path"))):
        real = getattr(jo, name)

        def spy(*a, _real=real, _label=label, **kw):
            y = _real(*a, **kw)
            seen.append(_label if y is not None else f"{_label}:None")
            return y

        monkeypatch.setattr(jo, name, spy)
    real_dim = jdf.fused_dim_pass

    def dim_spy(*a, **kw):
        seen.append("fused_dim_pass")
        return real_dim(*a, **kw)

    monkeypatch.setattr(jdf, "fused_dim_pass", dim_spy)
    dims = [("y", h), ("x", w)]
    ts = _spec(tspec, dims, (1, 0), (128, 128),
               "clamp" if clamp else "zero", times)
    js = _spec(jspec, dims, (1, 0), (128, 128),
               "clamp" if clamp else "zero", times)
    x = (np.random.default_rng(3).standard_normal((h, w)) * 0.01).astype(
        np.float32)
    mod = to.OverlapFilter(ts, use_kernels=True, matmul_precision=precision)
    assert _port_routes(mod) == route
    got = mod(torch.from_numpy(x)).numpy()
    want = np.asarray(jo.apply_filter_overlap(
        js, jnp.asarray(x), use_kernels=True, interpret=True,
        matmul_precision=precision))
    assert seen == calls
    oracle = jsc.oracle_apply(js, x.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    assert np.abs(got - want).max() <= 1e-5 * peak


def test_overlap_three_axes_routes():
    """Three scanned axes: ``overlap`` reads every carry from one pass
    (``OverlapND``, route ``nd``); ``overlap_k`` pairs the first two (the
    einsum form, ``OverlapND`` on two axes: not the trailing pair) and
    runs the third as a dimension pass."""
    dims, axes, tiles, border, coeff = OVERLAP["3-D"]
    ts = _spec(tspec, dims, axes, tiles, border, coeff=coeff)
    assert _port_routes(to.OverlapFilter(ts)) == ["OverlapND(nd)"]
    assert _port_routes(to.OverlapFilter(ts, use_kernels=True)) == [
        "OverlapND(pair)", "FusedLastAxis"]


def test_matmul_dtype_bfloat16_raises():
    """bf16 products (the JAX package's ``matmul_dtype``), which raised
    before they were ported (the name kept): the plan takes them, the
    ``overlap_k`` backend's HIGHEST pair runs ``final2d_k_bf16``'s twin
    and the other backends read no ``matmul_dtype``, as in the JAX
    package; an unknown dtype still raises."""
    assert rft.Plan(matmul_dtype="bfloat16").matmul_dtype == "bfloat16"
    with pytest.raises(ValueError):
        rft.Plan(matmul_dtype="float16")
    img = (np.random.default_rng(5).standard_normal((128, 256)) * 0.01
           ).astype(np.float32)
    outs = {}
    for backend, dt in (("overlap_k", "bfloat16"), ("overlap_k", "float32"),
                        ("einsum", "bfloat16"), ("einsum", "float32")):
        F = rft.RecFilter("B")
        x, y = rft.Dim("x", 256), rft.Dim("y", 128)
        F[y, x] = img
        for d in (+y, -y, +x, -x):
            F.add_filter(d, W3)
        F.split(x, 128, y, 128)
        F.set_plan(backend=backend, matmul_dtype=dt,
                   matmul_precision="highest")
        mod = F.as_func(device="cpu")
        if backend == "overlap_k":
            assert _port_routes(mod) == ["Fused2DK"]
            body = mod.stages[0]
            assert body.final.bf16 == (dt == "bfloat16")
        outs[backend, dt] = mod(torch.from_numpy(img))
    assert torch.equal(outs["einsum", "bfloat16"], outs["einsum", "float32"])
    assert not torch.equal(outs["overlap_k", "bfloat16"],
                           outs["overlap_k", "float32"])


def test_highest_pair_past_its_shapes_raises():
    """A leading tile above 128 (``split(y, 256)``) on the HIGHEST pair
    raises, naming the Queue 2 line; it routes nowhere else."""
    img = np.zeros((512, 256), np.float32)
    x, y = rft.Dim("x", 256), rft.Dim("y", 512)
    F = rft.RecFilter("G")
    F[y, x] = img
    for d in (+y, -y, +x, -x):
        F.add_filter(d, W3)
    F.split(x, 128, y, 256)
    F.set_plan(backend="overlap_k", matmul_precision="highest")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        F.as_func(device="cpu")
    F.split(y, 128)
    assert _port_routes(F.as_func(device="cpu")) == ["Fused2DK"]


def test_overlap_k_through_the_api_matches_jax():
    """``set_plan(backend="overlap_k", matmul_precision="highest")`` on
    the headline filter, through ``as_func``, against the JAX package's
    ``realize()`` (interpret) and the oracle."""
    img = (np.random.default_rng(4).standard_normal((256, 384)) * 0.01
           ).astype(np.float32)
    Fs = []
    for mod in (rft, jrf):
        x, y = mod.Dim("x", 384), mod.Dim("y", 256)
        F = mod.RecFilter("G")
        F[y, x] = img
        for d in (+x, -x, +y, -y):
            F.add_filter(d, W3)
        F.split(x, 128, y, 128)
        F.set_plan(backend="overlap_k", matmul_precision="highest")
        Fs.append(F)
    Ft, Fj = Fs
    Fj.set_plan(interpret=True)
    got = Ft.realize(device="cpu").numpy()
    want = np.asarray(Fj.realize(jnp.asarray(img)))
    oracle = jsc.oracle_apply(Fj.spec, img.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    assert np.abs(got - want).max() <= 1e-5 * peak
