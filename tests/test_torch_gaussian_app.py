"""The port's Gaussian app (``recfilter_tpu_torch/apps/gaussian.py``) and
the ``RecFilter`` cascade API it is built on, against the JAX package's.

Each variant runs at 256² through both packages (px6; the JAX package's
Pallas kernels in interpret mode) and is held to the f64 oracle of its
whole filter — the scans of every stage applied once, which the cascade
equals algebraically. Bound against the oracle: rtol=2e-5,
atol=2e-6·peak, the px6 bound. On these σ=5 Gaussians the JAX px6 path
itself sits a few 1e-6 from the oracle (ROADMAP Queue 3), so the two
packages are held to each other at 1e-5·peak.
"""

import numpy as np
import pytest
import torch

from recfilter_tpu import scan_core as jsc
from recfilter_tpu.apps import gaussian as jg
from recfilter_tpu.spec import FilterSpec as JSpec

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import overlap2d as to2
from recfilter_tpu_torch import planner
from recfilter_tpu_torch.apps import gaussian as tg

W = H = 256
VARIANTS = ["3x_3y", "1xy_2xy", "1xy_2x_2y", "1xy_1xy_1xy"]


def _img(seed=0):
    return (np.random.default_rng(seed).standard_normal((H, W)) * 0.1
            ).astype(np.float32)


def _whole(fc):
    """The JAX spec of a cascade's whole filter: every stage's scans."""
    s = fc[0].spec
    return JSpec("whole", s.dims, sum((f.spec.scans for f in fc), ()),
                 border=s.border, tile_widths=s.tile_widths)


def _sig(f):
    """A filter's definition as plain tuples, comparable across packages."""
    s = f.spec
    return (s.border, s.tile_widths, [(c.axis, c.causal, c.feedfwd,
                                       tuple(c.feedback)) for c in s.scans])


def _check_oracle(got, spec, x):
    want = jsc.oracle_apply(spec, x.astype(np.float64)).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())


def _check_jax(got, want):
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# stage executors: overlapped stages on the 2-D executor, x-only on the
# last-axis executor, y-only on the rows pass
ROUTES = {
    "3x_3y": ["FusedLastAxis", "FusedRowsPx"],
    "1xy_2xy": ["Fused2DPx", "Fused2DPx"],
    "1xy_2x_2y": ["Fused2DPx", "FusedLastAxis", "FusedRowsPx"],
    "1xy_1xy_1xy": ["Fused2DPx"] * 3,
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_cascade_variant_matches_jax_and_oracle(variant):
    x = _img(VARIANTS.index(variant))
    fc = getattr(tg, f"gaussian_{variant}")(W, H)
    fj = getattr(jg, f"gaussian_{variant}")(W, H, 128)
    assert [type(f.as_func(device="cpu")).__name__ for f in fc] == ROUTES[variant]
    assert [_sig(f) for f in fc] == [_sig(f) for f in fj]
    got = tg.run_cascade(fc, x, device="cpu")
    assert got.shape == (H, W) and got.device.type == "cpu"
    got = got.numpy().astype(np.float64)
    _check_jax(got, jg.run_cascade(fj, x))
    _check_oracle(got, _whole(fj), x)


def test_3x_3y_equals_3xy():
    """Cascading by dimension regroups commuting scans: 3x_3y is the
    filter of 3xy, and both sit on the oracle of 3xy."""
    x = _img(7)
    F = tg.gaussian_3xy(W, H)
    assert isinstance(F.as_func(device="cpu"), to2.Fused2DPx)
    y3 = F.realize(x, device="cpu").numpy().astype(np.float64)
    y33 = tg.run_cascade(tg.gaussian_3x_3y(W, H), x,
                         device="cpu").numpy().astype(np.float64)
    spec = jg.gaussian_3xy(W, H, 128).spec
    _check_oracle(y3, spec, x)
    _check_oracle(y33, spec, x)
    _check_jax(y3, jg.gaussian_3xy(W, H, 128).realize(x))


def test_3xy_rgb_matches_jax_per_channel():
    chw = np.stack([_img(s) for s in range(3)])
    F = tg.gaussian_3xy_rgb(W, H)
    got = F.realize(chw, device="cpu").numpy().astype(np.float64)
    _check_jax(got, jg.gaussian_3xy_rgb(W, H, 128).realize(chw))
    spec = jg.gaussian_3xy(W, H, 128).spec
    for c in range(3):
        _check_oracle(got[c], spec, chw[c])


def test_tile_width_resolves_to_the_kernels_tile():
    assert planner.auto_tile_width(4096) == 128
    assert planner.auto_tile_width(100) == 100
    for f in tg.gaussian_1xy_2x_2y(W, H):  # scanned axes tiled by 128
        assert {f.spec.tile_widths[s.axis] for s in f.spec.scans} == {128}


def test_chained_realize_runs_the_parent_first():
    """A cascade stage realized with no input filters its parent's output,
    as in the JAX package."""
    img = _img(3)
    x, y = rft.Dim("x", W), rft.Dim("y", H)
    F = rft.RecFilter("G")
    F.set_clamped_image_border()
    F[y, x] = img
    for d in (+x, -x, +y, -y):
        F.add_filter(d, rft.gaussian_weights(5.0, 3))
    fc = F.cascade_by_dimension()
    for f in fc:
        f.split_all_dimensions(128)
    got = fc[-1].realize(device="cpu").numpy().astype(np.float64)
    _check_oracle(got, jg.gaussian_3xy(W, H, 128).spec, img)


def test_run_cascade_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal applies without it")
    fc = tg.gaussian_3x_3y(W, H)
    with pytest.raises(RuntimeError, match="cuda"):
        tg.run_cascade(fc, _img())
    with pytest.raises(RuntimeError, match="cuda"):
        fc[0].realize(_img())


def _two_scan_filter(mod):
    x = mod.Dim("x", 8)
    F = mod.RecFilter("C")
    F[x] = np.ones(8, dtype=np.float32)
    F.add_filter(+x, [1.0, 0.5])
    F.add_filter(-x, [1.0, 0.4])
    return F


@pytest.mark.parametrize("groups", [([1], [0]), ([0],), ([0, 1], [1])],
                         ids=["swap-opposite", "drop", "duplicate"])
def test_cascade_legality_errors(groups):
    """The JAX package's legality checks: every scan exactly once, and
    opposite-causality scans of one dimension keep their order."""
    import recfilter_tpu as jrf

    for mod in (jrf, rft):
        with pytest.raises(ValueError, match="cascade"):
            _two_scan_filter(mod).cascade(*groups)


def test_cascade_by_causality_and_dimension():
    x = rft.Dim("x", 128)
    y = rft.Dim("y", 128)
    F = rft.RecFilter("C")
    img = _img()[:128, :128]
    F[y, x] = img
    F.add_filter(+x, [1.0, 0.5])
    F.add_filter(-x, [1.0, 0.4])
    F.add_filter(+y, [1.0, 0.3])
    fc = F.cascade_by_causality()
    assert len(fc) == 2 and fc[1]._chain_parent is fc[0]
    assert all(s.causal for s in fc[0].spec.scans)
    assert not any(s.causal for s in fc[1].spec.scans)
    dims = F.cascade_by_dimension()
    assert [[s.axis for s in f.spec.scans] for f in dims] == [[1, 1], [0]]
    for chain in (fc, dims):
        for f in chain:
            f.split_all_dimensions(128)
        assert {chain[-1].spec.tile_widths[s.axis]
                for s in chain[-1].spec.scans} == {128}
        got = chain[-1].realize(device="cpu").numpy().astype(np.float64)
        _check_oracle(got, F.spec, img)
    assert isinstance(dims[-1].as_func(device="cpu"), to2.FusedRowsPx)
    assert isinstance(dims[0].as_func(device="cpu"), tdf.FusedLastAxis)
