"""The port's cascade, Tuple and compute_at API against the JAX package's
(``tests/test_api.py``): ``fuse_cascade`` (``:356-396``),
``overlap_to_higher_order_filter`` (``:159-189``), ``compute_at``'s
dispatch and levels (``:495-602``), the Tuple routes (``:606-670``) and
``set_image``. Every case runs on the CPU (the kernels' twins).

The Tuple fold is taken by the epilogue's structure only: a clip at ±50 is
not linear, so it runs staged and is held to the f64 oracle of the staged
combine — the JAX package's numerical probe folds it (ROADMAP queue 3), so
that case is not compared with the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recfilter_tpu as jrf
from recfilter_tpu import api as japi
from recfilter_tpu import scan_core as jsc
from recfilter_tpu.apps.gaussian import gaussian_3x_3y as jgauss_3x_3y

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import api as tapi
from recfilter_tpu_torch.apps import gaussian_3x_3y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ fuse_cascade


@pytest.mark.parametrize("tile", [16, 32])
def test_fuse_cascade_equals_stage_composition(tile):
    """The merged filter equals the stages run one after another (clamp
    border), and the JAX package's ``fuse_cascade``."""
    img = np.random.default_rng(7).standard_normal((96, 96)).astype(
        np.float32)
    fc = gaussian_3x_3y(96, 96, tile)
    staged = _t(img)
    for f in fc:
        staged = f.as_func(device="cpu")(staged)
    fused = tapi.fuse_cascade(fc, device="cpu")(_t(img))
    np.testing.assert_allclose(fused.numpy(), staged.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(japi.fuse_cascade(jgauss_3x_3y(96, 96, tile))(
        jnp.asarray(img)))
    peak = np.abs(want).max()
    assert np.abs(fused.numpy() - want).max() <= 1e-5 * peak
    # the method form, and the merged plan's rotated emit reset
    fc[0].set_plan(rotate_emit=2)
    assert torch.equal(fc[0].fuse_cascade(*fc[1:], device="cpu")(_t(img)),
                       fused)


def _pair(border_b=False, dims_b=16, tuple_b=False):
    x, y = rft.Dim("x", 16), rft.Dim("y", 16)
    a = rft.RecFilter("A")
    a[y, x] = np.zeros((16, 16), np.float32)
    a.add_filter(+x, [1.0, 0.5])
    b = rft.RecFilter("B")
    if border_b:
        b.set_clamped_image_border()
    xb = rft.Dim("x", dims_b)
    zero = np.zeros((16, dims_b), np.float32)
    b[y, xb] = (zero, zero) if tuple_b else zero
    b.add_filter(+y, [1.0, 0.5])
    return a, b


@pytest.mark.parametrize("case", ["border", "dims", "tuple-width", "empty"])
def test_fuse_cascade_validation(case):
    with pytest.raises(ValueError):
        if case == "empty":
            tapi.fuse_cascade([], device="cpu")
        else:
            tapi.fuse_cascade(list(_pair(border_b=case == "border",
                                         dims_b=32 if case == "dims" else 16,
                                         tuple_b=case == "tuple-width")),
                              device="cpu")


# -------------------------------------------------- overlap to higher order


def _first_order(rf, name, img, coeff, causal=True):
    x1 = rf.Dim("x", img.shape[0])
    F = rf.RecFilter(name)
    F[x1] = img
    F.add_filter(+x1 if causal else -x1, coeff)
    return F, x1


def test_overlap_to_higher_order():
    """The overlapped filter equals the cascade A then B, and the JAX
    package's overlapped filter (``tests/test_overlap_filter_order.cpp``'s
    case, 8-wide tiles: the port runs tiled filters only)."""
    w = 16
    img = jrf.generate_random_image(w, lo=0, hi=1, seed=0)
    A, xa = _first_order(rft, "A", img, [1.0, 0.5])
    B, xb = _first_order(rft, "B", img, [1.0, 0.3, -0.1])
    A.split(xa, 8)
    B.split(xb, 8)
    O = A.overlap_to_higher_order_filter(B)
    assert O.spec.scans[0].order == 3 and O.name == "O"
    out_o = O.realize(img, device="cpu").numpy()
    out_c = B.realize(A.realize(img, device="cpu"), device="cpu").numpy()
    np.testing.assert_allclose(out_o, out_c, rtol=1e-4, atol=1e-5)
    Aj, _ = _first_order(jrf, "A", img, [1.0, 0.5])
    Bj, _ = _first_order(jrf, "B", img, [1.0, 0.3, -0.1])
    Oj = Aj.overlap_to_higher_order_filter(Bj)
    assert O.spec.scans == tuple(
        rft.Scan(s.axis, s.causal, s.feedfwd, tuple(s.feedback))
        for s in Oj.spec.scans)
    np.testing.assert_allclose(out_o, np.asarray(Oj.realize(img)),
                               rtol=1e-5, atol=1e-6)


def test_overlap_mismatch_raises():
    img = np.ones(16, np.float32)
    A, _ = _first_order(rft, "A", img, [1.0, 0.5])
    B, _ = _first_order(rft, "B", img, [1.0, 0.3], causal=False)
    with pytest.raises(ValueError):
        A.overlap_to_higher_order_filter(B)


# -------------------------------------------------------------- compute_at


def _ca_filter(rf, w, both=True, name="CA"):
    x, y = rf.Dim("x", w), rf.Dim("y", w)
    F = rf.RecFilter(name)
    F[y, x] = np.zeros((w, w), np.float32)
    wts = rf.gaussian_weights(3.0, 3)
    for d in ((+x, -x, +y, -y) if both else (+x, +y)):
        F.add_filter(d, wts)
    F.split(x, 16, y, 16)
    return F


def _combine(blur, image):
    return 2.0 * image - 1.0 * blur


def test_compute_at_routes_to_fusion_machinery():
    """An elementwise consumer becomes the epilogue, a tap bank the
    stencil2d fusion, an outer level or a non-elementwise consumer a
    composition with the reason logged; an unknown level raises. Values
    against the f64 oracle and the JAX package's routes."""
    w = 64
    img = np.random.default_rng(3).standard_normal((w, w)).astype(np.float32)
    F = _ca_filter(rft, w)
    fn = F.compute_at(_combine, device="cpu")
    assert fn.fused_route == "epilogue"
    got = fn(_t(img), _t(img)).numpy()
    want = 2.0 * img - jsc.oracle_apply(_ca_filter(jrf, w).spec,
                                        img.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    jfn = _ca_filter(jrf, w).compute_at(_combine)
    assert jfn.fused_route == "epilogue"
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(img),
                                                   jnp.asarray(img))),
                               rtol=2e-5, atol=2e-5)

    assert _ca_filter(rft, w).compute_at(
        _combine, level="intra", device="cpu").fused_route == "epilogue"
    f_outer = _ca_filter(rft, w).compute_at(_combine, level="outer",
                                            device="cpu")
    assert f_outer.fused_route == "composed"
    np.testing.assert_allclose(f_outer(_t(img), _t(img)).numpy(), want,
                               rtol=2e-5, atol=2e-5)

    F3 = _ca_filter(rft, w)
    f3 = F3.compute_at(lambda b: b.T, device="cpu")
    assert f3.fused_route == "composed"
    blur = got - 2.0 * img  # −blur, the filter's output negated
    np.testing.assert_allclose(f3(_t(img)).numpy(), -blur.T, rtol=2e-5,
                               atol=2e-5)

    f4 = _ca_filter(rft, w).compute_at([[(0, 0, 1.0), (1, 0, -1.0)]],
                                       device="cpu")
    assert f4.fused_route == "stencil2d"
    out = f4(_t(img))
    assert isinstance(out, tuple) and out[0].shape == (w, w)

    with pytest.raises(ValueError):
        _ca_filter(rft, w).compute_at(_combine, level="banana", device="cpu")


def test_compute_at_preserves_consumer_dtype_and_outer_bank():
    """A dtype-changing consumer (comparison, cast) composes and keeps its
    dtype; a dtype-keeping one fuses; a tap bank at an outer level
    composes with the fused route's values."""
    w = 64
    img = np.random.default_rng(7).standard_normal((w, w)).astype(np.float32)
    f_bool = _ca_filter(rft, w, False).compute_at(lambda b: b > 0.1,
                                                  device="cpu")
    assert f_bool.fused_route == "composed"
    out = f_bool(_t(img))
    assert out.dtype == torch.bool
    blur = jsc.oracle_apply(_ca_filter(jrf, w, False).spec,
                            img.astype(np.float64)).astype(np.float32)
    # the filter's px6 output against the oracle: the threshold agrees
    # away from 0.1
    far = np.abs(blur - 0.1) > 1e-5
    np.testing.assert_array_equal(out.numpy()[far], (blur > 0.1)[far])
    f_cast = _ca_filter(rft, w, False).compute_at(
        lambda b: b.to(torch.bfloat16), device="cpu")
    assert f_cast.fused_route == "composed"
    assert f_cast(_t(img)).dtype == torch.bfloat16
    assert _ca_filter(rft, w, False).compute_at(
        lambda b: 2.0 * b, device="cpu").fused_route == "epilogue"

    bank = [[(0, 0, 1.0), (1, 0, -1.0)]]
    f_fused = _ca_filter(rft, w, False).compute_at(bank, device="cpu")
    f_outer = _ca_filter(rft, w, False).compute_at(bank, level="outer",
                                                   device="cpu")
    assert f_fused.fused_route == "stencil2d"
    assert f_outer.fused_route == "composed"
    np.testing.assert_allclose(f_fused(_t(img))[0].numpy(),
                               f_outer(_t(img))[0].numpy(), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------------------------ Tuples


def _tuple_filter(rf, a, b, name="TupDoG"):
    w = a.shape[0]
    x, y = rf.Dim("x", w), rf.Dim("y", w)
    F = rf.RecFilter(name)
    F[y, x] = (a, b)
    F.add_filter(+x, [0.8, 0.4])
    F.add_filter(+y, [0.8, 0.4])
    F.split(x, 128, y, 128)
    return F


def _components(seed=12, w=256, scale=0.1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((w, w)) * scale).astype(np.float32)
            for _ in range(2)]


def _component_oracle(F, comps):
    one = rft.FilterSpec(F.spec.name, F.spec.dims, F.spec.scans,
                         F.spec.border, F.spec.dtype, F.spec.tile_widths)
    return [rft.oracle_apply(one, c.astype(np.float64)) for c in comps]


def test_tuple_plain_returns_components():
    a, b = _components()
    F = _tuple_filter(rft, a, b)
    mod = F.as_func(device="cpu")
    assert isinstance(mod, rft.TupleFilter) and mod.tuple_route == "plain"
    got = mod((_t(a), _t(b)))
    assert isinstance(got, tuple) and len(got) == 2
    stacked = mod(torch.stack([_t(a), _t(b)]))
    want = japi.RecFilter.as_func(_tuple_filter(jrf, a, b))((a, b))
    for g, s, wj, o in zip(got, stacked, want, _component_oracle(F, (a, b))):
        assert torch.equal(g, s)
        peak = np.abs(o).max()
        assert np.abs(g.numpy() - o).max() <= 2e-6 * peak
        assert np.abs(g.numpy() - np.asarray(wj)).max() <= 1e-5 * peak
    # realize runs the bound components
    r = F.realize(device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(r, got))


def test_tuple_epilogue_linear_folds_and_staged():
    """A linear combine of the components folds into the input: one
    single-component pass (the 3-touch executor), within 5e-6 of the
    component-wise oracle's peak; a nonlinear one runs staged."""
    a, b = _components()
    F = _tuple_filter(rft, a, b)
    fn = F.as_func(epilogue=lambda u, v: 2.0 * u - 3.0 * v, device="cpu")
    assert fn.tuple_route == "linear-folded"
    assert isinstance(fn.body, rft.Fused2DPx)
    assert fn.weights == (2.0, -3.0)
    got = fn((_t(a), _t(b))).numpy()
    ua, ub = _component_oracle(F, (a, b))
    want = 2.0 * ua - 3.0 * ub
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-6 * np.abs(want).max()
    jfn = _tuple_filter(jrf, a, b).as_func(
        epilogue=lambda u, v: 2.0 * u - 3.0 * v)
    assert jfn.tuple_route == "linear-folded"
    assert np.abs(got - np.asarray(jfn((a, b)))).max() <= 1e-5 * np.abs(
        want).max()

    fn_nl = F.as_func(epilogue=lambda u, v: u * v, device="cpu")
    assert fn_nl.tuple_route == "staged"
    got_nl = fn_nl((_t(a), _t(b))).numpy()
    want_nl = ua * ub
    assert np.abs(got_nl - want_nl).max() <= 1e-5 * np.abs(want_nl).max()
    jnl = _tuple_filter(jrf, a, b).as_func(epilogue=lambda u, v: u * v)
    assert jnl.tuple_route == "staged"
    assert np.abs(got_nl - np.asarray(jnl((a, b)))).max() <= 1e-5 * np.abs(
        want_nl).max()


def test_tuple_clip_is_not_folded():
    """clamp(2u − 3v, −50, 50) on components large enough for the clip to
    bind: staged, and held to the f64 oracle of the staged combine."""
    a, b = _components(seed=13, scale=100.0)
    F = _tuple_filter(rft, a, b)
    fn = F.as_func(epilogue=lambda u, v: torch.clamp(2 * u - 3 * v, -50, 50),
                   device="cpu")
    assert fn.tuple_route == "staged"
    got = fn((_t(a), _t(b))).numpy()
    ua, ub = _component_oracle(F, (a, b))
    lin = 2.0 * ua - 3.0 * ub
    want = np.clip(lin, -50, 50)
    assert (np.abs(lin) > 50).mean() > 0.1  # the clip binds
    assert np.abs(got - want).max() <= 5e-6 * np.abs(lin).max()


def test_tuple_definition_checks():
    a, b = _components(w=32)
    x, y = rft.Dim("x", 32), rft.Dim("y", 32)
    F = rft.RecFilter("T")
    with pytest.raises(ValueError, match="identical shape and dtype"):
        F[y, x] = (a, b[:16])
    with pytest.raises(ValueError, match="identical shape and dtype"):
        F[y, x] = (a, b.astype(np.float64))
    F[y, x] = (a, _t(b))  # a tensor component stacks as a tensor
    assert F.spec.tuple_width == 2 and isinstance(F._image, torch.Tensor)
    F.add_filter(+x, [0.8, 0.4])
    F.split(x, 16)
    with pytest.raises(ValueError, match="no stencil"):
        F.as_func(stencil2d=[[(0, 0, 1.0)]], device="cpu")


# --------------------------------------------------------------- set_image


def test_set_image_rebinds_the_input():
    w = 64
    F = _ca_filter(rft, w)
    img = np.random.default_rng(5).standard_normal((w, w)).astype(np.float32)
    F.set_image(img)
    got = F.realize(device="cpu").numpy()
    want = jsc.oracle_apply(_ca_filter(jrf, w).spec, img.astype(np.float64))
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    with pytest.raises(ValueError, match="does not match"):
        F.set_image(np.zeros((w, w + 1), np.float32))
    # a Tuple filter takes its components
    a, b = _components(w=256)
    T = _tuple_filter(rft, a, a)
    T.set_image((a, b))
    ga, gb = T.realize(device="cpu")
    ua, ub = _component_oracle(T, (a, b))
    assert np.abs(gb.numpy() - ub).max() <= 2e-6 * np.abs(ub).max()
