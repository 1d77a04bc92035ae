"""The port's integer route (``dimfuse.IntUnitPass`` on
``kernels/int_scan.py``) against the JAX package's ``apply_filter_int_exact``
and the integer oracle: bit-exact, modulo 2^k.

Same seeded numpy inputs through the JAX package (the Pallas kernels in
interpret mode, as ``tests/test_int_exact.py`` runs them) and through the
port's plain twins on the CPU, which compute in int64 and mask to 32 bits.
The CUDA kernels are held to these twins on a card by
``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import int_scan as jis

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import scan_core as tsc
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.apps import summed_table
from recfilter_tpu_torch.kernels import int_scan as tis


def _specs(dims, scans, dtype, tiles, border="zero"):
    """The same filter as a JAX-package spec and a port spec."""
    return [m.FilterSpec("U", tuple(m.Dim(n, e) for n, e in dims),
                         tuple(m.Scan(*s) for s in scans), border=border,
                         dtype=dtype, tile_widths=tiles)
            for m in (jspec, tspec)]


def _ints(shape, lo, hi, dtype, seed):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def _spy(monkeypatch, name):
    """Record the axis of every call of ``kernels.int_scan.<name>``."""
    calls = []
    orig = getattr(tis, name)

    def spy(x, scans, axis):
        calls.append(axis)
        return orig(x, scans, axis)

    monkeypatch.setattr(tis, name, spy)
    return calls


CASES = {
    # name: (dims, scans, dtype, tiles, value range, axes of the route)
    "sat-int32": ((("y", 192), ("x", 256)),
                  ((1, True, 1, (1,)), (0, True, 1, (1,))), "int32",
                  (64, 128), 2 ** 27, [1, 0]),
    "sat-int16": ((("y", 192), ("x", 256)),
                  ((1, True, 1, (1,)), (0, True, 1, (1,))), "int16",
                  (64, 128), 2 ** 12, [1, 0]),
    "sat-int8": ((("y", 192), ("x", 256)),
                 ((1, True, 1, (1,)), (0, True, 1, (1,))), "int8",
                 (64, 128), 100, [1, 0]),
    "alternating": ((("y", 64), ("x", 192)),
                    ((1, True, 2, (-1,)), (1, False, 1, (-1,)),
                     (1, False, 3, (1,))), "int32", (0, 64), 2 ** 20, [1]),
    "alternating-int8": ((("y", 96), ("x", 130)),
                         ((0, False, -3, (-1,)), (1, True, 5, (1,)),
                          (0, True, 1, (-1,))), "int8", (32, 0), 128, [0, 1]),
    "volume": ((("z", 16), ("y", 64), ("x", 128)),
               ((2, True, 1, (1,)), (1, True, 1, (1,)), (0, True, 1, (1,))),
               "int32", (0, 0, 64), 1000, [2, 1, 0]),
    "higher-order": ((("y", 64), ("x", 128)),
                     ((1, True, 1, (0, 1)), (0, True, 1, (3, -3, 1))),
                     "int16", (0, 64), 2 ** 10, [1, 0]),
    "segmented-lanes": ((("c", 4), ("x", 300_001)),
                        ((1, True, 1, (1,)),), "int32", (0, 4096), 1000,
                        [1]),
    "segmented-rows": ((("y", 8190), ("x", 64)),
                       ((0, False, 2, (-1,)),), "int32", (128, 64), 1000,
                       [0]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_unit_route_matches_jax_and_oracle(case, monkeypatch):
    """Bit-exact against ``apply_filter_int_exact`` and the integer oracle,
    one stage per scanned axis in the JAX package's order."""
    dims, scans, dtype, tiles, hi, axes = CASES[case]
    js, ts = _specs(dims, scans, dtype, tiles)
    img = _ints(tuple(e for _, e in dims), -hi, hi, dtype, seed=len(case))
    want = np.asarray(jdf.apply_filter_fused(js, img))
    calls = _spy(monkeypatch, "int_unit_dim_pass")
    mod = tdf.fused_filter_module(ts)
    assert isinstance(mod, tdf.IntUnitPass)
    got = mod(torch.from_numpy(img))
    assert calls == axes
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tsc.oracle_apply(ts, img))
    np.testing.assert_array_equal(mod.forward_plain(torch.from_numpy(img)),
                                  want)


def test_segmented_route_beyond_the_gates(monkeypatch):
    """Past 65,536 on the last axis and 4,096 on another, the route is
    segmented, one scan at a time, as in the JAX package."""
    seen = _spy(monkeypatch, "_segmented_unit_scan")
    x = torch.from_numpy(_ints((2, 100_000), -9, 9, np.int32, seed=1))
    y = tis.int_unit_dim_pass(x, [(1, 1, True), (1, -1, False)], 1)
    assert seen == [1, 1]
    np.testing.assert_array_equal(
        y.numpy(), tis.unit_scans_plain(x, [(1, 1, True), (1, -1, False)], 1))
    for shape, axis, seg in (((65_536, 2), 0, [0]), ((4097, 3), 0, [0]),
                             ((4096, 3), 0, []), ((2, 65_536), 1, [])):
        seen.clear()
        tis.int_unit_dim_pass(torch.zeros(shape, dtype=torch.int32),
                              [(1, 1, True)], axis)
        assert seen == seg, shape


@pytest.mark.parametrize("layout_shape,axis", [((3, 1000), 1),
                                               ((2, 1000, 5), 1)])
@pytest.mark.parametrize("unit", [(1, 1, True), (1, 1, False), (2, -1, True),
                                  (-3, -1, False)])
@pytest.mark.parametrize("C", [128, 256])
def test_segmented_phases_compose(layout_shape, axis, unit, C):
    """The chunk exits, the carry chain and the fix phase give the
    full-extent scan for any even chunk, ragged last chunk included."""
    x = torch.from_numpy(_ints(layout_shape, -2 ** 31, 2 ** 31, np.int64,
                               seed=C)).to(torch.int32)
    layout, P, E, W = tis._layout(x, axis)
    xr = x.reshape((P, E) if layout == 0 else (P, E, W))
    inc = tis._carry_chain(tis.seg_carries_plain(xr, unit, layout, C),
                           unit[2])
    got = tis.seg_fix_plain(xr, inc, unit, layout, C).reshape(x.shape)
    np.testing.assert_array_equal(got.numpy(),
                                  tis.unit_scans_plain(x, [unit], axis))


def test_unit_scans_of_equals_the_jax_packages():
    for fb, ff in (((1,), 1), ((-1,), 3), ((2, -1), 3), ((0, 1), 1),
                   ((3, -3, 1), 1), ((1, 1), 1), ((0.5,), 1), ((1,), 0.5),
                   ((1,) * 9, 1), ((-2, -1), -2)):
        for causal in (True, False):
            t = tis.unit_scans_of(tspec.Scan(0, causal, ff, fb))
            j = jis.unit_scans_of(jspec.Scan(0, causal, ff, fb))
            assert t == j, (fb, ff, causal)


def test_chunk_length_and_extent_one():
    """The chunk rule of the JAX package (10M → 3,200), and extent-1 axes,
    where the scans reduce to the product of their taps."""
    assert [tis._chunk_len(e) for e in (10_000_000, 300_001, 8190, 8192)] \
        == [3200, 4096, 4096, 4096]
    x = torch.from_numpy(_ints((5, 1), -100, 100, np.int8, seed=2))
    y = tis.int_unit_dim_pass(x, [(3, 1, True), (-2, -1, False)], 1)
    np.testing.assert_array_equal(y.numpy(),
                                  (x.numpy().astype(np.int32) * -6)
                                  .astype(np.int8))
    assert tis.int_unit_dim_pass(x, [(1, 1, True)], 1) is x


@pytest.mark.parametrize("dtype", ["int32", "int16", "int8"])
def test_summed_table_app(dtype):
    """``apps.summed_table`` at each integer width through ``realize`` on
    the CPU against numpy's wrapping cumsum and the JAX API."""
    import recfilter_tpu as rf

    w, h = 200, 136
    img = _ints((h, w), 0, 100, dtype, seed=3)
    F = summed_table(w, h, dtype=dtype)
    assert isinstance(F.as_func(device="cpu"), tdf.IntUnitPass)
    got = F.realize(img, device="cpu").numpy()
    want = img.cumsum(1, dtype=dtype).cumsum(0, dtype=dtype)
    np.testing.assert_array_equal(got, want)
    xj, yj = rf.Dim("x", w), rf.Dim("y", h)
    Fj = rf.RecFilter("IntSAT")
    Fj[yj, xj] = img
    Fj.add_filter(+xj, [1, 1])
    Fj.add_filter(+yj, [1, 1])
    Fj.split(xj, 16, yj, 16)
    np.testing.assert_array_equal(got, np.asarray(Fj.realize()))
    f32 = summed_table(w, h).realize(img.astype(np.float32), device="cpu")
    exact = img.astype(np.float64).cumsum(1).cumsum(0)
    np.testing.assert_allclose(f32.numpy(), exact, rtol=0,
                               atol=2e-6 * np.abs(exact).max())


def test_integer_refusals():
    """Where the JAX package takes its limb route (a clamp border) the
    port runs its limb route too, and where its gain gate declines (the
    unstable (2, 1) feedback) the sequential core: bit-exact against the
    JAX package and the oracle; a float16 SAT runs the float32 route cast
    in and out, as the JAX package does, and matches it; bfloat16 (its
    rotation chain at 32-wide tiles, the einsum form), refused until that
    form was ported, runs within 3e-2 of the oracle's peak and twice the
    JAX package's error; and a wrong input shape raises."""
    sat = ((1, True, 1, (1,)), (0, True, 1, (1,)))
    dims = (("y", 64), ("x", 64))
    img = _ints((64, 64), -100, 100, np.int16, seed=6)
    for scans, border in ((sat, "clamp"),
                          (((1, True, 1, (1,)), (0, True, 1, (2, 1))),
                           "zero")):
        js, ts = _specs(dims, scans, "int16", (0, 32), border)
        mod = tdf.fused_filter_module(ts)
        if border == "clamp":
            assert mod.route == "exact"
            assert all(r[0] == "limb" for _, rs in mod.plan for r in rs)
        else:
            assert mod.route == "core"
            assert jdf.apply_filter_int_exact(js, img) is None
        got = mod(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(got, jsc.oracle_apply(js, img))
        np.testing.assert_array_equal(
            got, np.asarray(jdf.apply_filter_fused(js, img)))
    js, ts = _specs(dims, sat, "float16", (32, 32))
    x16 = _ints((64, 64), -4, 4, np.float16, seed=7)
    got = tdf.fused_filter_module(ts)(torch.from_numpy(x16))
    want = np.asarray(jdf.apply_filter_fused(js, x16))
    assert got.dtype == torch.float16 and want.dtype == np.float16
    np.testing.assert_array_equal(got.numpy(), want)  # integers: exact
    np.testing.assert_array_equal(got.numpy(), jsc.oracle_apply(
        js, x16.astype(np.float64)).astype(np.float16))
    js, ts = _specs(dims, sat, "bfloat16", (32, 32))
    xb = _ints((64, 64), -4, 4, np.float32, seed=8)
    mod = tdf.fused_filter_module(ts)
    assert isinstance(mod, tdf.RotationChain)
    got = mod(torch.from_numpy(xb)).float().numpy()
    want = np.asarray(jdf.apply_filter_fused(
        js, jnp.asarray(xb, jnp.bfloat16)).astype(jnp.float32))
    ref = jsc.oracle_apply(dataclasses.replace(js, dtype="float32"),
                           xb.astype(np.float64))
    peak = np.abs(ref).max()
    e_port, e_jax = (np.abs(v - ref).max() / peak for v in (got, want))
    assert e_port <= 3e-2 and e_port <= max(2 * e_jax, 2.0 ** -8)
    _, ts = _specs(dims, sat, "int32", (32, 32))
    with pytest.raises(ValueError):
        tdf.fused_filter_module(ts)(torch.zeros((64, 63), dtype=torch.int32))


def test_clamp_is_never_unit_routed(monkeypatch):
    """The JAX package keeps clamp off its unit kernel (it takes the limb
    route); so does the port: no unit pass runs, and the limb route is
    bit-exact."""
    calls = _spy(monkeypatch, "int_unit_dim_pass")
    js, ts = _specs((("y", 64), ("x", 64)), ((1, True, 1, (1,)),), "int16",
                    (0, 32), "clamp")
    img = _ints((64, 64), -100, 100, np.int16, seed=4)
    want = jsc.oracle_apply(js, img)
    np.testing.assert_array_equal(np.asarray(jdf.apply_filter_fused(js, img)),
                                  want)
    mod = tdf.fused_filter_module(ts)
    assert mod.plan == [(1, [("limb", (0,), 16, 1)])]
    np.testing.assert_array_equal(mod(torch.from_numpy(img)).numpy(), want)
    assert calls == []


def test_integer_image_keeps_its_type_through_realize():
    """A filter defined on an int32 image runs the integer route and
    returns int32; a float input is cast first, as the JAX package casts
    its input to int32."""
    img = _ints((128, 128), -50, 50, np.int32, seed=5)
    x, y = rft.Dim("x", 128), rft.Dim("y", 128)
    F = rft.RecFilter("IntSAT")
    F[y, x] = img
    F.add_filter(+x, [1, 1])
    F.add_filter(-y, [1, -1])
    F.split(x, 128, y, 128)
    got = F.realize(device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), tsc.oracle_apply(F.spec, img))
    np.testing.assert_array_equal(
        F.realize(img.astype(np.float32), device="cpu").numpy(), got.numpy())
