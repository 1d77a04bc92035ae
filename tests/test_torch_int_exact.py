"""The port's exact integer executor (``dimfuse.IntUnitPass``, planned by
``dimfuse.int_exact_plan``) against the JAX package's
``apply_filter_int_exact`` — or, where that returns None, its fallback
``scan_core.apply_filter`` — and the integer oracle, bit for bit, on the
cases of ``tests/test_int_exact.py``.

The JAX package runs the same inputs in Pallas interpret mode and its limb
passes at f32x9; the port runs its unit kernels' plain twins and its limb
passes in float64 on the CPU. Each case also asserts the route: the port's
plan (unit axes, each limb chunk's limb width and count, or the core) is
the one the JAX package took, read from spies on its ``int_unit_dim_pass``
and ``_int_limbs``.
"""

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
from recfilter_tpu_torch.kernels import int_scan as tis

SAT = ((1, True, 1, (1,)), (0, True, 1, (1,)))
BOX2 = ((1, True, 1, (2, -1)), (1, False, 1, (2, -1)), (0, True, 1, (2, -1)))

# name: (dims, scans, dtype, tiles, border, value range, route)
#   route: "unit", "limb", "mixed" (unit and limb axes) or "core"
CASES = {
    "sat-int32-full-range": ((("y", 512), ("x", 512)), SAT, "int32",
                             (128, 128), "zero", (-2**28, 2**28), "unit"),
    "sat-int16-wraps": ((("y", 128), ("x", 128)), SAT, "int16", (16, 16),
                        "zero", (-32768, 32767), "unit"),
    "int8-sat": ((("y", 64), ("x", 64)), SAT[:1], "int8", (8, 8), "zero",
                 (-128, 127), "unit"),
    "box2-zero": ((("y", 96), ("x", 96)), BOX2, "int32", (16, 16), "zero",
                  (-2**29, 2**29), "unit"),
    "box2-clamp": ((("y", 96), ("x", 96)), BOX2, "int32", (16, 16), "clamp",
                   (-2**29, 2**29), "limb"),
    "box-cascade-six": ((("y", 64), ("x", 64)), SAT * 3, "int32", (16, 16),
                        "zero", (-2**30, 2**30), "unit"),
    "mixed-causality-feedfwd": ((("y", 64), ("x", 96)),
                                ((1, True, 1, (1,)), (1, False, 1, (-1,)),
                                 (0, True, 2, (1,))), "int32", (16, 16),
                                "zero", (-2**30, 2**30), "unit"),
    "noninteger-coeff-cast": ((("y", 32), ("x", 32)),
                              ((1, True, 1.0, (0.5,)),
                               (0, True, 1.0, (1.9,))), "int32", (8, 8),
                              "zero", (-20, 20), "mixed"),
    "non-dividing-clamp": ((("y", 61), ("x", 77)),
                           ((1, True, 1, (1,)), (0, False, 1, (1,))),
                           "int32", (16, 16), "clamp", (-2**24, 2**24),
                           "limb"),
    "unstable-falls-back": ((("y", 48), ("x", 80)), ((1, True, 3, (-2, 1)),),
                            "int32", (16, 16), "zero", (1, 2), "core"),
    "gain-gate-4k-box2": ((("y", 8), ("x", 4096)), ((1, True, 1, (2, -1)),),
                          "int32", (0, 128), "zero", (-2**20, 2**20),
                          "unit"),
    "gain-gate-4k-fibonacci": ((("y", 8), ("x", 4096)),
                               ((1, True, 1, (1, 1)),), "int32", (0, 128),
                               "zero", (-2**20, 2**20), "core"),
    "int64-falls-back": ((("y", 16), ("x", 16)), SAT[:1], "int64", (4, 4),
                         "zero", (-1000, 1000), "core"),
    "routes-through-limbs": ((("y", 64), ("x", 64)), SAT, "int32", (16, 16),
                             "zero", (-2**28, 2**28), "unit"),
    "unit-sat-256": ((("y", 256), ("x", 256)), SAT, "int32", (128, 128),
                     "zero", (-2**24, 2**24), "unit"),
    "unit-all-widths-int32": ((("y", 192), ("x", 256)), SAT, "int32",
                              (64, 128), "zero", (-2**27, 2**27), "unit"),
    "unit-all-widths-int16": ((("y", 192), ("x", 256)), SAT, "int16",
                              (64, 128), "zero", (-2**12, 2**12), "unit"),
    "unit-all-widths-int8": ((("y", 192), ("x", 256)), SAT, "int8",
                             (64, 128), "zero", (-100, 100), "unit"),
    "unit-anticausal-alternating": ((("y", 64), ("x", 192)),
                                    ((1, True, 2, (-1,)),
                                     (1, False, 1, (-1,)),
                                     (1, False, 3, (1,))), "int32",
                                    (0, 64), "zero", (-2**20, 2**20),
                                    "unit"),
    "unit-plus-limb-dims": ((("y", 64), ("x", 128)),
                            ((1, True, 1, (1,)), (0, True, 1, (1, 0))),
                            "int16", (32, 64), "zero", (-50, 50), "mixed"),
    "unit-volume": ((("z", 16), ("y", 64), ("x", 128)),
                    ((2, True, 1, (1,)), (1, True, 1, (1,)),
                     (0, True, 1, (1,))), "int32", (0, 0, 64), "zero",
                    (-1000, 1000), "unit"),
    "clamp-not-unit": ((("y", 64), ("x", 64)), SAT[:1], "int16", (0, 32),
                       "clamp", (-100, 100), "limb"),
    "unit-higher-order": ((("y", 64), ("x", 128)),
                          ((1, True, 1, (0, 1)), (0, True, 1, (3, -3, 1))),
                          "int16", (0, 64), "zero", (-2**10, 2**10),
                          "unit"),
    "segmented-lanes": ((("c", 2), ("x", 70_001)), SAT[:1], "int32",
                        (0, 4096), "zero", (-1000, 1000), "unit"),
    "segmented-rows": ((("y", 8190), ("x", 64)), ((0, False, 2, (-1,)),),
                       "int32", (128, 64), "zero", (-1000, 1000), "unit"),
    "extent-one": ((("y", 4), ("x", 1)), ((1, True, 5, (1,)),), "int32",
                   (2, 1), "zero", (0, 4), "unit"),
    "unsigned-uint8": ((("y", 96), ("x", 128)), SAT, "uint8", (32, 64),
                       "zero", (0, 200), "unit"),
    "unsigned-uint16": ((("y", 96), ("x", 128)), SAT, "uint16", (32, 64),
                        "zero", (0, 2**14), "unit"),
    "unsigned-uint32": ((("y", 96), ("x", 128)), SAT, "uint32", (32, 64),
                        "zero", (0, 2**30), "unit"),
    "unsigned-uint8-clamp": ((("y", 64), ("x", 96)), SAT, "uint8", (32, 32),
                             "clamp", (0, 200), "limb"),
    "unsigned-uint16-nonunit": ((("y", 64), ("x", 96)),
                                ((1, True, 1, (1, 0)), (0, True, 1, (1,))),
                                "uint16", (32, 32), "zero", (0, 2**14),
                                "mixed"),
    "unsigned-uint32-clamp": ((("y", 96), ("x", 128)), SAT, "uint32",
                              (32, 64), "clamp", (0, 2**30), "limb"),
}


def _specs(dims, scans, dtype, tiles, border):
    return [m.FilterSpec("U", tuple(m.Dim(n, e) for n, e in dims),
                         tuple(m.Scan(*s) for s in scans), border=border,
                         dtype=dtype, tile_widths=tiles)
            for m in (jspec, tspec)]


def _img(dims, lo, hi, dtype, seed=0):
    shape = tuple(e for _, e in dims)
    if lo == 1 and hi == 2:
        return np.ones(shape, dtype)
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(dtype)


def _jax_run(monkeypatch, js, img):
    """The JAX package's result for ``js`` (``apply_filter_int_exact``,
    else its fallback) and its route: (unit axes, [(lb, nl)] of every limb
    chunk, whether the exact executor ran)."""
    units, limbs = [], []
    u_orig, l_orig = jis.int_unit_dim_pass, jdf._int_limbs

    def u_spy(x, scans, axis, interpret):
        units.append(axis)
        return u_orig(x, scans, axis, interpret)

    def l_spy(v, lb, nl):
        limbs.append((lb, nl))
        return l_orig(v, lb, nl)

    monkeypatch.setattr(jis, "int_unit_dim_pass", u_spy)
    monkeypatch.setattr(jdf, "_int_limbs", l_spy)
    y = jdf.apply_filter_int_exact(js, img)
    exact = y is not None
    if not exact:
        y = jsc.apply_filter(js, img)
    return np.asarray(y), (units, limbs, exact)


def _port_route(mod):
    if mod.route == "core":
        return [], [], False
    units = [ax for ax, routes in mod.plan if routes[0][0] == "unit"]
    limbs = [(r[2], r[3]) for _, routes in mod.plan for r in routes
             if r[0] == "limb"]
    return units, limbs, True


@pytest.mark.parametrize("case", list(CASES))
def test_int_exact_cases(monkeypatch, case):
    """Bit-equal to the JAX package and the integer oracle, on the JAX
    package's route."""
    dims, scans, dtype, tiles, border, (lo, hi), route = CASES[case]
    js, ts = _specs(dims, scans, dtype, tiles, border)
    img = _img(dims, lo, hi, dtype)
    want, jroute = _jax_run(monkeypatch, js, img)
    mod = tdf.fused_filter_module(ts)
    assert isinstance(mod, tdf.IntUnitPass)
    got = mod(torch.from_numpy(img))
    assert str(got.dtype) == f"torch.{dtype}"
    oracle = jsc.oracle_apply(js, img)
    np.testing.assert_array_equal(got.numpy(), oracle)
    if dtype != "int64":  # the JAX package runs int64 as int32 here
        np.testing.assert_array_equal(got.numpy(), want)
    assert _port_route(mod) == jroute
    units, limbs, exact = jroute
    assert route == ("core" if not exact else "mixed" if units and limbs
                     else "unit" if units else "limb")
    np.testing.assert_array_equal(mod.forward_plain(torch.from_numpy(img))
                                  .numpy(), oracle)


def test_limb_route_when_unit_scans_are_disabled(monkeypatch):
    """With the unit decomposition off on both sides the SAT class runs
    the limb executor, still exact (the unit kernel is an optimisation)."""
    js, ts = _specs((("y", 128), ("x", 128)), SAT, "int16", (64, 64),
                    "zero")
    img = _img((("y", 128), ("x", 128)), -2**12, 2**12, "int16", seed=12)
    monkeypatch.setattr(jis, "unit_scans_of", lambda s: None)
    monkeypatch.setattr(tis, "unit_scans_of", lambda s: None)
    want, jroute = _jax_run(monkeypatch, js, img)
    mod = tdf.fused_filter_module(ts)
    assert _port_route(mod) == jroute and not jroute[0] and jroute[1]
    np.testing.assert_array_equal(mod(torch.from_numpy(img)).numpy(), want)


def test_limb_plan_matches_the_gate():
    """The plan's limb widths: 23 − ⌈log₂ gain⌉ bits, enough limbs for the
    value's bits so far; the gain of a clamp integrator over w samples is
    w + 1; chunks split where the gain product reaches 2^21."""
    ts = _specs((("y", 96), ("x", 96)), BOX2, "int32", (16, 16), "clamp")[1]
    plan = tdf.int_exact_plan(ts)
    g = tdf._int_abs_gain([tdf._int_cast_scans(ts)[0]], 96, "clamp")
    lb = 23 - int(np.ceil(np.log2(g)))
    assert plan[0][1][0] == ("limb", (0,), lb, -(-32 // lb))
    assert [r[1] for r in plan[0][1]] == [(0,), (1,)]
    sat = _specs((("y", 61), ("x", 77)), SAT, "int32", (16, 16), "clamp")[1]
    assert tdf._int_abs_gain(tdf._int_cast_scans(sat)[:1], 77,
                             "clamp") == 78.0


def test_limbs_rebuild_int32():
    """Signed limbs rebuild every int32 value, extremes included."""
    v = torch.tensor([0, 1, -1, 2**31 - 1, -2**31, 123456789, -987654321],
                     dtype=torch.int32)
    for lb, nl in ((10, 4), (16, 2), (17, 2), (2, 16), (23, 2)):
        limbs = tdf._int_limbs(v, lb, nl)
        total = sum(l.long() << (lb * i) for i, l in enumerate(limbs))
        assert torch.equal((total - v.long()) % 2**32,
                           torch.zeros_like(total))
        for l in limbs[:-1]:
            assert l.abs().max() <= 1 << (lb - 1)


def test_limb_passes_launch_no_kernel_and_run_f32x9():
    """A limb axis runs the tiled pass at f32x9: the einsum form (no
    kernel), its solve dense (no band dropped)."""
    ts = _specs((("y", 64), ("x", 64)), SAT[:1], "int16", (0, 32), "clamp")[1]
    mod = tdf.fused_filter_module(ts)
    (lim,) = mod.limbs
    assert isinstance(lim, tdf.FusedLastAxis)
    body = lim.body
    assert body.grade == "f32x9" and body.tails is None
    assert body.completion is None and body.offsets is None


def test_realize_through_the_api():
    """Integer images of each width through ``RecFilter.realize`` with a
    clamp border (the limb route) and a non-unit scan, against the
    oracle."""
    for dtype, hi in (("int8", 100), ("int16", 2**12), ("int32", 2**24),
                      ("uint8", 200), ("uint16", 2**14), ("uint32", 2**30)):
        lo = 0 if dtype.startswith("u") else -hi
        img = np.random.default_rng(3).integers(lo, hi, (48, 80)).astype(
            dtype)
        x, y = rft.Dim("x", 80), rft.Dim("y", 48)
        F = rft.RecFilter("IntClamp")
        F.set_clamped_image_border()
        F[y, x] = img
        F.add_filter(+x, [1, 1])
        F.add_filter(+y, [1, 1, 0])
        F.split(x, 16, y, 16)
        got = F.realize(img, device="cpu").numpy()
        assert got.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got, tsc.oracle_apply(F.spec, img))
        assert F.as_func(device="cpu").route == "exact"
