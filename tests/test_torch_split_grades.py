"""The split-einsum grades ``f32x3``, ``f32x4``, ``f32x6``, ``high`` and
``f32x9`` (and px3, px4, ``default`` on the last-axis einsum form) against
the JAX package's ``_split_einsum`` routes and the float64 oracle.

Bounds, as a share of the oracle's peak, are the reference's own: one
dimension pass ``tests/test_dimfuse.py:417`` (f32x3 1e-4, f32x4 8e-5,
f32x6 1e-5; ``high`` held to f32x3's, f32x9 to px6's 2e-6), random n-D
filters ``tests/test_fuzz.py:25-28`` (f32x3 2e-4, f32x4 8e-5, f32x6 4e-6,
``high`` 2e-4, f32x9 4e-6); against the JAX package twice the bound (on
the CPU its ``high`` is a full float32 product, the port's three bf16
products: TPU HIGH).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import fir as tfir
from recfilter_tpu_torch import planner
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.kernels import split

ONE_PASS = {"f32x3": 1e-4, "f32x4": 8e-5, "f32x6": 1e-5, "high": 1e-4,
            "f32x9": 2e-6}
RANDOM = {"f32x3": 2e-4, "f32x4": 8e-5, "f32x6": 4e-6, "high": 2e-4,
          "f32x9": 4e-6}
SCANS = [(1, True, 0.9, (0.6, 0.25, -0.1)), (1, False, 1.1, (0.5, 0.2, 0.05))]


def _rel(got, want, scale=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / (scale or np.abs(want).max())


def _oracle(spec, x):
    return jsc.oracle_apply(spec, x.astype(np.float64))


@pytest.mark.parametrize("border", ["clamp", "zero"])
@pytest.mark.parametrize("grade", list(ONE_PASS))
def test_one_pass(grade, border):
    """``fused_dim_pass`` at the grade: the JAX package's
    ``tests/test_dimfuse.py:417`` case (64 × 256, tiles of 32), against
    the oracle and the JAX package."""
    x = np.random.default_rng(7).standard_normal((64, 256)).astype(
        np.float32)
    js = [jspec.Scan(*s) for s in SCANS]
    ts = [tspec.Scan(*s) for s in SCANS]
    got = tdf.fused_dim_pass(torch.from_numpy(x), 1, ts, 32, border,
                             matmul_precision=grade).numpy()
    jy = np.asarray(jdf.fused_dim_pass(jnp.asarray(x), 1, js, 32, border,
                                       matmul_precision=grade))
    spec = jspec.FilterSpec("P", (jspec.Dim("y", 64), jspec.Dim("x", 256)),
                            tuple(js), border=border)
    want = _oracle(spec, x)
    assert _rel(got, want) <= ONE_PASS[grade]
    assert _rel(got, jy, np.abs(want).max()) <= 2 * ONE_PASS[grade]


def _gauss2d(m, n, grade):
    """The σ=5 Gaussian, causal + anticausal on both axes of an n × n
    image, tiles of 32, in both packages."""
    w = rft.gaussian_weights(5.0, 3)
    scans = [(ax, c, w[0], tuple(w[1:])) for ax in (1, 0)
             for c in (True, False)]
    return [mod.FilterSpec("G", (mod.Dim("y", n), mod.Dim("x", n)),
                           tuple(mod.Scan(*s) for s in scans),
                           tile_widths=(32, 32)) for mod in m]


@pytest.mark.parametrize("grade", list(RANDOM))
def test_gaussian_2d(grade):
    """A 2-D Gaussian at 192² runs the rotation chain at the grade (its
    passes' einsum forms, no kernel), within the random-filter bound of
    the oracle and twice it of the JAX package."""
    js, ts = _gauss2d((jspec, tspec), 192, grade)
    x = np.random.default_rng(3).standard_normal((192, 192)).astype(
        np.float32)
    mod = tdf.fused_filter_module(ts, grade)
    assert isinstance(mod, tdf.RotationChain)
    want_nsp = tdf.EINSUM_NPROD.get(grade, 0)
    for p in mod.passes:
        assert p.tails is None and p.completion is None
        assert p.nsp == want_nsp
    got = mod(torch.from_numpy(x)).numpy()
    jy = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(x),
                                           matmul_precision=grade))
    want = _oracle(js, x)
    assert _rel(got, want) <= RANDOM[grade]
    assert _rel(got, jy, np.abs(want).max()) <= 2 * RANDOM[grade]


def _random_spec(rng, m):
    """The JAX package's fuzz spec (``tests/test_fuzz.py``), in ``m``."""
    ndim = int(rng.integers(1, 4))
    extents = [int(rng.integers(5, 40)) for _ in range(ndim)]
    tiles = tuple(int(rng.integers(2, 17)) for _ in range(ndim))
    scans = []
    for _ in range(int(rng.integers(1, 5))):
        axis = int(rng.integers(0, ndim))
        order = int(rng.integers(1, 4))
        a = rng.uniform(-0.9, 0.9, size=order)
        a = a / max(1.0, 1.2 * np.abs(a).sum())
        scans.append((axis, bool(rng.integers(0, 2)),
                      float(rng.uniform(0.3, 1.4)),
                      tuple(float(v) for v in a)))
    border = "clamp" if rng.integers(0, 2) else "zero"
    if border == "clamp" and any(e % t for e, t in zip(extents, tiles)):
        border = "zero"
    return m.FilterSpec("Fz", tuple(m.Dim(f"d{i}", e)
                                    for i, e in enumerate(extents)),
                        tuple(m.Scan(*s) for s in scans), border=border,
                        tile_widths=tiles), extents


@pytest.mark.parametrize("grade", list(RANDOM))
def test_random_filters(grade):
    """Eight random filters (1–3 axes, orders 1–3, mixed causality, zero
    or clamp, padded tiles) at the grade: the oracle within the fuzz
    bound (scaled by max(1, peak), as the JAX package's fuzz scales it),
    the JAX package within twice it."""
    for seed in range(8):
        js, ext = _random_spec(np.random.default_rng(100 + seed), jspec)
        ts, _ = _random_spec(np.random.default_rng(100 + seed), tspec)
        x = np.random.default_rng(seed).standard_normal(ext).astype(
            np.float32)
        got = tdf.apply_filter_fused(ts, torch.from_numpy(x),
                                     grade).numpy()
        jy = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(x),
                                               matmul_precision=grade))
        want = _oracle(js, x)
        scale = max(1.0, float(np.abs(want).max()))
        assert _rel(got, want, scale) <= RANDOM[grade], (seed, js)
        assert _rel(got, jy, scale) <= 2 * RANDOM[grade], (seed, js)


@pytest.mark.parametrize("grade,bound", [("px3", 1e-4), ("px4", 8e-5),
                                         ("default", 3e-2)])
def test_reduced_grades_on_few_lines(grade, bound):
    """Fewer than 8 lines: the last-axis pass leaves its kernels for its
    einsum form at the grade's products (the JAX package's split einsum
    at px3, px4; one plain product at default), where the port refused
    before."""
    w = rft.gaussian_weights(5.0, 3)
    scans = [(1, True, w[0], tuple(w[1:])), (1, False, w[0], tuple(w[1:]))]
    js, ts = [m.FilterSpec("S", (m.Dim("c", 4), m.Dim("t", 2048)),
                           tuple(m.Scan(*s) for s in scans),
                           tile_widths=(0, 128)) for m in (jspec, tspec)]
    x = (np.random.default_rng(6).standard_normal((4, 2048)) * 0.1).astype(
        np.float32)
    mod = tdf.fused_filter_module(ts, grade)
    assert isinstance(mod.body, tdf.LastAxisPass)
    assert mod.body.completion is not None  # the kernels, for ≥ 8 lines
    got = mod(torch.from_numpy(x)).numpy()
    jy = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(x),
                                           matmul_precision=grade))
    want = _oracle(js, x)
    assert _rel(got, want) <= bound
    assert _rel(got, jy, np.abs(want).max()) <= 2 * bound


def test_split_input_three_chunks_exact():
    """Three bf16 chunks rebuild float32 exactly, as the JAX package's
    ``_split_input`` does, chunk for chunk."""
    x = np.random.default_rng(9).standard_normal((8, 128)).astype(
        np.float32) * np.float32(1e3)
    chunks = split.split_data(torch.from_numpy(x), 3)
    back = sum(c.float() for c in chunks)
    assert torch.equal(back, torch.from_numpy(x))
    for c, jc in zip(chunks, jdf._split_input(jnp.asarray(x), 3)):
        np.testing.assert_array_equal(c.float().numpy(),
                                      np.asarray(jc, np.float32))
    M = np.random.default_rng(2).standard_normal((16, 16))
    for c, jc in zip(split.split_const(M, 3), jdf._split_const(M, 3)):
        np.testing.assert_array_equal(c.float().numpy(),
                                      np.asarray(jc, np.float32))


def test_split_einsum_matches_the_jax_package():
    """``dimfuse._split_einsum`` at 3, 4 and 6 products against the JAX
    package's on the same constant and data (float32 sums in another
    order: 1e-6 of the peak)."""
    rng = np.random.default_rng(4)
    M = rng.standard_normal((1, 32, 32))
    X = rng.standard_normal((6, 5, 32)).astype(np.float32)
    for nprod in (3, 4, 6):
        nc = split.nchunks(nprod)
        Mc = torch.stack([c.float() for c in split.split_const(M, nc)])
        got = tdf._split_einsum("nos,pns->pno", Mc, torch.from_numpy(X),
                                nprod)
        want = np.asarray(jdf._split_einsum("os,pns->pno", M[0],
                                            jnp.asarray(X), nprod,
                                            jnp.float32))
        assert _rel(got.numpy(), want) <= 1e-6


def test_rotated_leading_group_runs_float64():
    """A rotated pass with a leading group P > 1 keeps its products in
    float64 at a split grade, as the JAX package keeps them at HIGHEST:
    equal to the pass at ``highest``."""
    w = rft.gaussian_weights(5.0, 3)
    spec = tspec.FilterSpec(
        "R", (tspec.Dim("c", 3), tspec.Dim("y", 64), tspec.Dim("x", 96)),
        (tspec.Scan(2, True, w[0], tuple(w[1:])),), tile_widths=(0, 0, 32))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 64, 96)).astype(np.float32))
    a = tdf.apply_filter_rotated(spec, x, 2, matmul_precision="f32x3")
    b = tdf.apply_filter_rotated(spec, x, 2, matmul_precision="highest")
    assert torch.equal(a, b)


def test_fir_grades():
    """The FIR band pass: f32x6 runs ``fir_band`` as px6 does; f32x3 and
    f32x4 run it at 3 and 4 products, as px3 and px4 do (the JAX package's
    product counts); ``high`` and f32x9 take the einsum form."""
    taps = [1.0 / 7] * 7
    shape = (16, 256)
    assert tfir.FirPass(taps, shape, matmul_precision="f32x6").band is not None
    for g, nprod in (("f32x3", 3), ("f32x4", 4), ("px3", 3)):
        band = tfir.FirPass(taps, shape, matmul_precision=g).band
        assert band is not None and band.nprod == nprod
    for g in ("high", "f32x9", "highest"):
        assert tfir.FirPass(taps, shape, matmul_precision=g).band is None


def test_every_grade_is_ported():
    for g in ("px6", "highest", "px3", "px4", "default", "high", "f32x3",
              "f32x4", "f32x6", "f32x9"):
        planner.check_precision(g)
        assert planner.Plan(matmul_precision=g).matmul_precision == g
    assert not hasattr(planner, "_UNPORTED_PRECISIONS")
    with pytest.raises(ValueError):
        planner.check_precision("f32x5")


# ------------------------------- the tensor-core kernels at the reduced grades

T = 128


@pytest.mark.parametrize("sl", [8, 56])
@pytest.mark.parametrize("nprod", [1, 3, 4, 6])
def test_tc_exact_is_the_grades_pair_sum(nprod, sl):
    """``completion.tc_exact(..., nprod)`` pinned to a float64 sum of the
    grade's pairs: the carry rows (k ≥ 128) at ``split.carry_nprod`` (at
    least three), the signal rows at ``nprod``, the data split into the
    carry grade's chunks (the signal's are their first ones); ``drop``
    takes one pair out of both slabs; and a float32 model of the kernel's
    k16 steps in its order lies within the bound at every output."""
    from recfilter_tpu_torch.kernels import completion as tc

    rng = np.random.default_rng(nprod + sl)
    kp = tc.tc_depth(sl)
    M = rng.standard_normal((T, kp)) * 10.0 ** rng.integers(-3, 2, (T, kp))
    M[:, T + sl - 3:] = 0.0  # a zero-padded contraction
    cn = split.carry_nprod(nprod)
    nc = split.nchunks(cn)
    Mc = split.split_const(M, nc)
    data = torch.from_numpy(rng.standard_normal((5, 3, kp)).astype(
        np.float32))
    data[..., T + sl - 3:] = 0.0
    ein = lambda m, v: torch.einsum("ok,qnk->qno", m, v)  # noqa: E731
    ref, bound = tc.tc_exact(Mc, data, ein, nprod=nprod)
    ms = [c.double() for c in Mc]
    ds = [c.double() for c in split.split_data(data, nc)]
    parts = {}
    for sl_, g in ((slice(T, kp), cn), (slice(0, T), nprod)):
        for i, j in split.prods(g):
            t = ein(ms[i][:, sl_], ds[j][..., sl_])
            parts[i, j] = parts.get((i, j), 0) + t
    want = sum(parts.values())
    peak = want.abs().max()
    assert (ref - want).abs().max() <= 1e-13 * peak
    ref_d, _ = tc.tc_exact(Mc, data, ein, (0, 0), nprod)
    assert (ref_d - (want - parts[0, 0])).abs().max() <= 1e-13 * peak
    acc = None
    for k0s, g in ((range(T, kp, 16), cn), (range(0, T, 16), nprod)):
        for i, j in split.prods(g):
            for k0 in k0s:
                t = ein(ms[i][:, k0:k0 + 16], ds[j][..., k0:k0 + 16])
                acc = t.float() if acc is None else (acc.double() + t).float()
    assert bool(((acc.double() - ref).abs() <= bound).all())
    assert bool((bound > 0).all()) and bound.max() <= 1e-5 * peak


@pytest.mark.parametrize("S", [6, 29, 56])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("nprod", [1, 3, 4])
def test_completion_split_constant_is_core_pack(nprod, clamp, S):
    """The unrotated ``CompletionPass(nprod=).Bc_k`` — the constant
    ``completion_split`` (the tensor-core completion at the grade) stages
    — is ``core_pack`` of each variant's two bf16 chunks of the split
    ``[Btot | Rcat | 0]`` (KP = ``tc_depth(sl)``), the variants [interior,
    first, last] of a clamp stack; its twin sums the grade's chunk products (the carry rows at
    three or more), the kernel's function."""
    from recfilter_tpu_torch.kernels import completion as tc

    rng = np.random.default_rng(S + nprod)
    n = 4
    nv = n if clamp else 1
    B = rng.standard_normal((nv, T, T)) * 0.1
    R = rng.standard_normal((nv, T, S))
    mod = tc.CompletionPass(B, R, n, nprod=nprod)
    sl, kp = tc.slots_for(S), tc.tc_depth(tc.slots_for(S))
    pick = [1, 0, n - 1] if clamp else [0]
    M = np.zeros((len(pick), T, kp))
    M[..., :T] = B[pick]
    M[..., T:T + S] = R[pick]
    C = torch.stack(split.split_const(M, 2), dim=1)
    assert mod.Bc_k.dtype == torch.bfloat16
    assert mod.Bc_k.shape == (len(pick), 2, T * kp)
    assert torch.equal(mod.Bc_k, tc.core_pack(C))
    assert torch.equal(mod.chunks(), C)
    x = torch.from_numpy(rng.standard_normal((9, n, T)).astype(np.float32))
    N = torch.zeros((n, sl, 9))
    N[:, :S] = torch.from_numpy(rng.standard_normal((n, S, 9)).astype(
        np.float32))
    ref, _ = mod.split_exact(x, N)
    got = mod(x, N)
    assert (got.double() - ref).abs().max() <= 1e-5 * ref.abs().max()
