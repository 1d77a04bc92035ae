"""The port's banded FIR path (``fir.py``, ``kernels/fir_band.py``, the box
and difference-of-Gaussians apps) against the JAX package's.

Same seeded numpy inputs through the JAX package (px6; the Pallas band
kernel in interpret mode, as ``tests/test_fir.py`` runs it) and through the
port's plain twins on the CPU, at the kernel's tile of 128. Bounds, as
``tests/test_fir.py`` holds the JAX package: 2e-6 of the peak against the
f64 oracle (5e-6 for the signed channel contraction), and 1e-5 of the peak
between the two packages (fp32 sums in another order). The CUDA kernel is
held to the twin on a card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import fir as jfir
from recfilter_tpu.apps import box as jbox
from recfilter_tpu.apps import dog as jdog
from recfilter_tpu.kernels import fir_band as jfb

from recfilter_tpu_torch import fir as tfir
from recfilter_tpu_torch.apps import box as tbox
from recfilter_tpu_torch.apps import dog as tdog
from recfilter_tpu_torch.kernels import fir_band as tfb
from recfilter_tpu_torch.kernels import split

T = 128


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _near(got, want, bound):
    """max|got − want| ≤ bound·max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * np.abs(want).max()


def _sep_oracle(img, taps):
    return tfir.fir_oracle(tfir.fir_oracle(img, taps, 1), taps, 0)


def test_host_helpers_equal_the_jax_packages():
    for B, n in ((1, 1), (5, 3), (9, 3), (5, 6)):
        np.testing.assert_array_equal(tfir.box_taps(B, n), jfir.box_taps(B, n))
    ragged = [tfir.box_taps(3, 3), tfir.box_taps(5, 3), np.ones(4) / 4]
    np.testing.assert_array_equal(tfir._align_taps(ragged),
                                  jfir._align_taps(ragged))
    for taps, Tw in ((tfir.box_taps(5, 3), 128), (np.arange(1.0, 5.0), 32)):
        for a, b in zip(tfir._band_mats(taps, Tw), jfir._band_mats(taps, Tw)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tfb.band_blocks(taps, Tw),
                                      jfb.band_blocks(taps, Tw))
    x = _x(6, 50, seed=1)
    np.testing.assert_array_equal(tfir.fir_oracle(x, np.arange(1.0, 6.0), 1),
                                  jfir.fir_oracle(x, np.arange(1.0, 6.0), 1))
    for args in ((128, 512, tfir.box_taps(5, 3), 8), (64, 512, [1.0], 8),
                 (128, 100, [1.0], 8), (128, 512, [1.0], 7),
                 (128, 512, np.ones(259), 8)):
        assert tfb.fir_band_ok(*args) == jfb.fir_band_ok(*args)


# ------------------------------------------------------------ band kernel

BANDS = {"plain": [tfir.box_taps(5, 3)],
         "bank": [tfir.box_taps(3, 3), tfir.box_taps(9, 3)],
         "contract": [tfir.box_taps(3, 3), tfir.box_taps(9, 3)]}


@pytest.mark.parametrize("form,rot,L", [
    ("plain", False, 512), ("plain", True, 1000), ("bank", True, 1000),
    ("bank", False, 384), ("contract", False, 1000), ("contract", True, 512)])
def test_fir_band_twin_matches_jax_kernel(form, rot, L):
    """FirBand's twin against ``fir_band_pass`` (interpret mode) and the f64
    oracle: a plain pass, a 1 → 2 bank, a signed 2 → 1 contraction, flat and
    rotated, ragged L."""
    taps = tfir._align_taps(BANDS[form])
    contract = form == "contract"
    signs = [1.0, -1.0] if contract else None
    q = 40
    x = _x(2, q, L, seed=L) if contract else _x(q, L, seed=L)
    band = tfb.FirBand(taps, rot=rot, contract=contract, signs=signs)
    got = band(torch.from_numpy(x)).numpy()
    want_jax = np.asarray(jfb.fir_band_pass(
        jnp.asarray(x), taps, T=T, rot=rot, nprod=6, signs=signs,
        contract=contract, interpret=True))
    _near(got, want_jax, 1e-5)
    if contract:
        oracle = (tfir.fir_oracle(x[0], taps[0], 1)
                  - tfir.fir_oracle(x[1], taps[1], 1))
    else:
        oracle = np.stack([tfir.fir_oracle(x, t, 1) for t in taps])
        oracle = oracle[0] if form == "plain" else oracle
    if rot:
        oracle = np.swapaxes(oracle, -1, -2)
    _near(got, oracle, 5e-6 if contract else 2e-6)


def test_fir_band_gradient_matches_jax():
    """The band pass is linear: the twin's VJP equals the JAX package's
    custom VJP (its einsum twin) within 1e-4."""
    taps = tfir._align_taps(BANDS["bank"])
    x, ct = _x(16, 300, seed=3), _x(2, 300, 16, seed=4)
    band = tfb.FirBand(taps, rot=True)
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(band(xt), xt, torch.from_numpy(ct))
    _, vjp = jax.vjp(lambda v: jfb.fir_band_pass(
        v, taps, T=T, rot=True, nprod=6, interpret=True), jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               rtol=1e-4, atol=1e-4)


# the reduced grades: (form, rot, tap_scale) cases at nprod 1, 3 and 4
GRADE_CASES = [("plain", False, None), ("plain", True, "scale"),
               ("bank", True, None), ("bank", False, "scale"),
               ("contract", False, None), ("contract", True, "scale")]
SCALES = {"plain": [11.0 ** 3], "bank": [7.0 ** 3, 19.0 ** 3],
          "contract": [7.0 ** 3, 19.0 ** 3]}


@pytest.mark.parametrize("form,rot,scale", GRADE_CASES)
@pytest.mark.parametrize("nprod", [1, 3, 4])
def test_fir_band_grades_match_jax_kernel(form, rot, scale, nprod):
    """FirBand's twin at nprod 1, 3 and 4 against ``fir_band_pass(nprod=)``
    (interpret mode), with and without ``tap_scale``: within 1e-5 of the
    JAX output's peak. With the scale, below px6, the box³ of radius 3
    (343-scaled taps, exact bf16 integers) takes the pairs (0, j) and the
    radius 9 (6859-scaled: not exact) the generic ones, as in the JAX
    package; at one product every channel takes (0, 0)."""
    taps = tfir._align_taps(BANDS[form])
    contract = form == "contract"
    signs = [1.0, -1.0] if contract else None
    ts = SCALES[form] if scale else None
    x = _x(2, 40, 500, seed=nprod) if contract else _x(40, 500, seed=nprod)
    band = tfb.FirBand(taps, rot=rot, contract=contract, signs=signs,
                       nprod=nprod, tap_scale=ts)
    reduced = [(0, j) for j in range(2)]
    if ts and nprod > 1:
        assert band.pairs[0] == reduced
        assert band.pairs[-1] == (reduced if form == "plain"
                                  else split.prods(nprod))
    else:
        assert all(len(p) == nprod for p in band.pairs)
    got = band(torch.from_numpy(x)).numpy()
    want = np.asarray(jfb.fir_band_pass(
        jnp.asarray(x), taps, T=T, rot=rot, nprod=nprod, signs=signs,
        contract=contract, interpret=True, tap_scale=ts))
    _near(got, want, 1e-5)


def test_exact_band_is_the_jax_decision():
    """``exact_band`` (torch's bfloat16 round trip) decides every channel
    as the JAX package's (``ml_dtypes``) does."""
    taps = tfir._align_taps([tfir.box_taps(3, 3), tfir.box_taps(9, 3),
                             tfir.box_taps(5, 1)])
    for scale in (None, 343.0, [343.0, 6859.0, 11.0], [1.0, 1.0, 3.0]):
        got, want = (m.exact_band(taps, scale, 3) for m in (tfb, jfb))
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1] and got[2] == want[2]


# ------------------------------------------------------------- the routes


def _spy_jax_kernel(monkeypatch):
    calls = []
    orig = jfb.fir_band_pass

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(jfb, "fir_band_pass", spy)
    return calls


@pytest.mark.parametrize("shape,kw", [
    ((40, 700), {}),                                     # kernel
    ((40, 700), {"emit_rot": True}),                     # kernel, rotated
    ((2, 3, 5, 300), {}),                                # kernel, 3 batch axes
    ((2, 6, 300), {"emit_rot": True}),                   # einsum: rot, 2 axes
    ((5, 700), {}),                                      # einsum: q < 8
    ((40, 700), {"tile_width": 64}),                     # einsum: T ≠ 128
    ((40, 700), {"matmul_precision": "highest"}),        # einsum: highest
    ((700,), {}),                                        # einsum: no batch
    ((40, 100), {}),                                     # einsum: L < T
], ids=["kernel", "kernel-rot", "kernel-3batch", "einsum-rot2", "einsum-q5",
        "einsum-T64", "einsum-highest", "einsum-1d", "einsum-short"])
def test_fir_pass_last_takes_the_jax_route(shape, kw, monkeypatch):
    """``fir_pass_last`` routes as the JAX package does, from the shapes
    and the precision alone, and agrees with it within 1e-5 of the peak and
    with the f64 oracle within 2e-6."""
    kw = {"tile_width": T, "matmul_precision": "px6", **kw}
    taps = tfir.box_taps(4, 3)
    x = _x(*shape, seed=5)
    calls = _spy_jax_kernel(monkeypatch)
    want = np.asarray(jfir.fir_pass_last(jnp.asarray(x), taps, **kw))
    mod = tfir.FirPass(taps, shape, **kw)
    assert (mod.band is not None) == bool(calls)
    got = mod(torch.from_numpy(x)).numpy()
    _near(got, want, 1e-5)
    oracle = tfir.fir_oracle(x, taps, -1)
    if kw.get("emit_rot"):
        oracle = np.swapaxes(oracle, -1, -2)
    _near(got, oracle, 2e-6)
    np.testing.assert_array_equal(
        tfir.fir_pass_last(torch.from_numpy(x), taps, **kw).numpy(), got)


# the grades' bounds of the f64 oracle's peak (tests/test_dimfuse.py:454)
GRADE_BOUNDS = {"px3": 1e-4, "f32x3": 1e-4, "px4": 8e-5, "f32x4": 8e-5,
                "default": 3e-2}


@pytest.mark.parametrize("grade", list(GRADE_BOUNDS))
@pytest.mark.parametrize("tile", [T, 64], ids=["kernel", "einsum"])
def test_fir_pass_last_grades_take_the_jax_route(grade, tile, monkeypatch):
    """At the reduced grades ``fir_pass_last`` takes the JAX package's
    route (the band kernel at its product count, or the split einsum where
    the kernel's gate fails), within the grade's bound of the f64 oracle
    and twice it of the JAX package."""
    taps = tfir.box_taps(4, 3)
    x = _x(40, 700, seed=13)
    kw = dict(tile_width=tile, matmul_precision=grade, tap_scale=9.0 ** 3)
    calls = _spy_jax_kernel(monkeypatch)
    want = np.asarray(jfir.fir_pass_last(jnp.asarray(x), taps, **kw))
    mod = tfir.FirPass(taps, x.shape, **kw)
    assert (mod.band is not None) == bool(calls) == (tile == T)
    if mod.band is not None:
        assert mod.band.nprod == tfir.BAND_NPROD[grade]
    else:
        assert mod.nsp == {"default": 1}.get(grade, tfir.BAND_NPROD[grade])
    got = mod(torch.from_numpy(x)).numpy()
    oracle = tfir.fir_oracle(x, taps, -1)
    bound = GRADE_BOUNDS[grade]
    _near(got, oracle, bound)
    _near(got, want, 2 * bound)


@pytest.mark.parametrize("bank", [True, False], ids=["bank", "contract"])
@pytest.mark.parametrize("T_", [T, 32])
def test_fir_pass_last_channels_match_jax(bank, T_, monkeypatch):
    """Banks and signed contractions on both routes (kernel at T = 128,
    einsum at T = 32)."""
    taps = tfir._align_taps(BANDS["bank"]) * np.array([[1.0], [-1.0]])
    x = _x(40, 500, seed=6) if bank else _x(2, 40, 500, seed=6)
    kw = dict(tile_width=T_, bank=bank, contract=not bank,
              matmul_precision="px6")
    calls = _spy_jax_kernel(monkeypatch)
    want = np.asarray(jfir.fir_pass_last(jnp.asarray(x), taps, **kw))
    mod = tfir.FirPass(taps, x.shape, **kw)
    assert (mod.band is not None) == bool(calls) == (T_ == T)
    _near(mod(torch.from_numpy(x)).numpy(), want, 1e-5)


@pytest.mark.parametrize("grade,K", [("default", 65), ("px3", 65),
                                     ("px4", 65), ("px6", 257)])
def test_fir_band_stages_what_it_fits(grade, K, monkeypatch):
    """A 16-channel bank: the kernel's tap rows per channel are its most
    chunk pairs (1 at ``default``, 3 at px3, 4 at px4, 1 at px6), and a
    bank whose staged taps pass the kernel's 4096 values (px4 at K = 65,
    px6 at K = 257) takes the einsum form, though the JAX kernel takes it;
    either way within the grade's bound of the f64 oracle and twice it of
    the JAX package (2e-6 and 1e-5 at px6)."""
    taps = np.random.default_rng(K).standard_normal((16, K)) / K
    x = _x(8, 256, seed=K)
    kw = dict(tile_width=T, bank=True, matmul_precision=grade)
    calls = _spy_jax_kernel(monkeypatch)
    want = np.asarray(jfir.fir_pass_last(jnp.asarray(x), taps, **kw))
    assert calls
    band = tfb.FirBand(taps, nprod=tfir.BAND_NPROD[grade])
    assert band.npair == {"default": 1, "px3": 3, "px4": 4, "px6": 1}[grade]
    assert band.taps_k.shape == ((16, band.Kpad) if grade == "px6"
                                 else (16, band.npair, band.Kpad))
    assert band.fits == (16 * band.npair * band.Kpad <= 4096)
    assert band.fits == (grade in ("default", "px3"))
    mod = tfir.FirPass(taps, x.shape, **kw)
    assert (mod.band is not None) == band.fits
    got = mod(torch.from_numpy(x)).numpy()
    bound = GRADE_BOUNDS.get(grade, 2e-6)
    oracle = np.stack([tfir.fir_oracle(x, t, -1) for t in taps])
    _near(got, oracle, bound)
    _near(got, want, 2 * bound if grade != "px6" else 1e-5)


def test_tap_scale_changes_nothing():
    """At px6 the port's fp32 sums read no ``tap_scale`` (below px6 it
    picks the reduced pairs: ``test_fir_band_grades_match_jax_kernel``)."""
    taps = tfir.box_taps(5, 3)
    x = torch.from_numpy(_x(16, 512, seed=7))
    a = tfir.fir_pass_last(x, taps, tile_width=T)
    b = tfir.fir_pass_last(x, taps, tile_width=T, tap_scale=11.0 ** 3)
    assert torch.equal(a, b)


def test_fir_refusals():
    """What the pass refuses; bf16 products and a bf16 image, refused
    until they were ported, now run (the identity band: x rounded to
    bf16, a float32 output for a float32 x, bf16 for a bf16 x)."""
    x = torch.zeros((8, 256))
    with pytest.raises(ValueError):  # support beyond the one-tile band
        tfir.fir_pass_last(x, np.ones(200) / 200.0, tile_width=16)
    x1 = x + 1.0 + 2.0 ** -12  # not a bf16 value: rounds to 1
    y = tfir.fir_pass_last(x1, [1.0], matmul_dtype="bfloat16")
    assert y.dtype == torch.float32 and torch.equal(y, x + 1.0)
    # px3 runs (fir_band's twin at three products): the identity band
    assert torch.equal(tfir.fir_pass_last(x + 1.0, [1.0],
                                          matmul_precision="px3"), x + 1.0)
    y = tfir.fir_pass_last(x1.to(torch.bfloat16), [1.0])
    assert y.dtype == torch.bfloat16 and torch.equal(y.float(), x + 1.0)
    with pytest.raises(NotImplementedError, match="item 4"):
        tfir.fir_pass_last(x.to(torch.float16), [1.0])
    with pytest.raises(ValueError):
        tfir.fir_pass_last(torch.zeros(256), [1.0], emit_rot=True)


# --------------------------------------------------------------- the apps

H, W = 200, 300


@pytest.mark.parametrize("iterations,B", [(1, 4), (3, 5), (6, 5)])
def test_box_fir_matches_jax_app(iterations, B):
    """box ×1/×3/×6 (FIR) against the JAX apps at T = 128 and the
    separable f64 oracle at every pixel."""
    img = _x(H, W, seed=iterations)
    build_t = {1: lambda: tbox.box_filter_order_1(W, H, B, T,
                                                  device="cpu")[0],
               3: lambda: tbox.box_filter_3(W, H, B, T, device="cpu"),
               6: lambda: tbox.box_filter_6(W, H, B, T, device="cpu")
               }[iterations]
    build_j = {1: lambda: jbox.box_filter_order_1(W, H, B, T)[0],
               3: lambda: jbox.box_filter_3(W, H, B, T),
               6: lambda: jbox.box_filter_6(W, H, B, T)}[iterations]
    mod = build_t()
    assert isinstance(mod, tfir.FirSeparable2D)
    assert mod.x_pass.band is not None and mod.y_pass.band is not None
    got = mod(torch.from_numpy(img)).numpy()
    _near(got, np.asarray(build_j()(jnp.asarray(img))), 1e-5)
    _near(got, _sep_oracle(img, tfir.box_taps(B, iterations)), 2e-6)
    if iterations == 1:
        _near(got, tbox.box_oracle(img, B, 1), 2e-6)
    np.testing.assert_array_equal(tbox.box_oracle(img[:40, :50], B, 2),
                                  jbox.box_oracle(img[:40, :50], B, 2))


def test_box_order_1_sat_matches_jax_app():
    """The SAT variant (2-D executor + torch differencing) against the JAX
    app, and against the box oracle where the reference's zeroed-margin
    contract defines the result (``tests/test_fir.py``'s tolerance)."""
    w, B = 256, 3
    img = _x(w, w, seed=8)
    pad = B + 1
    for s in (slice(0, pad), slice(w - pad, w)):
        img[s] = 0
        img[:, s] = 0
    mod, F = tbox.box_filter_order_1(w, w, B, T, variant="sat",
                                     device="cpu")
    fj, _ = jbox.box_filter_order_1(w, w, B, T, variant="sat")
    assert F.spec.tile_widths == (T, T)
    got = mod(torch.from_numpy(img)).numpy()
    _near(got, np.asarray(fj(jnp.asarray(img))), 1e-5)
    v = slice(0, w - pad)
    np.testing.assert_allclose(got[v, v], tbox.box_oracle(img, B, 1)[v, v],
                               rtol=1e-3, atol=1e-4)


def test_dog_matches_jax_app():
    """DoG (FIR): a C = 2 bank then a signed contraction, against the JAX
    app and within 5e-6 of the oracle's peak."""
    img = _x(H, W, seed=9)
    mod = tdog.difference_of_gaussians(W, H, 5, 9, T, device="cpu")
    assert mod.x_pass.band.Cout == 2 and mod.y_pass.band.contract
    got = mod(torch.from_numpy(img)).numpy()
    want = np.asarray(jdog.difference_of_gaussians(W, H, 5, 9, T)(
        jnp.asarray(img)))
    _near(got, want, 1e-5)
    t1, t2 = tfir.box_taps(5, 3), tfir.box_taps(9, 3)
    oracle = _sep_oracle(img, t1) - _sep_oracle(img, t2)
    scale = np.abs(_sep_oracle(img, t1)).max()
    assert np.abs(got - oracle).max() <= 5e-6 * scale


@pytest.mark.parametrize("grade", ["px3", "px4", "default"])
def test_fir_apps_at_the_grades(grade):
    """box ×3 and the DoG (FIR) at a reduced grade (``matmul_precision``
    carried through ``FirSeparable2D``): both passes on ``fir_band``'s
    twin at the grade's products with the apps' ``tap_scale``, within the
    grade's bound of the separable f64 oracle and twice it of the JAX
    apps' ``fir_separable_2d`` at the same grade."""
    h, w = 136, 264
    img = _x(h, w, seed=14)
    nprod = tfir.BAND_NPROD[grade]
    t1, t2 = tfir.box_taps(5, 3), tfir.box_taps(9, 3)
    box3 = tbox.box_filter_3(w, h, 5, T, device="cpu",
                             matmul_precision=grade)
    dog = tdog.difference_of_gaussians(w, h, 5, 9, T, device="cpu",
                                       matmul_precision=grade)
    for mod in (box3, dog):
        assert mod.x_pass.band.nprod == mod.y_pass.band.nprod == nprod
    bound = GRADE_BOUNDS[grade]
    got = box3(torch.from_numpy(img)).numpy()
    oracle = _sep_oracle(img, t1)
    _near(got, oracle, bound)
    _near(got, np.asarray(jfir.fir_separable_2d(
        jnp.asarray(img), [t1], tile_width=T, matmul_precision=grade,
        tap_scale=11.0 ** 3)), 2 * bound)
    got = dog(torch.from_numpy(img)).numpy()
    oracle = _sep_oracle(img, t1) - _sep_oracle(img, t2)
    _near(got, oracle, bound)
    _near(got, np.asarray(jfir.fir_separable_2d(
        jnp.asarray(img), [t1, t2], signs=[1.0, -1.0], tile_width=T,
        matmul_precision=grade, tap_scale=[11.0 ** 3, 19.0 ** 3])),
        2 * bound)


def test_box_gradient_matches_jax():
    img, ct = _x(H, W, seed=10), _x(H, W, seed=11)
    mod = tbox.box_filter_3(W, H, 3, T, device="cpu")
    xt = torch.from_numpy(img).requires_grad_()
    (g,) = torch.autograd.grad(mod(xt), xt, torch.from_numpy(ct))
    _, vjp = jax.vjp(jbox.box_filter_3(W, H, 3, T), jnp.asarray(img))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(ct))[0]),
                               rtol=1e-4, atol=1e-4)


def test_app_variants_route_as_the_jax_apps():
    """``variant="auto"`` picks the FIR form where 2nB+1 taps fit two
    tiles, as the JAX apps do, and the SAT forms past it: box ×3 as the
    order-1 box (its own rule) then the order-2 integrals, box ×6 as three
    order-2 stages, the DoG as the six-stage SAT pipeline."""
    for B, it in ((5, 3), (42, 3), (43, 3), (21, 6), (22, 6), (127, 1),
                  (128, 1)):
        assert (tbox._box_variant("auto", B, it, T, 512, 512)
                == jbox._box_variant("auto", B, it, T, 512, 512))
    box3 = tbox.box_filter_3(512, 512, 43, T, device="cpu")  # 259 taps
    assert [type(m) for m in box3.stages] == [tfir.FirSeparable2D,
                                              tbox._SatBox2]
    box6 = tbox.box_filter_6(512, 512, 5, T, variant="sat", device="cpu")
    assert [type(m) for m in box6.stages] == [tbox._SatBox2] * 3
    mod, (fx, fy) = tbox.box_filter_order_2(512, 512, 5, device="cpu")
    assert fx.plan.rotate_emit == fy.plan.rotate_emit == 2
    assert type(tdog.difference_of_gaussians(
        512, 512, 5, 43, T, device="cpu")).__name__ == "_DogSat"
    mod, F = tbox.box_filter_order_1(512, 512, 128, T, device="cpu")
    assert F is not None and isinstance(mod, tbox._SatBox1)
