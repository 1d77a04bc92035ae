"""bf16 products and the FIR band on bf16 images: the port's last TPU kernel
forms against the JAX package's.

Same seeded numpy inputs through the JAX package (its Pallas kernels in
interpret mode) and through the port's plain twins on the CPU:

  * ``FirBand`` / ``FirPass`` on a bf16 x (the JAX package's bf16 band,
    one product whatever the grade) against ``fir_band_pass`` and
    ``fir_pass_last``: the x pass (a bank, rotated) and the y pass (the
    signed contraction, rotated), the box³ and DoG's two radii; the
    separable bank on a bf16 image; ``fir_pass_last(matmul_dtype=
    "bfloat16")`` on float32 (``fir_band`` at one product, and its einsum
    form);
  * ``Final2DK(matmul_dtype="bfloat16")`` (``final2d_k_bf16``'s twin)
    against ``final2d(..., matmul_dtype=jnp.bfloat16)``, and the
    ``overlap_k`` backend at ``highest`` with ``Plan(matmul_dtype=
    "bfloat16")`` through ``as_func`` against the JAX package's
    ``realize()``;
  * the last-axis pass's einsum form on bf16 (more than 256 tiles, ΣK > 56,
    fewer than 8 lines, a rotated leading group with an epilogue) against
    ``apply_filter_fused`` on the bf16 image.

Bounds (:func:`_held`): the port within 3e-2 (the JAX package's bound of
its bf16 mode) of the peak of the f64 oracle of the float32 input, and
within twice the JAX package's error or 2⁻⁸ of the peak; the JAX package
held to 3e-2 too where it meets it — DoG's cancelling channels and the
JAX einsum form's bf16 carries may miss it (ROADMAP Queue 3), and each
case states which. The band's twin equals the JAX kernel's output where
both round the same fp32 sums (one bf16 step of the peak here at most);
``Final2DK``'s twin is within 1e-4 of the JAX output's peak (a Z element
whose fp32 sum rounds to the other bf16 neighbour moves y by one bf16 step
of Z times Btot_b). The CUDA kernels are held to these twins on a card by
``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recfilter_tpu as jrf
from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import fir as jfir
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import final2d as jk
from recfilter_tpu.kernels import fir_band as jfb

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import fir as tfir
from recfilter_tpu_torch import overlap2d as to
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.kernels import final2d as tk
from recfilter_tpu_torch.kernels import fir_band as tfb

T = 128
BF16_BOUND = 3e-2  # the JAX package's bound of its bf16 mode
W3 = rft.gaussian_weights(5.0, 3)
G3 = (float(W3[0]), tuple(float(c) for c in W3[1:]))
BOX3 = [tfir.box_taps(5, 3)]
DOG = [tfir.box_taps(5, 3), tfir.box_taps(9, 3)]  # the DoG app's radii


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(
        np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _err(got, want):
    return float(np.abs(_np(got) - want).max() / np.abs(want).max())


def _held(got, jax_out, want, jax_bound=True):
    """The port within :data:`BF16_BOUND` of the peak of the float64
    reference ``want`` and within twice the JAX package's error or 2⁻⁸ of
    the peak; the JAX package within the bound where ``jax_bound``.
    Returns the two errors."""
    e_port, e_jax = _err(got, want), _err(jax_out, want)
    assert not jax_bound or e_jax <= BF16_BOUND, e_jax
    assert e_port <= BF16_BOUND, e_port
    assert e_port <= max(2.0 * e_jax, 2.0 ** -8), (e_port, e_jax)
    return e_port, e_jax


# ------------------------------------------------------- the band on bf16

FIR_PASSES = {
    # label: (bank, pass, lines): the x pass fans 1 → C and emits rotated;
    # the y pass contracts C → 1 (signs folded) and emits rotated
    "box3-x": (BOX3, "x", 16),
    "box3-y": (BOX3, "y", 64),
    "dog-x": (DOG, "x", 32),
    "dog-y": (DOG, "y", 48),
}


@pytest.mark.parametrize("case", list(FIR_PASSES))
def test_fir_band_on_bf16_matches_jax_kernel(case):
    """``FirBand(nprod=1)`` on a bf16 x (``fir_band_bf16``'s twin): a bf16
    output, its float32 path on ``x.float()`` rounded once, within one
    bf16 step of the peak of ``fir_band_pass(nprod=1)`` on the bf16 x
    (interpret mode; both round the same fp32 sums), and held to the
    oracle of the float32 input; ``FirPass`` takes this route at every
    grade on a bf16 x."""
    bank, which, q = FIR_PASSES[case]
    taps = tfir._align_taps(bank)
    C, L = taps.shape[0], 256
    contract = which == "y" and C > 1
    signs = [1.0, -1.0] if contract else None
    x = _x(*((C, q, L) if contract else (q, L)), seed=q)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    band = tfb.FirBand(taps, rot=True, contract=contract, signs=signs,
                       nprod=1)
    got = band(xb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, band(xb.float()).to(torch.bfloat16))
    jax_out = jfb.fir_band_pass(jnp.asarray(x, jnp.bfloat16), taps, T=T,
                                rot=True, nprod=1, signs=signs,
                                contract=contract, interpret=True)
    assert jax_out.dtype == jnp.bfloat16
    peak = np.abs(_np(jax_out)).max()
    assert np.abs(_np(got) - _np(jax_out)).max() <= 2.0 ** -8 * peak
    sg = signs or [1.0] * C
    want = [tfir.fir_oracle(x[c] if contract else x, taps[c], -1)
            for c in range(C)]
    want = (sum(s * w for s, w in zip(sg, want)) if contract
            else np.stack(want) if C > 1 else want[0])
    _held(got, jax_out, np.swapaxes(want, -1, -2))
    shape = x.shape if contract else ((q, L))
    mod = tfir.FirPass(taps * np.asarray(sg)[:, None] if contract else taps,
                       shape, bank=C > 1 and not contract,
                       contract=contract, emit_rot=True,
                       matmul_precision="highest")
    assert mod.band is None and mod.band_bf16.nprod == 1
    assert torch.equal(mod(xb), got)


@pytest.mark.parametrize("bank,tile", [("box3", T), ("dog", 64)],
                         ids=["box3-band", "dog-einsum"])
def test_fir_separable_2d_on_bf16_matches_jax(bank, tile):
    """The separable bank on a bf16 image: both passes on their bf16 route
    (the band at one product, or past its gate at 64-wide tiles the
    einsum form on bf16 operands, rounded once), a bf16 output, against
    ``fir_separable_2d`` on the bf16 image and the oracle of the float32
    image. DoG's difference cancels: the JAX package misses 3e-2 there
    and the port is held to twice its error."""
    taps = BOX3 if bank == "box3" else DOG
    signs = None if bank == "box3" else [1.0, -1.0]
    h, w = 48, 256
    img = _x(h, w, seed=len(bank) + tile)
    xb = torch.from_numpy(img).to(torch.bfloat16)
    mod = tfir.FirSeparable2D(h, w, taps, signs=signs, tile_width=tile)
    assert (mod.x_pass.band_bf16 is None) == (tile != T)
    got = mod(xb)
    assert got.dtype == torch.bfloat16 and got.shape == (h, w)
    jax_out = jfir.fir_separable_2d(jnp.asarray(img, jnp.bfloat16), taps,
                                    signs=signs, tile_width=tile)
    assert jax_out.dtype == jnp.bfloat16
    sg = signs or [1.0]
    want = sum(s * tfir.fir_oracle(tfir.fir_oracle(
        img.astype(np.float64), t, 1), t, 0) for s, t in zip(sg, taps))
    _held(got, jax_out, want, jax_bound=bank == "box3")


@pytest.mark.parametrize("tile", [T, 64], ids=["band", "einsum"])
def test_fir_pass_last_bf16_products_on_float32(tile):
    """``fir_pass_last(matmul_dtype="bfloat16")`` on a float32 x: the
    float32 ``fir_band`` at one product (x rounded to bf16 on chip), or
    its einsum form on bf16-rounded operands, a float32 output; within
    1e-6 of the JAX package's output's peak (fp32 sums in another order)
    and held to the oracle."""
    taps = tfir.box_taps(5, 3)
    x = _x(16, 256, seed=tile)
    mod = tfir.FirPass(taps, x.shape, tile_width=tile,
                       matmul_dtype="bfloat16")
    assert (mod.band is not None and mod.band.nprod == 1) == (tile == T)
    got = mod(torch.from_numpy(x))
    assert got.dtype == torch.float32
    jax_out = jfir.fir_pass_last(jnp.asarray(x), taps, tile_width=tile,
                                 matmul_dtype="bfloat16")
    peak = np.abs(_np(jax_out)).max()
    assert np.abs(_np(got) - _np(jax_out)).max() <= 1e-6 * peak
    _held(got, jax_out, tfir.fir_oracle(x.astype(np.float64), taps, -1))


# ---------------------------------------------------- the HIGHEST pair

@pytest.mark.parametrize("Ta,clamp", [(32, False), (128, True)])
def test_final2d_k_bf16_twin_matches_jax(Ta, clamp):
    """``Final2DK(matmul_dtype="bfloat16")``'s twin against ``final2d(...,
    matmul_dtype=jnp.bfloat16)`` in interpret mode: within 1e-4 of the JAX
    output's peak (a Z element whose fp32 sum lands on the other side of
    a bf16 rounding moves y by one bf16 step of Z times Btot_b), and both
    held to the float64 product of the float32 operands."""
    p, na, nb = 2, 3, 2
    a = [tspec.Scan(0, c, *G3) for c in (True, False)]
    b = [tspec.Scan(1, c, 0.9, (0.6, 0.25, -0.1)) for c in (True, False)]
    ma = tdf.prepare_dim_pass(a, Ta, na, clamp)
    mb = tdf.prepare_dim_pass(b, T, nb, clamp)
    (_, Ra), (_, Rb) = to._cat_mats(ma), to._cat_mats(mb)
    rng = np.random.default_rng(Ta)
    x = rng.standard_normal((p, na, Ta, nb * T)).astype(np.float32)
    NA = rng.standard_normal((p, na, 6, nb * T)).astype(np.float32)
    NB = rng.standard_normal((p, na, nb, Ta, 6)).astype(np.float32)
    ops = [torch.from_numpy(v) for v in (x, NA, NB)]
    mod = tk.Final2DK(ma.Btot, Ra, mb.Btot, Rb, na, nb,
                      matmul_dtype="bfloat16")
    got = mod(*ops)
    assert got.dtype == torch.float32
    jax_out = jk.final2d(jnp.asarray(x), ma.Btot, Ra, mb.Btot, Rb,
                         jnp.asarray(NA), jnp.asarray(NB), True,
                         matmul_dtype=jnp.bfloat16)
    peak = np.abs(_np(jax_out)).max()
    assert np.abs(_np(got) - _np(jax_out)).max() <= 1e-4 * peak
    f32 = tk.Final2DK(ma.Btot, Ra, mb.Btot, Rb, na, nb)
    want = f32.double().plain(*(v.double() for v in ops)).numpy()
    _held(got, jax_out, want)
    with pytest.raises(ValueError):
        tk.Final2DK(ma.Btot, Ra, mb.Btot, Rb, na, nb, matmul_dtype="fp8")


def test_overlap_k_with_bf16_products_through_the_api():
    """``set_plan(backend="overlap_k", matmul_precision="highest",
    matmul_dtype="bfloat16")`` on the headline filter through
    ``as_func``: the HIGHEST pair with ``final2d_k_bf16``'s twin, against
    the JAX package's ``realize()`` (interpret) and the oracle."""
    img = (np.random.default_rng(4).standard_normal((256, 384)) * 0.01
           ).astype(np.float32)
    Fs = []
    for mod in (rft, jrf):
        x, y = mod.Dim("x", 384), mod.Dim("y", 256)
        F = mod.RecFilter("G")
        F[y, x] = img if mod is jrf else torch.from_numpy(img)
        for d in (+y, -y, +x, -x):
            F.add_filter(d, W3)
        F.split(x, 128, y, 128)
        F.set_plan(backend="overlap_k", matmul_precision="highest",
                   matmul_dtype="bfloat16")
        Fs.append(F)
    fn = Fs[0].as_func(device="cpu")
    assert isinstance(fn.stages[0], to.Fused2DK) and fn.stages[0].final.bf16
    got = fn(torch.from_numpy(img))
    jax_out = Fs[1].realize()
    js = Fs[1].spec
    want = jsc.oracle_apply(js, img.astype(np.float64))
    e_port, _ = _held(got, jax_out, want)
    assert e_port > 1e-4  # bf16 products: not the float32 pair's grade


# ----------------------------------------------- the einsum form on bf16

def _mix(y, a):
    return 0.75 * y + 0.25 * a


def _spec(m, shape, axes, tiles, orders=1, dtype="bfloat16"):
    scans = [m.Scan(ax, c, *G3) for ax in axes for _ in range(orders)
             for c in (True, False)]
    names = "wzyx"[-len(shape):]
    return m.FilterSpec("E", tuple(m.Dim(n, e) for n, e in zip(names, shape)),
                        tuple(scans), dtype=dtype, tile_widths=tiles)


EINSUM = {
    # label: (shape, scanned axes, tiles, Gaussians per axis, epilogue,
    # the JAX package within 3e-2)
    "over-256-tiles": ((33_000,), (0,), (T,), 1, False, False),
    "sum-K-over-56": ((16, 512), (1,), (0, T), 10, False, False),
    "few-lines": ((4, 1024), (1,), (0, T), 1, False, False),
    "rotated-group-epilogue": ((2, 128, 256), (1,), (0, T, 0), 1, True,
                               True),
}


@pytest.mark.parametrize("case", list(EINSUM))
def test_einsum_forms_in_bf16(case):
    """The last-axis pass's einsum form on a bf16 image, where its kernels'
    gates fail: the tails and completion products on the bf16 x and the
    bf16-rounded constants with float32 sums, the carries in float64, the
    output rounded once to bf16; against ``apply_filter_fused`` on the
    bf16 image (whose einsum form rounds its carries to bf16 and misses
    3e-2 on the longer chains: ROADMAP Queue 3) and the oracle."""
    shape, axes, tiles, orders, epi, jax_bound = EINSUM[case]
    js, ts = (_spec(m, shape, axes, tiles, orders) for m in (jspec, tspec))
    x = _x(*shape, seed=len(case), scale=0.1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    x64 = xb.double().numpy()
    aux = _x(*shape, seed=1) if epi else None
    kw = dict(epilogue=_mix) if epi else {}
    mod = tdf.fused_filter_module(ts, **kw)
    got = mod(xb, *((torch.from_numpy(aux),) if epi else ()))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    jax_out = jdf.apply_filter_fused(
        js, jnp.asarray(x, jnp.bfloat16),
        **(dict(epilogue=_mix, eaux=(jnp.asarray(aux),)) if epi else {}))
    assert jax_out.dtype == jnp.bfloat16
    want = jsc.oracle_apply(dataclasses.replace(js, dtype="float32"), x64)
    if epi:
        want = _mix(want, aux.astype(np.float64))
    _held(got, jax_out, want, jax_bound=jax_bound)
