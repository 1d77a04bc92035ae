"""The port's 3-touch 2-D executor against the JAX package's and the f64
oracle, forward and gradient.

Same numpy inputs through ``recfilter_tpu.overlap2d.fused_2d_px`` (px6,
Pallas interpret mode) and ``recfilter_tpu_torch.overlap2d.fused_2d_px``
(plain twins on the CPU). Bound: rtol=2e-5, atol=2e-6·scale — the bound
``tests/test_overlap2d.py`` holds the JAX px6 path to; gradients within
1e-4, its gradient bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import iir as jiir
from recfilter_tpu import overlap2d as jo2
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import overlap2d as to2
from recfilter_tpu_torch import spec as tspec


def _gauss_scans(mod, sigma=2.0):
    """3rd-order Gaussian, causal + anticausal on x (axis -1) and y."""
    w = jiir.gaussian_weights(sigma, 3)
    s = lambda ax, c: mod.Scan(ax, c, w[0], tuple(w[1:]))
    return [s(1, True), s(1, False), s(0, True), s(0, False)]


def _mixed_scans(mod):
    return [mod.Scan(1, True, 1.0, (0.5, 0.25)),
            mod.Scan(0, False, 1.0, (0.4,))]


def _img(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check(got, want):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=2e-5, atol=2e-6 * scale)


@pytest.mark.parametrize("h,w,border,scans", [
    (128, 256, "zero", _gauss_scans),
    (128, 256, "clamp", _gauss_scans),
    (130, 250, "zero", _mixed_scans),
    (130, 250, "zero", _gauss_scans),
])
def test_fused_2d_px_matches_jax_and_oracle(h, w, border, scans):
    x = _img(h, w, seed=h + w)
    js, ts = scans(jspec), scans(tspec)
    spec = jspec.FilterSpec("O", (jspec.Dim("y", h), jspec.Dim("x", w)),
                            tuple(js), border=border)
    jsa = [s for s in js if s.axis == 0]
    jsb = [s for s in js if s.axis == 1]
    want_jax = jo2.fused_2d_px(x, 0, jsa, 1, jsb, border, 6, True)
    assert want_jax is not None
    got = to2.fused_2d_px(
        torch.from_numpy(x), 0, [s for s in ts if s.axis == 0],
        1, [s for s in ts if s.axis == 1], border)
    assert got.shape == (h, w) and got.dtype == torch.float32
    _check(got.numpy(), want_jax)
    _check(got.numpy(), jsc.oracle_apply(spec, x.astype(np.float64)))


def _batch_spec(mod):
    return mod.FilterSpec(
        "PXB", (mod.Dim("c", 2), mod.Dim("y", 128), mod.Dim("x", 128)),
        (mod.Scan(2, True, 1.0, (0.5,)), mod.Scan(1, True, 1.0, (0.4,))),
        tile_widths=(0, 128, 128))


def test_batch_matches_jax_and_oracle():
    """A leading batch axis folds into the kernels' grid."""
    x = _img(2, 128, 128, seed=22)
    jspec_b = _batch_spec(jspec)
    want_jax = np.asarray(jdf.apply_filter_fused(
        jspec_b, jnp.asarray(x), matmul_precision="px6"))
    got = rft.apply_filter_fused(_batch_spec(tspec), torch.from_numpy(x))
    _check(got.numpy(), want_jax)
    _check(got.numpy(), jsc.oracle_apply(jspec_b, x.astype(np.float64)))


def _gauss_clamp_spec(mod):
    """The headline filter's scans (σ=5), clamp border, 256×128."""
    return mod.FilterSpec(
        "G", (mod.Dim("y", 256), mod.Dim("x", 128)),
        tuple(_gauss_scans(mod, 5.0)), border="clamp",
        tile_widths=(128, 128))


@pytest.mark.parametrize("spec_fn", [_batch_spec, _gauss_clamp_spec],
                         ids=["batch", "gauss-clamp"])
def test_gradient_matches_jax(spec_fn):
    """torch.autograd through the port against jax.grad through the JAX
    package's px6 executor, for sum(y²)."""
    js, ts = spec_fn(jspec), spec_fn(tspec)
    x = _img(*[d.extent for d in js.dims], seed=7)

    g_jax = np.asarray(jax.grad(lambda v: jnp.sum(jdf.apply_filter_fused(
        js, v, matmul_precision="px6") ** 2))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(
        (rft.apply_filter_fused(ts, xt) ** 2).sum(), xt)
    np.testing.assert_allclose(g.numpy(), g_jax, rtol=1e-4, atol=1e-4)


def test_module_plain_path_equals_forward_on_cpu():
    """On the CPU ``forward`` runs the twins, so it equals ``forward_plain``
    bit for bit; the module is built once and reused across batch sizes."""
    ts = _gauss_scans(tspec, 5.0)
    mod = to2.Fused2DPx(ts[2:], ts[:2], 200, 300, "zero")
    for shape in [(200, 300), (3, 200, 300)]:
        x = torch.from_numpy(_img(*shape, seed=len(shape)))
        assert torch.equal(mod(x), mod.forward_plain(x))
    with pytest.raises(ValueError):
        mod(torch.zeros(200, 299))
    with pytest.raises(TypeError):
        mod(torch.zeros(200, 300, dtype=torch.float64))


@pytest.mark.parametrize("border", ["zero", "clamp"])
@pytest.mark.parametrize("h,w", [(8192, 128), (128, 8192)],
                         ids=["dim-a", "dim-b"])
def test_banded_solve_from_64_tiles(h, w, border):
    """64 tiles on one dimension, where ``fused_2d_px`` switches that
    dimension's carry solve to the banded form — and so does the port:
    within the px6 bound of the oracle. Banded on y (dim A), the JAX
    executor agrees (1e-5·peak: the JAX px6 path sits a few 1e-6 from the
    oracle on σ=5 Gaussians). Banded on x (dim B), the JAX executor is
    wrong — its banded dim-B solve restores the carries in slot-major
    order (``recfilter_tpu/overlap2d.py:410-412``), 5.8 times the peak
    off at 128 × 8192 — so the port is held to the oracle alone there."""
    x = _img(h, w, seed=5)
    ts, js = _gauss_scans(tspec, 5.0), _gauss_scans(jspec, 5.0)
    mod = to2.Fused2DPx(ts[2:], ts[:2], h, w, border)
    d = "a" if h > w else "b"
    assert len(mod.offsets[d]) < 16  # a band, not the 64 × 64 blocks
    names = {n for n, _ in mod.named_buffers()}
    assert f"bands_{d}" in names and f"CM{d}_p" not in names
    got = mod(torch.from_numpy(x)).numpy()
    spec = jspec.FilterSpec("B", (jspec.Dim("y", h), jspec.Dim("x", w)),
                            tuple(js), border=border)
    oracle = jsc.oracle_apply(spec, x.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    if d == "a":
        want = np.asarray(jo2.fused_2d_px(jnp.asarray(x), 0, js[2:], 1,
                                          js[:2], border, 6, True))
        assert np.abs(got - want).max() <= 1e-5 * peak
