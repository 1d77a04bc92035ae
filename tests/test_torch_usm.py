"""The port's unsharp mask (``recfilter_tpu_torch.apps.unsharp_mask``)
against the JAX package's ``apps.usm.unsharp_mask`` on the same seeded
image, and against the f64 oracle of its cascade:

    USM = (1 + w)·I − w·Blur,  Blur = gaussian_3x_3y's two stages.

Sizes: the JAX tests' (``tests/test_apps.py:159-215``: 32² and 40² with
8-wide tiles, σ = 2 — the rotation chain, the epilogue as torch ops) and
256² with 128 tiles (the 3-touch executor, the combine in ``final2d``'s
store loop). Bounds: 2e-6 of the peak from the oracle (px6); 1e-5 from
the JAX package, whose fp32 glue misses px6 on these filters (ROADMAP
queue 3); merged against naive 1e-6.
"""

import numpy as np
import pytest
import torch

import recfilter_tpu as jrf
from recfilter_tpu import scan_core as jsc
from recfilter_tpu.apps.gaussian import gaussian_3x_3y as jgauss_3x_3y
from recfilter_tpu.apps.usm import unsharp_mask as junsharp

from recfilter_tpu_torch.apps import unsharp_mask

# (width, tile, sigma, weight)
CASES = {"32 tile 8": (32, 8, 2.0, 1.0), "40 tile 8": (40, 8, 2.0, 0.5),
         "256 tile 128": (256, 128, 5.0, 1.0)}


def _image(w, seed):
    return jrf.generate_random_image(w, w, lo=0, hi=1, seed=seed)


def _oracle(w, tile, sigma, weight, img):
    blur = img.astype(np.float64)
    for f in jgauss_3x_3y(w, w, tile, sigma):
        blur = jsc.oracle_apply(f.spec, blur)
    return (1.0 + weight) * img.astype(np.float64) - weight * blur


@pytest.mark.parametrize("case", list(CASES))
def test_unsharp_mask_matches_jax_and_oracle(case):
    w, tile, sigma, weight = CASES[case]
    img = _image(w, seed=8)
    mod = unsharp_mask(w, w, tile, sigma, weight, device="cpu")
    assert mod.usm_route == "merged"
    got = mod(torch.from_numpy(img)).numpy()
    ref = _oracle(w, tile, sigma, weight, img)
    peak = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 2e-6 * peak
    want = np.asarray(junsharp(w, w, tile, sigma, weight)(img))
    assert np.abs(got - want).max() <= 1e-5 * peak


def test_merged_route_rides_the_final_kernel():
    """At 256² the merged filter is the 3-touch executor and the combine
    its final kernel's affine epilogue, the image its one aux."""
    mod = unsharp_mask(256, 256, 128, device="cpu")
    (fused,) = mod.stages
    assert type(fused).__name__ == "Fused2DPx"
    assert fused.epilogue_route == "kernel"
    assert fused.affine.scale == -1.0 and fused.affine.aux_weights == (2.0,)


@pytest.mark.parametrize("case", list(CASES))
def test_merged_equals_naive(case):
    w, tile, sigma, weight = CASES[case]
    img = torch.from_numpy(_image(w, seed=9))
    a = unsharp_mask(w, w, tile, sigma, weight, device="cpu")(img)
    naive = unsharp_mask(w, w, tile, sigma, weight, fused=False,
                         device="cpu")
    assert naive.usm_route == "naive"
    b = naive(img)
    assert (a - b).abs().max() <= 1e-6 * b.abs().max()


@pytest.mark.parametrize("precision,route", [("px6", "merged"),
                                             ("highest", "staged")])
def test_route_gate(precision, route):
    """The JAX package's gate on the built filters' own precision: px6
    merges the cascade, ``highest`` (einsum passes) keeps the stages, the
    combine the last one's epilogue. Both within 2e-6 of the oracle."""
    w, tile, sigma, weight = CASES["32 tile 8"]
    img = _image(w, seed=8)
    mod = unsharp_mask(w, w, tile, sigma, weight, matmul_precision=precision,
                       device="cpu")
    assert mod.usm_route == route
    ref = _oracle(w, tile, sigma, weight, img)
    got = mod(torch.from_numpy(img)).numpy()
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()


def test_default_precision_is_not_ported():
    """``default`` — refused until the rotation chain ran at the reduced
    grades — takes the JAX package's merged route (its gate merges at the
    px grades and ``default``); at 32² with 8-wide tiles the merged filter
    is a rotation chain on its einsum forms at the grade, within
    ``default``'s bound 3e-2 of the oracle."""
    w, tile, sigma, weight = CASES["32 tile 8"]
    img = _image(w, seed=8)
    mod = unsharp_mask(w, w, tile, sigma, weight,
                       matmul_precision="default", device="cpu")
    assert mod.usm_route == "merged"
    ref = _oracle(w, tile, sigma, weight, img)
    got = mod(torch.from_numpy(img)).numpy()
    assert np.abs(got - ref).max() <= 3e-2 * np.abs(ref).max()


def test_gradient_through_the_combine():
    """The image's gradient flows through the filter and the combine (the
    aux operand), on the merged route as on the naive one."""
    img = _image(256, seed=3)
    grads = []
    for fused in (True, False):
        x = torch.from_numpy(img).requires_grad_()
        y = unsharp_mask(256, 256, 128, fused=fused, device="cpu")(x)
        (g,) = torch.autograd.grad((y ** 2).sum(), x)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)
