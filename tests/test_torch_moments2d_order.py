"""The bit-level twins of ``moments2d_naf`` and ``moments2d_k``
(``csrc/moments2d.cu``): ``Moments2D.naf_ordered`` and
``Moments2DK.ordered`` sum in float64 in the kernels' own order, with the
card's fp64 FMA emulated by ``fma64`` where a product is inexact, so the
card tests (``tests/test_torch_cuda.py``) hold those kernels to their
bits.

Here, on the CPU: ``fma64`` against the exact rational a·b + c rounded
once to float64 (random operands, cancellations, and sums within an ulp
of a rounding tie), and a plain ``c + a·b`` as the control that misses;
then each ordered twin against the same float64 products summed by
einsum (another order; each output rounded once to float32): within 2⁻²²
of each output plus 1e-12 of the peak (the solve: also a float32 ulp of
each tail it reads, times its weight).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import iir as tiir
from recfilter_tpu_torch.kernels import final2d as tk2d
from recfilter_tpu_torch.kernels.completion import pad_solve_matrix
from recfilter_tpu_torch.spec import Scan as TScan

T = 128
STACKS = {"uniform": (False, 0, 0), "clamp": (True, 0, 0),
          "pad": (False, 40, 72)}


def _fma_cases(kind, n=4000, seed=0):
    """(a, b, c) float64 arrays, b float32 values."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
    b = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
         ).astype(np.float32).astype(np.float64)
    c = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    if kind == "cancellation":  # c within a few ulps of −a·b
        c = -(a * b) * (1 + rng.integers(-4, 5, n) * 2.0 ** -52)
    elif kind == "near ties":  # a·b a hair (2⁻⁶⁹, 2⁻⁷²) off half c's
        # ulp, and RN(a·b) on it: one rounding and two part there
        up = rng.integers(0, 2, n).astype(bool)
        b = np.where(up, 1 + 2.0 ** -23, 1 - 2.0 ** -24)
        a = np.where(up, 1 - 2.0 ** -23 + 2.0 ** -46,
                     1 + 2.0 ** -24 + 2.0 ** -48) * 2.0 ** -53
        c = 1.0 + rng.integers(0, 2 ** 20, n) * 2.0 ** -52
        scale = np.exp2(rng.integers(-20, 20, n))
        a, c = a * scale, c * scale
    return a, b, c


@pytest.mark.parametrize("kind", ["random", "cancellation", "near ties"])
def test_fma64_rounds_once(kind):
    a, b, c = _fma_cases(kind)
    got = tk2d.fma64(*map(torch.from_numpy, (a, b, c))).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)
    assert not np.array_equal(c + a * b, want)  # two roundings miss


def _naf_module(kind, na, nb):
    clamp, pad_a, pad_b = STACKS[kind]
    w3 = tiir.gaussian_weights(5.0, 3)
    a = [TScan(0, True, w3[0], tuple(w3[1:])),
         TScan(0, False, w3[0], tuple(w3[1:]))]
    b = [TScan(1, True, 0.9, (0.6, 0.25, -0.1)),
         TScan(1, False, 1.1, (0.5, 0.2))]
    ma = tdf.prepare_dim_pass(a, T, na, clamp, pad_slots=pad_a)
    mb = tdf.prepare_dim_pass(b, T, nb, clamp, pad_slots=pad_b)
    cat = lambda ms: np.concatenate([np.asarray(m) for m in ms], axis=1)
    CM = pad_solve_matrix(tdf.combined_solve_matrix(ma, na), na,
                          int(sum(ma.orders)))
    return tk2d.Moments2D(cat(ma.G), cat(mb.G), ma.Btot, na, nb, solve=CM)


def _close(got, want, mag=None):
    """|got − want| ≤ 2⁻²² of ``mag`` (|want| by default) + 1e-12 of the
    peak, everywhere."""
    w = want.double()
    mag = w.abs() if mag is None else mag
    return bool(((got.double() - w).abs() <= 2.0 ** -22 * mag
                 + 1e-12 * w.abs().max()).all())


def _tiles(M, n):
    """A kernel operand's variants (1|3, ...) per tile, float64."""
    return M.double()[[tk2d._variant(M.shape[0], i, n) for i in range(n)]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", list(STACKS))
def test_naf_ordered_is_the_twin(kind, dtype):
    """``naf_ordered`` (float32 or bf16 x) against the kernel's operands
    summed by einsum in float64 (the solve's bound also takes a float32
    ulp of each tail it reads), within 1e-5 of ``plain``'s peak (its
    matrices unrounded), the pad slots zero."""
    p, na, nb = 1, 3, 2
    mod = _naf_module(kind, na, nb)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (p, na, T, nb * T)).astype(np.float32)).to(dtype)
    NA_t, term1 = mod.naf_ordered(x)
    xd = x.float().double()
    tails = torch.einsum("aks,pasw->pakw", _tiles(mod.Ga_v, na), xd)
    U = torch.einsum("bkt,pasbt->pabks", _tiles(mod.Gb_v, nb),
                     xd.reshape(p, na, T, nb, T))
    t1 = torch.einsum("aso,pabks->pabko", _tiles(mod.Ba1T_v, na), U)
    CM = mod.CMaT.t().reshape(na, 8, na, 8)
    tails = tails.float().double()
    NA = torch.einsum("ikaj,pajw->pikw", CM, tails)
    mag = torch.einsum("ikaj,pajw->pikw", CM.abs(), tails.abs())
    assert _close(term1, t1.reshape(p, na, nb * 8, T))
    assert _close(NA_t, NA, NA.abs() + mag)
    for got, want in zip((NA_t, term1), mod.plain(x)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert not NA_t[:, :, 6:].any()  # Ka = 6
    assert not term1.reshape(p, na, nb, 8, T)[:, :, :, 5:].any()  # Kb = 5
    with pytest.raises(ValueError, match="solve="):
        tk2d.Moments2D(mod.Ga_v[0].double().numpy()[None, :6],
                       mod.Gb_v[0].double().numpy()[None, :5],
                       np.eye(T)[None], na, nb).naf_ordered(x)


@pytest.mark.parametrize("Ta", [32, 128])
@pytest.mark.parametrize("kind", ["uniform", "clamp"])
def test_moments2dk_ordered_is_the_twin(Ta, kind):
    w3 = tiir.gaussian_weights(5.0, 3)
    a = [TScan(0, c, w3[0], tuple(w3[1:])) for c in (True, False)]
    b = [TScan(1, c, 0.9, (0.6, 0.25, -0.1)) for c in (True, False)]
    p, na, nb = 1, 3, 2
    ma = tdf.prepare_dim_pass(a, Ta, na, kind == "clamp")
    mb = tdf.prepare_dim_pass(b, T, nb, kind == "clamp")
    cat = lambda ms: np.concatenate([np.asarray(m) for m in ms], axis=1)
    mod = tk2d.Moments2DK(cat(ma.G), cat(mb.G), na, nb)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (p, na, Ta, nb * T)).astype(np.float32))
    for got, want in zip(mod.ordered(x), mod.plain(x)):
        assert got.shape == want.shape and _close(got, want)
