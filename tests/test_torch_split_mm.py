"""The split-bf16 probes of ``scripts/`` as the port's studies
(``kernels/split_mm.py``) on the CPU: each twin against the probe's own
Pallas kernel in interpret mode, on the probe's shape and inputs, and the
Hopper mechanisms the probes have no kernel for (1xTF32, 3xTF32, fp32 FMA)
against a float64 product at their grades.

The bf16 twins take the probes' chunk products in another summation
order: 1e-5 of the peak. The probes' carry dot (``R·Nᵀ``, default or
HIGHEST precision) is a full float32 product on the CPU, the twins'
``carry=2``.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu_torch.kernels import split_mm as smm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 128


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"probe_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(L, W, seed=0):
    """The probes' B (T, T)/√T and x (L, W)·0.01 from one seeded stream."""
    rng = np.random.default_rng(seed)
    B = (rng.standard_normal((T, T)) / np.sqrt(T)).astype(np.float32)
    x = (rng.standard_normal((L, W)) * 0.01).astype(np.float32)
    return B, x


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _f64(Bn, x, R=None, N=None):
    """C[l][t·128 + o] = Σ_k Bn[o][k]·x[l, t·128 + k] (+ Σ_s R[o][s]·N[l][s])
    in float64, (L, n, 128)."""
    L, W = x.shape
    y = np.einsum("ok,lnk->lno", np.float64(Bn),
                  np.float64(x).reshape(L, W // T, T))
    if R is not None:
        y = y + (np.float64(N) @ np.float64(R).T)[:, None, :]
    return y


@pytest.mark.parametrize("nprod", [3, 6])
def test_pallas_split_mm(nprod):
    """``pallas_split_mm`` (y = x·B, x (131072, 128)): the twin at the
    same products, emitted in place."""
    psm = _script("pallas_split_matmul")
    B, x = _inputs(psm.N, T)
    want = np.asarray(jax.jit(psm.pallas_split_mm(B, nprod, True))(
        jnp.asarray(x)))
    got = smm.split_mm(torch.from_numpy(x), smm.bf16_operand(B.T, nprod),
                       nprod=nprod)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("emit", [1, 2])
def test_pallas_split_mm_t(emit):
    """``pallas_split_mm_t`` (4096², transposed emit, px3, the carry dot
    R·Nᵀ with S = 6): directly from the accumulators or through the
    shared-memory transpose, the carry in float32 after the product."""
    psm = _script("pallas_split_matmul")
    B, x = _inputs(4096, 4096, seed=1)
    fn, R, N = psm.pallas_split_mm_t(B, 4096, 6, 512, True)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    got = smm.split_mm(torch.from_numpy(x), smm.bf16_operand(B, 3), nprod=3,
                       emit=emit, carry=2, N=torch.from_numpy(np.array(N)),
                       R=torch.from_numpy(np.array(R)), lb=512)
    assert got.shape == (4096, 4096)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("Lb,nt,orient", [(512, 1, "t"), (1024, 2, "t"),
                                          (1024, 2, "s")])
def test_px3t_sweep(Lb, nt, orient):
    """``px3t_sweep.build``: px3, orientation "t" (the transposed product,
    ``emit=1``) or "s" (the product, then the float32 transpose,
    ``emit=2``), the HIGHEST carry dot after it (``carry=2``); the block
    width and tiles per block change no value."""
    p3 = _script("px3t_sweep")
    B, x = _inputs(p3.W, p3.W, seed=2)
    fn, R, N = p3.build(B, Lb, nt, orient)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    got = smm.split_mm(torch.from_numpy(x), smm.bf16_operand(B, 3), nprod=3,
                       emit=1 if orient == "t" else 2, carry=2,
                       N=torch.from_numpy(np.array(N)),
                       R=torch.from_numpy(np.array(R)), nt=nt, lb=Lb)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("variant", ["sep", "stack"])
def test_px6_stack(variant):
    """``px6_stack_exp.build``: six products as six dots or one stacked
    contraction, transposed emit, against the twin's six products."""
    p6 = _script("px6_stack_exp")
    B, x = _inputs(p6.W, p6.W, seed=3)
    want = np.asarray(jax.jit(p6.build(B, variant, 512))(jnp.asarray(x)))
    got = smm.split_mm(torch.from_numpy(x), smm.bf16_operand(B, 6), nprod=6,
                       emit=1, stack=variant == "stack", lb=512)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("nprod,bound,carry", [
    (1, 1e-2, 0), (1, 1e-2, 1), (3, 1e-4, 0), (3, 1e-4, 1), (4, 8e-5, 0),
    (4, 8e-5, 1), (6, 2e-6, 0), (6, 2e-6, 2)])
def test_bf16_grades_against_f64(nprod, bound, carry):
    """Every bf16 grade within its bound of the float64 product (1e-2 at
    one product), transposed emit, the carry in the contraction
    (``carry=1``), after it in float32 (``carry=2``: px6's operands with
    the carry rows would outgrow the card's shared memory) or none."""
    B, x = _inputs(512, 4 * T, seed=4)
    rng = np.random.default_rng(5)
    R = (rng.standard_normal((T, 6)) * 0.1).astype(np.float32)
    N = (rng.standard_normal((512, 6)) * 0.01).astype(np.float32)
    got = smm.split_mm(
        torch.from_numpy(x), smm.bf16_operand(B, nprod, R if carry == 1
                                              else None),
        nprod=nprod, emit=1, carry=carry,
        N=torch.from_numpy(N) if carry else None, R=torch.from_numpy(R))
    want = _f64(B, x, *((R, N) if carry else ()))
    got = got.numpy().reshape(4, T, 512).transpose(2, 0, 1)
    assert _rel(got, want) <= bound


@pytest.mark.parametrize("npass,lo,hi", [(1, 1e-5, 2e-3), (3, 0, 2e-6)])
@pytest.mark.parametrize("emit,carry", [(0, 0), (1, 1)])
def test_tf32_twin_against_f64(npass, lo, hi, emit, carry):
    """1xTF32 keeps 11 bits of each operand (error between 1e-5 and 2e-3
    of the peak); 3xTF32 reaches the float32 grade (2e-6)."""
    B, x = _inputs(256, 3 * T, seed=6)
    R = (np.random.default_rng(7).standard_normal((T, 6)) * 0.1
         ).astype(np.float32)
    N = (np.random.default_rng(8).standard_normal((256, 6)) * 0.01
         ).astype(np.float32)
    got = smm.split_mm_tf32(
        torch.from_numpy(x), smm.tf32_operand(B, R if carry else None),
        npass=npass, emit=emit, carry=carry,
        N=torch.from_numpy(N) if carry else None).numpy()
    want = _f64(B, x, *((R, N) if carry else ()))
    if emit:
        got = got.reshape(3, T, 256).transpose(2, 0, 1)
    err = _rel(got.reshape(want.shape), want)
    assert lo <= err <= hi


def test_tf32_round_is_round_to_nearest_away():
    """``tf32_round`` = ``cvt.rna.tf32.f32``: 10 mantissa bits, ties away
    from zero, signs kept."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    v = np.array([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -23,
                  -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11], np.float32)
    got = smm.tf32_round(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(
        got, np.array([one, one + ulp, one, -(one + ulp), one + 2 * ulp],
                      np.float32))


def test_fp32_twin_against_f64():
    B, x = _inputs(256, 2 * T, seed=9)
    got = smm.split_mm_fp32(torch.from_numpy(x), smm.fp32_operand(B),
                            emit=0).numpy()
    want = _f64(B, x)
    assert _rel(got.reshape(want.shape), want) <= 2e-6
