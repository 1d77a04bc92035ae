"""The int8 and bf16 probes of ``scripts/`` as the port's studies
(``kernels/int8_mm.py``) on the CPU: the host slicing against the probe
script's own helpers, bit for bit; the dual-completion twins against the
float64 product and against the figures the script prints in interpret
mode; the GEMM twins against integer and float64 products.

The Ozaki twin repeats the script's arithmetic step for step (exact int32
level sums, float32 recombination in its order), so its error is the
script's own. The px6 twin sums each chunk product in float64 and rounds
it once (the script's dot on the CPU sums in float32 in another order):
within a factor of 2 of the script's figure.
"""

import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import iir as jiir
from recfilter_tpu.spec import Scan as JScan

from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import iir as tiir
from recfilter_tpu_torch.kernels import int8_mm as im
from recfilter_tpu_torch.kernels import split
from recfilter_tpu_torch.spec import Scan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 128


def _script():
    spec = importlib.util.spec_from_file_location(
        "int8_ozaki_exp", os.path.join(REPO, "scripts", "int8_ozaki_exp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _btot(W=256):
    """The script's constant: the σ=5 Gaussian pair's Btot (128 × 128)."""
    w = tiir.gaussian_weights(5.0, 3)
    scans = [Scan(1, True, w[0], tuple(w[1:])),
             Scan(1, False, w[0], tuple(w[1:]))]
    return np.asarray(tdf.prepare_dim_pass(scans, T, W // T, False).Btot,
                      np.float64)[0]


def _x(W, seed=0):
    """The script's input block x[:, :1, :, :Lb] of (1, na, 128, W)·0.7."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, W // T, T, W)) * 0.7).astype(np.float32)
    Lb = 2048 if W % 2048 == 0 else W
    return x[:, :1, :, :Lb]


def _y64(B, xs):
    """The dual completion in float64 (the script's oracle)."""
    Lb = xs.shape[-1]
    z = np.einsum("os,pasw->paow", B, xs.astype(np.float64))
    y = np.einsum("ot,pasct->pasco", B, z.reshape(1, 1, T, Lb // T, T))
    return y.reshape(xs.shape)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_constant_matches_the_jax_package():
    """The port's Btot is the JAX package's, the script's constant."""
    w = jiir.gaussian_weights(5.0, 3)
    scans = [JScan(1, True, w[0], tuple(w[1:])),
             JScan(1, False, w[0], tuple(w[1:]))]
    want = np.asarray(jdf.prepare_dim_pass(scans, T, 2, False).Btot)[0]
    np.testing.assert_allclose(_btot(), want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("which", ["gaussian", "random", "signed"])
def test_host_slicing_is_the_scripts(which):
    """``int8_const`` = ``_int8_const_np`` and ``px6_operand``'s chunks =
    ``_split_const_np``, bit for bit; the level operand lays level d's
    slices at columns OFFS[d]·128."""
    mod = _script()
    rng = np.random.default_rng(3)
    M = {"gaussian": _btot(), "random": rng.random((T, T)),
         "signed": rng.standard_normal((T, T)) * 37.0}[which]
    want, eB = mod._int8_const_np(M)
    got, eB2 = im.int8_const(M)
    assert eB == eB2
    for g, w in zip(got, want):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, w)
    C, e = im.ozaki_operand(M)
    assert 2.0 ** e == eB and tuple(C.shape) == (T, 10 * T)
    for d in range(4):
        lvl = C[:, im.OFFS[d] * T:im.OFFS[d + 1] * T].numpy()
        np.testing.assert_array_equal(lvl, np.concatenate(want[:d + 1], 1))
    chunks = mod._split_const_np(M, 3)
    Ac = im.px6_operand(M)
    assert tuple(Ac.shape) == (3, T, T + 8)
    for i, c in enumerate(chunks):
        np.testing.assert_array_equal(Ac[i, :, :T].float().numpy(),
                                      c.astype(np.float32))
        assert not Ac[i, :, T:].float().any()


def test_slices_rebuild_the_block():
    """Four slices rebuild each value to 2^-28 of its block's scale; each
    slice lies in [-64, 64]; the scale is a power of two with
    2^26 ≤ max·up < 2^27."""
    rng = np.random.default_rng(1)
    v = torch.from_numpy((rng.standard_normal((3, T, 2 * T)) * 5.0)
                         .astype(np.float32))
    dn, sl = im.slice_int8(v, (1, 2))
    m = v.abs().amax((1, 2), keepdim=True)
    up, _ = im.exp_scale(m)
    scaled = (m * up).double()
    assert ((scaled >= 2.0 ** 26) & (scaled < 2.0 ** 27)).all()
    assert torch.equal(up.double() * dn.double(), torch.ones_like(scaled))
    rebuilt = sum(s.double() * 2.0 ** (21 - 7 * i) for i, s in enumerate(sl))
    err = (rebuilt * dn.double() - v.double()).abs() / (dn.double() * 2 ** 27)
    assert err.max() <= 2.0 ** -28
    for s in sl:
        assert torch.equal(s, s.round()) and s.abs().max() <= 64


@pytest.mark.parametrize("W", [256, 512, 1024])
def test_twins_against_the_f64_product(W):
    """Ozaki ≤ 2e-7 and px6 ≤ 3e-7 of the f64 product's peak (the
    script's block: one 128-row block, Lb columns)."""
    B, xs = _btot(W), _x(W)
    y64 = _y64(B, xs)
    Ca, ea = im.ozaki_operand(B)
    Ac = im.px6_operand(B)
    x = torch.from_numpy(np.ascontiguousarray(xs))
    e8 = _rel(im.ozaki_i8(x, Ca, ea, Ca, ea).numpy(), y64)
    e6 = _rel(im.dual_px6(x, Ac, Ac).numpy(), y64)
    assert e8 <= 2e-7, e8
    assert e6 <= 3e-7, e6


def test_twins_against_the_script_figures():
    """At W = 256 each twin's error lies within a factor of 2 of the
    figure ``scripts/int8_ozaki_exp.py --check-only`` prints (Pallas
    interpret mode on the CPU)."""
    env = dict(os.environ, RECFILTER_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "scripts/int8_ozaki_exp.py", "--check-only", "--w",
         "256"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300, check=True).stdout
    figs = dict(re.findall(r"(\w+): max rel err vs f64 = ([0-9.e+-]+)", out))
    B, xs = _btot(256), _x(256)
    y64 = _y64(B, xs)
    Ca, ea = im.ozaki_operand(B)
    Ac = im.px6_operand(B)
    x = torch.from_numpy(np.ascontiguousarray(xs))
    got = {"int8": _rel(im.ozaki_i8_plain(x, Ca, ea, Ca, ea).numpy(), y64),
           "px6": _rel(im.dual_px6_plain(x, Ac, Ac).numpy(), y64)}
    for name, e in got.items():
        fig = float(figs[name])
        assert fig / 2 <= e <= 2 * fig, (name, e, fig)


def test_ozaki_twin_on_many_blocks():
    """P, na > 1 and several scale blocks: every block sliced on its own
    scale, equal to the twin run block by block."""
    B = _btot()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, T, 4 * T)).astype(np.float32)
    x[1, 2] *= 1e3  # one block far larger: its own scale
    xt = torch.from_numpy(x)
    Ca, ea = im.ozaki_operand(B)
    y = im.ozaki_i8_plain(xt, Ca, ea, Ca, ea, Lb=2 * T)
    for p in range(2):
        for a in range(3):
            for l in range(2):
                blk = xt[p:p + 1, a:a + 1, :, l * 2 * T:(l + 1) * 2 * T]
                want = im.ozaki_i8_plain(blk.contiguous(), Ca, ea, Ca, ea)
                assert torch.equal(y[p, a, :, l * 2 * T:(l + 1) * 2 * T],
                                   want[0, 0])
    z64 = np.einsum("os,pasw->paow", B, x.astype(np.float64))
    y64 = np.einsum("ot,pasct->pasco", B, z64.reshape(2, 3, T, 4, T)
                    ).reshape(x.shape)
    assert _rel(y.numpy(), y64) <= 2e-7


def test_px6_twin_is_the_chunk_algebra():
    """dual_px6's twin sums the six pairs of ``split.prods(6)``; its error
    sits far below one bf16 product's, above the exact f32 product's."""
    assert split.prods(6) == _script()._prods6()
    B, xs = _btot(), _x(256)
    y64 = _y64(B, xs)
    x = torch.from_numpy(np.ascontiguousarray(xs))
    e6 = _rel(im.dual_px6_plain(x, im.px6_operand(B),
                                im.px6_operand(B)).numpy(), y64)
    assert 1e-9 < e6 < 3e-7


@pytest.mark.parametrize("shape", [(128, 128, 64), (256, 384, 320)])
def test_gemm_twins(shape):
    """gemm_i8's int32 sums equal the int64 product, its store the sums
    >> 13 in their low 8 bits; gemm_bf16 is the float64 product rounded
    to bf16 (within one bf16 step of the peak)."""
    M, N, K = shape
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(-100, 100, (M, K)).astype(np.int8))
    bt = torch.from_numpy(rng.integers(-100, 100, (N, K)).astype(np.int8))
    exact = a.long() @ bt.long().t()
    raw = im.gemm_i8(a, bt, raw=True)
    assert raw.dtype == torch.int32 and torch.equal(raw.long(), exact)
    y = im.gemm_i8(a, bt)
    assert y.dtype == torch.int8
    want = ((exact >> 13) & 0xFF)
    assert torch.equal(y.long() & 0xFF, want)
    af = torch.from_numpy(rng.standard_normal((M, K)) * 0.01).to(
        torch.bfloat16)
    bf = torch.from_numpy(rng.standard_normal((N, K)) * 0.01).to(
        torch.bfloat16)
    c = im.gemm_bf16(af, bf)
    assert c.dtype == torch.bfloat16
    c64 = af.double() @ bf.double().t()
    assert ((c.double() - c64).abs().max() / c64.abs().max()) <= 2.0 ** -8


def test_wrappers_refuse_bad_shapes():
    x = torch.zeros(1, 1, 64, 256)
    Ca, ea = im.ozaki_operand(_btot())
    with pytest.raises(ValueError):
        im.ozaki_i8(x, Ca, ea, Ca, ea)
    with pytest.raises(ValueError):
        im.ozaki_i8(torch.zeros(1, 1, T, 384), Ca, ea, Ca, ea, Lb=256)
    with pytest.raises(ValueError):
        im.dual_px6(torch.zeros(1, 1, T, 200), im.px6_operand(_btot()),
                    im.px6_operand(_btot()))
