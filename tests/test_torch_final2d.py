"""The port's kernel modules (``kernels/final2d.py``) against the JAX
package's Pallas kernels.

On the CPU the port's wrappers run their plain twins; the JAX side runs
``moments2d_px``/``final2d_px`` at px6 in Pallas interpret mode, as the
JAX package's own tests do. Bound: rtol=2e-5, atol=2e-6·scale — the bound
``tests/test_overlap2d.py`` holds the JAX px6 path to.
The CUDA kernels themselves are held to these twins on a card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from recfilter_tpu.kernels import final2d as jk2d

from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import iir as tiir
from recfilter_tpu_torch.kernels import final2d as tk2d
from recfilter_tpu_torch.kernels import launch as tl
from recfilter_tpu_torch.spec import Scan as TScan

P, NA, NB, T = 2, 2, 3, 128
# stack kinds: uniform (zero border), 3-variant clamp edges, pad projector
STACKS = {"uniform": (False, 0, 0), "clamp": (True, 0, 0),
          "pad": (False, 40, 72)}


def _mats(kind):
    """Matrices from the port's builders (equal to the JAX package's,
    ``test_torch_host.py``), fed to both packages' kernels."""
    clamp, pad_a, pad_b = STACKS[kind]
    w3 = tiir.gaussian_weights(5.0, 3)
    a = [TScan(0, True, w3[0], tuple(w3[1:])),
         TScan(0, False, w3[0], tuple(w3[1:]))]
    b = [TScan(1, True, 0.9, (0.6, 0.25, -0.1)),
         TScan(1, False, 1.1, (0.5, 0.2))]
    ma = tdf.prepare_dim_pass(a, T, NA, clamp, pad_slots=pad_a)
    mb = tdf.prepare_dim_pass(b, T, NB, clamp, pad_slots=pad_b)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    return ma, mb, cat(ma.G, 1), cat(mb.G, 1), cat(ma.Rhat, 2), cat(mb.Rhat, 2)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((P, NA, T, NB * T)).astype(np.float32)
    NA_t = rng.standard_normal((P, NA, 8, NB * T)).astype(np.float32)
    NB_t = rng.standard_normal((P, NA, NB * 8, T)).astype(np.float32)
    return x, NA_t, NB_t


def _assert_close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5,
                               atol=2e-6 * scale)


@pytest.mark.parametrize("kind", list(STACKS))
def test_moments2d_matches_jax(kind):
    ma, mb, Ga, Gb, _, _ = _mats(kind)
    x = _inputs()[0]
    bA_j, t1_j, used_t1, used_naf = jk2d.moments2d_px(
        x, Ga, Gb, nprod=6, interpret=True, term1_mats=ma.Btot)
    assert used_t1 and not used_naf
    bA, t1 = tk2d.moments2d(torch.from_numpy(x), Ga, Gb, ma.Btot)
    assert bA.shape == (P, NA, 8, NB * T) and t1.shape == (P, NA, NB * 8, T)
    _assert_close(bA.numpy(), bA_j)
    _assert_close(t1.numpy(), t1_j)
    Ka, Kb = Ga.shape[1], Gb.shape[1]
    assert not bA[:, :, Ka:].any()
    assert not t1.reshape(P, NA, NB, 8, T)[:, :, :, Kb:].any()


@pytest.mark.parametrize("kind", list(STACKS))
def test_final2d_matches_jax(kind):
    ma, mb, _, _, Ra, Rb = _mats(kind)
    x, NA_t, NB_t = _inputs(1)
    want = jk2d.final2d_px(x, ma.Btot, Ra, mb.Btot, Rb, NA_t, NB_t,
                           nprod=6, interpret=True)
    got = tk2d.final2d(torch.from_numpy(x), ma.Btot, Ra, mb.Btot, Rb,
                       torch.from_numpy(NA_t), torch.from_numpy(NB_t))
    assert got.shape == x.shape
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
def test_kernel_backward_is_the_twins_vjp(kind):
    """The CUDA path's backward (the twin's VJP taken at zero — both
    passes are linear) equals autograd through the twin at a real point."""
    ma, mb, Ga, Gb, Ra, Rb = _mats(kind)
    mom = tk2d.Moments2D(Ga, Gb, ma.Btot, NA, NB)
    fin = tk2d.Final2D(ma.Btot, Ra, mb.Btot, Rb, NA, NB)
    rng = np.random.default_rng(5)
    for mod, ins in ((mom, _inputs(2)[:1]), (fin, _inputs(3))):
        ins = [torch.from_numpy(a).requires_grad_() for a in ins]
        outs = mod.plain(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cts = [torch.from_numpy(rng.standard_normal(o.shape)
                                .astype(np.float32)) for o in outs]
        want = torch.autograd.grad(outs, ins, cts)
        got = tl._linear_vjp(mod.plain, [i.shape for i in ins],
                               torch.device("cpu"), cts)
        for g, w in zip(got, want):
            _assert_close(g.numpy(), w.numpy())
