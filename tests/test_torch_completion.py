"""The port's 1-D kernel modules (``kernels/completion.py``) against the
JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain twins; the JAX side runs
``tails_pass``/``completion_pass`` at px6 (``rot=False``, transposed
slot-padded carries) in Pallas interpret mode, as the JAX package's own
tests do (``tests/test_kernels.py``). Same numpy-seeded inputs; bound
rtol=2e-5, atol=2e-6·scale — the px6 bound of the port's other kernel
tests. The CUDA kernels themselves are held to these twins on a card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from recfilter_tpu.kernels import completion as jc

from recfilter_tpu_torch.kernels import completion as tc
from recfilter_tpu_torch.kernels import launch as tl

N_TILES, T = 4, 128
STACKS = ["uniform", "clamp", "pad"]
CARRIES = [2, 6, 8, 12, 29]  # one slot up to 8; 2 and 4 slots past it


def _stack(kind, rows, cols, rng, scale=1.0):
    """A per-tile matrix stack as ``prepare_dim_pass`` shapes them:
    uniform (1 matrix), clamp (first and last tiles differ from the
    interior), pad (the last tile differs)."""
    M = [rng.standard_normal((rows, cols)) * scale for _ in range(3)]
    if kind == "uniform":
        return M[0][None]
    first = M[1] if kind == "clamp" else M[0]
    return np.stack([first] + [M[0]] * (N_TILES - 2) + [M[2]])


def _carries(S, q, rng):
    """(n, sl, q) slot-padded carries with zero pad rows, as the port's
    tails kernel and solves produce them."""
    N = np.zeros((N_TILES, tc.slots_for(S), q), np.float32)
    N[:, :S] = rng.standard_normal((N_TILES, S, q))
    return N


def _assert_close(got, want):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=2e-5, atol=2e-6 * scale)


CASES = ([(k, S, 37) for k in STACKS for S in CARRIES]
         + [("clamp", 6, 8), ("pad", 29, 8)])


@pytest.mark.parametrize("kind,S,q", CASES)
def test_tails_matches_jax(kind, S, q):
    rng = np.random.default_rng(S * 100 + q)
    x = rng.standard_normal((q, N_TILES, T)).astype(np.float32)
    G = _stack(kind, S, T, rng)
    want = jc.tails_pass(x, G, nprod=6, interpret=True)
    got = tc.TailsPass(G, N_TILES).plain(torch.from_numpy(x))
    assert got.shape == (N_TILES, tc.slots_for(S), q)
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want)
    assert not got[:, S:].any()  # pad slots are zeros


@pytest.mark.parametrize("kind,S,q", CASES)
def test_completion_matches_jax(kind, S, q):
    rng = np.random.default_rng(S * 100 + q + 1)
    x = rng.standard_normal((q, N_TILES, T)).astype(np.float32)
    Btot = _stack(kind, T, T, rng, 0.1)
    Rcat = _stack(kind, T, S, rng)
    N = _carries(S, q, rng)
    want = jc.completion_pass(x, Btot, Rcat, N, rot=False, nprod=6,
                              interpret=True, carries_transposed=True)
    got = tc.CompletionPass(Btot, Rcat, N_TILES).plain(
        torch.from_numpy(x), torch.from_numpy(N))
    assert got.shape == x.shape and got.dtype == torch.float32
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("T_,q,n,S", [(128, 8, 512, 56), (128, 7, 4, 6),
                                      (128, 8, 513, 6), (128, 8, 4, 57),
                                      (101, 64, 4, 6)])
def test_completion_gate_matches_jax(T_, q, n, S):
    assert tc.completion_ok(T_, q, n, S) == jc.completion_ok(
        T_, q, n, S, True)
    assert tc.slots_for(S) == jc.slots_for(S)


def test_kernel_backward_is_the_twins_vjp():
    """The CUDA path's backward (the twin's VJP taken at zero — both
    passes are linear) equals autograd through the twin at a real point."""
    rng = np.random.default_rng(11)
    q, S = 9, 12
    tails = tc.TailsPass(_stack("clamp", S, T, rng), N_TILES)
    comp = tc.CompletionPass(_stack("pad", T, T, rng, 0.1),
                             _stack("pad", T, S, rng), N_TILES)
    x = rng.standard_normal((q, N_TILES, T)).astype(np.float32)
    for mod, ins in ((tails, [x]), (comp, [x, _carries(S, q, rng)])):
        ins = [torch.from_numpy(a).requires_grad_() for a in ins]
        outs = mod.plain(*ins)
        ct = torch.from_numpy(rng.standard_normal(outs.shape)
                              .astype(np.float32))
        want = torch.autograd.grad(outs, ins, ct)
        got = tl._linear_vjp(mod.plain, [i.shape for i in ins],
                             torch.device("cpu"), (ct,))
        for g, w in zip(got, want):
            _assert_close(g.numpy(), w.numpy())


def test_cpu_tensors_run_the_twins():
    """On the CPU ``forward`` is the twin and launches nothing."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((8, N_TILES, T))
                         .astype(np.float32))
    tails = tc.TailsPass(_stack("uniform", 6, T, rng), N_TILES)
    tl.reset_launches()
    assert torch.equal(tails(x), tails.plain(x))
    assert not any(tl.LAUNCHES.values())
    with pytest.raises(ValueError):
        tc.TailsPass(_stack("uniform", 57, T, rng), N_TILES)
    with pytest.raises(ValueError):
        tc.TailsPass(_stack("uniform", 6, 64, rng), N_TILES)
