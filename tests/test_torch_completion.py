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


@pytest.mark.parametrize("kind,S,q", CASES)
def test_tails_ordered_plain_pins_the_summation_order(kind, S, q):
    """``tails_ordered_plain`` (the kernels' order: one float64 loop over τ
    ascending) against the einsum twin in float64 at 1e-12 of the peak,
    and, rounded to float32, against the JAX ``tails_pass`` at the px6
    bound; for one matrix and for a per-tile stack."""
    rng = np.random.default_rng(S * 100 + q + 2)
    x = rng.standard_normal((q, N_TILES, T)).astype(np.float32)
    G = _stack(kind, S, T, rng).astype(np.float32)
    xt = torch.from_numpy(x)
    per_tile = torch.from_numpy(tc._expand_stack(G, N_TILES))
    got = tc.tails_ordered_plain(xt, per_tile, f64=True)
    want = torch.einsum("nst,qnt->nsq", per_tile.double(), xt.double())
    assert got.shape == (N_TILES, S, q) and got.dtype == torch.float64
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-12 * scale
    got32 = tc.tails_ordered_plain(xt, per_tile)
    assert got32.dtype == torch.float32
    _assert_close(got32.numpy(), np.asarray(
        jc.tails_pass(x, G, nprod=6, interpret=True))[:, :S])
    if kind == "uniform":  # one (S, T) matrix for every tile
        assert torch.equal(tc.tails_ordered_plain(xt, per_tile[0]), got32)


def test_tails_ordered_plain_is_one_rounding_per_step():
    """The loop's steps round once each: a sum whose terms cancel exactly
    in float64 (an fp32 x fp32 product is exact) comes out as the exact
    value, where a float32 sum would not."""
    x = torch.zeros((1, 1, T))
    G = torch.zeros((1, T))
    x[0, 0, :3] = torch.tensor([1.0, 2.0**-30, -1.0])
    G[0, :3] = 1.0
    got = tc.tails_ordered_plain(x, G, f64=True)
    assert got.item() == 2.0**-30
    assert (x[0, 0, 0] + x[0, 0, 1]).item() - 1.0 == 0.0  # lost in float32


def _launch_case(case, rng):
    """A wrapper's kernel path on CPU tensors, with its inputs: ``(fn,
    args)`` for one of the persistent entries."""
    from recfilter_tpu_torch.epilogue import Affine

    q = 200
    x = torch.from_numpy(rng.standard_normal((q, N_TILES, T)).astype(
        np.float32))
    if case == "tails":
        tails = tc.TailsPass(_stack("clamp", 6, T, rng), N_TILES)
        return tails._kernel, (x,)
    if case == "tails_traced":
        G = torch.from_numpy(rng.standard_normal((6, T)).astype(np.float32))
        return tc._tails_traced_kernel, (x, G)
    stencil = ({"taps": [(-2, 0.5), (0, 1.0), (3, -0.25)], "start": "clamp"}
               if case.endswith("stencil") else None)
    affine = Affine(0.5, (2.0,), 0.0) if "epi" in case else None
    comp = tc.CompletionPass(_stack("clamp", T, T, rng, 0.1),
                             _stack("clamp", T, 6, rng), N_TILES, rot=True,
                             stencil=stencil, affine=affine)
    N = torch.zeros((N_TILES, comp.sl, q))
    halos = [torch.zeros((N_TILES, h, q)) for h in (comp.hp, comp.hn) if h]
    aux = [torch.zeros((N_TILES * T, q))] if affine is not None else []
    return comp._kernel, (x, N, *halos, *aux)


LAUNCH_CASES = [("tails", "tails"), ("tails_traced", "tails_traced"),
                ("completion_rot", "completion_rot"),
                ("completion_rot stencil", "completion_rot"),
                ("completion_rot_epi", "completion_rot_epi"),
                ("completion_rot_epi stencil", "completion_rot_epi")]


@pytest.mark.parametrize("case,entry", LAUNCH_CASES)
def test_persistent_wrappers_pass_their_signatures(case, entry, monkeypatch):
    """The redesigned kernels' wrappers launch the entry they name with the
    arguments its ``launch.SIGNATURES`` row declares (the stream is
    ``_launch``'s own): the launchers choose their stage counts, so no
    plan travels from the host."""
    got = []
    monkeypatch.setattr(tc, "_launch",
                        lambda e, args, dev: got.append((e, args)))
    fn, args = _launch_case(case, np.random.default_rng(7))
    fn(*args)
    (e, largs), = got
    argtypes = tl.SIGNATURES[tl.ENTRIES[e]][f"{e}_launch"][0]
    assert e == entry and len(largs) == len(argtypes) - 1


@pytest.mark.parametrize("err,raised", [(701, ValueError),
                                        (1, tl.LaunchError)])
@pytest.mark.parametrize("case", ["completion_rot stencil",
                                  "completion_rot_epi stencil"])
def test_rotated_refusal_of_shared_memory_is_a_value_error(case, err, raised,
                                                            monkeypatch):
    """The rotated launcher refuses a stencil whose taps outgrow the
    block's shared memory with cudaErrorLaunchOutOfResources (701): the
    wrapper raises a ValueError naming it; any other refusal passes as
    the launch error it is."""
    def refuse(entry, args, dev):
        raise tl.LaunchError(entry, "refused", err)

    monkeypatch.setattr(tc, "_launch", refuse)
    fn, args = _launch_case(case, np.random.default_rng(8))
    with pytest.raises(raised) as info:
        fn(*args)
    assert (err == 701) == ("shared memory" in str(info.value))


@pytest.mark.parametrize("n,q,ok", [(32, 4096, True), (1, 1, True),
                                    (512, 2**31 // 4, False), (0, 8, False),
                                    (4, 0, False)])
def test_persistent_walk_bounds(n, q, ok):
    """The persistent kernels number n × ⌈q/128⌉ work items in an int."""
    if ok:
        tc._items_ok("tails", n, q)
    else:
        with pytest.raises(ValueError, match="work items"):
            tc._items_ok("tails", n, q)


def test_rotated_operand_is_the_transpose():
    """``completion_rot`` reads ``BT_v`` = [Btot | Rcat] (outputs as rows),
    the transpose of the other entries' ``BR_v``, per variant."""
    rng = np.random.default_rng(13)
    comp = tc.CompletionPass(_stack("clamp", T, T, rng, 0.1),
                             _stack("clamp", T, 6, rng), N_TILES, rot=True)
    assert comp.BT_v.shape == (3, T, T + 8)
    assert torch.equal(comp.BT_v, comp.BR_v.transpose(1, 2))
