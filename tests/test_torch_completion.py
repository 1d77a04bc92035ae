"""The port's 1-D kernel modules (``kernels/completion.py``) against the
JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain twins; the JAX side runs
``tails_pass``/``completion_pass`` at px6 (``rot=False``, transposed
slot-padded carries) in Pallas interpret mode, as the JAX package's own
tests do (``tests/test_kernels.py``). Same numpy-seeded inputs; bound
rtol=2e-5, atol=2e-6·scale — the px6 bound of the port's other kernel
tests. The CUDA kernels themselves are held to these twins on a card by
``tests/test_torch_cuda.py``.

The unrotated completion kernels (``completion``, ``completion_epi``,
``completion_traced``) compute the JAX package's px6 arithmetic, six
split-bf16 products, on the tensor cores; their split twins
(``CompletionPass.split_plain``, ``completion_traced_split``) are held to
the JAX kernels at nprod=6 within 5e-7 of the peak (the same chunk products
in float32, summed in another order: 1.4e-7 measured), tighter than the
float32 twins' 2e-6, and to the f64 product within px6's 2e-6 on the real
matrices of the σ=5 Gaussian and the audio filter A with their solved
carries. ``core_pack``'s byte order is held to a model of the wgmma
descriptor's addressing.
"""

import numpy as np
import pytest
import torch

from recfilter_tpu.kernels import completion as jc

from recfilter_tpu_torch.kernels import completion as tc
from recfilter_tpu_torch.kernels import launch as tl
from recfilter_tpu_torch.kernels import split

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


def _assert_split(got, want):
    """The split twins against the JAX kernels at nprod=6: 5e-7 of the
    peak, no relative slack."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= 5e-7 * np.abs(want).max()


@pytest.mark.parametrize("kind,S,q", CASES + [("clamp", 56, 37),
                                              ("uniform", 56, 64)])
def test_completion_matches_jax(kind, S, q):
    """The float32 twin ``plain`` (2e-6) and the split twin
    ``split_plain`` (5e-7: the tensor-core kernel's arithmetic, the
    constant split from float64 by ``split_const``, x and N in float32,
    the six products) against ``completion_pass(rot=False, nprod=6)`` in
    interpret mode: zero, clamp and pad stacks, S up to 56, ragged q."""
    rng = np.random.default_rng(S * 100 + q + 1)
    x = rng.standard_normal((q, N_TILES, T)).astype(np.float32)
    Btot = _stack(kind, T, T, rng, 0.1)
    Rcat = _stack(kind, T, S, rng)
    N = _carries(S, q, rng)
    want = jc.completion_pass(x, Btot, Rcat, N, rot=False, nprod=6,
                              interpret=True, carries_transposed=True)
    comp = tc.CompletionPass(Btot, Rcat, N_TILES)
    xt, Nt = torch.from_numpy(x), torch.from_numpy(N)
    for got, held in ((comp.plain(xt, Nt), _assert_close),
                      (comp.split_plain(xt, Nt), _assert_split)):
        assert got.shape == x.shape and got.dtype == torch.float32
        held(got.numpy(), want)
    Bc = comp.chunks()
    assert Bc.dtype == torch.bfloat16
    assert Bc.shape == (Bc.shape[0], 3, T, tc.tc_depth(comp.sl))
    assert not hasattr(comp, "BR_v")  # the rotated entries' operand


@pytest.mark.parametrize("S,q", [(1, 37), (2, 8), (6, 64), (8, 9)])
def test_completion_traced_split_twin_matches_jax(S, q):
    """``completion_traced_split`` — the runtime matrices split in float32
    as the kernel splits them — against ``completion_pass_traced(nprod=6)``
    in interpret mode, N's pad rows NaN (never read)."""
    rng = np.random.default_rng(S * 10 + q)
    x = rng.standard_normal((q, N_TILES, T)).astype(np.float32)
    Btot = (rng.standard_normal((T, T)) * 0.1).astype(np.float32)
    Rcat = rng.standard_normal((T, S)).astype(np.float32)
    N = np.full((N_TILES, 8, q), np.nan, np.float32)
    N[:, :S] = rng.standard_normal((N_TILES, S, q))
    want = jc.completion_pass_traced(x, Btot, Rcat, np.nan_to_num(N),
                                     nprod=6, interpret=True)
    got = tc.completion_traced_split(*map(torch.from_numpy,
                                          (x, Btot, Rcat, N)))
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    _assert_split(got.numpy(), want)


def _gaussian_pass(q, n):
    """The σ=5 Gaussian's last-axis pass (causal + anticausal, zero
    border) on q lines of n tiles, and a signal."""
    from recfilter_tpu_torch import dimfuse as tdf
    from recfilter_tpu_torch import gaussian_weights
    from recfilter_tpu_torch.spec import Scan

    w = gaussian_weights(5.0, 3)
    scans = [Scan(1, True, w[0], tuple(w[1:])),
             Scan(1, False, w[0], tuple(w[1:]))]
    loc = tdf.LastAxisPass(scans, (T, n, 0), False, "px6")
    x = np.random.default_rng(3).standard_normal((q, n * T)) * 0.01
    return loc, torch.from_numpy(x.astype(np.float32)).reshape(q, n, T)


def _audio_pass():
    """The audio filter A's kernel pass (``audio_filter_high_order(·, 2,
    1000)``: 256 tiles of 128, supertiles as lines) at 300,000 samples."""
    import torch.nn.functional as F_

    from recfilter_tpu_torch.apps import audio_filter_high_order

    F = audio_filter_high_order(300_000, 2, 1000)
    body = F.as_func(device="cpu").body
    loc = body.locals[0]
    x = np.random.default_rng(6).standard_normal(F._image.shape) * 0.1
    X = F_.pad(torch.from_numpy(x.astype(np.float32)), (0, body.pad))
    return loc, X.reshape(-1, loc.n, loc.T).contiguous()


@pytest.mark.parametrize("case", ["gaussian", "audio A"])
def test_split_twins_hold_the_f64_product(case):
    """Both split twins on a real filter's matrices and its solved carries
    (the σ=5 Gaussian, 12 lines of 4 tiles; A, whose DC gain amplifies
    errors) against the product in float64 with the float64 matrices:
    within px6's 2e-6 of the peak."""
    loc, X = _gaussian_pass(12, 4) if case == "gaussian" else _audio_pass()
    comp = loc.completion
    Nt = loc._solve_t(loc.tails.plain(X).double()).float()
    S = loc.S
    want = (tc.tile_einsum("nos,qns->qno", loc.B_v, X.double())
            + tc.tile_einsum("nou,nuq->qno", loc.R_v, Nt[:, :S].double()))
    peak = want.abs().max().item()
    got = comp.split_plain(X, Nt)
    assert (got.double() - want).abs().max().item() <= 2e-6 * peak
    assert loc.B_v.shape[0] == 1  # one variant: the traced form applies
    got = tc.completion_traced_split(X, loc.B_v[0].float(),
                                     loc.R_v[0].float(), Nt)
    assert (got.double() - want).abs().max().item() <= 2e-6 * peak


def _tc_model(Mc, data, ein):
    """A model of the tensor-core completion's sums: the kernel's k16
    steps in its order (``tc.tc_exact``'s), each step's sixteen terms
    summed exactly and added to a float32 accumulator with one rounding."""
    ds = [c.double() for c in split.split_data(data, 3)]
    ms = [c.double() for c in Mc]
    acc = None
    for k0s in (range(T, data.shape[-1], 16), range(0, T, 16)):
        for i, j in split.prods(6):
            for k0 in k0s:
                t = ein(ms[i][..., k0:k0 + 16], ds[j][..., k0:k0 + 16])
                acc = t.float() if acc is None else (acc.double() + t).float()
    return acc


@pytest.mark.parametrize("drop", [(0, 2), (1, 1), (2, 0)])
@pytest.mark.parametrize("case", ["gaussian traced", "audio A"])
def test_summation_bound_sees_a_missing_product(case, drop):
    """``tc_exact``'s per-output bound on a real filter's matrices and
    solved carries (the σ=5 Gaussian through ``completion_traced_exact``,
    A through ``split_exact``): the model of the kernel's sums
    (``_tc_model``) lies inside it at every output, the sum with one
    level-2 product left out outside it at some — so the card's check
    against the bound sees a missing product."""
    if case == "audio A":
        loc, X = _audio_pass()
    else:
        loc, X = _gaussian_pass(12, 4)
    comp = loc.completion
    Nt = loc._solve_t(loc.tails.plain(X).double()).float()
    if case == "audio A":
        exact = lambda d=None: comp.split_exact(X, Nt, d)
        Bc = comp.chunks()
        data = torch.cat([X, Nt.permute(2, 0, 1), X.new_zeros(
            X.shape[:2] + (Bc.shape[-1] - T - comp.sl,))], dim=-1)
        model = _tc_model(Bc.unbind(1), data, lambda m, v: tc.tile_einsum(
            "nok,qnk->qno", m, v))
    else:
        Bt, Rt = loc.B_v[0].float(), loc.R_v[0].float()
        N8 = torch.zeros((loc.n, 8, X.shape[0]))
        N8[:, :loc.S] = Nt[:, :loc.S]
        exact = lambda d=None: tc.completion_traced_exact(X, Bt, Rt, N8, d)
        kp, S = tc.tc_depth(8), loc.S
        M = torch.cat([Bt, Rt, Bt.new_zeros(T, kp - T - S)], 1)
        data = torch.cat([X, N8[:, :S].permute(2, 0, 1), X.new_zeros(
            X.shape[:2] + (kp - T - S,))], dim=-1)
        model = _tc_model(split.split_data(M, 3), data,
                          lambda m, v: torch.einsum("ok,qnk->qno", m, v))
    ref, bound = exact()
    assert bool(((model.double() - ref).abs() <= bound).all())
    assert bool(((model.double() - exact(drop)[0]).abs() > bound).any())


@pytest.mark.parametrize("sl", [8, 16, 32, 56])
def test_core_unpack_inverts_core_pack(sl):
    """``core_unpack`` returns ``core_pack``'s input (the chunks the twins
    and bounds read from the kernel's one copy)."""
    C = torch.randn(3, 3, T, tc.tc_depth(sl)).to(torch.bfloat16)
    assert torch.equal(tc.core_unpack(tc.core_pack(C), T, tc.tc_depth(sl)),
                       C)


@pytest.mark.parametrize("sl", [8, 16, 32, 56])
def test_core_pack_is_the_descriptor_order(sl):
    """``core_pack`` against a model of what the kernel reads: for each
    k16 step s, wgmma's B element (n, k) at the descriptor's start + (n/8)
    · SBO + (k/8) · LBO + (n%8)·8 + k%8 (elements; LBO 64, SBO 8·KP), and
    the thread's A pairs at samples 16s + kperm(k) — so the permuted
    product over all steps equals the plain one, bit for bit on integers."""
    rng = np.random.default_rng(sl)
    KP = tc.tc_depth(sl)
    C = torch.from_numpy(rng.integers(-4, 5, (2, T, KP)).astype(np.float32))
    flat = tc.core_pack(C.to(torch.bfloat16)).float()
    assert flat.shape == (2, T * KP)
    x = torch.from_numpy(rng.integers(-4, 5, (64, KP)).astype(np.float32))
    n = torch.arange(T)[:, None]
    k = torch.arange(16)[None, :]
    for v in range(2):
        acc = torch.zeros((64, T))
        for s in range(KP // 16):
            off = 128 * s + (n // 8) * 8 * KP + (k // 8) * 64 + (n % 8) * 8 \
                + k % 8
            B = flat[v][off]  # (n, k) of the step
            A = x[:, [16 * s + tc._kperm(j) for j in range(16)]]
            acc += A @ B.t()
        assert torch.equal(acc, x @ C[v].t())


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
    if case == "completion_traced":
        Btot = torch.from_numpy(rng.standard_normal((T, T)).astype(
            np.float32))
        Rcat = torch.from_numpy(rng.standard_normal((T, 6)).astype(
            np.float32))
        return tc._completion_traced_kernel, (x, Btot, Rcat,
                                              torch.zeros((N_TILES, 8, q)))
    if case.startswith("completion ") or case == "completion_epi":
        S = 56 if case.endswith("56") else 6
        affine = Affine(0.5, (2.0, -1.0), 0.25) if "epi" in case else None
        comp = tc.CompletionPass(_stack("clamp", T, T, rng, 0.1),
                                 _stack("clamp", T, S, rng), N_TILES,
                                 affine=affine)
        aux = [torch.zeros_like(x)] * (2 if affine is not None else 0)
        return comp._kernel, (x, torch.zeros((N_TILES, comp.sl, q)), *aux)
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
                ("completion sl 8", "completion"),
                ("completion sl 56", "completion"),
                ("completion_epi", "completion_epi"),
                ("completion_traced", "completion_traced"),
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
    if entry in ("completion", "completion_epi"):
        # the host-split chunks, bf16 in the kernel's order, as the operand
        comp = fn.__self__
        KP = tc.tc_depth(comp.sl)
        assert comp.Bc_k.dtype == torch.bfloat16
        assert comp.Bc_k.shape == (3, 3, T * KP)  # clamp: three variants
        assert largs[2] == comp.Bc_k.data_ptr()
        assert largs[-3 if entry == "completion_epi" else -2] == comp.sl
        assert torch.equal(comp.Bc_k, tc.core_pack(comp.chunks()))


@pytest.mark.parametrize("err,raised", [(701, ValueError),
                                        (1, tl.LaunchError)])
@pytest.mark.parametrize("case", ["completion_rot stencil",
                                  "completion_rot_epi stencil",
                                  "completion sl 56", "completion_epi",
                                  "completion_traced"])
def test_rotated_refusal_of_shared_memory_is_a_value_error(case, err, raised,
                                                            monkeypatch):
    """The persistent launchers refuse a layout whose shared memory does
    not fit (a rotated stencil's taps; the tensor-core completion's chunks
    and one stage) with cudaErrorLaunchOutOfResources (701): the wrapper
    raises a ValueError naming it; any other refusal passes as the launch
    error it is."""
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
    """The rotated entries (``completion_rot``, ``completion_rot_tails``)
    emit the product transposed, not the operand: at each grade they read
    the unrotated kernels' ``Bc_k`` — ``completion``'s at px6,
    ``completion_split``'s at 4, 3 and 1 products — the constant [Btot |
    Rcat | 0] in the grade's chunks (three at px6, two else), in the
    descriptor order; its chunks sum to [Btot | Rcat] within the grade's
    split."""
    rng = np.random.default_rng(13)
    Bs, Rs = _stack("clamp", T, T, rng, 0.1), _stack("clamp", T, 6, rng)
    for nprod in (6, 4, 3, 1):
        comp = tc.CompletionPass(Bs, Rs, N_TILES, rot=True, nprod=nprod)
        flat = tc.CompletionPass(Bs, Rs, N_TILES, nprod=nprod)
        nc = 3 if nprod == 6 else 2
        assert comp.Bc_k.dtype == torch.bfloat16
        assert comp.Bc_k.shape == (3, nc, T * tc.tc_depth(8))
        assert torch.equal(comp.Bc_k, flat.Bc_k)
        M = comp.grade_constant().double()
        want = np.concatenate([tc._variants3(Bs), tc._variants3(Rs),
                               np.zeros((3, T, 2))], axis=2)
        assert np.abs(M.numpy() - want).max() <= 2.0 ** (
            -16 if nc == 2 else -24) * np.abs(want).max()
