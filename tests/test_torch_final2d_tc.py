"""``final2d`` at px6 on the tensor cores (``csrc/final2d.cu``): its
six-product twin against the JAX kernel, its exact-sum bound, and numpy
models of the operand packings and shared-memory index maps the kernel
reads and writes.

On the CPU the kernel cannot run; what it computes is held here in three
parts. ``Final2D.split_plain`` (the six split-bf16 products in float32)
against ``final2d_px(nprod=6)`` in Pallas interpret mode: 1e-6 of the JAX
kernel's peak (both sum the same bf16 chunk products in float32, in
another order: the JAX kernel's one concatenated dot against the twin's
pair by pair), bit for bit where every sum is exact. ``split_exact``'s
bound holds the twin and rejects a sum with one level-2 product left out.
The models rebuild, from the kernel's own index arithmetic, the register
fragments it loads (``Af_k``), the chaining of the first product's
accumulators into the second's A operand, the core-matrix order of the
second product's constant (``Bc_k``) and the split x stage each thread
writes, and compare them with the host's operands. The card holds the
kernel to these twins (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu.kernels import final2d as jk2d

from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import iir as tiir
from recfilter_tpu_torch.kernels import completion as tc
from recfilter_tpu_torch.kernels import final2d as tk2d
from recfilter_tpu_torch.kernels import split
from recfilter_tpu_torch.spec import Scan as TScan

P, NA, NB, T = 1, 2, 2, 128
KP, KS = T + 16, (T + 16) // 16
STACKS = {"uniform": (False, 0, 0), "clamp": (True, 0, 0),
          "pad": (False, 40, 72)}


def _mats(kind):
    """Ba, Ra, Bb, Rb of the σ=5 Gaussian on dim A and orders 3 + 2 on
    dim B, from the port's builders."""
    clamp, pad_a, pad_b = STACKS[kind]
    w3 = tiir.gaussian_weights(5.0, 3)
    a = [TScan(0, True, w3[0], tuple(w3[1:])),
         TScan(0, False, w3[0], tuple(w3[1:]))]
    b = [TScan(1, True, 0.9, (0.6, 0.25, -0.1)),
         TScan(1, False, 1.1, (0.5, 0.2))]
    ma = tdf.prepare_dim_pass(a, T, NA, clamp, pad_slots=pad_a)
    mb = tdf.prepare_dim_pass(b, T, NB, clamp, pad_slots=pad_b)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    return (np.asarray(ma.Btot), cat(ma.Rhat, 2), np.asarray(mb.Btot),
            cat(mb.Rhat, 2))


def _inputs(seed=0, ints=False):
    rng = np.random.default_rng(seed)
    shapes = [(P, NA, T, NB * T), (P, NA, 8, NB * T), (P, NA, NB * 8, T)]
    if ints:
        return [rng.integers(-300, 301, s).astype(np.float32)
                for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_px6(mats, xs):
    return np.asarray(jk2d.final2d_px(
        jnp.asarray(xs[0]), *mats, jnp.asarray(xs[1]), jnp.asarray(xs[2]),
        nprod=6, interpret=True))


@pytest.mark.parametrize("kind", list(STACKS))
def test_split_twin_matches_final2d_px6(kind):
    """The six-product twin against the JAX kernel at px6: within 1e-6 of
    its peak on the Gaussian's matrices; bit for bit on integer matrices
    and inputs (every chunk product and sum exact in float32)."""
    mats = _mats(kind)
    xs = _inputs(1)
    got = tk2d.Final2D(*mats, NA, NB).split_plain(
        *(torch.from_numpy(a) for a in xs)).numpy()
    want = _jax_px6(mats, xs)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    rng = np.random.default_rng(2)
    imats = [rng.integers(-1, 2, np.shape(m)).astype(np.float64)
             for m in mats]
    ixs = _inputs(3, ints=True)
    got = tk2d.Final2D(*imats, NA, NB).split_plain(
        *(torch.from_numpy(a) for a in ixs)).numpy()
    np.testing.assert_array_equal(got, _jax_px6(imats, ixs))


@pytest.mark.parametrize("kind", list(STACKS))
def test_split_exact_bounds_the_twin(kind):
    """``split_exact``: its exact sum within 1e-6 of the float64 product's
    peak, the twin (six products summed in float32 in another order,
    its own Z split) inside its bound, and the twin outside the bound of
    a sum with the level-2 pair (0, 2) left out; the bound below 1e-4
    of the output's peak."""
    mats = _mats(kind)
    mod = tk2d.Final2D(*mats, NA, NB)
    xs = [torch.from_numpy(a) for a in _inputs(4)]
    y = mod.split_plain(*xs).double()
    ref, bound = mod.split_exact(*xs)
    peak = y.abs().max()
    assert bool(((y - ref).abs() <= bound).all())
    assert bound.max() < 1e-4 * peak
    ref2, bound2 = mod.split_exact(*xs, drop=(0, 2))
    assert bool(((y - ref2).abs() > bound2).any())
    Ba, Ra, Bb, Rb = (np.asarray(m, np.float64) for m in mats)
    x, NA_t, NB_t = (a.double().numpy() for a in xs)
    A = np.concatenate([tk2d._per_tile(Ba, NA),
                        tk2d._per_tile(tk2d._pad_slots(Ra), NA)], -1)
    B = np.concatenate([tk2d._per_tile(Bb, NB),
                        tk2d._per_tile(tk2d._pad_slots(Rb), NB)], -1)
    z = np.einsum("ask,pakw->pasw", A, np.concatenate([x, NA_t], 2))
    nbr = NB_t.reshape(P, NA, NB, 8, T).transpose(0, 1, 4, 2, 3)
    y64 = np.einsum("bok,pasbk->pasbo", B, np.concatenate(
        [z.reshape(P, NA, T, NB, T), nbr], -1)).reshape(y.shape)
    assert np.abs(ref.numpy() - y64).max() <= 1e-6 * peak.item()


def _thread(tau):
    """(warp, lane, qd, row r) of thread τ of a warpgroup."""
    w, lane = tau // 32, tau % 32
    return w, lane, lane % 4, 16 * w + lane // 4


def test_a_fragments_and_chaining_model():
    """``Af_k`` holds, at (variant, half h, chunk i, step c, thread τ,
    element 2e + u), chunk i of A1 at row 64h + r + 8(e % 2) and position
    16c + 8(e // 2) + 2qd + u — the register A operand of ``wgmma``
    (``csrc/wgmma.cuh``: a0..a3 the pairs (r, 2qd), (r + 8, 2qd), (r, 8 +
    2qd), (r + 8, 8 + 2qd)). The second product's fragment of step c is
    the first's accumulators z[8c + 2e + u], accumulator d[4j + 2h' + e']
    being row r + 8h', column 8j + 2qd + e': the same (row, position)
    map, so Z's columns feed the second product unpermuted."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((3, T, KP))
    F = tk2d.px_fragments(M)
    assert F.shape == (3, 2, 3, KS, 128, 8) and F.dtype == torch.bfloat16
    C = torch.stack(split.split_const(M, 3), dim=1)
    torch.testing.assert_close(tk2d.px_unfragment(F), C, rtol=0, atol=0)
    for tau in (0, 5, 37, 70, 127):
        w, lane, qd, r = _thread(tau)
        for h, i, c, e, u in ((0, 0, 0, 0, 0), (1, 2, 8, 3, 1),
                              (0, 1, 3, 1, 0), (1, 0, 5, 2, 1)):
            row, k = 64 * h + r + 8 * (e % 2), 16 * c + 8 * (e // 2) + \
                2 * qd + u
            assert F[1, h, i, c, tau, 2 * e + u] == C[1, i, row, k]
            if c == KS - 1:  # the carry step: NB's fragment, not Z's
                continue
            # chaining: z[8c + 2e + u] is accumulator d[4j + 2h' + e']
            acc = 8 * c + 2 * e + u
            j, h2, e2 = acc // 4, (acc % 4) // 2, acc % 2
            assert (r + 8 * h2, 8 * j + 2 * qd + e2) == (
                r + 8 * (e % 2), 16 * c + 8 * (e // 2) + 2 * qd + u)


def _core_off(n, k, kp=KP):
    """``wgmma.cuh``'s core_off: B's (n, k) in the core-matrix order."""
    return ((n // 8) * (kp // 8) + k // 8) * 64 + (n % 8) * 8 + k % 8


def test_second_operand_is_core_packed_unpermuted():
    """``Bc_k``: the chunks of [Bb | Rb | 0] at ``core_off(o, k)`` with k
    in its own order (no ``kperm``: the A fragments come from the
    accumulators), and ``chunks_b`` its inverse."""
    mats = _mats("clamp")
    mod = tk2d.Final2D(*mats, NA, NB)
    M2 = tk2d._px_matrix(mats[2], tk2d._pad_slots(mats[3]))
    C = torch.stack(split.split_const(M2, 3), dim=1)
    torch.testing.assert_close(mod.chunks_b(), C, rtol=0, atol=0)
    o = np.arange(T)[:, None]
    k = np.arange(KP)[None, :]
    flat = torch.zeros_like(C.reshape(3, 3, -1))
    flat[:, :, torch.from_numpy(_core_off(o, k).ravel())] = C.reshape(
        3, 3, -1)
    assert torch.equal(mod.Bc_k, flat)
    torch.testing.assert_close(mod.chunks_a(), torch.stack(
        split.split_const(tk2d._px_matrix(mats[0], tk2d._pad_slots(
            mats[1])), 3), dim=1), rtol=0, atol=0)


XBLK, XLD, XRAW = 3 * T * 8, T + 4, 36864  # csrc/final2d.cu's


def _xoff(c, w, t):
    """``final2d.cu``'s xoff: X's chunk c at (column w, row t), 8-row
    blocks of t outermost, each block's three chunks together."""
    return (t // 8) * XBLK + c * T * 8 + (w // 8) * 64 + (w % 8) * 8 + t % 8


def test_x_stage_model():
    """The kernel's X stage, simulated on one flat buffer of its shared
    memory: [x; NA] (136 rows t of 128 columns w) copied raw at byte XRAW
    in rows of XLD floats; then split in place, three 8-row blocks at a
    time, every thread reading its float4s of a group — block warp
    wq, lane (tt = l % 8, qq = l / 8): row 8m + tt, columns 16wq + 4qq ..
    + 3 — before any chunk of the group is stored; lanes tt, tt ^ 1 swap
    halves (``__shfl_xor_sync``), the even lane keeping columns +0, +1,
    the odd +2, +3, each the rows (t0, t0 + 1), split and stored as one
    32-bit word at xoff(c, w, t0) / 2; then rows 136..143 zeros. The
    buffer ends as the split data in ``xoff``'s order (each word written
    once, no raw row overwritten before it is read), and ``xdesc``'s
    descriptor (start 2·s·XBLK + c·T·8 elements, K-adjacent core matrices
    2·XBLK bytes apart, N-adjacent 128) addresses element (n, k) of step s
    at xoff(c, n, 16s + k): the B operand of the first product."""
    rng = np.random.default_rng(6)
    X = rng.standard_normal((T + 8, T)).astype(np.float32)
    buf = np.full(3 * T * KP * 2, 0xAB, np.uint8)  # the chunks' bytes
    raw = buf[XRAW:XRAW + (T + 8) * XLD * 4].view(np.float32).reshape(
        T + 8, XLD)
    raw[:, :T] = X
    seen = np.zeros(3 * T * KP // 2, int)
    words = buf.view(np.uint32)
    for m0 in range(0, 17, 3):
        m1 = min(m0 + 3, 17)
        v = {}
        for wq in range(8):
            for lane in range(32):
                tt, qq = lane % 8, lane // 8
                for m in range(m0, m1):
                    v[wq, lane, m] = raw[8 * m + tt, 16 * wq + 4 * qq:
                                         16 * wq + 4 * qq + 4].copy()
        for wq in range(8):
            for lane in range(32):
                tt, qq = lane % 8, lane // 8
                odd = tt & 1
                for m in range(m0, m1):
                    me, partner = v[wq, lane, m], v[wq, lane ^ 1, m]
                    # the partner sends (z, w) if even, (x, y) if odd
                    r0, r1 = partner[2:] if odd else partner[:2]
                    pa = (r0, me[2]) if odd else (me[0], r0)
                    pb = (r1, me[3]) if odd else (me[1], r1)
                    t0 = 8 * m + (tt & ~1)
                    w = 16 * wq + 4 * qq + (2 if odd else 0)
                    for col, pair in ((w, pa), (w + 1, pb)):
                        chunks = split.split_data(torch.tensor(pair), 3)
                        bits = [c.view(torch.int16).numpy().astype(
                            np.uint16) for c in chunks]
                        for ch in range(3):
                            off = _xoff(ch, col, t0) // 2
                            seen[off] += 1
                            words[off] = (int(bits[ch][0])
                                          | int(bits[ch][1]) << 16)
    words[17 * XBLK // 2:18 * XBLK // 2] = 0
    chunks = split.split_data(torch.from_numpy(X), 3)  # (t, w) each
    got = torch.from_numpy(buf.view(np.int16).copy()).view(torch.bfloat16)
    t_, w_ = np.meshgrid(np.arange(T + 8), np.arange(T), indexing="ij")
    for ch in range(3):
        idx = torch.from_numpy(_xoff(ch, w_, t_).ravel())
        assert torch.equal(got[idx], chunks[ch].reshape(-1))
    assert (seen[:17 * XBLK // 2] == 1).all()
    assert not got[17 * XBLK:].float().any()
    # xdesc: element (n, k) of step s of chunk c
    n, k = np.meshgrid(np.arange(T), np.arange(16), indexing="ij")
    for c in range(3):
        for s_ in range(KS):
            start = 2 * (2 * s_ * XBLK + c * T * 8)
            addr = start + (k // 8) * 2 * XBLK + (n // 8) * 128 + \
                (n % 8) * 16 + (k % 8) * 2
            assert (addr == 2 * _xoff(c, n, 16 * s_ + k)).all()
