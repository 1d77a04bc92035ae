"""The port's rows pass (a scan on a non-last axis) against the JAX
package's, and the routes that reach it: volumes and the staged per-axis
loop of ``apply_filter_fused``.

Same seeded numpy inputs through the JAX package (px6, Pallas interpret
mode, as ``tests/test_overlap2d.py`` runs it) and through the port's plain
twins on the CPU. Bound: rtol=2e-5, atol=2e-6·peak — the bound
``tests/test_overlap2d.py`` holds the JAX px6 rows route to; gradients
within 1e-4. The CUDA kernels themselves are held to these twins on a card
by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import overlap2d as jo2
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import final2d as jk2d

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import iir as tiir
from recfilter_tpu_torch import overlap2d as to2
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.kernels import completion as tcomp
from recfilter_tpu_torch.kernels import final2d as tk2d
from recfilter_tpu_torch.kernels import split as tsplit

T = 128


def _img(*shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _check(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=2e-5,
                               atol=2e-6 * np.abs(want).max())


def _gauss(mod, axis, sigma=5.0):
    w = tiir.gaussian_weights(sigma, 3)
    return [mod.Scan(axis, c, w[0], tuple(w[1:])) for c in (True, False)]


# ---------------------------------------------------------------- kernels

P, N, NL = 2, 3, 2  # batch, tiles along the scan, 128-lane blocks


def _rows_mats(clamp):
    """Matrices of the σ=5 Gaussian pair plus a causal 1st-order scan
    (K = 7) from the port's builders (equal to the JAX package's,
    ``test_torch_host.py``), fed to both packages' kernels."""
    scans = _gauss(tspec, 0) + [tspec.Scan(0, True, 0.9, (0.5,))]
    m = tdf.prepare_dim_pass(scans, T, N, clamp)
    G = np.concatenate([np.asarray(g) for g in m.G], axis=1)
    R = np.concatenate([np.asarray(r) for r in m.Rhat], axis=2)
    return m, G, R


@pytest.mark.parametrize("clamp", [False, True], ids=["zero", "clamp"])
def test_rows_tails_matches_jax(clamp):
    _, G, _ = _rows_mats(clamp)
    x = _img(P, N, T, NL * T, seed=1, scale=1.0)
    want = jk2d.rows_tails_px(x, G, nprod=6, interpret=True)
    mod = tk2d.RowsTails(G, N)
    assert mod.G_v64.shape[0] == (3 if clamp else 1)
    got = mod(torch.from_numpy(x))
    assert got.shape == (P, N, 8, NL * T) and got.dtype == torch.float32
    _check(got.numpy(), want)
    assert not got[:, :, G.shape[1]:].any()  # pad slots are zeros


@pytest.mark.parametrize("clamp", [False, True], ids=["zero", "clamp"])
def test_rows_final_matches_jax(clamp):
    m, _, R = _rows_mats(clamp)
    x = _img(P, N, T, NL * T, seed=2, scale=1.0)
    NA_t = _img(P, N, 8, NL * T, seed=3, scale=1.0)
    want = jk2d.rows_final_px(x, m.Btot, R, NA_t, nprod=6, interpret=True)
    got = tk2d.RowsFinal(m.Btot, R, N)(torch.from_numpy(x),
                                       torch.from_numpy(NA_t))
    assert got.shape == x.shape
    _check(got.numpy(), want)


def test_rows_kernel_backward_is_the_twins_vjp():
    """The CUDA path's backward (the twin's VJP at zero — both passes are
    linear) equals autograd through the twin at a real point."""
    from recfilter_tpu_torch.kernels import launch as tl

    m, G, R = _rows_mats(True)
    rng = np.random.default_rng(4)
    ins = {"tails": [_img(P, N, T, NL * T, seed=5)],
           "final": [_img(P, N, T, NL * T, seed=6),
                     _img(P, N, 8, NL * T, seed=7)]}
    for mod, key in ((tk2d.RowsTails(G, N), "tails"),
                     (tk2d.RowsFinal(m.Btot, R, N), "final")):
        xs = [torch.from_numpy(a).requires_grad_() for a in ins[key]]
        out = mod.plain(*xs)
        ct = torch.from_numpy(rng.standard_normal(out.shape).astype(
            np.float32))
        want = torch.autograd.grad(out, xs, ct)
        got = tl._linear_vjp(mod.plain, [a.shape for a in xs],
                             torch.device("cpu"), (ct,))
        for g, w in zip(got, want):
            _check(g.numpy(), w.numpy())


# ------------------------------------------ the kernels' layouts and sums


def _rows_chunks(m, R):
    """The three bf16 chunks of [Btot | Rhat | 0] (KP = 144) per matrix
    variant [interior, first, last], built here from the stacks."""
    B, R8 = np.asarray(m.Btot), np.zeros((len(R), T, 8))
    R8[..., :R.shape[2]] = R
    pick = [0] if len(B) == 1 else [1 if len(B) > 2 else 0, 0, len(B) - 1]
    M = np.zeros((len(pick), T, 144))
    for v, t in enumerate(pick):
        M[v, :, :T] = B[t]
        M[v, :, T:T + 8] = R8[t]
    return torch.stack(tsplit.split_const(M, 3), dim=1)  # (nv, 3, T, 144)


@pytest.mark.parametrize("clamp", [False, True], ids=["zero", "clamp"])
def test_rows_final_constant_is_the_descriptor_order(clamp):
    """``RowsFinal.Bc_k`` — the constant the kernel stages — is
    ``core_pack`` of each variant's three chunks of [Btot | Rhat | 0], and
    a model of the wgmma descriptor reads them back: chunk c, k16 step s,
    B element (o, k) at c·CH + 128·s + (o/8)·8·KP + (k/8)·64 + (o%8)·8 +
    k%8 holds chunk c's (o, 16s + kperm(k))."""
    m, _, R = _rows_mats(clamp)
    fin = tk2d.RowsFinal(m.Btot, R, N)
    C = _rows_chunks(m, R)
    assert fin.Bc_k.dtype == torch.bfloat16
    assert fin.Bc_k.shape == (3 if clamp else 1, 3, T * 144)
    assert torch.equal(fin.Bc_k, tcomp.core_pack(C))
    assert torch.equal(fin.chunks(), C)
    o = torch.arange(T)[:, None]
    k = torch.arange(16)[None, :]
    perm = [tcomp._kperm(j) for j in range(16)]
    for v in range(C.shape[0]):
        for c in range(3):
            for s in range(144 // 16):
                off = (c * T * 144 + 128 * s + (o // 8) * 8 * 144
                       + (k // 8) * 64 + (o % 8) * 8 + k % 8)
                got = fin.Bc_k[v].reshape(-1)[off]
                assert torch.equal(got, C[v, c][:, [16 * s + j
                                                    for j in perm]])


def test_rows_final_stage_reads_are_whole_and_conflict_free():
    """A model of ``csrc/rows_final.cu``'s fp32 stage (``_stage_off``):
    the cp.async writes of 16-byte groups stay whole and aligned and fill
    136 × 64 floats once; each warp's fragment read — rows k0 + 4qd + e
    (kperm), lanes r and r + 8 — falls in 32 distinct banks; and the
    product of the fragments so read with the descriptor-ordered constant
    equals the plain product, bit for bit on integers."""
    offs = [tk2d._stage_off(s, w) for s in range(136) for w in range(64)]
    assert sorted(offs) == list(range(136 * 64))
    for s in range(136):
        for c in range(0, 64, 4):
            o = tk2d._stage_off(s, c)
            assert o % 4 == 0
            assert [tk2d._stage_off(s, c + i) for i in range(4)] == [
                o + i for i in range(4)]
    rng = np.random.default_rng(5)
    X = rng.integers(-4, 5, (136, 64)).astype(np.float32)  # rows × lanes
    stage = np.zeros(136 * 64, np.float32)
    for s in range(136):
        for w in range(64):
            stage[tk2d._stage_off(s, w)] = X[s, w]
    C = rng.integers(-4, 5, (T, 144)).astype(np.float32)
    C[:, 136:] = 0.0
    flat = tcomp.core_pack(torch.from_numpy(C)).numpy()
    acc = np.zeros((64, T))
    for k0 in list(range(0, T, 16)) + [T]:
        A = np.zeros((64, 16))  # the k16 step's fragment, kperm order
        for wp in range(4):
            for h in range(2):
                for e in range(4):
                    addr = []
                    for lane in range(32):
                        qd, r = lane % 4, 16 * wp + lane // 4 + 8 * h
                        row = k0 + 4 * qd + e
                        if k0 == T and 4 * qd >= 8:
                            continue  # zeros past the 8 carry rows
                        addr.append(tk2d._stage_off(row, r))
                        # sample 4qd + e sits at position kperm⁻¹
                        pos = [j for j in range(16)
                               if tcomp._kperm(j) == 4 * qd + e][0]
                        A[r, pos] = stage[addr[-1]]
                    assert len({a % 32 for a in addr}) == len(addr)
        o = np.arange(T)[:, None]
        k = np.arange(16)[None, :]
        B = flat[k0 * 8 + (o // 8) * 8 * 144 + (k // 8) * 64 + (o % 8) * 8
                 + k % 8]  # (o, position)
        acc += A @ B.T
    XN = np.concatenate([X, np.zeros((8, 64), np.float32)])
    assert np.array_equal(acc, (C @ XN).T)


def _tc_model(Mc, data, ein):
    """A model of the tensor-core kernel's sums: its k16 steps in its
    order (``tc_exact``'s), each step's sixteen terms summed exactly and
    added to a float32 accumulator with one rounding."""
    ds = [c.double() for c in tsplit.split_data(data, 3)]
    ms = [c.double() for c in Mc]
    acc = None
    for k0s in (range(T, data.shape[-1], 16), range(0, T, 16)):
        for i, j in tsplit.prods(6):
            for k0 in k0s:
                t = ein(ms[i][..., k0:k0 + 16], ds[j][..., k0:k0 + 16])
                acc = t.float() if acc is None else (acc.double() + t).float()
    return acc


@pytest.mark.parametrize("clamp", [False, True], ids=["zero", "clamp"])
def test_rows_final_split_sums_match_jax(clamp):
    """``RowsFinal.split_exact`` (the exact sum of the kernel's six chunk
    products, and its per-output bound): a model of the kernel's fp32
    sums lies inside the bound at every output, the sum with a level-2
    product left out outside it at some; the model within this file's
    bound of ``rows_final_px(..., nprod=6)`` in interpret mode."""
    m, _, R = _rows_mats(clamp)
    x = _img(P, N, T, NL * T, seed=2, scale=1.0)
    NA_t = _img(P, N, 8, NL * T, seed=3, scale=1.0)
    fin = tk2d.RowsFinal(m.Btot, R, N)
    xt, Nt = torch.from_numpy(x), torch.from_numpy(NA_t)
    ref, bound = fin.split_exact(xt, Nt)
    assert ref.shape == bound.shape == (P, N, T, NL * T)
    data = torch.cat([xt, Nt, torch.zeros_like(Nt)], dim=2).transpose(2, 3)
    model = _tc_model(fin.chunks().unbind(1), data, lambda mm, v:
                      tcomp.tile_einsum("nok,pnwk->pnow", mm, v))
    assert bool(((model.double() - ref).abs() <= bound).all())
    for drop in ((0, 2), (1, 1), (2, 0)):
        assert bool(((model.double() - fin.split_exact(xt, Nt, drop)[0])
                     .abs() > bound).any())
    want = jk2d.rows_final_px(x, m.Btot, R, NA_t, nprod=6, interpret=True)
    _check(model.numpy(), want)
    _check(ref.numpy(), want)


# ------------------------------------------- rows_final at the reduced grades

GRADE_BOUNDS = {"px3": 1e-4, "px4": 8e-5, "default": 3e-2}
NPROD_OF = {"px3": 3, "px4": 4, "default": 1}


def _rows_f64(m, R, x, NA_t):
    """``rows_final``'s function in float64 from the per-tile stacks."""
    B = np.asarray(m.Btot, np.float64)
    R8 = tk2d._pad_slots(R)
    pick = np.minimum(np.arange(N), B.shape[0] - 1)
    return (np.einsum("aos,pasw->paow", B[pick], x.astype(np.float64))
            + np.einsum("aok,pakw->paow", R8[pick], NA_t.astype(np.float64)))


@pytest.mark.parametrize("grade", list(GRADE_BOUNDS))
@pytest.mark.parametrize("clamp", [False, True], ids=["zero", "clamp"])
def test_rows_final_twin_matches_jax_at_the_grades(clamp, grade):
    """``RowsFinal.plain`` at nprod 3, 4 and 1 (the grade's chunk products
    in float32) against ``rows_final_px(..., nprod=k)`` in interpret mode:
    within 1e-5 of the JAX kernel's peak (summation order). At one
    product the port takes three on the carry rows, where the JAX kernel
    takes one (``split.carry_nprod``): the product is linear, so there the
    twin is held to ``rows_final_px`` at one product without the carries
    plus ``rows_final_px`` at three on the carries alone, and, as a
    control, lies outside that limit of the JAX kernel at one product;
    the two then agree within twice the grade's bound (3e-2 of the
    peak), each lies within the bound of the float64 product, and the
    twin the closer."""
    nprod = NPROD_OF[grade]
    m, _, R = _rows_mats(clamp)
    x = _img(P, N, T, NL * T, seed=2, scale=1.0)
    NA_t = _img(P, N, 8, NL * T, seed=3, scale=1.0)
    fin = tk2d.RowsFinal(m.Btot, R, N, nprod)
    got = fin(torch.from_numpy(x), torch.from_numpy(NA_t)).numpy()

    def jax_rows(xk, nk, k):
        return np.asarray(jk2d.rows_final_px(xk, m.Btot, R, nk, nprod=k,
                                             interpret=True))

    if nprod == 1:
        want = jax_rows(x, 0 * NA_t, 1) + jax_rows(0 * x, NA_t, 3)
    else:
        want = jax_rows(x, NA_t, nprod)
    lim = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= lim
    if nprod == 1:
        j1 = jax_rows(x, NA_t, 1)
        y64 = _rows_f64(m, R, x, NA_t)
        bound = GRADE_BOUNDS[grade] * np.abs(y64).max()
        assert np.abs(got - j1).max() > lim
        assert np.abs(got - j1).max() <= 2 * bound
        assert np.abs(j1 - y64).max() <= bound
        assert np.abs(got - y64).max() < np.abs(j1 - y64).max()


@pytest.mark.parametrize("grade", list(GRADE_BOUNDS))
@pytest.mark.parametrize("clamp", [False, True], ids=["zero", "clamp"])
def test_rows_final_constant_at_the_grades(clamp, grade):
    """At the reduced grades ``RowsFinal.Bc_k`` is ``core_pack`` of each
    variant's TWO chunks of [Btot | Rhat | 0] (the carry rows' grade,
    ``completion.grade_chunks``): the first two of px6's three, so B takes
    73.7 KB of the kernel's shared memory against 110.6 KB."""
    m, _, R = _rows_mats(clamp)
    fin = tk2d.RowsFinal(m.Btot, R, N, NPROD_OF[grade])
    C = _rows_chunks(m, R)[:, :2]
    assert fin.Bc_k.shape == (3 if clamp else 1, 2, T * 144)
    assert fin.Bc_k.dtype == torch.bfloat16
    assert torch.equal(fin.Bc_k, tcomp.core_pack(C.contiguous()))
    assert torch.equal(fin.chunks(), C)
    assert fin.Bc_k.numel() * 2 // fin.Bc_k.shape[0] == 73728


def _grade_model(Mc, data, ein, nprod):
    """``_tc_model`` at grade ``nprod``: the carry slab's
    ``carry_nprod(nprod)`` products, then the signal slab's ``nprod``, in
    the kernel's k16 steps, each step's terms summed exactly and added to a
    float32 accumulator with one rounding."""
    cn = tsplit.carry_nprod(nprod)
    ds = [c.double() for c in tsplit.split_data(data, tsplit.nchunks(cn))]
    ms = [c.double() for c in Mc]
    acc = None
    for k0s, g in ((range(T, data.shape[-1], 16), cn), (range(0, T, 16),
                                                        nprod)):
        for i, j in tsplit.prods(g):
            for k0 in k0s:
                t = ein(ms[i][..., k0:k0 + 16], ds[j][..., k0:k0 + 16])
                acc = t.float() if acc is None else (acc.double() + t).float()
    return acc


@pytest.mark.parametrize("grade", list(GRADE_BOUNDS))
@pytest.mark.parametrize("clamp", [False, True], ids=["zero", "clamp"])
def test_rows_final_split_sums_at_the_grades(clamp, grade):
    """``RowsFinal.split_exact`` at the grade: a model of the kernel's
    fp32 sums (``_grade_model``) lies inside its per-output bound at every
    output, and the model equals the twin within 1e-5 of its peak (the
    same chunk products summed in another order); the sum with the
    signal's largest pair (0, 0) left out lies outside the bound."""
    nprod = NPROD_OF[grade]
    m, _, R = _rows_mats(clamp)
    xt = torch.from_numpy(_img(P, N, T, NL * T, seed=2, scale=1.0))
    Nt = torch.from_numpy(_img(P, N, 8, NL * T, seed=3, scale=1.0))
    fin = tk2d.RowsFinal(m.Btot, R, N, nprod)
    ref, bound = fin.split_exact(xt, Nt)
    data = torch.cat([xt, Nt, torch.zeros_like(Nt)], dim=2).transpose(2, 3)
    model = _grade_model(fin.chunks().unbind(1), data, lambda mm, v:
                         tcomp.tile_einsum("nok,pnwk->pnow", mm, v), nprod)
    assert bool(((model.double() - ref).abs() <= bound).all())
    twin = fin.plain(xt, Nt)
    assert (model - twin).abs().max() <= 1e-5 * twin.abs().max()
    assert bool(((model.double() - fin.split_exact(xt, Nt, (0, 0))[0])
                 .abs() > bound).any())


@pytest.mark.parametrize("clamp", [False, True], ids=["zero", "clamp"])
def test_rows_tails_warp_order_matches_the_twin(clamp):
    """The kernel's summation order (each warp's 16 rows, then the warps
    in order: ``RowsTails.grouped``) in float64 equals the twin's float64
    sums within 1e-12 of their peak."""
    _, G, _ = _rows_mats(clamp)
    mod = tk2d.RowsTails(G, N)
    assert mod.ROW_GROUP * 8 == T  # eight warps
    x = torch.from_numpy(_img(P, N, T, NL * T, seed=8, scale=1.0))
    got, want = mod.grouped(x), mod.plain64(x)
    assert got.dtype == want.dtype == torch.float64
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    assert not got[:, :, G.shape[1]:].any()


# ------------------------------------------------------------- executor

@pytest.mark.parametrize("border", ["zero", "clamp"])
@pytest.mark.parametrize("shape,axis", [((256, 384), 0),
                                        ((2, 128, 3, 128), 1)],
                         ids=["y-of-2d", "batch-and-lanes"])
def test_fused_rows_px_matches_jax_and_oracle(shape, axis, border):
    x = _img(*shape, seed=sum(shape))
    js = [jspec.Scan(axis, True, 1.0, (0.6,)),
          jspec.Scan(axis, False, 0.9, (0.4, 0.1))]
    ts = [tspec.Scan(axis, s.causal, s.feedfwd, s.feedback) for s in js]
    want = jo2.fused_rows_px(jnp.asarray(x), axis, js, border, 6, True)
    assert want is not None
    got = to2.fused_rows_px(torch.from_numpy(x), axis, ts, border)
    assert got.shape == shape
    _check(got.numpy(), want)
    spec = jspec.FilterSpec("R", tuple(jspec.Dim(f"d{i}", e)
                                       for i, e in enumerate(shape)),
                            tuple(js), border=border)
    _check(got.numpy(), jsc.oracle_apply(spec, x.astype(np.float64)))


def test_fused_rows_px_banded_solve():
    """8192 × 128, a y-only σ=5 Gaussian: 64 tiles, where the JAX package
    switches to the banded carry solve — and so does the port."""
    x = _img(8192, 128, seed=9)
    mod = to2.FusedRowsPx(_gauss(tspec, 0), 8192, (128,), "zero")
    assert mod.offsets is not None and not hasattr(mod, "CMp")
    got = mod(torch.from_numpy(x))
    want = jo2.fused_rows_px(jnp.asarray(x), 0, _gauss(jspec, 0), "zero", 6,
                             True)
    # the JAX px6 path sits a few 1e-6 from the oracle on σ=5 Gaussians
    # (ROADMAP Queue 3), so the two packages agree to 1e-5·peak; the port
    # is held to the oracle at the px6 bound
    peak = np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * peak
    spec = jspec.FilterSpec("B", (jspec.Dim("y", 8192), jspec.Dim("x", 128)),
                            tuple(_gauss(jspec, 0)))
    _check(got.numpy(), jsc.oracle_apply(spec, x.astype(np.float64)))


def test_banded_solve_takes_a_leading_batch():
    """The banded carry solve on (p, n, sl, W) tails equals it on each
    (n, sl, W) slice."""
    mod = to2.FusedRowsPx(_gauss(tspec, 0), 8192, (128,), "clamp")
    bands = list(zip(mod.offsets, mod.bands))
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 64, 8, 128)))
    got = tdf._banded_solve_apply(bands, b, 6)
    for i in range(3):
        torch.testing.assert_close(got[i], tdf._banded_solve_apply(
            bands, b[i], 6), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", [
    ("extent-below-tile", (64, 128), 0, 2),
    ("extent-not-multiple", (200, 128), 0, 2),
    ("lanes-not-multiple", (128, 100), 0, 2),
    ("too-many-tiles", (257 * 128, 128), 0, 2),
    ("carries-over-8", (128, 128), 0, 9),
    ("last-axis", (128, 128), 1, 2)], ids=lambda c: c[0])
def test_rows_gates_match_jax(case):
    """Where the JAX package's ``fused_rows_px`` declines (returns None),
    the port's rows pass raises NotImplementedError naming the einsum pass
    the router takes instead."""
    _, shape, axis, K = case
    x = np.zeros(shape, np.float32)
    scans = [(i % 2 == 0, (0.3, 0.1, 0.01)[:min(3, K - 3 * i)])
             for i in range(-(-K // 3))]
    js = [jspec.Scan(axis, c, 1.0, fb) for c, fb in scans]
    ts = [tspec.Scan(axis, c, 1.0, fb) for c, fb in scans]
    assert sum(s.order for s in ts) == K
    assert jo2.fused_rows_px(jnp.asarray(x), axis, js, "zero", 6,
                             True) is None
    with pytest.raises(NotImplementedError,
                       match="FusedAxisPass|last axis"):
        to2.fused_rows_px(torch.from_numpy(x), axis, ts, "zero")


# ---------------------------------------------------------------- routes

def _spec(mod, shape, scans, border="zero", tiles=None):
    names = "wzyx"[-len(shape):]
    return mod.FilterSpec("F", tuple(mod.Dim(n, e) for n, e in
                                     zip(names, shape)), tuple(scans),
                          border=border,
                          tile_widths=tiles or (128,) * len(shape))


def _both(make):
    """A spec built by ``make(module)`` in each package."""
    return make(jspec), make(tspec)


def _volume(border):
    # the scans of tests/test_overlap2d.py::test_volume_rows_plus_2d_route
    return lambda m: _spec(m, (128, 128, 256), (
        m.Scan(2, True, 1.0, (0.6,)), m.Scan(2, False, 1.0, (0.6,)),
        m.Scan(1, True, 0.9, (0.5, 0.1)), m.Scan(0, True, 1.0, (0.4,))),
        border)


def _y_only(border):
    return lambda m: _spec(m, (256, 384), (
        m.Scan(0, True, 1.0, (0.6,)), m.Scan(0, False, 0.9, (0.4,))),
        border, (128, 0))


def _axes_02(m):
    return _spec(m, (128, 64, 256), (
        m.Scan(0, True, 1.0, (0.5,)), m.Scan(2, True, 1.0, (0.3,))),
        tiles=(128, 0, 128))


def _axes_01(m):
    return _spec(m, (128, 256, 128), (
        m.Scan(1, False, 1.0, (0.5, 0.2)), m.Scan(0, True, 0.8, (0.3,)),
        m.Scan(1, True, 1.0, (0.4,))), border="clamp", tiles=(128, 128, 0))


ROUTED = {
    "volume-zero": (_volume("zero"), "volume",
                    ["FusedRowsPx", "Fused2DPx"]),
    "volume-clamp": (_volume("clamp"), "volume",
                     ["FusedRowsPx", "Fused2DPx"]),
    "y-only-zero": (_y_only("zero"), None, ["FusedRowsPx"]),
    "y-only-clamp": (_y_only("clamp"), None, ["FusedRowsPx"]),
    "axes-0-2": (_axes_02, "staged", ["FusedRowsPx", "FusedLastAxis"]),
    "axes-0-1": (_axes_01, "staged", ["FusedRowsPx", "FusedRowsPx"]),
}


def _jax_route(js, x, monkeypatch, precision="px6"):
    """Run the JAX package's ``apply_filter_fused`` (at ``precision``)
    with spies on its executors: the list of (executor, axis) it ran, and
    its output."""
    calls = []

    def spy(name, fn, axis_arg):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if out is not None:
                calls.append((name, a[axis_arg] if axis_arg is not None
                              else None))
            return out
        return wrapped

    monkeypatch.setattr(jo2, "fused_rows_px",
                        spy("FusedRowsPx", jo2.fused_rows_px, 1))
    monkeypatch.setattr(jo2, "fused_2d_px",
                        spy("Fused2DPx", jo2.fused_2d_px, None))
    monkeypatch.setattr(jdf, "fused_dim_pass",
                        spy("FusedLastAxis", jdf.fused_dim_pass, 1))
    y = jdf.apply_filter_fused(js, jnp.asarray(x), tile_default=128,
                               matmul_precision=precision)
    return calls, np.asarray(y)


@pytest.mark.parametrize("case", list(ROUTED))
def test_route_matches_jax_and_oracle(case, monkeypatch):
    """Each filter takes the route the JAX package takes — the same
    executors on the same axes, in the same order — and both packages
    agree with each other and with the f64 oracle."""
    make, route, stages = ROUTED[case]
    js, ts = _both(make)
    x = _img(*[d.extent for d in js.dims], seed=len(case))
    calls, want = _jax_route(js, x, monkeypatch)
    mod = tdf.fused_filter_module(ts)
    parts = list(mod.stages) if isinstance(mod, tdf.StagedPass) else [mod]
    assert getattr(mod, "route", None) == route
    assert [type(m).__name__ for m in parts] == stages
    assert [name for name, _ in calls] == stages
    for (_, ax), m in zip(calls, parts):  # rows passes on the same axes
        if isinstance(m, to2.FusedRowsPx):
            assert m.L == js.dims[ax].extent
            assert m.trailing == tuple(d.extent for d in js.dims[ax + 1:])
    got = mod(torch.from_numpy(x))
    assert torch.equal(got, mod.forward_plain(torch.from_numpy(x)))
    _check(got.numpy(), want)
    _check(got.numpy(), jsc.oracle_apply(js, x.astype(np.float64)))


# Filters the port refused until the rotation chain came: each now takes
# the JAX package's route (spied) and is held to it and the oracle.
REFUSED = {
    # a volume whose depth is not a multiple of 128: JAX's rows pass
    # declines and its rotation chain runs
    "volume-depth-100": (lambda m: _spec(m, (100, 128, 128), (
        m.Scan(0, True, 1.0, (0.4,)), m.Scan(1, True, 1.0, (0.4,)),
        m.Scan(2, True, 1.0, (0.4,)))), ["RotationChain"]),
    # the trailing pair declines after the rows pass: the chain finishes
    # (x 16 wide: one 16-wide tile, the einsum form)
    "volume-pair-declines": (lambda m: _spec(m, (128, 40, 16), (
        m.Scan(2, True, 1.0, (0.5,)), m.Scan(1, True, 1.0, (0.4,)),
        m.Scan(0, True, 1.0, (0.3,))), tiles=(128, 32, 128)),
        ["FusedRowsPx", "RotationChain"]),
    # four trailing scanned axes: the rotation chain
    "4-d": (lambda m: _spec(m, (8, 8, 8, 8), tuple(
        m.Scan(i, True, 1.0, (0.4,)) for i in range(4)), tiles=(4,) * 4),
        ["RotationChain"]),
    # a non-last axis the rows gates decline: JAX's einsum pass
    "y-extent-200": (lambda m: _spec(m, (200, 128), (
        m.Scan(0, True, 1.0, (0.4,)),), tiles=(128, 0)), ["FusedAxisPass"]),
}


def _jax_chain_route(js, x, monkeypatch, precision="px6"):
    """:func:`_jax_route` with the JAX package's per-pass executor spied
    too: ``_last_axis_pass_t`` calls made by the chain (rot_axes = Ds) are
    recorded as one "RotationChain" entry."""
    calls = []
    orig = jdf._last_axis_pass_t

    def spy(*a, **k):
        calls.append(("_last_axis_pass_t", None))
        return orig(*a, **k)

    monkeypatch.setattr(jdf, "_last_axis_pass_t", spy)
    if precision == "px6":
        rcalls, y = _jax_route(js, x, monkeypatch)
    else:
        rcalls = []
        monkeypatch.setattr(jdf, "fused_dim_pass", _spied(
            rcalls, "FusedAxisPass", jdf.fused_dim_pass, 1))
        y = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(x),
                                              tile_default=128,
                                              matmul_precision=precision))
    names = [  # fused_dim_pass on a non-last axis is FusedAxisPass
        "FusedAxisPass" if name == "FusedLastAxis" and ax != x.ndim - 1
        else name for name, ax in rcalls]
    chain = len(calls) - sum(n == "FusedAxisPass" for n in names)
    if chain:
        names.append("RotationChain")
    return names, y


def _spied(calls, name, fn, axis_arg):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        calls.append((name, a[axis_arg]))
        return out
    return wrapped


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_routes_raise_naming_the_item(case, monkeypatch):
    """The filters this test held to a refusal while the rotation chain
    was unported: each takes the JAX package's route — the same executors
    in the same order — and agrees with the JAX package and the oracle."""
    make, stages = REFUSED[case]
    js, ts = _both(make)
    x = _img(*[d.extent for d in js.dims], seed=len(case))
    names, want = _jax_chain_route(js, x, monkeypatch)
    mod = tdf.fused_filter_module(ts)
    parts = list(mod.stages) if isinstance(mod, tdf.StagedPass) else [mod]
    assert [type(m).__name__ for m in parts] == stages == names
    got = mod(torch.from_numpy(x))
    assert torch.equal(got, mod.forward_plain(torch.from_numpy(x)))
    _check(got.numpy(), want)
    _check(got.numpy(), jsc.oracle_apply(js, x.astype(np.float64)))


def test_non_last_axis_at_highest_raises(monkeypatch):
    """At ``highest`` the JAX package runs its einsum pass on a non-last
    axis (its rows kernels run at the px grades only), and so does the
    port: the y-only filter takes ``FusedAxisPass``, no rows pass, and
    matches the JAX package's ``highest`` route and the oracle."""
    js, ts = _both(_y_only("zero"))
    x = _img(*[d.extent for d in js.dims], seed=7)
    names, want = _jax_chain_route(js, x, monkeypatch, "highest")
    mod = tdf.fused_filter_module(ts, "highest")
    assert type(mod).__name__ == "FusedAxisPass" and names == [
        "FusedAxisPass"]
    got = mod(torch.from_numpy(x))
    _check(got.numpy(), want)
    _check(got.numpy(), jsc.oracle_apply(js, x.astype(np.float64)))


# The routes with a split form at the reduced grades (ROUTED's filters):
# volumes at px3, px4 and default (rows_final, then final2d_split); the
# per-axis loop's rows passes at px3 and px4 only
GRADED = [(case, grade) for case in ROUTED for grade in GRADE_BOUNDS
          if grade != "default" or ROUTED[case][1] == "volume"]


@pytest.mark.parametrize("case,grade", GRADED)
def test_route_matches_jax_and_oracle_at_the_grades(case, grade,
                                                    monkeypatch):
    """At a reduced grade each filter takes the JAX package's route — the
    same executors on the same axes, in the same order (spied) — each
    kernel stage at the grade, and lies within the grade's bound of the
    f64 oracle and within twice it of the JAX package's output."""
    make, route, stages = ROUTED[case]
    js, ts = _both(make)
    x = _img(*[d.extent for d in js.dims], seed=len(case))
    calls, want = _jax_route(js, x, monkeypatch, grade)
    mod = tdf.fused_filter_module(ts, grade)
    parts = list(mod.stages) if isinstance(mod, tdf.StagedPass) else [mod]
    assert getattr(mod, "route", None) == route
    assert [type(m).__name__ for m in parts] == stages
    assert [name for name, _ in calls] == stages
    for (_, ax), m in zip(calls, parts):
        if isinstance(m, to2.FusedRowsPx):
            assert m.L == js.dims[ax].extent
            assert m.final.nprod == NPROD_OF[grade]
        if isinstance(m, to2.Fused2DPx):
            assert m.nprod == NPROD_OF[grade]
    got = mod(torch.from_numpy(x)).numpy().astype(np.float64)
    oracle = jsc.oracle_apply(js, x.astype(np.float64))
    bound = GRADE_BOUNDS[grade] * np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= bound
    assert np.abs(got - want).max() <= 2 * bound


@pytest.mark.parametrize("grade", list(GRADE_BOUNDS))
@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_fused_rows_px_matches_jax_at_the_grades(border, grade):
    """``FusedRowsPx(nprod).forward_plain`` (fp64 tails, the grade's
    ``rows_final`` twin) on the σ=5 Gaussian along y of 256 × 384 against
    the JAX package's ``fused_rows_px`` at the grade (its tails split too)
    and the oracle: within the grade's bound of the oracle, twice it of
    the JAX package."""
    x = _img(256, 384, seed=5)
    js, ts = _gauss(jspec, 0), _gauss(tspec, 0)
    nprod = NPROD_OF[grade]
    want = jo2.fused_rows_px(jnp.asarray(x), 0, js, border, nprod, True)
    assert want is not None
    mod = to2.FusedRowsPx(ts, 256, (384,), border, nprod)
    got = mod.forward_plain(torch.from_numpy(x)).numpy()
    spec = jspec.FilterSpec("R", (jspec.Dim("y", 256), jspec.Dim("x", 384)),
                            tuple(js), border=border)
    oracle = jsc.oracle_apply(spec, x.astype(np.float64))
    bound = GRADE_BOUNDS[grade] * np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= bound
    assert np.abs(got - np.asarray(want)).max() <= 2 * bound


def test_reduced_grade_routes_without_a_kernel_raise(monkeypatch):
    """The routes the port refused at the reduced grades until the
    rotated emit had its split form now run as the JAX package runs them:
    a y-only filter at ``default`` takes ``FusedAxisPass`` (spied in the
    JAX package), its einsum form — no kernel, as the JAX package's
    einsum pass — and a volume whose trailing pair declines takes the rows
    pass at the grade, then the rotation chain; each within the grade's
    bound of the f64 oracle and twice it of the JAX package."""
    js, ts = _both(_y_only("zero"))
    x = _img(*[d.extent for d in js.dims], seed=3)
    names, want = _jax_chain_route(js, x, monkeypatch, "default")
    assert names == ["FusedAxisPass"]
    mod = tdf.fused_filter_module(ts, "default")
    assert type(mod).__name__ == "FusedAxisPass"
    assert mod.body.completion is None and mod.body.tails is None
    cases = [(mod, x, want, js, "default")]
    js, ts = _both(REFUSED["volume-pair-declines"][0])
    xv = _img(*[d.extent for d in js.dims], seed=4)
    for grade in GRADE_BOUNDS:
        mv = tdf.fused_filter_module(ts, grade)
        assert [type(m).__name__ for m in mv.stages] == [
            "FusedRowsPx", "RotationChain"]
        assert mv.stages[0].final.nprod == NPROD_OF[grade]
        wv = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(xv),
                                               tile_default=128,
                                               matmul_precision=grade))
        cases.append((mv, xv, wv, js, grade))
    for m, xi, w, spec, grade in cases:
        got = m(torch.from_numpy(xi)).numpy().astype(np.float64)
        oracle = jsc.oracle_apply(spec, xi.astype(np.float64))
        bound = GRADE_BOUNDS[grade] * np.abs(oracle).max()
        assert np.abs(got - oracle).max() <= bound
        assert np.abs(got - w).max() <= 2 * bound


@pytest.mark.parametrize("case", ["volume-clamp", "y-only-clamp"])
def test_gradient_matches_jax(case):
    """torch.autograd through the port against jax.grad through the JAX
    package's px6 route, for sum(y²)."""
    js, ts = _both(ROUTED[case][0])
    x = _img(*[d.extent for d in js.dims], seed=11)
    g_jax = np.asarray(jax.grad(lambda v: jnp.sum(jdf.apply_filter_fused(
        js, v, tile_default=128, matmul_precision="px6") ** 2))(
            jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad((rft.apply_filter_fused(ts, xt) ** 2).sum(),
                               xt)
    np.testing.assert_allclose(g.numpy(), g_jax, rtol=1e-4, atol=1e-4)


def test_rows_module_checks_its_input():
    mod = to2.FusedRowsPx(_gauss(tspec, 0), 256, (3, 128), "zero")
    for shape in [(256, 3, 128), (2, 256, 3, 128)]:
        x = torch.from_numpy(_img(*shape, seed=len(shape)))
        assert torch.equal(mod(x), mod.forward_plain(x))
    with pytest.raises(ValueError):
        mod(torch.zeros(256, 3, 127))
    with pytest.raises(TypeError):
        mod(torch.zeros(256, 3, 128, dtype=torch.float64))
