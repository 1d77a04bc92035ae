"""The reduced precision grades (px3, px4, default) on the CPU twins
against the JAX package: the chunk algebra bit for bit, the two split
kernels' twins against the JAX px kernels in interpret mode, the whole
slice through ``RecFilter.as_func`` against the f64 oracle and the JAX
``apply_filter_fused``, every route without a split form raising, and the
``blocked`` backend's tile repair.

The bounds are the JAX package's (``tests/test_dimfuse.py:454``,
``tests/test_overlap2d.py:438``): 1e-4 (px3), 8e-5 (px4) and 3e-2
(default) of the oracle's peak.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import recfilter_tpu as jrf
from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import completion as jc
from recfilter_tpu.kernels import final2d as jk2d

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import overlap2d as to
from recfilter_tpu_torch.epilogue import affine_form
from recfilter_tpu_torch import fir as tfir
from recfilter_tpu_torch import scan_core as tsc
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.kernels import completion as tc
from recfilter_tpu_torch.kernels import final2d as tk2d
from recfilter_tpu_torch.kernels import split
from recfilter_tpu_torch.kernels import stencil2d as tst
from recfilter_tpu_torch.overlap2d import Fused2DPx

T = 128
BOUNDS = {"px3": 1e-4, "px4": 8e-5, "default": 3e-2}
GRADES = list(BOUNDS)


def _img(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------ (a) the chunk algebra

@pytest.mark.parametrize("n", [1, 2, 3])
def test_data_split_is_the_jax_split(n):
    """``split_data`` = ``_split_vmem`` bit for bit; three chunks rebuild
    float32 exactly."""
    x = _img(8, 128, seed=9)
    x[0, :4] = [1e-30, -3e38, 0.0, 1.0 + 2.0 ** -23]
    got = split.split_data(torch.from_numpy(x), n)
    want = jc._split_vmem(jnp.asarray(x), n)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            g.view(torch.int16).numpy(),
            np.asarray(w).view(np.int16))
    if n == 3:
        back = sum(c.float() for c in got)
        np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_const_split_is_the_jax_split(n):
    """``split_const`` = ``_split_const_np`` bit for bit, on float64
    constants (float32 first, then bfloat16, residuals in float64)."""
    rng = np.random.default_rng(n)
    M = rng.standard_normal((3, 17, 40)) * 10.0 ** rng.integers(-6, 3,
                                                                 (3, 17, 40))
    got = split.split_const(M, n)
    want = jc._split_const_np(M, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g.view(torch.int16).numpy(),
            np.asarray(w, ml_dtypes.bfloat16).view(np.int16))


@pytest.mark.parametrize("nprod", [1, 3, 4, 6])
def test_pairs_and_levels_are_the_jax_ones(nprod):
    assert split.prods(nprod) == jc._prods(nprod)
    assert split.nchunks(nprod) == jc._nchunks(nprod)
    assert split.level_groups(nprod) == jc._level_groups(nprod)


# --------------------------------------- (b) final2d_split's twin vs final2d_px

def _mats2d(clamp, na, nb, small=False):
    """The per-tile stacks of a 2-D pair: the σ=5 Gaussian on dim A and
    orders 3 + 2 on dim B, or (``small``) carries of at most 2 slots a
    dim — first-order scans both ways on A, one second-order scan on B."""
    w3 = rft.gaussian_weights(5.0, 3)
    if small:
        a = [jspec.Scan(0, True, 0.4, (0.6,)),
             jspec.Scan(0, False, 0.5, (0.5,))]
        b = [jspec.Scan(1, True, 0.8, (0.6, -0.2))]
    else:
        a = [jspec.Scan(0, True, w3[0], tuple(w3[1:])),
             jspec.Scan(0, False, w3[0], tuple(w3[1:]))]
        b = [jspec.Scan(1, True, 0.9, (0.6, 0.25, -0.1)),
             jspec.Scan(1, False, 1.1, (0.5, 0.2))]
    ma = jdf.prepare_dim_pass(a, T, na, clamp)
    mb = jdf.prepare_dim_pass(b, T, nb, clamp)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    return (np.asarray(ma.Btot), cat(ma.Rhat, 2), np.asarray(mb.Btot),
            cat(mb.Rhat, 2))


def _expand(M, n):
    """A (n|1, ...) per-tile stack as n tiles, float64."""
    M = np.asarray(M, np.float64)
    return np.broadcast_to(M, (n,) + M.shape[1:]) if M.shape[0] == 1 else M


def _final2d_f64(mats, xs, na, nb):
    """``final2d``'s function in float64 from the per-tile stacks:
    Y = [Z; NBᵀ]·Bᵀ with Z = A·[x; NA]."""
    Ba, Ra, Bb, Rb = mats
    A = np.concatenate([_expand(Ba, na), _expand(tk2d._pad_slots(Ra), na)],
                       -1)
    B = np.concatenate([_expand(Bb, nb), _expand(tk2d._pad_slots(Rb), nb)],
                       -1)
    x, NA, NB = (a.astype(np.float64) for a in xs)
    p = x.shape[0]
    z = np.einsum("ask,pakw->pasw", A, np.concatenate([x, NA], 2))
    nbr = NB.reshape(p, na, nb, 8, T).transpose(0, 1, 4, 2, 3)
    y = np.einsum("bok,pasbk->pasbo", B, np.concatenate(
        [z.reshape(p, na, T, nb, T), nbr], -1))
    return y.reshape(p, na, T, nb * T)


def _widen_carries(R, N):
    """A carry product R·N at one product as the three products (0,1),
    (1,0), (0,0) of their two-chunk splits (the JAX package's
    ``_split_const_np`` and ``_split_vmem``): [R₀ | R₁ | R₀] against
    [N₁; N₀; N₀] on the slot axis (-2 of N), zero-padded to the 8-row
    slot. Every chunk is bf16, so a one-product split leaves it as it
    is."""
    K = np.shape(R)[-1]
    assert 3 * K <= 8, "three products of the carries fill at most 8 slots"
    R0, R1 = (np.asarray(c, np.float32).astype(np.float64)
              for c in jc._split_const_np(np.asarray(R, np.float64), 2))
    n = np.ascontiguousarray(N[..., :K, :])
    N0, N1 = (np.asarray(c, np.float32) for c in jc._split_vmem(
        jnp.asarray(n), 2))
    pad = np.zeros(n.shape[:-2] + (8 - 3 * K, n.shape[-1]), np.float32)
    return (tk2d._pad_slots(np.concatenate([R0, R1, R0], -1)),
            np.concatenate([N1, N0, N0, pad], -2))


def _final2d_px_port_carries(ms, xs, na, nb, **kw):
    """The JAX kernel with the port's carry grade at one product:
    ``final2d_px(nprod=1)`` on carries widened to three products
    (:func:`_widen_carries`) — one product on the image rows, three on
    the carry rows, as ``final2d_split`` takes them. ``kw``: its
    consumers (``epilogue``/``eaux``, ``stencil2d`` and the halos)."""
    Ba, Ra, Bb, Rb = ms
    x, NA, NB = xs
    p = x.shape[0]
    Ra3, NA3 = _widen_carries(Ra, NA)
    nbr = NB.reshape(p, na, nb, 8, T)
    Rb3, NB3 = _widen_carries(Rb, nbr)
    out = jk2d.final2d_px(
        jnp.asarray(x), Ba, Ra3, Bb, Rb3, jnp.asarray(NA3),
        jnp.asarray(NB3.reshape(p, na, nb * 8, T)), nprod=1,
        interpret=True, **kw)
    return (np.stack([np.asarray(o) for o in out]) if isinstance(out, tuple)
            else np.asarray(out))


def _final2d_px_at(nprod, ms, xs, na, nb, **kw):
    """``final2d_px`` at ``nprod`` with the port's carry grade (one
    product: :func:`_final2d_px_port_carries`), channels stacked."""
    if nprod == 1:
        return _final2d_px_port_carries(ms, xs, na, nb, **kw)
    out = jk2d.final2d_px(jnp.asarray(xs[0]), *ms, jnp.asarray(xs[1]),
                          jnp.asarray(xs[2]), nprod=nprod, interpret=True,
                          **kw)
    return (np.stack([np.asarray(o) for o in out]) if isinstance(out, tuple)
            else np.asarray(out))


def _ints(shapes, rng, lo, hi, dtype):
    return [rng.integers(lo, hi + 1, s).astype(dtype) for s in shapes]


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("nprod", [1, 3, 4])
def test_final2d_split_twin_matches_final2d_px(clamp, nprod):
    """p = 1, na = 2, Ta = 128, W = 256: within 1e-5 of the JAX kernel's
    peak (summation order) per output, plus, at one product, the bound of
    the two bf16 roundings of Z (``Final2DSplit.resplit_bound``: nonzero
    only where a Z value lies within both sums' error of a rounding
    boundary); bit for bit on integer matrices and inputs that need two
    bf16 chunks a value, where every sum is exact.

    At one product the port takes three products on the carry rows
    (``split.carry_nprod``) where the JAX kernel takes one, so there the
    JAX kernel runs on carries widened to those three products
    (:func:`_final2d_px_port_carries`, carries of at most 2 slots). As a
    control, the twin at three products lies outside that limit. On the
    Gaussian's 6-slot carries the twin lies closer to the float64 product
    than ``final2d_px`` at one product does."""
    na = nb = 2
    ins = [_img(1, na, T, nb * T, seed=1), _img(1, na, 8, nb * T, seed=2),
           _img(1, na, nb * 8, T, seed=3)]
    rng = np.random.default_rng(4)
    iins = _ints([a.shape for a in ins], rng, -300, 300, np.float32)
    mats = _mats2d(clamp, na, nb, small=nprod == 1)
    imats = _ints([m.shape for m in mats], rng, -1, 1, np.float64)
    if nprod == 1:
        def ref(ms, xs):
            return _final2d_px_port_carries(ms, xs, na, nb)
    else:
        def ref(ms, xs):
            return np.asarray(jk2d.final2d_px(
                jnp.asarray(xs[0]), *ms, jnp.asarray(xs[1]),
                jnp.asarray(xs[2]), nprod=nprod, interpret=True))
    for ms, xs, held in ((imats, iins, "exact"), (mats, ins, "tight")):
        want = ref(ms, xs)
        mod = tk2d.Final2DSplit(*ms, na, nb, nprod)
        tx = [torch.from_numpy(a) for a in xs]
        got = mod(*tx).numpy()
        if held == "exact":
            np.testing.assert_array_equal(got, want)
            continue
        lim = 1e-5 * np.abs(want).max() + mod.resplit_bound(*tx[:2]).numpy()
        assert (np.abs(got - want) <= lim).all()
        if nprod == 1:  # the control: three products on the image rows
            y3 = tk2d.Final2DSplit(*ms, na, nb, 3)(*tx).numpy()
            assert (np.abs(y3 - want) > lim).any()
    if nprod == 1:
        gm = _mats2d(clamp, na, nb)
        want = np.asarray(jk2d.final2d_px(
            jnp.asarray(ins[0]), *gm, jnp.asarray(ins[1]),
            jnp.asarray(ins[2]), nprod=1, interpret=True))
        got = tk2d.Final2DSplit(*gm, na, nb, 1)(
            *(torch.from_numpy(a) for a in ins)).numpy()
        y64 = _final2d_f64(gm, ins, na, nb)
        assert np.abs(got - y64).max() < np.abs(want - y64).max()


def _corner_taps(B):
    s = 1.0 / float((2 * B + 1) ** 2)
    return [(B, B, s), (B, -B - 1, -s), (-B - 1, B, -s), (-B - 1, -B - 1, s)]


@pytest.mark.parametrize("nprod", [1, 3, 4])
def test_final2d_stencil_split_twin_matches_final2d_px(nprod):
    """``Final2DStencil`` at the grade against ``final2d_px(stencil2d=)``
    at p = 1, na = 2, W = 256 (a dual-radius 4-corner bank, h8 = 16; a
    clamp border at three products): within 1e-5 of the JAX output's peak
    per output plus, at one product, the bank over the resplit bound
    (``Final2DStencil.resplit_bound``). Both read the halo strips of the
    twin's own output rows (the JAX kernel reads them, the twin recomputes
    them); at one product the JAX kernel runs on the widened carries."""
    na = nb = 2
    h8, bank = 16, [_corner_taps(5), _corner_taps(7)]
    xs = [_img(1, na, T, nb * T, seed=21), _img(1, na, 8, nb * T, seed=22),
          _img(1, na, nb * 8, T, seed=23)]
    ms = _mats2d(nprod == 3, na, nb, small=nprod == 1)
    fin = tk2d.Final2DStencil(*ms, na, nb, bank, h8, nprod)
    tx = [torch.from_numpy(a) for a in xs]
    Y = fin.final.plain(*tx)
    z = torch.zeros_like(Y[:, :1, :h8])
    top = torch.cat([z, Y[:, :-1, T - h8:]], 1)
    bot = torch.cat([Y[:, 1:, :h8], z], 1)
    got = fin(*tx, top, bot).numpy()
    want = _final2d_px_at(nprod, ms, xs, na, nb,
                          stencil2d={"taps_c": bank, "h8": h8},
                          halo_top=jnp.asarray(top.numpy()),
                          halo_bot=jnp.asarray(bot.numpy()))
    assert got.shape == want.shape == (2, 1, na, T, nb * T)
    lim = (1e-5 * np.abs(want).max(axis=(1, 2, 3, 4), keepdims=True)
           + fin.resplit_bound(*tx[:2]).numpy())
    assert (np.abs(got - want) <= lim).all()


def _usm_like(y, a):
    return 1.5 * a - 0.5 * y + 0.25


@pytest.mark.parametrize("nprod", [1, 3, 4])
def test_final2d_split_epilogue_twin_matches_final2d_px(nprod):
    """``Final2DSplit(affine=)`` (``final2d_split_epi``'s twin) against
    ``final2d_px(epilogue=, eaux=)`` at p = 1, na = 2, W = 256: within
    1e-5 of the JAX output's peak per output, plus 0.5 × the resplit bound
    at one product (the form scales Y by −0.5)."""
    na = nb = 2
    xs = [_img(1, na, T, nb * T, seed=31), _img(1, na, 8, nb * T, seed=32),
          _img(1, na, nb * 8, T, seed=33)]
    aux = _img(1, na, T, nb * T, seed=34)
    ms = _mats2d(False, na, nb, small=nprod == 1)
    form = affine_form(_usm_like)
    mod = tk2d.Final2DSplit(*ms, na, nb, nprod, affine=form)
    tx = [torch.from_numpy(a) for a in xs]
    got = mod(*tx, torch.from_numpy(aux)).numpy()
    want = _final2d_px_at(nprod, ms, xs, na, nb, epilogue=_usm_like,
                          eaux=(jnp.asarray(aux),))
    lim = 1e-5 * np.abs(want).max() + 0.5 * mod.resplit_bound(
        *tx[:2]).numpy()
    assert (np.abs(got - want) <= lim).all()
    # the epilogue's aux is read: without it the output is another
    plain = tk2d.Final2DSplit(*ms, na, nb, nprod)(*tx).numpy()
    np.testing.assert_allclose(got, _usm_like(plain, aux), rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------- (c) completion_split's twin vs completion

@pytest.mark.parametrize("clamp,n,q", [(False, 3, 40), (True, 4, 24)])
@pytest.mark.parametrize("nprod", [1, 3, 4])
def test_completion_split_twin_matches_completion_pass(clamp, n, q, nprod):
    """Within 1e-5 of ``completion_pass(rot=False)``'s peak. At one
    product the port takes three on the carry rows, where the JAX kernel
    takes one: the completion is linear, so there the twin is held to
    ``completion_pass`` at one product without the carries plus
    ``completion_pass`` at three on the carries alone — and, as a
    control, lies outside the limit of the JAX kernel at one product."""
    w3 = rft.gaussian_weights(5.0, 3)
    sc = [jspec.Scan(0, True, w3[0], tuple(w3[1:])),
          jspec.Scan(0, False, w3[0], tuple(w3[1:]))]
    m = jdf.prepare_dim_pass(sc, T, n, clamp)
    Rc = np.concatenate([np.asarray(r) for r in m.Rhat], axis=2)
    S = Rc.shape[-1]
    x = _img(q, n, T, seed=5)
    N = _img(n, 8, q, seed=6)
    N[:, S:] = 0.0
    mod = tc.CompletionPass(np.asarray(m.Btot), Rc, n, nprod=nprod)

    def jax_pass(xk, Nk, k):
        return np.asarray(jc.completion_pass(
            jnp.asarray(xk), np.asarray(m.Btot), Rc, jnp.asarray(Nk),
            rot=False, nprod=k, interpret=True, carries_transposed=True))

    got = mod(torch.from_numpy(x), torch.from_numpy(N)).numpy()
    if nprod == 1:
        want = jax_pass(x, 0 * N, 1) + jax_pass(0 * x, N, 3)
    else:
        want = jax_pass(x, N, nprod)
    lim = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= lim
    if nprod == 1:
        assert np.abs(got - jax_pass(x, N, 1)).max() > lim


@pytest.mark.parametrize("nprod", [1, 3, 4])
def test_completion_split_epilogue_twin_matches_completion_pass(nprod):
    """``CompletionPass(affine=)`` unrotated at the grade
    (``completion_split_epi``'s twin) against ``completion_pass(rot=False,
    epilogue=, eaux=)``: within 1e-5 of the JAX output's peak. At one
    product the carries are zero (the port takes three products there,
    the JAX kernel one; the carry rows are held above)."""
    w3 = rft.gaussian_weights(5.0, 3)
    sc = [jspec.Scan(0, True, w3[0], tuple(w3[1:])),
          jspec.Scan(0, False, w3[0], tuple(w3[1:]))]
    n, q = 3, 40
    m = jdf.prepare_dim_pass(sc, T, n, True)
    Rc = np.concatenate([np.asarray(r) for r in m.Rhat], axis=2)
    x = _img(q, n, T, seed=35)
    N = _img(n, 8, q, seed=36) * (nprod != 1)
    N[:, Rc.shape[-1]:] = 0.0
    aux = _img(q, n, T, seed=37)
    mod = tc.CompletionPass(np.asarray(m.Btot), Rc, n, nprod=nprod,
                            affine=affine_form(_usm_like))
    got = mod(torch.from_numpy(x), torch.from_numpy(N),
              torch.from_numpy(aux)).numpy()
    want = np.asarray(jc.completion_pass(
        jnp.asarray(x), np.asarray(m.Btot), Rc, jnp.asarray(N), rot=False,
        nprod=nprod, interpret=True, carries_transposed=True,
        epilogue=_usm_like, eaux=(jnp.asarray(aux.reshape(q, n * T)),)))
    assert np.abs(got - want.reshape(got.shape)).max() <= 1e-5 * np.abs(
        want).max()


# ----------------------------------------- (d) the slice through the API

def _filter(rf, kind, img, clamp=False):
    """The same filter in either package: the 2-D spec of
    ``test_overlap2d.py::test_px_path_throughput_mode``, the σ=5 Gaussian
    on x and y, or the 1-D spec of ``test_dimfuse.py``'s precision test
    (two 3rd-order scans on x, tile 128)."""
    h, w = img.shape
    x, y = rf.Dim("x", w), rf.Dim("y", h)
    F = rf.RecFilter(kind)
    if clamp:
        F.set_clamped_image_border()
    F[y, x] = img
    if kind == "two-scans":
        F.add_filter(+x, (0.9, 0.6, 0.2))
        F.add_filter(-y, (1.05, 0.4, 0.15))
        F.split(x, 128, y, 128)
    elif kind == "gaussian":
        for d in (+x, -x, +y, -y):
            F.add_filter(d, rf.gaussian_weights(5.0, 3))
        F.split(x, 128, y, 128)
    else:
        F.add_filter(+x, (0.9, 0.6, 0.25, -0.1))
        F.add_filter(-x, (1.1, 0.5, 0.2, 0.05))
        F.split(x, 128)
    return F


@pytest.mark.parametrize("kind,shape", [("two-scans", (128, 256)),
                                        ("gaussian", (128, 256)),
                                        ("1-D", (64, 256))])
@pytest.mark.parametrize("grade", GRADES)
def test_the_slice_through_as_func(kind, shape, grade):
    """Each filter at each reduced grade through ``as_func`` on the CPU
    twins: the 2-D filters on ``Fused2DPx`` with ``final2d_split``, the
    1-D one on the unrotated ``LastAxisPass`` with ``completion_split``;
    within the grade's bound of the f64 oracle and of the JAX package's
    ``apply_filter_fused`` at the same grade."""
    img = _img(*shape, seed=7)
    Ft, Fj = _filter(rft, kind, img), _filter(jrf, kind, img)
    Ft.set_plan(matmul_precision=grade)
    mod = Ft.as_func(device="cpu")
    if kind == "1-D":
        assert isinstance(mod.body, tdf.LastAxisPass) and not mod.body.rot
        assert isinstance(mod.body.completion, tc.CompletionPass)
        assert not mod.body.completion.rot
        assert mod.body.completion.nprod == split.NPROD[grade]
    else:
        assert isinstance(mod, Fused2DPx)
        assert isinstance(mod.final, tk2d.Final2DSplit)
        assert mod.final.nprod == split.NPROD[grade]
    got = mod(torch.from_numpy(img)).numpy()
    oracle = jsc.oracle_apply(Fj.spec, img.astype(np.float64))
    peak = np.abs(oracle).max()
    bound = BOUNDS[grade] * peak
    assert np.abs(got - oracle).max() <= bound
    want = np.asarray(jdf.apply_filter_fused(Fj.spec, jnp.asarray(img),
                                             matmul_precision=grade))
    assert np.abs(got - want).max() <= bound


# ------------------------------------- (e) the routes without a split form

def _declined2d():
    """The Gaussian on a clamp border at 200 × 300: extents that are not
    tile multiples, so the 3-touch executor declines it."""
    return _filter(rft, "gaussian", _img(200, 300), clamp=True)


def _y_only(h, w):
    x, y = rft.Dim("x", w), rft.Dim("y", h)
    F = rft.RecFilter("YOnly")
    F[y, x] = _img(h, w)
    F.add_filter(+y, rft.gaussian_weights(5.0, 3))
    F.split(y, 128)
    return F


def _volume():
    z, y, x = rft.Dim("z", 128), rft.Dim("y", 128), rft.Dim("x", 128)
    F = rft.RecFilter("Vol")
    F[z, y, x] = _img(128, 128, 128, scale=0.01)
    for d in (+z, +y, +x):
        F.add_filter(d, rft.gaussian_weights(5.0, 3))
    F.split({z: 128, y: 128, x: 128})
    return F


def _x_only(h, w, tile=128):
    x, y = rft.Dim("x", w), rft.Dim("y", h)
    F = rft.RecFilter("XOnly")
    F[y, x] = _img(h, w)
    F.add_filter(+x, rft.gaussian_weights(5.0, 3))
    F.split(x, tile)
    return F


def _chained():
    """The σ=5 Gaussian on the three axes of a 40 × 128 × 256 volume: the
    rows pass declines z (not a tile multiple), so the chain runs all
    three; its x pass hands the y pass its tails (z takes 32-wide tiles,
    no kernel)."""
    z, y, x = rft.Dim("z", 40), rft.Dim("y", 128), rft.Dim("x", 256)
    F = rft.RecFilter("Chained")
    F[z, y, x] = _img(40, 128, 256, scale=0.01)
    for d in (+z, +y, +x):
        F.add_filter(d, rft.gaussian_weights(5.0, 3))
    F.split({y: 128, x: 128})
    return F


def _as_func(F, grade, **plan):
    F.set_plan(matmul_precision=grade, **plan)
    return F.as_func(device="cpu")


def _chained_pass(grade):
    sc = [tspec.Scan(1, True, 1.0, (0.5,))]
    G = np.ones((1, 1, 128))
    return tdf.LastAxisPass(sc, (128, 2, 0), False, grade, rot_axes=2,
                            next_tails=(G, 2, 128))


# the routes that still have no split form at the reduced grades
ROUTES = {
    "supertile hierarchy": lambda g: tdf.hierarchical_dim_pass(
        torch.zeros(200_000), 0, [tspec.Scan(0, True, 1.0, (0.5,))],
        "zero", g),
}


def _strips_run(g):
    """The ``pallas`` backend at the grade: its strips sum in fp64 and read
    no grade (as the JAX package's), so the output is px6's bit for bit."""
    img = torch.from_numpy(_x_only(64, 256)._image)
    got = _as_func(_x_only(64, 256), g, backend="pallas")(img)
    want = _as_func(_x_only(64, 256), "px6", backend="pallas")(img)
    assert torch.equal(got, want)


def _fir_run(g):
    """The FIR band pass on ``fir_band``'s twin at the grade's products,
    within the grade's bound of the f64 oracle."""
    x, taps = _img(8, 256, seed=12), np.array([0.25, 0.5, 0.25])
    mod = tfir.FirPass(taps, x.shape, matmul_precision=g)
    assert mod.band is not None and mod.band.nprod == split.NPROD[g]
    got = mod(torch.from_numpy(x)).numpy()
    want = tfir.fir_oracle(x, taps, -1)
    assert np.abs(got - want).max() <= BOUNDS[g] * np.abs(want).max()


def _stencil_run(g):
    """A fused ``stencil2d`` bank on the 3-touch executor at the grade
    (``final2d_stencil``'s split form), within the grade's bound of the
    bank over the f64 oracle."""
    F = _filter(rft, "gaussian", _img(256, 256))
    F.set_plan(matmul_precision=g)
    bank = [[(1, 0, 0.5), (0, 1, 0.5)]]
    mod = F.as_func(stencil2d=bank, device="cpu")
    assert isinstance(mod.final, tk2d.Final2DStencil)
    assert mod.final.nprod == split.NPROD[g]
    (got,) = mod(torch.from_numpy(F._image))
    y = tsc.oracle_apply(F.spec, F._image.astype(np.float64))
    (want,) = tst.stencil2d_ref(torch.from_numpy(y), bank)
    want = want.numpy()
    assert np.abs(got.numpy() - want).max() <= BOUNDS[g] * np.abs(want).max()


# the routes whose split form came with their kernels' reduced-grade
# forms: each runs at every grade (its check above)
CHECKS = {"strip kernels": _strips_run, "FIR band": _fir_run,
          "final2d_stencil": _stencil_run}


# the routes that have a split form now, and the grades they run at: the
# last-axis einsum form (fewer than 8 lines: the JAX package's split
# einsum at the grade's products), volumes (rows_final, then
# final2d_split), the per-axis loop's rows pass (rows_final at px3 and
# px4; at default its FusedAxisPass, the einsum pass of the JAX package),
# and the rotated routes (the rotated completions at px3 and px4; at
# default the kernels where the JAX package finds a structural win —
# chained tails — else the einsum form): rotate_emit (its output
# rotated), tails chained between a chain's passes (:func:`_chained`),
# the chain on the declined pair, and FusedAxisPass (a y extent the rows
# pass declines)
RUNS = {**{route: (None, GRADES) for route in CHECKS},
        "einsum form (lines)": (lambda: _x_only(4, 256), GRADES),
        "volumes": (_volume, GRADES),
        "rows pass": (lambda: _y_only(512, 256), GRADES),
        "rotated emit": (lambda: _x_only(256, 256), GRADES),
        "tails chaining": (lambda: _chained(), GRADES),
        "rotation chain": (_declined2d, GRADES),
        "FusedAxisPass": (lambda: _y_only(320, 256), GRADES),
        # overlap_k off the 3-touch gates: the pair fallback at highest at
        # every grade, as the JAX package's fused_2d_pass runs it (its px
        # pair declines the filter; default never takes that pair)
        "HIGHEST pair": (_declined2d, GRADES)}
PLANS = {"rotated emit": dict(rotate_emit=2),
         "HIGHEST pair": dict(backend="overlap_k")}


def _route_of(route, mod, grade):
    """The module ``as_func`` built takes the route its RUNS entry names
    (kernels at the grade where the JAX package takes them)."""
    nprod = split.NPROD[grade]
    if route == "rotated emit":
        comp = mod.body.completion
        assert comp is None if grade == "default" else comp.nprod == nprod
    elif route in ("tails chaining", "rotation chain"):
        assert isinstance(mod, tdf.RotationChain)
        if route == "tails chaining":
            assert mod.tails_in_taken == [False, True, False]
            assert [p.nprod for p in mod.passes] == [nprod, nprod, 0 if
                                                     grade == "default"
                                                     else nprod]
    elif route == "FusedAxisPass":
        assert isinstance(mod, tdf.FusedAxisPass)
        comp = mod.body.completion
        assert comp is None if grade == "default" else comp.nprod == nprod
    elif route == "HIGHEST pair":
        (st,) = mod.stages
        st = st.body if isinstance(st, to._Swapped) else st
        assert isinstance(st, tdf.StagedPass) and st.route == "pair-fallback"


@pytest.mark.parametrize("route", list(ROUTES) + list(RUNS))
@pytest.mark.parametrize("grade", GRADES)
def test_routes_without_a_split_form_raise(route, grade):
    """No route runs another grade, another device or a twin in place of
    a reduced grade: each without a split form (:data:`ROUTES`) names the
    ROADMAP item. The routes of :data:`RUNS` have one at their grades: each
    runs there, on the route its entry names, within the grade's bound of
    the oracle."""
    make, grades = RUNS.get(route, (None, ()))
    if route in CHECKS:
        CHECKS[route](grade)
        return
    if grade in grades:
        F = make()
        img = F._image
        mod = _as_func(F, grade, **PLANS.get(route, {}))
        got = mod(torch.from_numpy(img)).numpy()
        _route_of(route, mod, grade)
        want = tsc.oracle_apply(F.spec, img.astype(np.float64))
        if route == "rotated emit":
            want = want.T
        assert np.abs(got - want).max() <= BOUNDS[grade] * np.abs(want).max()
        return
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        ROUTES[route](grade)


def test_the_refused_builders_run_at_px6():
    """Some of the same builders at px6 run: the refusals are the
    grade's."""
    _as_func(_y_only(512, 256), "px6")
    _as_func(_x_only(256, 256), "px6", rotate_emit=2)
    _chained_pass("px6")


# -------------------------------------- (f) the blocked backend's tile repair

@pytest.mark.parametrize("border", ["zero", "clamp"])
@pytest.mark.parametrize("tile", [2, 3])
def test_blocked_split_narrower_than_the_order(border, tile):
    """The σ=5 Gaussian (order 3) at 41 × 43 split by 2 and 3 on the
    ``blocked`` backend: the tile widens to the order (or the core runs
    the scan), within 2e-6 of the f64 oracle."""
    img = _img(41, 43, seed=11)
    x, y = rft.Dim("x", 43), rft.Dim("y", 41)
    F = rft.RecFilter("G")
    if border == "clamp":
        F.set_clamped_image_border()
    F[y, x] = img
    for d in (+x, -x, +y, -y):
        F.add_filter(d, rft.gaussian_weights(5.0, 3))
    F.split(x, tile, y, tile)
    F.set_plan(backend="blocked")
    got = F.realize(img, device="cpu").numpy()
    want = tsc.oracle_apply(F.spec, img.astype(np.float64))
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_the_grades_never_import_jax():
    """With jax made unimportable, the port imports the split modules and
    runs the headline filter at 256² at each reduced grade and a 1-D
    pass over 16 lines at px3 on the CPU twins, each within its bound of
    the oracle."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import recfilter_tpu_torch as rft
        from recfilter_tpu_torch import bench
        from recfilter_tpu_torch.kernels import split, split_mm
        img = (np.random.default_rng(0).standard_normal((256, 256)) * 0.01
               ).astype(np.float32)
        for g, b in (("default", 3e-2), ("px3", 1e-4), ("px4", 8e-5)):
            F = bench._build_filter(256, 256)
            F.set_plan(matmul_precision=g)
            got = F.realize(img, device="cpu").numpy()
            want = rft.oracle_apply(F.spec, img.astype(np.float64))
            assert np.abs(got - want).max() <= b * np.abs(want).max(), g
        c, x = rft.Dim("c", 16), rft.Dim("x", 512)
        A = rft.RecFilter("A")
        A[c, x] = img.reshape(128, 512)[:16]
        A.add_filter(+x, (0.9, 0.6, 0.25, -0.1))
        A.split(x, 128)
        A.set_plan(matmul_precision="px3")
        got = A.realize(device="cpu").numpy()
        want = rft.oracle_apply(A.spec, A._image.astype(np.float64))
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        assert not any(m == "jax" or m.startswith(("jax.", "recfilter_tpu."))
                       or m == "recfilter_tpu" for m in sys.modules
                       if sys.modules[m] is not None)
        print("grades-ok")
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=repo, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "grades-ok" in out.stdout
