"""bf16 storage on the stencil consumers: ``Stencil2D``, ``Moments2D``'s
edge rows, ``Final2DStencil``, ``TailsPass`` with extra rows and
``CompletionPass``'s rotated stencil body (with and without an affine
epilogue) on a bf16 x at one product, then the routes — a Sobel bank fused
into the 2-D pair (GS), the bank after the rotation chain on a padded frame
(HS) and after a y-only blur (C4b), a Gaussian derivative fused into the
rotated emit (D1) and with an affine combine (D1e), the per-slice branch
(C6b), and the fallback of a padded rotated pass.

Same seeded numpy inputs through the JAX package (its Pallas kernels in
interpret mode, as ``tests/test_overlap2d.py`` and ``tests/test_dimfuse.py``
run its bf16 mode) and through the port's plain twins on the CPU. Bounds
(:func:`_held`): both packages within 3e-2 of the f64 oracle's peak (the
oracle of the bf16 input), the port within twice the JAX package's own
error or 2⁻⁸ of the peak, whichever is larger. The JAX package misses 3e-2
on GS, HS and D1 (4e-2 to 0.10): at one product it takes one product on
the carry rows too, whose terms cancel, and a bank's or a derivative's
differences amplify that loss (ROADMAP Queue 3); the port takes three
there and is held to 3e-2 on every case. Each twin's bf16 output is
its float32 path on the same values, rounded once, bit for bit. The JAX
package's unfused fallbacks (``apply_stencil``, ``stencil2d_ref``) take
the taps in bf16 arithmetic; the port's take them in float32 and round
once (ROADMAP Queue 3). The CUDA kernels are held to these twins on a card
by ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import completion as jc
from recfilter_tpu.kernels import final2d as jk2d
from recfilter_tpu.kernels import stencil2d as jst

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.apps.dog import _stencil
from recfilter_tpu_torch.epilogue import affine_form
from recfilter_tpu_torch.kernels import completion as tc
from recfilter_tpu_torch.kernels import final2d as tk2d
from recfilter_tpu_torch.kernels import stencil2d as tst

T = 128
BF16 = torch.bfloat16
BF16_BOUND = 3e-2  # the JAX package's bound of its bf16 mode
# the two Sobel gradients (dy, dx, coeff): chip_smoke.py's SOBEL
SOBEL = [[(-1, -1, -1.0), (0, -1, -2.0), (1, -1, -1.0), (-1, 1, 1.0),
          (0, 1, 2.0), (1, 1, 1.0)],
         [(-1, -1, -1.0), (-1, 0, -2.0), (-1, 1, -1.0), (1, -1, 1.0),
          (1, 0, 2.0), (1, 1, 1.0)]]
DERIV = {"taps": [(-1, -0.5), (1, 0.5)]}  # D1's central difference


def _img(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16(a):
    """A float32 array rounded to bf16 (round to nearest even), as float32
    values."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _err(got, want):
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _held(got, jax_out, want, jax_bound=True):
    """Both outputs within :data:`BF16_BOUND` of the float64 reference
    ``want``'s peak (the JAX package's only where ``jax_bound``: module
    docstring), the port within twice the JAX package's error or 2⁻⁸ of
    the peak. Returns the two errors."""
    e_port, e_jax = _err(_np(got), want), _err(_np(jax_out), want)
    assert not jax_bound or e_jax <= BF16_BOUND, e_jax
    assert e_port <= BF16_BOUND, e_port
    assert e_port <= max(2.0 * e_jax, 2.0 ** -8), (e_port, e_jax)
    return e_port, e_jax


def _shift_np(f, off, ax):
    """f[i + off] along ``ax``: the edge past the far end, zero before 0
    (the bank's border rule)."""
    n = f.shape[ax]
    lo, hi = max(off, 0), max(-off, 0)
    pads = [(0, 0)] * f.ndim
    pads[ax] = (hi, lo)
    g = np.pad(f, pads, mode="edge" if off > 0 else "constant")
    return np.take(g, np.arange(lo, lo + n), axis=ax)


def _bank_np(y, taps_c):
    return [sum(c * _shift_np(_shift_np(y, dy, y.ndim - 2), dx, y.ndim - 1)
                for dy, dx, c in taps) for taps in taps_c]


def _shift1_np(f, off, ax, mode):
    """f[i + off] along ``ax``, "clamp" replicating the edge, "zero"
    reading zeros (a rotated stencil's border modes)."""
    n = f.shape[ax]
    lo, hi = max(off, 0), max(-off, 0)
    pads = [(0, 0)] * f.ndim
    pads[ax] = (hi, lo)
    g = np.pad(f, pads, mode="edge" if mode == "clamp" else "constant")
    return np.take(g, np.arange(lo, lo + n), axis=ax)


def _stencil1_np(y, taps, ax, start="zero", end="clamp"):
    return sum(c * _shift1_np(y, d, ax, end if d > 0 else start)
               for d, c in taps)


def _pick(M, n):
    M = np.asarray(M, np.float64)
    return M[np.minimum(np.arange(n), M.shape[0] - 1)]


# ------------------------------------------------------------- the kernels

def test_stencil2d_takes_bf16_rounded_once():
    """``Stencil2D`` on a bf16 image: bf16 channels, each its float32 path
    on the widened values rounded once; against the JAX kernel on the bf16
    image (interpret mode; bf16 arithmetic) and the f64 bank."""
    y = _bf16(_img(96, 200, seed=1))
    bank = tst.Stencil2D(SOBEL)
    yb = torch.from_numpy(y).to(BF16)
    got = bank(yb)
    assert all(g.dtype == BF16 for g in got)
    for g, f in zip(got, bank(torch.from_numpy(y))):
        assert torch.equal(g, f.to(BF16))
    jout = jst.stencil2d_pass(jnp.asarray(y, jnp.bfloat16), SOBEL,
                              interpret=True)
    for g, j, w in zip(got, jout, _bank_np(y.astype(np.float64), SOBEL)):
        _held(g, j, w)


def _mats(clamp, na=3, nb=2):
    w3 = rft.gaussian_weights(5.0, 3)
    a = [tspec.Scan(0, True, w3[0], tuple(w3[1:])),
         tspec.Scan(0, False, w3[0], tuple(w3[1:]))]
    b = [tspec.Scan(1, True, 0.9, (0.6, 0.25, -0.1))]
    ma = tdf.prepare_dim_pass(a, T, na, clamp)
    mb = tdf.prepare_dim_pass(b, T, nb, clamp)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    return ma, mb, cat(ma.G, 1), cat(mb.G, 1), cat(ma.Rhat, 2), cat(mb.Rhat, 2)


@pytest.mark.parametrize("h8", [8, 16])
def test_moments_edge_rows_take_bf16_to_the_float32_bits(h8):
    """``Moments2D(edge=)`` on a bf16 x (``moments2d_bf16`` with edge
    rows): float32 outputs bit-equal to its float32 path on the same
    values; against ``moments2d_px(edge_mats=)`` on the bf16 x at one
    product and the f64 sums."""
    ma, mb, Ga, Gb, _, _ = _mats(True)
    p, na, nb = 1, 3, 2
    x = _bf16(_img(p, na, T, nb * T, seed=h8))
    mom = tk2d.Moments2D(Ga, Gb, ma.Btot, na, nb, edge=(ma.Btot, h8))
    outs = mom(torch.from_numpy(x).to(BF16))
    assert len(outs) == 4 and all(o.dtype == torch.float32 for o in outs)
    for g, f in zip(outs, mom(torch.from_numpy(x))):
        assert torch.equal(g, f)
    jout = jk2d.moments2d_px(jnp.asarray(x, jnp.bfloat16), Ga, Gb, nprod=1,
                             interpret=True, edge_mats=(ma.Btot, h8),
                             term1_mats=ma.Btot)
    B = _pick(ma.Btot, na)
    E = np.einsum("ask,pakw->pasw", B, x.astype(np.float64))
    _held(outs[2], jout[2], E[:, :, :h8])
    _held(outs[3], jout[3], E[:, :, T - h8:])


def _final_f64(ma, mb, Ra, Rb, x, NA_t, NB_t):
    """The dual completion Y (p, na·T, W) in float64."""
    p, na, _, W = x.shape
    nb, Ka, Kb = W // T, Ra.shape[-1], Rb.shape[-1]
    z = (np.einsum("ask,pakw->pasw", _pick(ma.Btot, na), x)
         + np.einsum("asj,pajw->pasw", _pick(Ra, na), NA_t[:, :, :Ka]))
    nbr = NB_t.reshape(p, na, nb, 8, T)[:, :, :, :Kb]
    y = (np.einsum("bot,pasbt->pasbo", _pick(mb.Btot, nb),
                   z.reshape(p, na, T, nb, T))
         + np.einsum("boj,pabjs->pasbo", _pick(Rb, nb), nbr))
    return y.reshape(p, na * T, W)


@pytest.mark.parametrize("clamp", [False, True])
def test_final2d_stencil_takes_bf16_at_one_product(clamp):
    """``Final2DStencil(nprod=1)`` on a bf16 x (``final2d_stencil_bf16``):
    bf16 banks, its float32 path on the same values rounded once; against
    ``final2d_px(stencil2d=)`` on the bf16 x at one product and the f64
    bank of the f64 completion. px6 refuses a bf16 x."""
    ma, mb, _, _, Ra, Rb = _mats(clamp)
    p, na, nb, h8 = 1, 3, 2, 8
    x = _bf16(_img(p, na, T, nb * T, seed=3))
    NA_t = _img(p, na, 8, nb * T, seed=4)
    NB_t = _img(p, na, nb * 8, T, seed=5)
    fin = tk2d.Final2DStencil(ma.Btot, Ra, mb.Btot, Rb, na, nb, SOBEL, h8,
                              nprod=1)
    Y = fin.final.plain(*(torch.from_numpy(v) for v in (x, NA_t, NB_t)))
    z = torch.zeros_like(Y[:, :1, :h8])
    top = torch.cat([z, Y[:, :-1, T - h8:]], 1).numpy()
    bot = torch.cat([Y[:, 1:, :h8], z], 1).numpy()
    ops = [torch.from_numpy(v) for v in (NA_t, NB_t, top, bot)]
    xb = torch.from_numpy(x).to(BF16)
    got = fin(xb, *ops)
    assert got.dtype == BF16 and got.shape == (2, p, na, T, nb * T)
    assert torch.equal(got, fin(torch.from_numpy(x), *ops).to(BF16))
    want = jk2d.final2d_px(
        jnp.asarray(x, jnp.bfloat16), ma.Btot, Ra, mb.Btot, Rb,
        jnp.asarray(NA_t), jnp.asarray(NB_t), nprod=1, interpret=True,
        stencil2d={"taps_c": SOBEL, "h8": h8}, halo_top=jnp.asarray(top),
        halo_bot=jnp.asarray(bot))
    y64 = _final_f64(ma, mb, Ra, Rb, x.astype(np.float64), NA_t, NB_t)
    for g, j, w in zip(got, want, _bank_np(y64, SOBEL)):
        _held(g.reshape(p, na * T, -1), _np(j).reshape(p, na * T, -1), w)
    px6 = tk2d.Final2DStencil(ma.Btot, Ra, mb.Btot, Rb, na, nb, SOBEL, h8)
    with pytest.raises(ValueError, match="one product"):
        px6(xb, *ops)


def _pass_mats(n, clamp):
    w3 = rft.gaussian_weights(5.0, 3)
    scans = [tspec.Scan(1, True, w3[0], tuple(w3[1:])),
             tspec.Scan(1, False, w3[0], tuple(w3[1:]))]
    m = tdf.prepare_dim_pass(scans, T, n, clamp)
    cat = lambda ms, ax: np.concatenate([np.asarray(a) for a in ms], axis=ax)
    return m, cat(m.G, 1), cat(m.Rhat, 2)


@pytest.mark.parametrize("taps", [DERIV["taps"], _stencil(5)["taps"]],
                         ids=["D1", "C6-radius-5"])
def test_tails_extra_takes_bf16_to_the_float32_bits(taps):
    """``TailsPass(extra_rows=)`` on a bf16 x (``tails_extra_bf16``): the
    slot rows and the halo base rows bit-equal to its float32 path on the
    same values; against ``tails_pass(extra_rows=)`` on the bf16 x at one
    product and the f64 sums."""
    n, q = 3, 40
    m, Gcat, _ = _pass_mats(n, True)
    E = tdf._stencil_extra_rows(m, taps, T)
    x = _bf16(_img(q, n, T, seed=7))
    mod = tc.TailsPass(Gcat, n, extra_rows=E)
    got = mod(torch.from_numpy(x).to(BF16))
    assert got.dtype == torch.float32 and got.shape == (n, 8 + E.shape[1], q)
    assert torch.equal(got, mod(torch.from_numpy(x)))
    jout = _np(jc.tails_pass(jnp.asarray(x, jnp.bfloat16), Gcat, nprod=1,
                             interpret=True, extra_rows=E))
    S = Gcat.shape[1]
    xd = x.astype(np.float64)
    _held(got[:, :S], jout[:, :S],
          np.einsum("nst,qnt->nsq", _pick(Gcat, n), xd))
    _held(got[:, 8:], jout[:, 8:8 + E.shape[1]],
          np.einsum("nst,qnt->nsq", _pick(E, n), xd))


def _combine(y, a):  # D1e's affine combine y' + 0.25·x
    return y + 0.25 * a


@pytest.mark.parametrize("epi", [None, _combine], ids=["D1", "D1e"])
@pytest.mark.parametrize("start,end", [("zero", "clamp"), ("clamp", "zero")])
def test_completion_rot_stencil_takes_bf16(start, end, epi):
    """``CompletionPass(rot=True, stencil=, nprod=1)`` on a bf16 x
    (``completion_rot_stencil_bf16``, ``_epi_bf16`` with the affine
    combine, its aux float32): a bf16 output, its float32 path on the same
    values — the taps on the strips, then the epilogue — rounded once;
    against ``completion_pass(rot=True, stencil=)`` on the bf16 x at one
    product and the f64 stencil of the f64 completion."""
    n, q = 3, 40
    m, _, Rcat = _pass_mats(n, True)
    S = Rcat.shape[-1]
    x = _bf16(_img(q, n, T, seed=8))
    N = np.zeros((n, 8, q), np.float32)
    N[:, :S] = _img(n, S, q, seed=9)
    st = dict(DERIV, start=start, end=end)
    comp = tc.CompletionPass(m.Btot, Rcat, n, rot=True, stencil=st, nprod=1,
                             affine=affine_form(epi) if epi else None)
    y64 = (np.einsum("nos,qns->qno", _pick(m.Btot, n), x.astype(np.float64))
           + np.einsum("nou,nuq->qno", _pick(Rcat, n), N[:, :S]))
    yf = y64.transpose(1, 2, 0).reshape(n * T, q)
    Y = yf.reshape(n, T, q)
    prev = np.concatenate([np.zeros((1, 1, q)), Y[:-1, T - 1:]]).astype(
        np.float32)
    nxt = np.concatenate([Y[1:, :1], np.zeros((1, 1, q))]).astype(
        np.float32)
    aux = _img(n * T, q, seed=10, scale=0.5)
    ex = (torch.from_numpy(aux),) if epi else ()
    ops = (torch.from_numpy(N), torch.from_numpy(prev),
           torch.from_numpy(nxt), *ex)
    got = comp(torch.from_numpy(x).to(BF16), *ops)
    assert got.dtype == BF16 and got.shape == (n * T, q)
    assert torch.equal(got, comp(torch.from_numpy(x), *ops).to(BF16))
    jp = np.zeros((n, 8, q), np.float32)
    jp[:, 7:] = prev
    jn = np.zeros((n, 8, q), np.float32)
    jn[:, :1] = nxt
    kw = dict(epilogue=epi, eaux=(jnp.asarray(aux),)) if epi else {}
    jout = jc.completion_pass(
        jnp.asarray(x, jnp.bfloat16), m.Btot, Rcat, jnp.asarray(N),
        rot=True, nprod=1, interpret=True, carries_transposed=True,
        stencil=dict(taps=DERIV["taps"], prev=jnp.asarray(jp),
                     nxt=jnp.asarray(jn), start=start, end=end), **kw)
    want = _stencil1_np(yf, DERIV["taps"], 0, start, end)
    if epi:
        want = epi(want, aux.astype(np.float64))
    _held(got, _np(jout).reshape(n * T, q), want)


# ------------------------------------------------------------ the routes

def _spec(m, shape, scans, tiles=None, border="zero", dtype="bfloat16"):
    names = "wzyx"[-len(shape):]
    return m.FilterSpec("B", tuple(m.Dim(nm, e) for nm, e in
                                   zip(names, shape)),
                        tuple(m.Scan(*s) for s in scans), border=border,
                        dtype=dtype, tile_widths=tiles or (T,) * len(shape))


def _gauss(axes):
    w3 = rft.gaussian_weights(5.0, 3)
    return [(ax, c, w3[0], tuple(w3[1:])) for ax in axes
            for c in (True, False)]


def _oracle(js, x):
    return jsc.oracle_apply(dataclasses.replace(js, dtype="float32"),
                            x.astype(np.float64))


BANKS = {
    # name: (shape, scanned axes, the port's module and its body, whether
    # the JAX package holds the bound)
    "GS": ((256, 256), (0, 1), "Fused2DPx", None, False),
    "HS": ((200, 256), (0, 1), "Stencil2DAfter", "RotationChain", False),
    "C4b": ((256, 256), (0,), "Stencil2DAfter", "FusedRowsPx", True),
}


@pytest.mark.parametrize("case", list(BANKS))
def test_a_bank_on_a_bf16_filter(case):
    """The Sobel bank on a bf16 Gaussian: fused into the 2-D pair (GS:
    ``moments2d_bf16`` with edge rows, ``final2d_stencil_bf16``), after the
    rotation chain on a frame the pair declines (HS: the bank needs whole
    tiles) and after a y-only blur's rows pass (C4b), both on
    ``stencil2d_bf16``: bf16 channels, and against
    ``apply_filter_fused(stencil2d=)`` on the bf16 image and the f64 bank
    of the oracle."""
    shape, axes, kind, body, jax_bound = BANKS[case]
    js, ts = (_spec(m, shape, _gauss(axes)) for m in (jspec, tspec))
    x = _bf16(_img(*shape, seed=len(case), scale=0.1))
    mod = tdf.fused_filter_module(ts, stencil2d=SOBEL)
    assert type(mod).__name__ == kind
    if body is None:
        assert isinstance(mod.final, tk2d.Final2DStencil) and mod.h8 == 8
        assert mod.final.nprod == 1 and mod.dtype == BF16
    else:
        assert type(mod.body).__name__ == body
    xb = torch.from_numpy(x).to(BF16)
    got = mod(xb)
    assert len(got) == 2 and all(g.dtype == BF16 and g.shape == shape
                                 for g in got)
    if body is not None:  # the bank on the bf16 output, rounded once
        y = mod.body(xb)
        assert y.dtype == BF16
        for g, f in zip(got, tst.Stencil2D(SOBEL)(y.float())):
            assert torch.equal(g, f.to(BF16))
    jout = jdf.apply_filter_fused(js, jnp.asarray(x, jnp.bfloat16),
                                  stencil2d=SOBEL)
    for g, j, w in zip(got, jout, _bank_np(_oracle(js, x), SOBEL)):
        assert j.dtype == jnp.bfloat16
        _held(g, j, w, jax_bound)


def _rotated(shape, stencil, epi=None, seed=0, tiles=None):
    """The x pass with ``rotate_emit=2`` and ``stencil`` on a bf16 image of
    ``shape``: the port's RotatedPass output, the JAX package's
    ``apply_filter_rotated``, the f64 reference and the port's module."""
    js, ts = (_spec(m, shape, _gauss((len(shape) - 1,)), tiles=tiles)
              for m in (jspec, tspec))
    x = _bf16(_img(*shape, seed=seed, scale=0.1))
    aux = np.swapaxes(x, -1, -2).copy()  # the image, rotated, as float32
    mod = tdf.RotatedPass(ts, 2, stencil=stencil, epilogue=epi)
    ex = (torch.from_numpy(aux),) if epi else ()
    got = mod(torch.from_numpy(x).to(BF16), *ex)
    kw = dict(epilogue=epi, eaux=(jnp.asarray(aux),)) if epi else {}
    jout = jdf.apply_filter_rotated(js, jnp.asarray(x, jnp.bfloat16),
                                    rot_axes=2, stencil=stencil, **kw)
    z = np.swapaxes(_oracle(js, x), -1, -2)
    taps = stencil["taps"]
    if isinstance(taps[0][0], (list, tuple)):  # per slice
        want = np.stack([_stencil1_np(z[p], t, 0, stencil.get("start",
                                                              "zero"),
                                      stencil.get("end", "clamp"))
                         for p, t in enumerate(taps)])
    else:
        want = _stencil1_np(z, taps, z.ndim - 2, stencil.get("start",
                                                             "zero"),
                            stencil.get("end", "clamp"))
    if epi:
        want = epi(want, aux.astype(np.float64))
    return got, jout, want, mod


@pytest.mark.parametrize("epi", [None, _combine], ids=["D1", "D1e"])
def test_a_gaussian_derivative_fused_into_the_rotated_emit(epi):
    """D1 and D1e at 128 × 512: the x pass emitted rotated with the
    central difference fused (``tails_extra_bf16``,
    ``completion_rot_stencil_bf16``; D1e's combine y′ + 0.25·x, its aux the
    image as float32, in ``completion_rot_stencil_epi_bf16``): a bf16
    output, against ``apply_filter_rotated(stencil=)`` on the bf16 image
    and the f64 reference."""
    got, jout, want, mod = _rotated((128, 512), DERIV, epi, seed=21)
    body = mod.body
    assert body.st_comp is not None and body.nprod == 1
    assert body.epilogue_route == (None if epi is None else "kernel")
    assert got.dtype == BF16 and got.shape == (512, 128)
    _held(got, jout, want, jax_bound=epi is not None)


def test_the_per_slice_branch_in_bf16():
    """C6b at (2, 64, 256): C6's per-slice taps (the DoG radii's double
    differences) on the Gaussian x pass, one ``tails_extra_bf16`` +
    ``completion_rot_stencil_bf16`` pair per slice; against
    ``apply_filter_rotated`` on the bf16 volume and the f64 reference."""
    st = {"taps": [_stencil(5)["taps"], _stencil(9)["taps"]],
          "start": "zero", "end": "clamp"}
    got, jout, want, mod = _rotated((2, 64, 256), st, seed=22)
    assert len(mod.body.st_comp) == 2
    assert got.dtype == BF16 and got.shape == (2, 256, 64)
    _held(got, jout, want)


def test_the_padded_rotated_pass_falls_back_in_float32():
    """A rotated pass whose extent (500) is not a whole number of tiles
    cannot fuse its stencil: the bf16 filter output, then the taps (and
    the combine) in float32 on it, rounded once — bit-equal to that
    computed by hand; against ``apply_filter_rotated`` (whose fallback
    takes the taps in bf16 arithmetic) and the f64 reference."""
    got, jout, want, mod = _rotated((64, 500), DERIV, _combine, seed=23)
    body = mod.body
    assert body.pad == 12 and body.st_comp is None
    assert got.dtype == BF16 and got.shape == (500, 64)
    _held(got, jout, want)
    x = torch.from_numpy(_bf16(_img(64, 500, seed=23, scale=0.1))).to(BF16)
    aux = x.float().t().contiguous()
    body.stencil, body.epilogue = None, None
    y = mod(x)
    assert y.dtype == BF16
    ref = _combine(tdf.apply_stencil(y.float(), -2, DERIV["taps"], "zero",
                                     "clamp"), aux).to(BF16)
    assert torch.equal(got, ref)


# ----------------------------------------------------- the kernels' layouts

LDX, LDNS, LDZ, TM = 144, 68, 68, 64  # completion_tc.cuh, completion_rot.cuh


def _rot_smem(bf16, sl, hp, hn, ntaps, nwg, nc=2, kc=1):
    """``completion_rot.cuh``'s ``rot_smem`` (bytes)."""
    xs = TM * LDX * (2 if bf16 else 4) // 4 + sl * LDNS
    zh = (hp + T + hn) * LDZ if ntaps else 0
    return (nc * T * (T + 16 * kc) * 2 + 4 * ((2 * ntaps + 3) // 4 * 4)
            + 4 * nwg * max(xs, zh))


def test_bf16_stencil_body_stage_model():
    """A model of ``completion_rot.cuh``'s stencil body on a bf16 x stage.
    The x stage (64 rows of LDX = 144 bf16, then sl carry rows of 68
    floats) is read by the products as the unstenciled bf16 body reads it:
    a half warp's 8-byte fragment reads touch 32 distinct banks. The
    stencil stage Z (hp + 128 + hn rows of 68 floats) lies over it from
    the same base: its fragment writes (row hp + 8j + 2qd + e, column r +
    8h) and the emit's line-wise reads touch distinct banks; its rows start
    16-byte aligned for the halo copies. With a bf16 x stage the stencil
    stage is the larger at every reach, so the stage is sized from it, and
    two warpgroups fit wherever they fit at float32 (D1's reach, C6's)."""
    for k0 in range(0, T, 16):
        for half in range(2):
            for h in range(2):
                banks = []
                for lane in range(16 * half, 16 * half + 16):
                    r, qd = lane // 4 + 8 * h, lane % 4
                    byte = (r * LDX + k0 + 4 * qd) * 2
                    banks += [(byte // 4 + i) % 32 for i in range(2)]
                assert sorted(banks) == list(range(32))
    for hp in (0, 1, 20):
        for j in range(16):
            for h in range(2):
                for e in range(2):
                    banks = [((hp + 8 * j + 2 * (lane % 4) + e) * LDZ
                              + lane // 4 + 8 * h) % 32
                             for lane in range(32)]
                    assert len(set(banks)) == 32
        for row in range(hp + T):
            assert len({(row * LDZ + lane) % 32 for lane in range(32)}) == 32
    assert LDZ * 4 % 16 == 0
    for sl in (8, 16):
        for hp, hn, ntaps in ((1, 1, 2), (20, 18, 3), (0, 0, 1),
                              (128, 128, 2)):
            xs16 = TM * LDX // 2 + sl * LDNS
            assert (hp + T + hn) * LDZ >= xs16
            for nwg in (1, 2):
                assert (_rot_smem(True, sl, hp, hn, ntaps, nwg)
                        <= _rot_smem(False, sl, hp, hn, ntaps, nwg))
    max_smem = 232448
    for hp, hn in ((1, 1), (20, 18)):
        assert _rot_smem(True, 8, hp, hn, 3, 2) <= max_smem
