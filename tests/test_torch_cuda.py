"""The port's CUDA kernels on a card: against their plain twins, through
the public API, and the wrappers' refusals.

Every test here is marked ``cuda`` and skips (inside the test) on a machine
without a CUDA device. The file imports neither jax nor the JAX package, so
it also runs on a card machine that has no jax — there ``tests/conftest.py``
(which imports jax) is left out:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch.apps import (audio_filter_high_order,
                                      gaussian_1xy_2x_2y, run_cascade)
from recfilter_tpu_torch.kernels import completion as tc
from recfilter_tpu_torch.kernels import final2d as tk2d
from recfilter_tpu_torch.kernels import launch as tl
from recfilter_tpu_torch.spec import Scan

P, NA, NB, T = 2, 3, 4, 128
STACKS = {"uniform": (False, 0, 0), "clamp": (True, 0, 0),
          "pad": (False, 40, 72)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda")


def _only(**kw):
    """Launch counts with every kernel entry not named at 0."""
    return {k: kw.get(k, 0) for k in tl.LAUNCHES}


def _modules(kind, dev):
    clamp, pad_a, pad_b = STACKS[kind]
    w3 = rft.gaussian_weights(5.0, 3)
    a = [Scan(0, True, w3[0], tuple(w3[1:])),
         Scan(0, False, w3[0], tuple(w3[1:]))]
    b = [Scan(1, True, 0.9, (0.6, 0.25, -0.1)),
         Scan(1, False, 1.1, (0.5, 0.2))]
    ma = tdf.prepare_dim_pass(a, T, NA, clamp, pad_slots=pad_a)
    mb = tdf.prepare_dim_pass(b, T, NB, clamp, pad_slots=pad_b)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    mom = tk2d.Moments2D(cat(ma.G, 1), cat(mb.G, 1), ma.Btot, NA, NB)
    fin = tk2d.Final2D(ma.Btot, cat(ma.Rhat, 2), mb.Btot, cat(mb.Rhat, 2),
                       NA, NB)
    return mom.to(dev), fin.to(dev)


def _inputs(dev, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(P, NA, T, NB * T), (P, NA, 8, NB * T), (P, NA, NB * 8, T)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev) for s in shapes]


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


@pytest.mark.parametrize("kind", list(STACKS))
def test_kernels_match_twins(kind, dev):
    """max|kernel − twin| ≤ 1e-5·max|twin| (fp32 sums in another order)."""
    mom, fin = _modules(kind, dev)
    x, NA_t, NB_t = _inputs(dev)
    tl.reset_launches()
    outs = mom(x)
    y = fin(x, NA_t, NB_t)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(moments2d=1, final2d=1)
    for got, want in zip(outs, mom.plain(x)):
        assert _rel(got, want) <= 1e-5
    assert _rel(y, fin.plain(x, NA_t, NB_t)) <= 1e-5
    bA, term1 = outs
    assert not bA[:, :, 6:].any()  # Ka = 6: pad slots written as zeros
    assert not term1.reshape(P, NA, NB, 8, T)[:, :, :, 5:].any()  # Kb = 5


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    mom, fin = _modules("uniform", dev)
    x, NA_t, NB_t = _inputs(dev)
    with pytest.raises(TypeError):
        mom(x.double())
    with pytest.raises(ValueError):
        mom(x[:, :, :, :-T])
    with pytest.raises(ValueError):
        mom(x.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError):
        fin(x, NA_t[:, :, :4], NB_t)
    with pytest.raises(ValueError):
        fin(x, NA_t.cpu(), NB_t)


def test_headline_filter_on_the_card(dev):
    """``bench.py::_build_filter`` at 512² through ``realize`` on the
    card, within the px6 bound 2e-6 of the f64 oracle."""
    h = w = 512
    img = (np.random.default_rng(0).standard_normal((h, w)) * 0.01
           ).astype(np.float32)
    x, y = rft.Dim("x", w), rft.Dim("y", h)
    F = rft.RecFilter("GaussianIIR")
    F[y, x] = img
    for d in (+x, -x, +y, -y):
        F.add_filter(d, rft.gaussian_weights(5.0, 3))
    F.split(x, 128, y, 128)
    got = F.realize(device=dev)
    assert got.device.type == "cuda"
    want = rft.oracle_apply(F.spec, img.astype(np.float64))
    err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-6


def _stack(kind, rows, cols, n, rng, scale=1.0):
    """A per-tile stack: uniform, clamp (first/last differ) or pad (last
    differs), as ``prepare_dim_pass`` shapes them."""
    M = [rng.standard_normal((rows, cols)) * scale for _ in range(3)]
    if kind == "uniform":
        return M[0][None]
    first = M[1] if kind == "clamp" else M[0]
    return np.stack([first] + [M[0]] * (n - 2) + [M[2]])


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("S,q", [(2, 300), (6, 64), (29, 77), (56, 8)])
def test_1d_kernels_match_twins(kind, S, q, dev):
    """tails and completion against their twins, one to seven carry
    slots, ragged line blocks: max|kernel − twin| ≤ 1e-5·max|twin|."""
    rng = np.random.default_rng(S + q)
    n = 5
    tails = tc.TailsPass(_stack(kind, S, T, n, rng), n).to(dev)
    comp = tc.CompletionPass(_stack(kind, T, T, n, rng, 0.1),
                             _stack(kind, T, S, n, rng), n).to(dev)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(np.float32)
                         ).to(dev)
    tl.reset_launches()
    b = tails(x)
    y = comp(x, b)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(tails=1, completion=1)
    assert b.shape == (n, tc.slots_for(S), q)
    assert not b[:, S:].any()  # pad slots written as zeros
    assert _rel(b, tails.plain(x)) <= 1e-5
    assert _rel(y, comp.plain(x, b)) <= 1e-5


def test_1d_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(1)
    n, S, q = 3, 6, 16
    tails = tc.TailsPass(_stack("clamp", S, T, n, rng), n).to(dev)
    comp = tc.CompletionPass(_stack("clamp", T, T, n, rng),
                             _stack("clamp", T, S, n, rng), n).to(dev)
    x = torch.zeros((q, n, T), device=dev)
    N = torch.zeros((n, 8, q), device=dev)
    with pytest.raises(TypeError):
        tails(x.double())
    with pytest.raises(ValueError):
        tails(x[:, :2].contiguous())
    with pytest.raises(ValueError):
        tails(x.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):
        comp(x, N[:, :4].contiguous())
    with pytest.raises(ValueError):
        comp(x, N.cpu())
    with pytest.raises(ValueError):
        comp(x, torch.zeros((n, 8, q + 1), device=dev))


def test_audio_filter_on_the_card(dev):
    """The order-5 audio filter at 300,000 samples (the supertile
    hierarchy, 10 supertiles) through ``realize`` on the card: one tails
    and one completion launch, within 2e-6 of the f64 oracle."""
    n = 300_000
    x = (np.random.default_rng(2).standard_normal(n) * 0.1
         ).astype(np.float32)
    F = audio_filter_high_order(n, 5, 1000)
    tl.reset_launches()
    got = F.realize(x, device=dev)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(tails=1, completion=1)
    want = rft.oracle_apply(F.spec, x.astype(np.float64))
    err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-6
    assert F.profile(2, device=dev) > 0  # prints Msamples/s


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("p,n,nl", [(2, 3, 2), (1, 2, 5), (3, 2, 1)])
def test_rows_kernels_match_twins(kind, p, n, nl, dev):
    """rows_tails and rows_final against their twins:
    max|kernel − twin| ≤ 1e-5·max|twin|, pad slots written as zeros."""
    rng = np.random.default_rng(p * 100 + n * 10 + nl)
    K = 6
    tails = tk2d.RowsTails(_stack(kind, K, T, n, rng), n).to(dev)
    fin = tk2d.RowsFinal(_stack(kind, T, T, n, rng, 0.1),
                         _stack(kind, T, K, n, rng), n).to(dev)
    x = torch.from_numpy(rng.standard_normal((p, n, T, nl * T)).astype(
        np.float32)).to(dev)
    tl.reset_launches()
    b = tails(x)
    y = fin(x, b)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(rows_tails=1, rows_final=1)
    assert b.shape == (p, n, 8, nl * T)
    assert not b[:, :, K:].any()
    assert _rel(b, tails.plain(x)) <= 1e-5
    assert _rel(y, fin.plain(x, b)) <= 1e-5


def test_rows_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(3)
    n = 2
    tails = tk2d.RowsTails(_stack("clamp", 3, T, n, rng), n).to(dev)
    fin = tk2d.RowsFinal(_stack("clamp", T, T, n, rng),
                         _stack("clamp", T, 3, n, rng), n).to(dev)
    x = torch.zeros((1, n, T, 2 * T), device=dev)
    N = torch.zeros((1, n, 8, 2 * T), device=dev)
    with pytest.raises(TypeError):
        tails(x.double())
    with pytest.raises(ValueError):
        tails(x[:, :, :, :-1].contiguous())  # lanes not a multiple of 128
    with pytest.raises(ValueError):
        tails(torch.zeros((1, n + 1, T, T), device=dev))
    with pytest.raises(ValueError):
        tails(torch.zeros((65536, n, T, T), device=dev))  # gridDim.z
    with pytest.raises(ValueError):
        fin(x, N[:, :, :4].contiguous())
    with pytest.raises(ValueError):
        fin(x, N.cpu())


def test_volume_on_the_card(dev):
    """A 128 × 128 × 256 σ=5 Gaussian volume (clamp) through ``realize``:
    one launch of each of the rows and 2-D kernels, none of the 1-D ones,
    within 2e-6 of the f64 oracle."""
    z, h, w = 128, 128, 256
    vol = (np.random.default_rng(4).standard_normal((z, h, w)) * 0.01
           ).astype(np.float32)
    dz, dy, dx = rft.Dim("z", z), rft.Dim("y", h), rft.Dim("x", w)
    F = rft.RecFilter("Volume")
    F.set_clamped_image_border()
    F[dz, dy, dx] = vol
    for d in (+dz, -dz, +dy, -dy, +dx, -dx):
        F.add_filter(d, rft.gaussian_weights(5.0, 3))
    F.split(dz, 128, dy, 128, dx, 128)
    tl.reset_launches()
    got = F.realize()
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert tl.LAUNCHES == _only(rows_tails=1, rows_final=1, moments2d=1,
                                final2d=1)
    want = rft.oracle_apply(F.spec, vol.astype(np.float64))
    err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-6


def test_gaussian_cascade_on_the_card(dev):
    """``gaussian_1xy_2x_2y`` at 512²: stage 0 on the 2-D kernels, stage 1
    (x) on the 1-D kernels, stage 2 (y) on the rows kernels — each once —
    within 2e-6 of the oracle of the whole filter before ``cascade``."""
    img = (np.random.default_rng(5).standard_normal((512, 512)) * 0.01
           ).astype(np.float32)
    fc = gaussian_1xy_2x_2y(512, 512)
    tl.reset_launches()
    got = run_cascade(fc, img)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(moments2d=1, final2d=1, tails=1,
                                completion=1, rows_tails=1, rows_final=1)
    whole = rft.FilterSpec("G", fc[0].spec.dims,
                           sum((f.spec.scans for f in fc), ()),
                           border="clamp", tile_widths=(128, 128))
    want = rft.oracle_apply(whole, img.astype(np.float64))
    err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-6


# ---------------------------------------------------------------------------
# The FIR and integer kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["plain", "bank", "contract"])
@pytest.mark.parametrize("rot", [False, True])
@pytest.mark.parametrize("q,L,B", [(64, 1000, 5), (37, 384, 9), (8, 128, 21)])
def test_fir_band_matches_twin(form, rot, q, L, B, dev):
    """fir_band against its twin — a 1→1 pass, a C = 2 bank, a signed
    C → 1 contraction, flat and rotated, ragged L, box³ supports up to
    K = 127: max|kernel − twin| ≤ 1e-5·max|twin| (fp32 sums in another
    order), one launch."""
    from recfilter_tpu_torch.fir import box_taps
    from recfilter_tpu_torch.kernels import fir_band

    taps = [box_taps(B, 3)] if form == "plain" else [
        np.pad(box_taps(B - 2, 3), 6), box_taps(B, 3)]
    band = fir_band.FirBand(np.stack(taps), rot=rot,
                            contract=form == "contract",
                            signs=[1.0, -1.0] if form == "contract" else None)
    band = band.to(dev)
    rng = np.random.default_rng(q + L + B)
    shape = (2, q, L) if form == "contract" else (q, L)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    tl.reset_launches()
    y = band(x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(fir_band=1)
    want = band.plain(x)
    assert y.shape == want.shape
    assert _rel(y, want) <= 1e-5


def test_fir_band_refuses_what_the_kernel_does_not_take(dev):
    from recfilter_tpu_torch.fir import box_taps
    from recfilter_tpu_torch.kernels import fir_band

    band = fir_band.FirBand(box_taps(5, 3)).to(dev)
    x = torch.zeros((16, 256), device=dev)
    with pytest.raises(TypeError):
        band(x.double())
    with pytest.raises(ValueError):
        band(x.t())  # not contiguous
    with pytest.raises(ValueError):
        band(x[None])  # (C, q, L) without contract
    with pytest.raises(ValueError):
        band(torch.zeros((16, 128 * 65536), device=dev))  # gridDim.y


UNITS = [[(1, 1, True)], [(2, -1, True), (1, -1, False), (3, 1, False)],
         [(1, 1, True)] * 9]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16, torch.int8])
@pytest.mark.parametrize("units", range(len(UNITS)))
@pytest.mark.parametrize("shape,axis", [((37, 3000), 1), ((3, 1000, 77), 1),
                                         ((4096, 40), 0)])
def test_int_scan_matches_twin(dtype, units, shape, axis, dev):
    """int_scan bit-equal to its twin: int8/16/32, a = ±1, causal and
    anticausal, f ≠ 1, more than 8 scans (two launches), the last axis
    and a leading one."""
    from recfilter_tpu_torch.kernels import int_scan

    scans = UNITS[units]
    info = torch.iinfo(dtype)
    x = torch.from_numpy(np.random.default_rng(units).integers(
        info.min, info.max, shape, endpoint=True)).to(dtype).to(dev)
    tl.reset_launches()
    y = int_scan.int_unit_dim_pass(x, scans, axis)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(int_scan=-(-len(scans) // 8))
    assert y.dtype == dtype
    assert torch.equal(y.cpu(), int_scan.unit_scans_plain(x.cpu(), scans,
                                                          axis))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8])
@pytest.mark.parametrize("unit", [(1, 1, True), (2, -1, False),
                                  (-3, -1, True)])
@pytest.mark.parametrize("shape,axis", [((2, 300_001), 1), ((8190, 64), 0),
                                         ((2, 5000, 33), 1)])
def test_int_seg_scan_matches_twin(dtype, unit, shape, axis, dev):
    """The segmented phases past the full-extent gates, each against its
    twin and the whole route against the full-extent twin: bit-equal, one
    launch of each phase."""
    from recfilter_tpu_torch.kernels import int_scan

    info = torch.iinfo(dtype)
    x = torch.from_numpy(np.random.default_rng(7).integers(
        info.min, info.max, shape, endpoint=True)).to(dtype).to(dev)
    layout, P, E, W = int_scan._layout(x, axis)
    C = int_scan._chunk_len(E)
    xr = x.reshape((P, E) if layout == 0 else (P, E, W))
    c = int_scan.seg_carries(xr, unit, layout, C)
    assert torch.equal(c.cpu(), int_scan.seg_carries_plain(
        xr.cpu(), unit, layout, C))
    inc = int_scan._carry_chain(c, unit[2])
    assert torch.equal(int_scan.seg_fix(xr, inc, unit, layout, C).cpu(),
                       int_scan.seg_fix_plain(xr.cpu(), inc.cpu(), unit,
                                              layout, C))
    tl.reset_launches()
    y = int_scan.int_unit_dim_pass(x, [unit], axis)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(int_seg_carries=1, int_seg_fix=1)
    assert torch.equal(y.cpu(), int_scan.unit_scans_plain(x.cpu(), [unit],
                                                          axis))


def test_int_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from recfilter_tpu_torch.kernels import int_scan

    x = torch.zeros((4, 256), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        int_scan.int_unit_dim_pass(x.float(), [(1, 1, True)], 1)
    with pytest.raises(TypeError):
        int_scan.int_unit_dim_pass(x.long(), [(1, 1, True)], 1)
    with pytest.raises(ValueError):  # gridDim.y of the other-axis layout
        int_scan.int_unit_dim_pass(
            torch.zeros((65536, 2, 1), dtype=torch.int8, device=dev),
            [(1, 1, True)], 1)


def test_box_and_dog_on_the_card(dev):
    """box_filter_3 and difference_of_gaussians at 512 × 384: two fir_band
    launches each, within 2e-6 (5e-6 for the signed contraction) of the
    f64 oracle's peak; the box gradient through the kernel against the
    plain path within rtol = atol = 1e-4."""
    from recfilter_tpu_torch.apps import box_filter_3, difference_of_gaussians
    from recfilter_tpu_torch.fir import box_taps, fir_oracle

    img = np.random.default_rng(8).random((384, 512)).astype(np.float32)
    x = torch.from_numpy(img).to(dev)
    for mod, taps, bound in (
            (box_filter_3(512, 384, 5), [(1.0, box_taps(5, 3))], 2e-6),
            (difference_of_gaussians(512, 384, 5, 9),
             [(1.0, box_taps(5, 3)), (-1.0, box_taps(9, 3))], 5e-6)):
        mod = mod.to(dev)
        tl.reset_launches()
        got = mod(x)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(fir_band=2)
        want = sum(s * fir_oracle(fir_oracle(img, t, 1), t, 0)
                   for s, t in taps)
        err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
        assert err <= bound
    mod = box_filter_3(512, 384, 5).to(dev)
    grads = []
    for fwd in (mod.forward, mod.forward_plain):
        xg = x.clone().requires_grad_()
        (g,) = torch.autograd.grad((fwd(xg) ** 2).sum(), xg)
        grads.append(g)
    assert torch.allclose(grads[0], grads[1], rtol=1e-4, atol=1e-4)


def test_int_summed_table_on_the_card(dev):
    """An int32 summed-area table through ``realize`` on the card: one
    int_scan launch per axis, bit-exact against numpy's wrapping
    cumsum."""
    from recfilter_tpu_torch.apps import summed_table

    img = np.random.default_rng(9).integers(0, 256, (640, 1000)).astype(
        np.int32)
    F = summed_table(1000, 640, dtype="int32")
    tl.reset_launches()
    got = F.realize(img)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(int_scan=2)
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    want = img.cumsum(1, dtype=np.int32).cumsum(0, dtype=np.int32)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


# ---------------------------------------------------------------------------
# The rotated emit and the stencil consumers
# ---------------------------------------------------------------------------


def _halos_flat(yf, n, hp, hn):
    """Halo strips of a flat rotated output (n·T, q): prev[t] = the last
    hp rows of tile t−1, nxt[t] = the first hn rows of tile t+1 (zeros
    at the ends) — what ``dimfuse._stencil_halo`` completes."""
    Y = yf.reshape(n, T, -1)
    z = torch.zeros_like(Y[:1])
    prev = torch.cat([z[:, :hp], Y[:-1, T - hp:]]) if hp else None
    nxt = torch.cat([Y[1:, :hn], z[:, :hn]]) if hn else None
    return [h.contiguous() for h in (prev, nxt) if h is not None]


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("taps,start,end", [
    (None, "zero", "zero"),
    ([(10, 0.25), (-1, -2.0), (-12, 1.0)], "zero", "clamp"),
    ([(10, 0.25), (-1, -2.0), (-12, 1.0)], "clamp", "zero"),
    ([(3, 1.0), (0, -0.5)], "zero", "zero"),
    ([(-128, 1.0), (128, 0.5), (0, 2.0)], "clamp", "clamp")])
def test_completion_rot_matches_twin(kind, taps, start, end, dev):
    """The rotated completion, with and without a fused stencil, both
    border modes: max|kernel − twin| ≤ 1e-5·max|twin| (the twin reads the
    whole output, the kernel the halo strips); tails with extra rows
    against their twin."""
    rng = np.random.default_rng(3)
    n, S, q = 4, 3, 200
    st = None if taps is None else {"taps": taps, "start": start,
                                    "end": end}
    Btot, Rcat = _stack(kind, T, T, n, rng, 0.1), _stack(kind, T, S, n, rng)
    comp = tc.CompletionPass(Btot, Rcat, n, rot=True, stencil=st).to(dev)
    flat = tc.CompletionPass(Btot, Rcat, n, rot=True).to(dev)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(np.float32)
                         ).to(dev)
    N = torch.from_numpy(rng.standard_normal((n, 8, q)).astype(np.float32)
                         ).to(dev)
    halos = _halos_flat(flat.plain(x, N), n, comp.hp, comp.hn)
    tl.reset_launches()
    y = comp(x, N, *halos)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(completion_rot=1)
    assert y.shape == (n * T, q)
    assert _rel(y, comp.plain(x, N, *halos)) <= 1e-5
    E = _stack(kind, 20, T, n, rng)
    tails = tc.TailsPass(_stack(kind, S, T, n, rng), n, extra_rows=E).to(dev)
    tl.reset_launches()
    b = tails(x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(tails_extra=1)
    assert b.shape == (n, 8 + 20, q) and not b[:, S:8].any()
    assert _rel(b, tails.plain(x)) <= 1e-5


WIDE = [[(0, 100, 1.0), (0, -90, 1.0), (3, 0, 0.5)]]      # nothing staged
MID = [[(0, 30, 1.0), (-16, -30, -1.0)], [(16, 0, 2.0)]]  # A1 staged


@pytest.mark.parametrize("kind,bank", [(k, None) for k in STACKS]
                         + [("uniform", WIDE), ("clamp", MID)])
def test_moments_edge_rows_and_final2d_stencil_match_twins(kind, bank,
                                                           dev):
    """moments2d with edge rows and final2d_stencil (a dual-radius
    4-corner bank, lane and row reach across tiles; wide column reaches
    whose operands stay in device memory) against their twins:
    max|kernel − twin| ≤ 1e-5·max|twin|."""
    clamp, pad_a, pad_b = STACKS[kind]
    w3 = rft.gaussian_weights(5.0, 3)
    a = [Scan(0, True, w3[0], tuple(w3[1:])),
         Scan(0, False, w3[0], tuple(w3[1:]))]
    b = [Scan(1, True, 0.9, (0.6, 0.25, -0.1))]
    ma = tdf.prepare_dim_pass(a, T, NA, clamp, pad_slots=pad_a)
    mb = tdf.prepare_dim_pass(b, T, NB, clamp, pad_slots=pad_b)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    bank = bank or [
        [(5, 5, 1.0), (5, -6, -1.0), (-6, 5, -1.0), (-6, -6, 1.0)],
        [(9, 9, 0.5), (9, -10, -0.5), (-10, 9, -0.5), (-10, -10, 0.5),
         (0, 0, 0.25)]]
    h8 = 16
    mom = tk2d.Moments2D(cat(ma.G, 1), cat(mb.G, 1), ma.Btot, NA, NB,
                         edge=(ma.Btot, h8)).to(dev)
    fin = tk2d.Final2DStencil(ma.Btot, cat(ma.Rhat, 2), mb.Btot,
                              cat(mb.Rhat, 2), NA, NB, bank, h8).to(dev)
    x, NA_t, NB_t = _inputs(dev, seed=4)
    outs = mom(x)
    assert len(outs) == 4 and outs[2].shape == (P, NA, h8, NB * T)
    for got, want in zip(outs, mom.plain(x)):
        assert _rel(got, want) <= 1e-5
    Y = fin.final.plain(x, NA_t, NB_t).reshape(P, NA, T, NB * T)
    z = torch.zeros_like(Y[:, :1, :h8])
    top = torch.cat([z, Y[:, :-1, T - h8:]], dim=1).contiguous()
    bot = torch.cat([Y[:, 1:, :h8], z], dim=1).contiguous()
    tl.reset_launches()
    got = fin(x, NA_t, NB_t, top, bot)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(final2d_stencil=1)
    want = fin.plain(x, NA_t, NB_t, top, bot)
    assert got.shape == (len(bank), P, NA, T, NB * T)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int16])
@pytest.mark.parametrize("H,W,bank", [
    (300, 520, [[(1, 0, 1.0), (-1, 0, -1.0)], [(0, 1, 0.5), (0, -1, -0.5)]]),
    (257, 384, [[(5, 5, 1.0), (5, -6, -1.0), (-6, 5, -1.0), (-6, -6, 1.0)]]),
    (200, 260, [[(120, -3, 1.0), (-120, 130, 2.0)], [(0, 0, 1.0)]])])
def test_stencil2d_matches_twin(dtype, H, W, bank, dev):
    """stencil2d (staged tile, and direct reads past the staging reach)
    against stencil2d_ref: float32 within 1e-5 of the peak, integer
    tables exactly (float32 output either way)."""
    from recfilter_tpu_torch.kernels.stencil2d import Stencil2D

    rng = np.random.default_rng(H)
    if dtype == torch.float32:
        y = torch.from_numpy(rng.standard_normal((H, W)).astype(np.float32))
    else:
        y = torch.from_numpy(rng.integers(-999, 999, (H, W))).to(dtype)
    st = Stencil2D(bank).to(dev)
    tl.reset_launches()
    got = st(y.to(dev))
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(stencil2d=1)
    want = st.plain(y)
    assert len(got) == len(bank)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == torch.float32
        if dtype == torch.float32:
            assert _rel(g.cpu(), w) <= 1e-5
        else:
            assert torch.equal(g.cpu(), w)


def test_stencil2d_rank_is_the_routers_choice(dev):
    """The stencil2d wrapper launches on an (H, W) card tensor only and
    raises on another rank; Stencil2DAfter routes a 3-D filter output to
    the twin (the JAX package's _st_fallback), a 2-D one to the kernel."""
    from recfilter_tpu_torch.kernels.stencil2d import Stencil2D

    bank = [[(1, 0, 1.0), (-1, 0, -1.0)]]
    y = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 64, 96)).astype(np.float32)).to(dev)
    with pytest.raises(ValueError, match="takes an"):
        Stencil2D(bank).to(dev)(y)
    cd, yd, xd = rft.Dim("c", 2), rft.Dim("y", 256), rft.Dim("x", 256)
    for shape, dims, launches in (
            ((2, 256, 256), (cd, yd, xd), _only(tails=1, completion=1)),
            ((256, 256), (yd, xd),
             _only(tails=1, completion=1, stencil2d=1))):
        F = rft.RecFilter("ScanX")
        F[dims] = np.zeros(shape, np.float32)
        F.add_filter(+xd, [0.5, 0.5])
        F.split(xd, T)
        mod = F.as_func(stencil2d=bank)
        x = torch.from_numpy(np.random.default_rng(6).standard_normal(
            shape).astype(np.float32)).to(dev)
        tl.reset_launches()
        got = mod(x)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == launches
        assert _rel(got[0], mod.forward_plain(x)[0]) <= 1e-5


def test_sat_apps_and_consumers_on_the_card(dev):
    """The consumers through the public API on the card, at 256²: the DoG
    SAT (moments2d, final2d_stencil, four rotated stencil passes), box ×3
    SAT (the FIR order-1 box feeding the rotated integrals a transposed
    view), a y-only blur with a Sobel bank (stencil2d), the Gaussian with
    an epilogue (affine: in final2d's store loop; a clamp: torch ops after
    it), and the per-slice rotated pass: launch counts, and the plain path
    within 1e-3 of the peak (the integrals' fp32 rounding). The DoG's
    subtraction is its last rotated pass's affine epilogue."""
    from recfilter_tpu_torch.apps import box_filter_3, difference_of_gaussians
    from recfilter_tpu_torch.apps.dog import _stencil

    w = 256
    img = np.random.default_rng(20).random((w, w)).astype(np.float32)
    img[:21] = img[-21:] = 0
    img[:, :21] = img[:, -21:] = 0
    x = torch.from_numpy(img).to(dev)
    sobel = [[(-1, -1, -1.0), (0, 1, 2.0)], [(1, 0, 1.0), (-1, 0, -1.0)]]
    xd, yd = rft.Dim("x", w), rft.Dim("y", w)
    blur = rft.RecFilter("BlurY")
    blur[yd, xd] = img
    blur.add_filter(+yd, [0.5, 0.5])
    blur.split(yd, T)
    gauss = rft.RecFilter("G")
    gauss[yd, xd] = img
    for d in (+xd, -xd, +yd, -yd):
        gauss.add_filter(d, rft.gaussian_weights(3.0, 3))
    gauss.split(xd, T, yd, T)
    cd = rft.Dim("c", 2)
    sl = rft.RecFilter("S")
    sl[cd, yd, xd] = np.stack([img, img])
    sl.add_filter(+xd, [1.0, 2.0, -1.0])
    sl.split(xd, T)
    sl.set_plan(rotate_emit=2)
    cases = [
        (difference_of_gaussians(w, w, 5, 9, variant="sat"), (x,),
         _only(moments2d=1, final2d_stencil=1, tails_extra=4,
               completion_rot=3, completion_rot_epi=1)),
        (box_filter_3(w, w, 5, variant="sat"), (x,),
         _only(fir_band=2, tails=2, completion_rot=2)),
        (blur.as_func(stencil2d=sobel), (x,),
         _only(rows_tails=1, rows_final=1, stencil2d=1)),
        (gauss.as_func(epilogue=lambda o, a: 2.0 * a - o), (x, x),
         _only(moments2d=1, final2d_epi=1)),
        (gauss.as_func(epilogue=lambda o, a: torch.clamp(2.0 * a - o, -1,
                                                         1)), (x, x),
         _only(moments2d=1, final2d=1)),
        (sl.as_func(stencil={"taps": [_stencil(5)["taps"],
                                      _stencil(9)["taps"]]}),
         (torch.stack([x, x]),), _only(tails_extra=2, completion_rot=2))]
    for mod, args, launches in cases:
        tl.reset_launches()
        y = mod(*args)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == launches
        y = torch.stack(y) if isinstance(y, tuple) else y
        yp = mod.forward_plain(*args)
        yp = torch.stack(yp) if isinstance(yp, tuple) else yp
        assert _rel(y, yp) <= 1e-3


# ---------------------------------------------------------------------------
# The rotation chain
# ---------------------------------------------------------------------------


def _int_stack(kind, rows, cols, n, rng, lo=-2, hi=2):
    """An integer-valued per-tile stack (every product and sum exact)."""
    M = [rng.integers(lo, hi, (rows, cols), endpoint=True).astype(float)
         for _ in range(3)]
    if kind == "uniform" or n == 1:  # one tile: first and last at once
        return M[1 if kind == "clamp" else 0][None]
    return np.stack([M[1]] + [M[0]] * (n - 2) + [M[2]])


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("ra,n2", [(1, 3), (1, 1), (5, 2), (2, 3)],
                         ids=["image", "image-n2=1", "volume", "volume-3"])
def test_completion_rot_tails_matches_twin(kind, ra, n2, dev):
    """completion_rot_tails against its twin on integer-valued input,
    where every sum is exact: the rotated output and the next pass's tails
    bit-equal, pad slots zero; the output equal to completion_rot's."""
    rng = np.random.default_rng(ra * 10 + n2)
    n, S, S2 = 3, 6, 5
    q = ra * n2 * T
    Btot, Rcat = _int_stack(kind, T, T, n, rng), _int_stack(kind, T, S, n,
                                                            rng)
    G2 = _int_stack(kind, S2, T, n2, rng)
    comp = tc.CompletionPass(Btot, Rcat, n, rot=True,
                             next_tails=(G2, n2)).to(dev)
    x = torch.from_numpy(rng.integers(-8, 8, (q, n, T)).astype(np.float32)
                         ).to(dev)
    N = torch.zeros((n, 8, q), device=dev)
    N[:, :S] = torch.from_numpy(rng.integers(-8, 8, (n, S, q)).astype(
        np.float32)).to(dev)
    tl.reset_launches()
    y, t2 = comp(x, N)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(completion_rot_tails=1)
    yp, tp = comp.plain(x, N)
    assert t2.shape == (n2, 8, n * T * ra)
    assert torch.equal(y, yp) and torch.equal(t2, tp)
    assert not t2[:, S2:].any()
    flat = tc.CompletionPass(Btot, Rcat, n, rot=True).to(dev)
    assert torch.equal(flat(x, N), y)


def _chain_spec(shape, scans, border="zero", tiles=None):
    names = "vwzyx"[-len(shape):]
    return rft.FilterSpec("C", tuple(rft.Dim(n_, e) for n_, e in
                                     zip(names, shape)),
                          tuple(Scan(*s) for s in scans), border=border,
                          tile_widths=tiles or (T,) * len(shape))


CHAINS = {
    # (shape, scans, border, launches, tails_in per pass); every case
    # through fused_filter_module but "rgb", whose leading group the
    # router sends to the 3-touch executor
    "image-clamp-pad": (  # y in 100-row tiles: the einsum form
        (200, 384), [(1, True, 0.9, (0.6, 0.2)), (0, False, 1.05, (0.4,))],
        "clamp", dict(tails=1, completion_rot=1), [False, False]),
    "panorama": (  # x: 257 tiles, einsum tails, then the kernel extracts
        (256, 257 * T), [(1, True, 0.9, (0.6, 0.2)),
                         (0, False, 1.05, (0.4,))],
        "zero", dict(completion_rot_tails=1, completion_rot=1),
        [False, True]),
    "rgb": ((3, 256, 384), [(2, True, 0.9, (0.6, 0.2)),
                            (1, False, 1.05, (0.4,))], "clamp",
            dict(tails=3, completion_rot_tails=3, completion_rot=3),
            [False, True]),
    "volume": ((100, 128, 256), [(2, True, 1.0, (0.5,)),
                                 (1, True, 0.9, (0.4, 0.1)),
                                 (0, False, 1.05, (0.3,))], "zero",
               dict(tails=1, completion_rot_tails=1, completion_rot=1),
               [False, True, False]),
    "k>8": ((256, 256), [(1, c, 0.5, (0.4, 0.1, 0.05)) for c in
                         (True, False, True)]
            + [(0, True, 0.5, (0.4,))], "zero",
            dict(tails=2, completion_rot=2), [False, False]),
}


@pytest.mark.parametrize("case", list(CHAINS))
def test_rotation_chain_on_the_card(case, dev):
    """The chain on the card: its launch counts and tails reads per
    route, within 2e-6 of the f64 oracle, and chained equal to unchained
    bit for bit (the extracted tails are summed as the tails kernel sums
    them)."""
    shape, scans, border, launches, taken = CHAINS[case]
    spec = _chain_spec(shape, scans, border)
    if case == "rgb":
        groups = {ax: [spec.scans[i] for i in ids]
                  for ax, ids in spec.scans_by_axis().items()}
        mod = tdf.RotationChain(groups, shape, spec.tile_widths, border)
    else:
        mod = tdf.fused_filter_module(spec)
    mod = mod.to(dev)
    assert isinstance(mod, tdf.RotationChain)
    img = (np.random.default_rng(4).standard_normal(shape) * 0.1
           ).astype(np.float32)
    x = torch.from_numpy(img).to(dev)
    tl.reset_launches()
    y = mod(x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(**launches)
    assert mod.tails_in_taken == taken
    want = rft.oracle_apply(spec, img.astype(np.float64))
    assert np.abs(y.cpu().numpy() - want).max() <= 2e-6 * np.abs(want).max()
    assert _rel(y, mod.forward_plain(x)) <= 1e-5  # the twins' path
    for p in mod.passes:
        p.completion_nt = None
    assert torch.equal(mod(x), y)


def test_chain_routes_on_the_card(dev):
    """One launch-count check per route of the slice: the einsum pass on
    a non-last axis (rotated kernel route), the chain at ``highest`` (no
    launch), the volume fallback (rows pass, then the chain on the pair),
    and the B-spline prefilter at 1920 × 1080 (x on the kernels, y's
    120-row tiles on the einsum form)."""
    from recfilter_tpu_torch.apps import bicubic

    rng = np.random.default_rng(6)
    y_only = _chain_spec((200, 256), [(0, True, 0.9, (0.5,))])
    pair = _chain_spec((128, 40, 16), [(2, True, 1.0, (0.5,)),
                                       (1, True, 1.0, (0.4,)),
                                       (0, True, 1.0, (0.3,))],
                       tiles=(128, 32, 128))
    gauss = _chain_spec((256, 256), [(a, c, 0.5, (0.4, 0.1)) for a in (1, 0)
                                     for c in (True, False)])
    cases = [(tdf.fused_filter_module(y_only), y_only,
              _only(tails=1, completion_rot=1)),
             (tdf.fused_filter_module(gauss, "highest"), gauss, _only()),
             (tdf.fused_filter_module(pair), pair,
              _only(rows_tails=1, rows_final=1)),
             (bicubic(1920, 1080).as_func(device=dev),
              bicubic(1920, 1080).spec, _only(tails=1, completion_rot=1))]
    for mod, spec, launches in cases:
        mod = mod.to(dev)
        img = rng.standard_normal([d.extent for d in spec.dims]).astype(
            np.float32)
        tl.reset_launches()
        y = mod(torch.from_numpy(img).to(dev))
        torch.cuda.synchronize()
        assert tl.LAUNCHES == launches
        want = rft.oracle_apply(spec, img.astype(np.float64))
        assert (np.abs(y.cpu().numpy() - want).max()
                <= 2e-6 * np.abs(want).max())


def _traced_inputs(q, n, S, dev, seed):
    """x, G, Btot, Rcat and slot-padded carries N (pad rows NaN: the kernel
    must not read them) for the traced kernels, on ``dev``."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    N = torch.full((n, 8, q), float("nan"), device=dev)
    N[:, :S] = f(n, S, q)
    return f(q, n, T), f(S, T), 0.1 * f(T, T), f(T, S), N


@pytest.mark.parametrize("S", [1, 2, 6, 8])
@pytest.mark.parametrize("q,n", [(8, 512), (300, 3), (4096, 32)])
def test_traced_kernels_match_twins(S, q, n, dev):
    """tails_traced and completion_traced against their twins: within 1e-5
    of the twin's peak, the tails' pad slots written as zeros, N's pad rows
    never read (NaN there), one launch each."""
    x, G, Btot, Rcat, N = _traced_inputs(q, n, S, dev, S + q)
    tl.reset_launches()
    b = tc.tails_traced(x, G)
    y = tc.completion_traced(x, Btot, Rcat, N)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(tails_traced=1, completion_traced=1)
    assert b.shape == (n, 8, q) and not b[:, S:].any()
    assert _rel(b, tc.tails_traced_plain(x, G)) <= 1e-5
    assert bool(torch.isfinite(y).all())
    assert _rel(y, tc.completion_traced_plain(x, Btot, Rcat, N)) <= 1e-5


def test_traced_kernel_gradients_match_the_twins(dev):
    """Gradients through the Functions with the kernels forward equal those
    with the twins forward (the backward is the same einsums): every
    input, the matrices included."""
    S, q, n = 6, 64, 4
    x, G, Btot, Rcat, N = _traced_inputs(q, n, S, dev, 3)
    N = torch.nan_to_num(N)
    ct_b = torch.randn(n, 8, q, device=dev)
    ct_y = torch.randn(q, n, T, device=dev)
    grads = []
    for plain in (False, True):
        ins = [t.clone().requires_grad_() for t in (x, G, Btot, Rcat, N)]
        loss = ((tc.tails_traced(ins[0], ins[1], plain) * ct_b).sum()
                + (tc.completion_traced(ins[0], *ins[2:], plain) * ct_y).sum())
        grads.append(torch.autograd.grad(loss, ins))
    for gk, gp in zip(*grads):
        assert torch.allclose(gk, gp, rtol=1e-4, atol=1e-4)


def test_traced_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, G, Btot, Rcat, N = _traced_inputs(16, 2, 6, dev, 5)
    with pytest.raises(ValueError):
        tc.tails_traced(x, torch.zeros(9, T, device=dev))
    with pytest.raises(TypeError):
        tc.tails_traced(x, G.double())
    with pytest.raises(ValueError):
        tc.completion_traced(x, Btot.t(), Rcat, N)
    with pytest.raises(ValueError):
        tc.completion_traced(x, Btot, Rcat, N[:, :6].contiguous())
    with pytest.raises(ValueError):
        tc.completion_traced(x, Btot, Rcat.cpu(), N)


def test_learnable_gaussian_on_the_card(dev):
    """The σ=5 Gaussian as a LearnableRecFilter at 512² (x and y on the
    traced kernels): within 2e-6 of the f64 oracle, two launches of each
    traced kernel per forward, and coefficient gradients within
    rtol = atol = 1e-4 of the plain path's (the twins on the card)."""
    from recfilter_tpu_torch.learnable import LearnableRecFilter

    h = w = 512
    img = (np.random.default_rng(0).standard_normal((h, w)) * 0.01
           ).astype(np.float32)
    x, y = rft.Dim("x", w), rft.Dim("y", h)
    F = rft.RecFilter("GaussianIIR")
    F[y, x] = img
    for d in (+x, -x, +y, -y):
        F.add_filter(d, rft.gaussian_weights(5.0, 3))
    m = LearnableRecFilter(F.spec, tile_width=128, device=dev)
    xt = torch.from_numpy(img).to(dev)
    tl.reset_launches()
    with torch.no_grad():
        out = m(xt)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(tails_traced=2, completion_traced=2)
    want = rft.oracle_apply(F.spec, img.astype(np.float64))
    assert (np.abs(out.cpu().numpy() - want).max()
            <= 2e-6 * np.abs(want).max())
    target = out * 1.1
    grads = []
    for fwd in (m.forward, m.forward_plain):
        m.zero_grad()
        ((fwd(xt) - target) ** 2).mean().backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for gk, gp in zip(*grads):
        assert torch.allclose(gk, gp, rtol=1e-4, atol=1e-4)


def test_learnable_biquad_on_the_card(dev):
    """One scan per axis (a biquad, 8 × 32,768: 256 tiles, the associative
    solve): its Btot is the scan's own B, which the kernel takes as it is
    built; within 2e-6 of scipy.signal.lfilter's peak, one launch each."""
    from scipy.signal import lfilter

    from recfilter_tpu_torch.learnable import LearnableRecFilter

    n = 32768
    spec = rft.FilterSpec("SysId", (rft.Dim("c", 8), rft.Dim("t", n)),
                          (Scan(1, True, 0.3, (0.9, -0.45)),))
    sig = np.random.default_rng(6).standard_normal((8, n)).astype(np.float32)
    m = LearnableRecFilter(spec, tile_width=128, device=dev)
    tl.reset_launches()
    with torch.no_grad():
        out = m(torch.from_numpy(sig).to(dev))
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(tails_traced=1, completion_traced=1)
    want = lfilter([0.3], [1.0, -0.9, 0.45], sig.astype(np.float64))
    assert (np.abs(out.cpu().numpy() - want).max()
            <= 2e-6 * np.abs(want).max())


# ------------------------------------------------- the affine epilogue


# (scale, aux weights, bias): k = 0..4, with and without a bias
AFFINES = [(0.5, (), 1.0), (-1.0, (2.0,), 0.0), (2.0, (-3.0, 0.5), 0.25),
           (1.0, (1.0, -1.0, 0.5), -2.0), (0.75, (1.0, 2.0, -1.0, 0.5), 0.0)]


def _affine(i):
    from recfilter_tpu_torch.epilogue import Affine

    a, b, c = AFFINES[i]
    return Affine(a, b, c)


def _aux(shape, k, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev) for _ in range(k)]


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("i", range(len(AFFINES)))
def test_final2d_epi_matches_twin(kind, i, dev):
    """final2d_epi, k = 0..4 aux arrays with and without a bias, against
    its twin (plain's Y, then the form as torch ops): 1e-5 of the twin's
    peak; and its Y part equal to final2d's within the same bound."""
    clamp, pad_a, pad_b = STACKS[kind]
    w3 = rft.gaussian_weights(5.0, 3)
    a = [Scan(0, True, w3[0], tuple(w3[1:])),
         Scan(0, False, w3[0], tuple(w3[1:]))]
    ma = tdf.prepare_dim_pass(a, T, NA, clamp)
    mb = tdf.prepare_dim_pass(a, T, NB, clamp)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    aff = _affine(i)
    fin = tk2d.Final2D(ma.Btot, cat(ma.Rhat, 2), mb.Btot, cat(mb.Rhat, 2),
                       NA, NB, affine=aff).to(dev)
    x, NA_t, NB_t = _inputs(dev, seed=i)
    aux = _aux(x.shape, aff.k, dev, 10 + i)
    tl.reset_launches()
    y = fin(x, NA_t, NB_t, *aux)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(final2d_epi=1)
    assert _rel(y, fin.plain(x, NA_t, NB_t, *aux)) <= 1e-5
    with pytest.raises(ValueError):
        fin(x, NA_t, NB_t, *aux, x)  # one aux too many


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("i", range(len(AFFINES)))
def test_completion_epi_matches_twin(kind, i, dev):
    """completion_epi and completion_rot_epi (with and without a fused
    stencil, the epilogue after it), k = 0..4, ragged line blocks: 1e-5
    of the twin's peak."""
    rng = np.random.default_rng(i)
    n, S, q = 4, 6, 300
    aff = _affine(i)
    Btot, Rcat = _stack(kind, T, T, n, rng, 0.1), _stack(kind, T, S, n, rng)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(np.float32)
                         ).to(dev)
    N = torch.from_numpy(rng.standard_normal((n, 8, q)).astype(np.float32)
                         ).to(dev)
    comp = tc.CompletionPass(Btot, Rcat, n, affine=aff).to(dev)
    aux = _aux((q, n, T), aff.k, dev, 20 + i)
    tl.reset_launches()
    y = comp(x, N, *aux)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(completion_epi=1)
    assert _rel(y, comp.plain(x, N, *aux)) <= 1e-5
    st = {"taps": [(1, 1.0), (0, -2.0), (-1, 1.0)], "start": "zero",
          "end": "clamp"}
    flat = tc.CompletionPass(Btot, Rcat, n, rot=True).to(dev)
    aux = _aux((n * T, q), aff.k, dev, 30 + i)
    for stencil in (None, st):
        rot = tc.CompletionPass(Btot, Rcat, n, rot=True, stencil=stencil,
                                affine=aff).to(dev)
        halos = _halos_flat(flat.plain(x, N), n, rot.hp, rot.hn)
        tl.reset_launches()
        y = rot(x, N, *halos, *aux)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(completion_rot_epi=1)
        assert _rel(y, rot.plain(x, N, *halos, *aux)) <= 1e-5


def test_ragged_aux_padding_on_the_2d_path(dev):
    """A 1000 × 1920 image (padded to 1024 × 1920) with an affine
    epilogue of two aux arrays, one of them a broadcast row: the aux
    arrays are padded, tiled and materialized for final2d_epi; against the
    plain path and the torch-op route of the same combine."""
    h, w = 1000, 1920
    rng = np.random.default_rng(4)
    img, a0 = (torch.from_numpy(rng.standard_normal((h, w)).astype(
        np.float32)).to(dev) for _ in range(2))
    a1 = torch.from_numpy(rng.standard_normal(w).astype(np.float32)).to(dev)
    w3 = rft.gaussian_weights(5.0, 3)
    xd, yd = rft.Dim("x", w), rft.Dim("y", h)
    F = rft.RecFilter("Ragged")
    F[yd, xd] = np.zeros((h, w), np.float32)
    for d in (+xd, -xd, +yd, -yd):
        F.add_filter(d, w3)
    F.split(xd, T, yd, T)
    mod = F.as_func(epilogue=lambda y, a, b: 0.5 * y + 2.0 * a - b + 1.0,
                    device=dev)
    assert mod.epilogue_route == "kernel"
    tl.reset_launches()
    got = mod(img, a0, a1)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(moments2d=1, final2d_epi=1)
    assert got.shape == (h, w)
    assert _rel(got, mod.forward_plain(img, a0, a1)) <= 1e-5
    blur = F.as_func(device=dev)(img)
    assert _rel(got, 0.5 * blur + 2.0 * a0 - a1 + 1.0) <= 1e-5


def test_epilogue_on_the_last_axis_and_the_chain(dev):
    """A dry/wet mix 0.7·y + 0.3·x on 16 channels × 4096 samples (one
    tiled pass: tails, then completion_epi) and the unsharp combine on the
    rotation chain's last pass at 256², ΣK = 12 (completion_rot_epi):
    launch counts, 2e-6 of the f64 oracle."""
    rng = np.random.default_rng(5)
    sig = (rng.standard_normal((16, 4096)) * 0.1).astype(np.float32)
    c, xd = rft.Dim("c", 16), rft.Dim("x", 4096)
    A = rft.RecFilter("Mix")
    A[c, xd] = sig
    A.add_filter(+xd, [1.0, 0.01, 0.01])
    A.split(xd, T)
    mod = A.as_func(epilogue=lambda y, x: 0.7 * y + 0.3 * x, device=dev)
    x = torch.from_numpy(sig).to(dev)
    tl.reset_launches()
    got = mod(x, x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(tails=1, completion_epi=1)
    want = 0.7 * rft.oracle_apply(A.spec, sig.astype(np.float64)) + 0.3 * sig
    assert np.abs(got.cpu().numpy() - want).max() <= 2e-6 * np.abs(
        want).max()
    img = (rng.standard_normal((256, 256)) * 0.01).astype(np.float32)
    wts = rft.gaussian_weights(5.0, 3)
    xd, yd = rft.Dim("x", 256), rft.Dim("y", 256)
    K = rft.RecFilter("K1")
    K[yd, xd] = img
    for d in (xd, yd):
        for _ in range(2):
            K.add_filter(+d, wts)
            K.add_filter(-d, wts)
    K.split(xd, T, yd, T)
    mod = K.as_func(epilogue=lambda b, i: 2.0 * i - b, device=dev)
    assert type(mod).__name__ == "RotationChain"
    x = torch.from_numpy(img).to(dev)
    tl.reset_launches()
    got = mod(x, x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(tails=2, completion_rot=1,
                                completion_rot_epi=1)
    assert mod.passes[-1].epilogue_route == "kernel"
    want = 2.0 * img - rft.oracle_apply(K.spec, img.astype(np.float64))
    assert np.abs(got.cpu().numpy() - want).max() <= 2e-6 * np.abs(
        want).max()


def test_unsharp_mask_gradient_on_the_card(dev):
    """U1's input gradient at 512²: through the merged route (moments2d,
    final2d_epi: the image reaches the output through the filter and the
    combine's aux) against the naive route's, rtol = atol = 1e-4."""
    from recfilter_tpu_torch.apps import unsharp_mask

    img = np.random.default_rng(6).random((512, 512)).astype(np.float32)
    grads = []
    for fused in (True, False):
        mod = unsharp_mask(512, 512, fused=fused, device=dev)
        x = torch.from_numpy(img).to(dev).requires_grad_()
        tl.reset_launches()
        y = mod(x)
        if fused:
            assert tl.LAUNCHES == _only(moments2d=1, final2d_epi=1)
        (g,) = torch.autograd.grad((y ** 2).sum(), x)
        grads.append(g)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the pallas backend's strip kernels and the overlap_k backend's HIGHEST pair
# ---------------------------------------------------------------------------

def _strip_mats(T, clamp):
    """Causal order 3 (the σ=5 Gaussian), anticausal order 2, causal
    order 1: the strip kernels' ScanMats at tile T."""
    from recfilter_tpu_torch.kernels import fused as tkf

    w3 = rft.gaussian_weights(5.0, 3)
    scans = [(True, w3[0], tuple(w3[1:])), (False, 1.1, (0.5, 0.2)),
             (True, 0.9, (0.4,))]
    return [tkf.prepare_scan_mats(b0, fb, c, T, 3, clamp)
            for c, b0, fb in scans]


@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("pad", [0, 37])
@pytest.mark.parametrize("line_block", [0, 16, 32, 64])
def test_dim_pass_rows_matches_twin(clamp, pad, line_block, dev):
    """dim_pass_rows (causal order 3, anticausal 2, causal 1) against its
    twin: 1e-5 of the twin's peak, one launch."""
    from recfilter_tpu_torch.kernels import fused as tkf

    L, n = 200, 4
    mats = _strip_mats(128, clamp)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (L, n * 128)).astype(np.float32))
    w_real = n * 128 - pad
    x[:, w_real:] = 0.0
    mod = tkf.DimPassRows(mats, 128, n, w_real, line_block).to(dev)
    xd = x.to(dev)
    tl.reset_launches()
    got = mod(xd)
    torch.cuda.synchronize()
    assert tl.LAUNCHES["dim_pass_rows"] == 1
    want = mod.plain(xd)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("T", [8, 32, 40, 128])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("line_block", [0, 16, 64])
def test_dim_pass_cols_matches_twin(T, clamp, line_block, dev):
    """dim_pass_cols at several tiles, 3 outer slices and 150 lines (a
    ragged last line block), with a padded tail: 1e-5 of the twin's
    peak, one launch."""
    from recfilter_tpu_torch.kernels import fused as tkf

    outer, n, L = 3, 5, 150
    mats = _strip_mats(T, clamp)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (outer, n * T, L)).astype(np.float32))
    w_real = n * T - (0 if clamp else 3)
    x[:, w_real:] = 0.0
    mod = tkf.DimPassCols(mats, T, n, w_real, line_block).to(dev)
    xd = x.to(dev)
    tl.reset_launches()
    got = mod(xd)
    torch.cuda.synchronize()
    assert tl.LAUNCHES["dim_pass_cols"] == 1
    assert _rel(got, mod.plain(xd)) <= 1e-5


@pytest.mark.parametrize("Ta", [32, 128])
@pytest.mark.parametrize("K", [6, 12])
@pytest.mark.parametrize("kind", ["uniform", "clamp"])
def test_highest_pair_matches_twins(Ta, K, kind, dev):
    """moments2d_k and final2d_k against their twins at Ta ∈ {32, 128} and
    K ∈ {6, 12} carries per axis: 1e-5 of the twin's peak, one launch
    each."""
    w3 = rft.gaussian_weights(5.0, 3)
    reps = K // 6
    a = [Scan(0, c, w3[0], tuple(w3[1:])) for _ in range(reps)
         for c in (True, False)]
    b = [Scan(1, c, 0.9, (0.6, 0.25, -0.1)) for _ in range(reps)
         for c in (True, False)]
    p, na, nb = 2, 3, 4
    clamp = kind == "clamp"
    ma = tdf.prepare_dim_pass(a, Ta, na, clamp)
    mb = tdf.prepare_dim_pass(b, 128, nb, clamp)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    mom = tk2d.Moments2DK(cat(ma.G, 1), cat(mb.G, 1), na, nb).to(dev)
    fin = tk2d.Final2DK(ma.Btot, cat(ma.Rhat, 2), mb.Btot, cat(mb.Rhat, 2),
                        na, nb).to(dev)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(
        (p, na, Ta, nb * 128)).astype(np.float32)).to(dev)
    NA_ = torch.from_numpy(rng.standard_normal(
        (p, na, K, nb * 128)).astype(np.float32)).to(dev)
    NB_ = torch.from_numpy(rng.standard_normal(
        (p, na, nb, Ta, K)).astype(np.float32)).to(dev)
    tl.reset_launches()
    outs = mom(x)
    y = fin(x, NA_, NB_)
    torch.cuda.synchronize()
    assert tl.LAUNCHES["moments2d_k"] == 1 and tl.LAUNCHES["final2d_k"] == 1
    for got, want in zip(outs, mom.plain(x)):
        assert _rel(got, want) <= 1e-5
    assert _rel(y, fin.plain(x, NA_, NB_)) <= 1e-5


def _headline(h, w, clamp=False, times=1):
    w3 = rft.gaussian_weights(5.0, 3)
    x, y = rft.Dim("x", w), rft.Dim("y", h)
    F = rft.RecFilter("G")
    if clamp:
        F.set_clamped_image_border()
    img = (np.random.default_rng(0).standard_normal((h, w)) * 0.01
           ).astype(np.float32)
    F[y, x] = img
    for d in (+x, -x, +y, -y):
        for _ in range(times):
            F.add_filter(d, w3)
    F.split(x, 128, y, 128)
    return F, img


BACKEND_CASES = {
    # label: (h, w, clamp, times, plan, launches)
    "pallas": (512, 512, False, 1, dict(backend="pallas"),
               dict(dim_pass_rows=1, dim_pass_cols=1)),
    "pallas-clamp-pad": (200, 300, True, 1, dict(backend="pallas"), {}),
    "pallas-line-block": (512, 384, False, 1,
                          dict(backend="pallas", line_block=32),
                          dict(dim_pass_rows=1, dim_pass_cols=1)),
    "overlap_k-highest": (512, 512, False, 1,
                          dict(backend="overlap_k",
                               matmul_precision="highest"),
                          dict(moments2d_k=1, final2d_k=1)),
    "overlap_k-K12": (512, 512, False, 2, dict(backend="overlap_k"),
                      dict(moments2d_k=1, final2d_k=1)),
    "overlap_k-px6": (512, 512, False, 1, dict(backend="overlap_k"),
                      dict(moments2d=1, final2d=1)),
    "overlap": (256, 384, False, 1, dict(backend="overlap"), {}),
    "blocked": (256, 256, False, 1, dict(backend="blocked"), {}),
    "scan": (64, 96, True, 1, dict(backend="scan"), {}),
}


@pytest.mark.parametrize("case", list(BACKEND_CASES))
def test_backends_on_the_card(case, dev):
    """Each backend through RecFilter.as_func() on the card: the launches
    its route makes, and within the px6 bound 2e-6 of the f64 oracle."""
    h, w, clamp, times, plan, launches = BACKEND_CASES[case]
    F, img = _headline(h, w, clamp, times)
    F.set_plan(**plan)
    mod = F.as_func()
    tl.reset_launches()
    with torch.no_grad():
        got = mod(torch.from_numpy(img).to(dev))
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(**launches)
    want = rft.oracle_apply(F.spec, img.astype(np.float64))
    err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-6


def test_pallas_integer_sat_on_the_card(dev):
    """An int32 SAT under pallas runs the sequential core: bit-equal to
    numpy's cumsum, no launch."""
    x, y = rft.Dim("x", 96), rft.Dim("y", 80)
    F = rft.RecFilter("SAT")
    img = np.random.default_rng(4).integers(-1000, 1000, (80, 96)).astype(
        np.int32)
    F[y, x] = img
    F.add_filter(+x, [1, 1])
    F.add_filter(+y, [1, 1])
    F.split(x, 32, y, 32)
    F.set_plan(backend="pallas")
    tl.reset_launches()
    got = F.realize().cpu().numpy()
    assert not any(tl.LAUNCHES.values())
    np.testing.assert_array_equal(got, img.cumsum(1).cumsum(0))


def test_strip_and_pair_wrappers_refuse(dev):
    """The wrappers raise on what their kernels do not take."""
    from recfilter_tpu_torch.kernels import fused as tkf

    mats = _strip_mats(64, False)
    with pytest.raises(ValueError, match="128-wide"):
        tkf.DimPassRows(mats, 64, 2, 0).to(dev)(torch.zeros(
            8, 128, device=dev))
    rows = tkf.DimPassRows(_strip_mats(128, False), 128, 2, 0).to(dev)
    with pytest.raises(ValueError):
        rows(torch.zeros(8, 200, device=dev))
    with pytest.raises(TypeError):
        rows(torch.zeros(8, 256, device=dev, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="Queue 2"):
        tk2d.Moments2DK(np.zeros((1, 33, 32)), np.zeros((1, 6, 128)), 1, 1)


# ------------------- the 2-D carry routes (bsolve, moments2d_naf), copy


def _carry_mats(kind, na, nb):
    """Gb_cat, Ra_cat and both padded solve matrices of ``_modules``'
    scans for na × nb tiles."""
    from recfilter_tpu_torch.kernels.completion import pad_solve_matrix

    clamp, pad_a, pad_b = STACKS[kind]
    w3 = rft.gaussian_weights(5.0, 3)
    a = [Scan(0, True, w3[0], tuple(w3[1:])),
         Scan(0, False, w3[0], tuple(w3[1:]))]
    b = [Scan(1, True, 0.9, (0.6, 0.25, -0.1)),
         Scan(1, False, 1.1, (0.5, 0.2))]
    ma = tdf.prepare_dim_pass(a, T, na, clamp, pad_slots=pad_a)
    mb = tdf.prepare_dim_pass(b, T, nb, clamp, pad_slots=pad_b)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    CM = [pad_solve_matrix(tdf.combined_solve_matrix(m, n), n,
                           int(sum(m.orders)))
          for m, n in ((ma, na), (mb, nb))]
    return ma, mb, cat(ma.G, 1), cat(mb.G, 1), cat(ma.Rhat, 2), CM


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("p,na,nb", [(P, NA, NB), (1, 20, 2), (1, 3, 33)])
def test_bsolve_matches_twin(kind, p, na, nb, dev):
    """bsolve against its twin: 1e-5 of the twin's peak, pad slots zero,
    one launch; term1's junk rows (random here) never enter."""
    _, _, _, Gb_cat, Ra_cat, (_, CMb) = _carry_mats(kind, na, nb)
    bs = tk2d.BSolve(Gb_cat, Ra_cat, CMb, na, nb).to(dev)
    rng = np.random.default_rng(na + nb)
    NA_t, term1 = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev) for s in ((p, na, 8, nb * T),
                                       (p, na, nb * 8, T)))
    tl.reset_launches()
    got = bs(NA_t, term1)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(bsolve=1)
    assert _rel(got, bs.plain(NA_t, term1)) <= 1e-5
    assert not got.reshape(p, na, nb, 8, T)[:, :, :, 5:].any()  # Kb = 5


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("p,na,nb", [(P, NA, NB), (1, 20, 2), (2, 9, 1),
                                     (1, 40, 1)])
def test_moments2d_naf_matches_twin(kind, p, na, nb, dev):
    """moments2d_naf (clusters of min(16, na) blocks: one tile a block at
    na = 3 and 9, uneven tile shares at na = 20 and 40) against its twin:
    1e-5 of the twin's peak, the same term1 as moments2d, pad slots
    zero."""
    ma, _, Ga_cat, Gb_cat, _, (CMa, _) = _carry_mats(kind, na, nb)
    raw = tk2d.Moments2D(Ga_cat, Gb_cat, ma.Btot, na, nb).to(dev)
    naf = tk2d.Moments2D(Ga_cat, Gb_cat, ma.Btot, na, nb, solve=CMa).to(dev)
    x = torch.from_numpy(np.random.default_rng(na).standard_normal(
        (p, na, T, nb * T)).astype(np.float32)).to(dev)
    tl.reset_launches()
    NA_t, term1 = naf(x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(moments2d_naf=1)
    want = naf.plain(x)
    assert _rel(NA_t, want[0]) <= 1e-5 and _rel(term1, want[1]) <= 1e-5
    assert torch.equal(term1, raw(x)[1])
    assert not NA_t[:, :, 6:].any()  # Ka = 6


@pytest.mark.parametrize("n", [0, 1, 7, 4096 * 4096, 3 * 5 * 129])
def test_copy_matches_twin(n, dev):
    """copy bit-equal to its twin (one fp32 multiply), ragged tails too."""
    from recfilter_tpu_torch.kernels import copy as tcopy

    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n).astype(
        np.float32)).to(dev)
    tl.reset_launches()
    y = tcopy.copy(x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(copy=1)
    assert torch.equal(y, tcopy.plain(x))


def test_carry_route_wrappers_refuse(dev):
    """bsolve, moments2d_naf and copy refuse what their kernels do not
    take."""
    from recfilter_tpu_torch.kernels import copy as tcopy

    ma, _, Ga_cat, Gb_cat, Ra_cat, (CMa, CMb) = _carry_mats("uniform", NA, NB)
    bs = tk2d.BSolve(Gb_cat, Ra_cat, CMb, NA, NB).to(dev)
    naf = tk2d.Moments2D(Ga_cat, Gb_cat, ma.Btot, NA, NB, solve=CMa).to(dev)
    x, NA_t, NB_t = _inputs(dev)
    with pytest.raises(TypeError):
        bs(NA_t.double(), NB_t)
    with pytest.raises(ValueError):
        bs(NA_t[:, :, :4], NB_t)
    with pytest.raises(ValueError):
        bs(NA_t, NB_t.cpu())
    with pytest.raises(TypeError):
        naf(x.double())
    with pytest.raises(ValueError):
        naf(x[:, :, :, :-T])
    with pytest.raises(TypeError):
        tcopy.copy(x.double())
    with pytest.raises(ValueError):
        tcopy.copy(x.transpose(2, 3))
    with pytest.raises(ValueError, match="exclusive"):
        tk2d.Moments2D(Ga_cat, Gb_cat, ma.Btot, NA, NB, edge=(ma.Btot, 8),
                       solve=CMa)


@pytest.mark.parametrize("bsolve,naf", [(False, False), (True, False),
                                        (False, True), (True, True)])
@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_carry_routes_on_the_card(bsolve, naf, border, dev):
    """The headline filter at 512² (and 384 × 640, zero: pad variants) on
    each route: its launches, within px6 (2e-6) of the f64 oracle."""
    from recfilter_tpu_torch.overlap2d import Fused2DPx

    w3 = rft.gaussian_weights(5.0, 3)
    for h, w in ((512, 512),) + (((384, 600),) if border == "zero" else ()):
        sc = lambda ax: [Scan(ax, True, w3[0], tuple(w3[1:])),
                         Scan(ax, False, w3[0], tuple(w3[1:]))]
        mod = Fused2DPx(sc(0), sc(1), h, w, border, bsolve=bsolve,
                        naf=naf).to(dev)
        img = (np.random.default_rng(0).standard_normal((h, w)) * 0.01
               ).astype(np.float32)
        tl.reset_launches()
        got = mod(torch.from_numpy(img).to(dev))
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(
            final2d=1, bsolve=int(bsolve),
            **{"moments2d_naf" if naf else "moments2d": 1})
        spec = rft.FilterSpec("G", (rft.Dim("y", h), rft.Dim("x", w)),
                              tuple(sc(0) + sc(1)), border=border)
        want = rft.oracle_apply(spec, img.astype(np.float64))
        err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
        assert err <= 2e-6
