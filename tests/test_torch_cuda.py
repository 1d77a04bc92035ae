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
from recfilter_tpu_torch.kernels import split_mm as smm
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


def _within(got, want, bound):
    """Every output within its own bound (a tensor of got's shape)."""
    return bool(((got.double() - want.double()).abs() <= bound).all())


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("S,q", [(2, 300), (6, 64), (29, 77), (56, 8),
                                 (8, 306), (13, 50), (29, 306), (56, 50)])
def test_1d_kernels_match_twins(kind, S, q, dev):
    """tails and completion against their twins, one to seven carry
    slots (one to four k16 steps of the tensor-core completion), ragged
    line blocks (A's 306 lines: four 64-line items and a 50-line tail; one
    50-line item), one and three matrix variants: max|kernel − twin| ≤
    1e-5·max|twin|; the completion (six split-bf16 products on the tensor
    cores) also within ``split_exact``'s bound of its products' exact
    sum at every output."""
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
    assert _within(y, *comp.split_exact(x, b))


@pytest.mark.parametrize("drop", [(0, 2), (1, 1), (2, 0)])
@pytest.mark.parametrize("case", ["gaussian traced", "audio A"])
def test_summation_bound_sees_a_missing_product(case, drop, dev):
    """On a real filter's matrices and solved carries (the σ=5 Gaussian,
    64 lines of 8 tiles, through ``completion_traced``; A's kernel pass at
    300,000 samples through ``completion``): the kernel within the bound
    of its six products' exact sum at every output, the sum with one
    level-2 product left out outside it at some output (a control: the
    check sees a product missing)."""
    if case == "audio A":
        F = audio_filter_high_order(300_000, 2, 1000)
        body = F.as_func(device=dev).body
        loc = body.locals[0]
        x = np.random.default_rng(6).standard_normal(F._image.shape) * 0.1
        X = torch.nn.functional.pad(torch.from_numpy(x.astype(
            np.float32)).to(dev), (0, body.pad)).reshape(-1, loc.n, T)
    else:
        w = rft.gaussian_weights(5.0, 3)
        scans = [Scan(1, True, w[0], tuple(w[1:])),
                 Scan(1, False, w[0], tuple(w[1:]))]
        loc = tdf.LastAxisPass(scans, (T, 8, 0), False, "px6").to(dev)
        X = torch.from_numpy((np.random.default_rng(3).standard_normal(
            (64, 8, T)) * 0.01).astype(np.float32)).to(dev)
    Nt = loc._solve_t(loc.tails.plain(X).double()).float()
    if case == "audio A":
        y = loc.completion(X, Nt)
        exact = lambda d=None: loc.completion.split_exact(X, Nt, d)
    else:
        Bt, Rt = loc.B_v[0].float(), loc.R_v[0].float()
        N8 = torch.full((loc.n, 8, X.shape[0]), float("nan"), device=dev)
        N8[:, :loc.S] = Nt[:, :loc.S]
        y = tc.completion_traced(X, Bt, Rt, N8)
        exact = lambda d=None: tc.completion_traced_exact(X, Bt, Rt, N8, d)
    ref, bound = exact()
    assert _within(y, ref, bound)
    assert not _within(y, exact(drop)[0], bound)


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("S,q", [(6, 306), (29, 77)])
def test_completion_kernels_bit_equal_on_integers(kind, S, q, dev):
    """On integer-valued input small integers are exact in chunk 0 and
    every chunk product and partial sum is exact: completion,
    completion_epi (integer coefficients) and completion_traced equal both
    twins, the fp32 product and the split one, bit for bit (matrices
    from ``_int_stack`` in [-2, 2])."""
    from recfilter_tpu_torch.epilogue import Affine

    rng = np.random.default_rng(S + q)
    n = 4
    ints = lambda *s: torch.from_numpy(rng.integers(-8, 8, s).astype(
        np.float32)).to(dev)
    Bs, Rs = _int_stack(kind, T, T, n, rng), _int_stack(kind, T, S, n, rng)
    x = ints(q, n, T)
    comp = tc.CompletionPass(Bs, Rs, n).to(dev)
    N = torch.zeros((n, comp.sl, q), device=dev)
    N[:, :S] = ints(n, S, q)
    y = comp(x, N)
    assert torch.equal(y, comp.plain(x, N))
    assert torch.equal(y, comp.split_plain(x, N))
    epi = tc.CompletionPass(Bs, Rs, n, affine=Affine(2.0, (1.0, -3.0),
                                                      5.0)).to(dev)
    aux = (ints(q, n, T), ints(q, n, T))
    tl.reset_launches()
    ye = epi(x, N, *aux)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(completion_epi=1)
    assert torch.equal(ye, epi.plain(x, N, *aux))
    assert torch.equal(ye, epi.split_plain(x, N, *aux))
    if kind == "uniform" and S <= 8:
        Bt = torch.from_numpy(Bs[0].astype(np.float32)).to(dev)
        Rt = torch.from_numpy(Rs[0].astype(np.float32)).to(dev)
        N8 = torch.full((n, 8, q), float("nan"), device=dev)
        N8[:, :S] = N[:, :S]
        yt = tc.completion_traced(x, Bt, Rt, N8)
        assert torch.equal(yt, tc.completion_traced_plain(x, Bt, Rt, N8))
        assert torch.equal(yt, tc.completion_traced_split(x, Bt, Rt, N8))


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
    with pytest.raises(ValueError):  # no lines: no work item to walk
        tails(torch.zeros((0, n, T), device=dev))
    # a stencil whose taps overflow the rotated emit's shared memory (the
    # twin takes it on the CPU; on the card the launcher refuses and the
    # wrapper raises, no fallback)
    Bs, Rs = _stack("clamp", T, T, n, rng), _stack("clamp", T, S, n, rng)
    wide = tc.CompletionPass(Bs, Rs, n, rot=True, stencil={
        "taps": [(1, 1.0), (-1, 1.0)] * 8000})
    xc = torch.zeros((q, n, T))
    Nc = torch.zeros((n, 8, q))
    hc = [torch.zeros((n, 1, q)), torch.zeros((n, 1, q))]
    assert wide(xc, Nc, *hc).shape == (n * T, q)
    wide = wide.to(dev)
    tl.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        wide(x, N, *(h.to(dev) for h in hc))
    assert not any(tl.LAUNCHES.values())


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


@pytest.mark.parametrize("nprod", [6, 4, 3, 1])
@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("p,n,nl", [(2, 3, 2), (1, 2, 5), (3, 2, 1),
                                    (2, 5, 1), (1, 2, 512)])
def test_rows_kernels_match_twins(kind, p, n, nl, nprod, dev):
    """rows_tails and rows_final against their twins:
    max|kernel − twin| ≤ 1e-5·max|twin|, pad slots written as zeros;
    rows_final (the grade's split-bf16 products on the tensor cores: six
    at px6; 4, 3, 1 on x and at least three on the carries at px4, px3,
    default) also within ``split_exact``'s bound of its products' exact
    sum at every output. (1, 2, 512) is V1's rows pass (256³); (3, 2, 1)
    and (2, 5, 1) walk fewer 64-lane items (12, 20) than the card has
    SMs, clamp with three matrix variants."""
    rng = np.random.default_rng(p * 100 + n * 10 + nl)
    K = 6
    tails = tk2d.RowsTails(_stack(kind, K, T, n, rng), n).to(dev)
    fin = tk2d.RowsFinal(_stack(kind, T, T, n, rng, 0.1),
                         _stack(kind, T, K, n, rng), n, nprod).to(dev)
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
    assert _within(y, *fin.split_exact(x, b))


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
@pytest.mark.parametrize("n,q", [(4, 200), (3, 5001), (40, 1030)],
                         ids=["8-items", "120-items", "360-items"])
def test_completion_rot_matches_twin(kind, taps, start, end, n, q, dev):
    """The rotated completion, with and without a fused stencil, both
    border modes: max|kernel − twin| ≤ 1e-5·max|twin| (the twin reads the
    whole output, the kernel the halo strips); tails with extra rows
    against their twin. Work items (tiles × 128-line blocks) below and
    well above the persistent grid's 132 blocks; ragged q (5001: rows not
    16-byte aligned)."""
    rng = np.random.default_rng(3)
    S = 3
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


@pytest.mark.parametrize("shape", [(102400, 4, 4), (512, 320, 4)],
                         ids=["K3", "K6"])
def test_completion_rot_is_bit_equal_to_completion_rot_tails(shape, dev):
    """completion_rot and completion_rot_tails run one product
    (completion_rot.cuh: the same split-bf16 wgmma steps on the same
    staged samples), so on real-valued N(0,1) input their outputs are
    equal bit for bit, at K3's and K6's first-pass shapes (px6)."""
    q, n, n2 = shape
    rng = np.random.default_rng(q + n)
    Btot = _stack("clamp", T, T, n, rng, 0.1)
    Rcat = _stack("clamp", T, 6, n, rng)
    G2 = rng.standard_normal((1, 5, T))
    chained = tc.CompletionPass(Btot, Rcat, n, rot=True,
                                next_tails=(G2, n2)).to(dev)
    flat = tc.CompletionPass(Btot, Rcat, n, rot=True).to(dev)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(np.float32)
                         ).to(dev)
    N = torch.zeros((n, 8, q), device=dev)
    N[:, :6] = torch.from_numpy(rng.standard_normal((n, 6, q)).astype(
        np.float32)).to(dev)
    tl.reset_launches()
    y = flat(x, N)
    yc, _ = chained(x, N)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(completion_rot=1, completion_rot_tails=1)
    assert torch.equal(y, yc)


def _tails_stack(rows, n, rng):
    """A clamp-style per-tile stack of tail rows: first and last tiles
    differ from the interior (one matrix for one tile)."""
    M = [rng.standard_normal((rows, T)) for _ in range(3)]
    if n == 1:
        return M[1][None]
    return np.stack([M[1]] + [M[0]] * (n - 2) + [M[2]])


@pytest.mark.parametrize("entry", ["tails", "tails_traced"])
@pytest.mark.parametrize("q", [77, 300, 4096])
@pytest.mark.parametrize("n", [1, 2, 32])
def test_tails_are_bit_equal_to_the_ordered_plain(entry, q, n, dev):
    """tails (per-tile variants, S = 6 and 29) and tails_traced (one
    runtime matrix, S = 6) bit-equal to ``tails_ordered_plain`` — fp64 fma
    over τ ascending from 0.0 — on N(0,1) input, ragged q, the first/last
    variants (n = 1, 2) and many tiles; pad slots zero."""
    rng = np.random.default_rng(q * 7 + n)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(np.float32)
                         ).to(dev)
    for S in ((6, 29) if entry == "tails" else (6,)):
        if entry == "tails":
            G = _tails_stack(S, n, rng).astype(np.float32)
            mod = tc.TailsPass(G, n).to(dev)
            per_tile = torch.from_numpy(tc._expand_stack(G, n)).to(dev)
            run = lambda: mod(x)
        else:
            G = torch.from_numpy(rng.standard_normal((S, T)).astype(
                np.float32)).to(dev)
            per_tile = G
            run = lambda: tc.tails_traced(x, G)
        tl.reset_launches()
        b = run()
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(**{entry: 1})
        assert b.shape == (n, tc.slots_for(S), q)
        assert torch.equal(b[:, :S], tc.tails_ordered_plain(x, per_tile))
        assert not b[:, S:].any()


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


@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("q,n", [(8, 512), (300, 3), (4096, 32)])
def test_traced_kernels_match_twins(S, q, n, dev):
    """tails_traced and completion_traced against their twins: within 1e-5
    of the twin's peak (the completion also within
    ``completion_traced_exact``'s bound of its products' exact sum at
    every output), the
    tails' pad slots written as zeros, N's pad rows never read (NaN
    there), one launch each."""
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
    assert _within(y, *tc.completion_traced_exact(x, Btot, Rcat, N))


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
    tl.reset_launches()
    with pytest.raises(ValueError):  # no lines: no work item to walk
        tc.tails_traced(torch.zeros((0, 2, T), device=dev), G)
    with pytest.raises(ValueError):
        tc.tails_traced(x, torch.zeros(0, T, device=dev))
    assert not any(tl.LAUNCHES.values())


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
    # the exact sum of the six products, then the form in float64: the
    # kernel's bound scaled by |a|, and the form's own roundings (2⁻²² of
    # the output and its terms)
    ref, bound = comp.split_exact(x, N)
    want = aff.apply(ref, [u.double() for u in aux])
    terms = (abs(aff.scale) * ref.abs() + abs(aff.bias)
             + sum(abs(b) * u.double().abs()
                   for b, u in zip(aff.aux_weights, aux)))
    assert _within(y, want, abs(aff.scale) * bound
                   + 2.0 ** -22 * (want.abs() + terms))
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
    # the raw kernel sums the same fp64 products in another order (four
    # partial sums a contraction), each rounded once to fp32 (the bits of
    # both outputs: test_moments2d_naf_keeps_its_bits)
    t1 = raw(x)[1].double()
    assert bool(((term1.double() - t1).abs() <= 2.0 ** -23 * t1.abs()
                 + 1e-12 * t1.abs().max()).all())
    assert not NA_t[:, :, 6:].any()  # Ka = 6


def _bits_equal(got, want):
    """Bit for bit, else how many outputs differ and by how much."""
    got = got.cpu()
    same = torch.equal(got, want)
    assert same, (f"{int((got != want).sum())} of {want.numel()} outputs "
                  f"differ, the most by {(got - want).abs().max():.3e}")


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("p,na,nb", [(P, NA, NB), (1, 20, 2)])
@pytest.mark.parametrize("bf16", [False, True])
def test_moments2d_naf_keeps_its_bits(kind, p, na, nb, bf16, dev):
    """moments2d_naf and moments2d_naf_bf16 (one tile a block at na = 3,
    uneven shares at 20) return bit for bit their sums in their own order
    (``Moments2D.naf_ordered``: float64 on the CPU, the card's fp64 FMA
    emulated where a product is inexact)."""
    ma, _, Ga_cat, Gb_cat, _, (CMa, _) = _carry_mats(kind, na, nb)
    naf = tk2d.Moments2D(Ga_cat, Gb_cat, ma.Btot, na, nb, solve=CMa).to(dev)
    x = torch.from_numpy(np.random.default_rng(na + 1).standard_normal(
        (p, na, T, nb * T)).astype(np.float32)).to(dev)
    if bf16:
        x = x.to(torch.bfloat16)
    tl.reset_launches()
    got = naf(x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(**{"moments2d_naf_bf16" if bf16
                                   else "moments2d_naf": 1})
    for g, w in zip(got, naf.naf_ordered(x)):
        _bits_equal(g, w)


@pytest.mark.parametrize("Ta", [32, 128])
@pytest.mark.parametrize("K", [6, 12])
@pytest.mark.parametrize("kind", ["uniform", "clamp"])
def test_moments2d_k_keeps_its_bits(Ta, K, kind, dev):
    """moments2d_k returns bit for bit its sums in its own order
    (``Moments2DK.ordered``: float64 on the CPU, exact products)."""
    w3 = rft.gaussian_weights(5.0, 3)
    reps = K // 6
    a = [Scan(0, c, w3[0], tuple(w3[1:])) for _ in range(reps)
         for c in (True, False)]
    b = [Scan(1, c, 0.9, (0.6, 0.25, -0.1)) for _ in range(reps)
         for c in (True, False)]
    p, na, nb = 2, 3, 4
    ma = tdf.prepare_dim_pass(a, Ta, na, kind == "clamp")
    mb = tdf.prepare_dim_pass(b, 128, nb, kind == "clamp")
    cat = lambda ms: np.concatenate([np.asarray(m) for m in ms], axis=1)
    mom = tk2d.Moments2DK(cat(ma.G), cat(mb.G), na, nb).to(dev)
    x = torch.from_numpy(np.random.default_rng(Ta + K).standard_normal(
        (p, na, Ta, nb * 128)).astype(np.float32)).to(dev)
    tl.reset_launches()
    got = mom(x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(moments2d_k=1)
    for g, w in zip(got, mom.ordered(x)):
        _bits_equal(g, w)


# ------------- the 2-D executor's kernels on their persistent walks (PR 23)
# (p, na, nb): one tile, grids below the card's 132 SMs, a ragged one past
# them (154 tiles: 22 blocks take a second tile) and one of 2.2 waves
PX_GRIDS = [(1, 1, 1), (1, 3, 5), (2, 7, 11), (1, 17, 17)]


def _px_mats(kind, na, nb):
    ma, mb, Ga_cat, Gb_cat, Ra_cat, _ = _carry_mats(kind, na, nb)
    Rb_cat = np.concatenate([np.asarray(r) for r in mb.Rhat], axis=2)
    return ma.Btot, Ra_cat, mb.Btot, Rb_cat, Ga_cat, Gb_cat


def _px_inputs(p, na, nb, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev) for s in ((p, na, T, nb * T), (p, na, 8, nb * T),
                               (p, na, nb * 8, T))]


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("p,na,nb", PX_GRIDS)
@pytest.mark.parametrize("i", [None, 0, 1, 2, 3, 4])
def test_final2d_px6_within_its_products_bound(kind, p, na, nb, i, dev):
    """final2d (i None) and final2d_epi (k = i aux arrays) on the tensor
    cores, one launch: within 1e-5 of the float32 twin's peak, and per
    output within ``split_exact``'s bound of the exact sum of its six
    products (the epilogue: |a| times the bound plus four fp32 roundings
    of its terms); a sum with the level-2 pair (0, 2) left out lies
    outside that bound somewhere."""
    Ba, Ra, Bb, Rb, _, _ = _px_mats(kind, na, nb)
    aff = None if i is None else _affine(i)
    fin = tk2d.Final2D(Ba, Ra, Bb, Rb, na, nb, affine=aff).to(dev)
    x, NA_t, NB_t = _px_inputs(p, na, nb, dev, 100 + na + (i or 0))
    aux = [] if aff is None else _aux(x.shape, aff.k, dev, 7 + na)
    tl.reset_launches()
    y = fin(x, NA_t, NB_t, *aux)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(**{"final2d" if aff is None
                                   else "final2d_epi": 1})
    assert _rel(y, fin.plain(x, NA_t, NB_t, *aux)) <= 1e-5
    ref, bound = fin.split_exact(x, NA_t, NB_t)
    if aff is None:
        assert _within(y, ref, bound)
        ref2, bound2 = fin.split_exact(x, NA_t, NB_t, drop=(0, 2))
        assert not _within(y, ref2, bound2)
        return
    a, b, c = AFFINES[i]
    want = a * ref + c
    mag = abs(a) * ref.abs() + abs(c)
    for bk, u in zip(b, aux):
        want = want + bk * u.double()
        mag = mag + abs(bk) * u.double().abs()
    assert _within(y, want, abs(a) * bound + 2.0 ** -22 * mag)


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("p,na,nb", PX_GRIDS)
@pytest.mark.parametrize("h8", [0, 16])
def test_moments2d_ring_matches_twin(kind, p, na, nb, h8, dev):
    """moments2d (the persistent ring) and moments2d_bf16, with and
    without 16 edge rows, on grids below and past the card's SMs: within
    1e-5 of the twin's peak (zero where the twin is: the pad projector of
    a one-tile stack zeroes edge rows), the pad slots zero, bf16 the
    float32 entry's outputs on the same values bit for bit, one launch
    each."""
    Ba, _, _, _, Ga_cat, Gb_cat = _px_mats(kind, na, nb)
    mom = tk2d.Moments2D(Ga_cat, Gb_cat, Ba, na, nb,
                         edge=(Ba, h8) if h8 else None).to(dev)
    x = _px_inputs(p, na, nb, dev, 200 + nb)[0]
    for xx, entry in ((x, "moments2d"), (x.to(torch.bfloat16),
                                          "moments2d_bf16")):
        tl.reset_launches()
        got = mom(xx)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(**{entry: 1})
        assert len(got) == (4 if h8 else 2)
        for g, w in zip(got, mom.plain(xx)):  # an edge row may be all zero
            assert bool(((g - w).abs().max() <= 1e-5 * w.abs().max()).item())
        assert not got[0][:, :, 6:].any()  # Ka = 6
        assert not got[1].reshape(p, na, nb, 8, T)[:, :, :, 5:].any()
    for g, f in zip(mom(x.to(torch.bfloat16)),
                    mom(x.to(torch.bfloat16).float())):
        assert torch.equal(g, f)


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


# ------------------------------------------- the reduced grades (split bf16)

def _split_mats(kind, rng=None):
    """The 2-D test filter's matrices (``_modules``'s), or, with ``rng``,
    integer-valued matrices in {-1, 0, 1} of the same variant layout."""
    clamp, pad_a, pad_b = STACKS[kind]
    w3 = rft.gaussian_weights(5.0, 3)
    a = [Scan(0, True, w3[0], tuple(w3[1:])),
         Scan(0, False, w3[0], tuple(w3[1:]))]
    b = [Scan(1, True, 0.9, (0.6, 0.25, -0.1)),
         Scan(1, False, 1.1, (0.5, 0.2))]
    ma = tdf.prepare_dim_pass(a, T, NA, clamp, pad_slots=pad_a)
    mb = tdf.prepare_dim_pass(b, T, NB, clamp, pad_slots=pad_b)
    cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms], axis=ax)
    mats = [np.asarray(ma.Btot), cat(ma.Rhat, 2), np.asarray(mb.Btot),
            cat(mb.Rhat, 2)]
    if rng is not None:
        mats = [rng.integers(-1, 2, m.shape).astype(np.float64)
                for m in mats]
    return mats


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("nprod", [1, 3, 4])
def test_final2d_split_matches_twin(kind, nprod, dev):
    """``final2d_split`` within 1e-5 of its twin's peak per output (fp32
    sums in another order). At one product the two also round their own
    Z to bf16: held on top at ``resplit_bound`` (nonzero only where a Z
    value lies within the kernel's summation error of a rounding
    boundary), and, as a control, the twin at three products lies outside
    that limit. Bit for bit on integer matrices and inputs that need two
    bf16 chunks a value, where every sum is exact, so one product and
    three give different results."""
    mats = _split_mats(kind)
    mod = tk2d.Final2DSplit(*mats, NA, NB, nprod).to(dev)
    x, NA_t, NB_t = _inputs(dev)
    tl.reset_launches()
    y = mod(x, NA_t, NB_t)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(final2d_split=1)
    want = mod.plain(x, NA_t, NB_t)
    lim = 1e-5 * want.abs().max() + mod.resplit_bound(x, NA_t)
    assert bool(((y - want).abs() <= lim).all())
    if nprod == 1:
        y3 = tk2d.Final2DSplit(*mats, NA, NB, 3).to(dev).plain(x, NA_t, NB_t)
        assert bool(((y - y3).abs() > lim).any())
    rng = np.random.default_rng(3)
    imod = tk2d.Final2DSplit(*_split_mats(kind, rng), NA, NB, nprod).to(dev)
    ints = [torch.from_numpy(rng.integers(-300, 301, t.shape)
                             .astype(np.float32)).to(dev)
            for t in (x, NA_t, NB_t)]
    assert torch.equal(imod(*ints), imod.plain(*ints))


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("nprod", [1, 3, 4])
@pytest.mark.parametrize("S,q", [(6, 300), (29, 77), (56, 8), (2, 306),
                                 (13, 50), (40, 64)])
def test_completion_split_matches_twin(kind, nprod, S, q, dev):
    """``completion_split`` (the tensor-core completion at the grade: one
    to four carry k16 steps, ragged 64-line items, one and three matrix
    variants) within 1e-5 of its twin's peak, and within ``split_exact``'s
    bound of its chunk products' exact sum at every output."""
    rng = np.random.default_rng(S)
    n = 3
    B = _stack(kind, T, T, n, rng)
    R = _stack(kind, T, S, n, rng, 0.1)
    mod = tc.CompletionPass(B, R, n, nprod=nprod).to(dev)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(np.float32))
    N = torch.zeros((n, mod.sl, q))
    N[:, :S] = torch.from_numpy(
        rng.standard_normal((n, S, q)).astype(np.float32))
    x, N = x.to(dev), N.to(dev)
    tl.reset_launches()
    y = mod(x, N)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(completion_split=1)
    assert _rel(y, mod.plain(x, N)) <= 1e-5
    assert _within(y, *mod.split_exact(x, N))


def _probe_inputs(dev, L=256, n=3, S=6, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa
    return (t(rng.standard_normal((L, n * T)) * 0.01),
            (rng.standard_normal((T, T)) / np.sqrt(T)).astype(np.float32),
            t(rng.standard_normal((L, S)) * 0.01),
            (rng.standard_normal((T, S)) * 0.1).astype(np.float32))


# (nprod, emit, carry, stack): px6 takes no carry in the contraction (its
# operands would outgrow the block's shared memory; the launch refuses it)
SPLIT_MM_FORMS = [(n, e, c, st) for n in (1, 3, 4, 6) for e, c, st in (
    (0, 0, False), (1, 1, False), (1, 2, False), (2, 1, False),
    (2, 2, False), (1, 0, True), (0, 0, True)) if not (n == 6 and c == 1)]


@pytest.mark.parametrize("nprod,emit,carry,stack", SPLIT_MM_FORMS)
def test_split_mm_matches_twin(nprod, emit, carry, stack, dev):
    """The study's bf16 entry on every emit, carry and stacking form,
    against its twin at 1e-5 of the peak."""
    x, B, N, R = _probe_inputs(dev)
    C = smm.bf16_operand(B, nprod, R if carry == 1 else None).to(dev)
    kw = dict(nprod=nprod, emit=emit, carry=carry, stack=stack,
              N=N if carry else None,
              R=torch.from_numpy(R).to(dev) if carry == 2 else None)
    y = smm.split_mm(x, C, nt=2, lb=256, **kw)
    want = smm.split_mm(x.cpu(), C.cpu(), **{
        k: (v.cpu() if isinstance(v, torch.Tensor) else v)
        for k, v in kw.items()})
    assert _rel(y.cpu(), want) <= 1e-5


@pytest.mark.parametrize("emit,carry", [(0, 0), (1, 1), (0, 1)])
def test_split_mm_tf32_and_fp32_match_twins(emit, carry, dev):
    x, B, N, R = _probe_inputs(dev, seed=1)
    Nk = N if carry else None
    for npass in (1, 3):
        Bf = smm.tf32_operand(B, R if carry else None)
        y = smm.split_mm_tf32(x, Bf.to(dev), npass=npass, emit=emit,
                              carry=carry, N=Nk)
        want = smm.split_mm_tf32(x.cpu(), Bf, npass=npass, emit=emit,
                                 carry=carry, N=None if Nk is None
                                 else Nk.cpu())
        assert _rel(y.cpu(), want) <= 1e-5
    Bk = smm.fp32_operand(B, R if carry else None)
    y = smm.split_mm_fp32(x, Bk.to(dev), emit=emit, carry=carry, N=Nk)
    want = smm.split_mm_fp32(x.cpu(), Bk, emit=emit, carry=carry,
                             N=None if Nk is None else Nk.cpu())
    assert _rel(y.cpu(), want) <= 1e-5


@pytest.mark.parametrize("precision,bound", [("px3", 1e-4), ("px4", 8e-5),
                                             ("default", 3e-2)])
def test_headline_at_the_reduced_grades_on_the_card(precision, bound, dev):
    """The headline Gaussian at 512² through ``as_func`` at each reduced
    grade: ``moments2d`` then ``final2d_split``, within the grade's bound
    of the f64 oracle."""
    from recfilter_tpu_torch import scan_core
    from recfilter_tpu_torch.bench import _build_filter

    F = _build_filter(512, 512)
    F.set_plan(matmul_precision=precision)
    img = (np.random.default_rng(0).standard_normal((512, 512)) * 0.01
           ).astype(np.float32)
    fn = F.as_func()
    tl.reset_launches()
    y = fn(torch.from_numpy(img).to(dev)).cpu().numpy()
    assert tl.LAUNCHES == _only(moments2d=1, final2d_split=1)
    want = scan_core.oracle_apply(F.spec, img.astype(np.float64))
    assert np.abs(y - want).max() <= bound * np.abs(want).max()


@pytest.mark.parametrize("precision,bound", [("px3", 1e-4), ("px4", 8e-5),
                                             ("default", 3e-2)])
def test_volume_and_rows_pass_at_the_reduced_grades_on_the_card(
        precision, bound, dev):
    """A 128 × 128 × 256 σ=5 Gaussian volume (clamp) at each reduced grade
    through ``as_func``: ``rows_tails``, ``rows_final`` at the grade, then
    ``moments2d`` and ``final2d_split``; at px3 and px4 a y-only filter on
    256 × 384 (the per-axis loop's rows pass): ``rows_tails`` and
    ``rows_final``; each within the grade's bound of the f64 oracle."""
    rng = np.random.default_rng(4)
    vol = (rng.standard_normal((128, 128, 256)) * 0.01).astype(np.float32)
    dz, dy, dx = rft.Dim("z", 128), rft.Dim("y", 128), rft.Dim("x", 256)
    F = rft.RecFilter("Volume")
    F.set_clamped_image_border()
    F[dz, dy, dx] = vol
    for d in (+dz, -dz, +dy, -dy, +dx, -dx):
        F.add_filter(d, rft.gaussian_weights(5.0, 3))
    F.split(dz, 128, dy, 128, dx, 128)
    F.set_plan(matmul_precision=precision)
    cases = [(F, vol, _only(rows_tails=1, rows_final=1, moments2d=1,
                            final2d_split=1))]
    if precision != "default":
        img = (rng.standard_normal((256, 384)) * 0.01).astype(np.float32)
        dy, dx = rft.Dim("y", 256), rft.Dim("x", 384)
        G = rft.RecFilter("YOnly")
        G[dy, dx] = img
        G.add_filter(+dy, rft.gaussian_weights(5.0, 3))
        G.add_filter(-dy, rft.gaussian_weights(5.0, 3))
        G.split(dy, 128)
        G.set_plan(matmul_precision=precision)
        cases.append((G, img, _only(rows_tails=1, rows_final=1)))
    for H, x, launches in cases:
        fn = H.as_func()
        tl.reset_launches()
        y = fn(torch.from_numpy(x).to(dev)).cpu().numpy()
        assert tl.LAUNCHES == launches
        want = rft.oracle_apply(H.spec, x.astype(np.float64))
        assert np.abs(y - want).max() <= bound * np.abs(want).max()


def _dual_inputs(dev, W=512, seed=0):
    from recfilter_tpu_torch.kernels import int8_mm as im

    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((2, 3, T, W)) * 0.7).astype(
        np.float32))
    B = rng.random((T, T)) / T
    Ca, ea = im.ozaki_operand(B)
    return im, x, B, Ca, ea, im.px6_operand(B)


@pytest.mark.parametrize("Lb", [None, 256])
def test_ozaki_i8_matches_its_twin_bit_for_bit(Lb, dev):
    """The int8 Ozaki dual completion equals its twin bit for bit (the
    same exact int32 level sums and fp32 steps), x blocks on their own
    scales; launched once a call."""
    im, x, _, Ca, ea, _ = _dual_inputs(dev)
    x[1, 2] *= 1e3
    tl.reset_launches()
    y = im.ozaki_i8(x.to(dev), Ca.to(dev), ea, Ca.to(dev), ea, Lb=Lb)
    assert tl.LAUNCHES == _only(ozaki_i8=1)
    assert torch.equal(y.cpu(), im.ozaki_i8_plain(x, Ca, ea, Ca, ea, Lb=Lb))


def test_dual_px6_matches_its_twin(dev):
    im, x, _, _, _, Ac = _dual_inputs(dev, seed=1)
    tl.reset_launches()
    y = im.dual_px6(x.to(dev), Ac.to(dev), Ac.to(dev))
    assert tl.LAUNCHES == _only(dual_px6=1)
    assert _rel(y.cpu(), im.dual_px6_plain(x, Ac, Ac)) <= 1e-6


@pytest.mark.parametrize("shape", [(128, 128, 64), (256, 384, 320)])
def test_gemm_pair_matches_its_twins(shape, dev):
    """gemm_i8's int32 sums and its >> 13 store equal the twin's; gemm_bf16
    lies within one bf16 step of its twin's peak."""
    from recfilter_tpu_torch.kernels import int8_mm as im

    M, N, K = shape
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (N, K)).astype(np.int8))
    assert torch.equal(im.gemm_i8(a.to(dev), b.to(dev), raw=True).cpu(),
                       im.gemm_i8_plain(a, b, raw=True))
    assert torch.equal(im.gemm_i8(a.to(dev), b.to(dev)).cpu(),
                       im.gemm_i8_plain(a, b))
    af = torch.from_numpy(rng.standard_normal((M, K))).to(torch.bfloat16)
    bf = torch.from_numpy(rng.standard_normal((N, K))).to(torch.bfloat16)
    y = im.gemm_bf16(af.to(dev), bf.to(dev)).cpu()
    assert _rel(y.float(), im.gemm_bf16_plain(af, bf).float()) <= 2.0 ** -8


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "uint8",
                                   "uint16", "uint32"])
def test_integer_limb_route_on_the_card(dtype, dev):
    """A clamp-border SAT through the limb route (no kernel launch) and a
    unit SAT through int_scan, bit-exact against the integer oracle."""
    from recfilter_tpu_torch import scan_core

    hi = {"int8": 100, "int16": 2 ** 12, "int32": 2 ** 24, "uint8": 200,
          "uint16": 2 ** 14, "uint32": 2 ** 30}[dtype]
    lo = 0 if dtype.startswith("u") else -hi
    img = np.random.default_rng(3).integers(lo, hi, (96, 160)).astype(dtype)
    for clamp in (True, False):
        x, y = rft.Dim("x", 160), rft.Dim("y", 96)
        F = rft.RecFilter("IntSAT")
        if clamp:
            F.set_clamped_image_border()
        F[y, x] = img
        F.add_filter(+x, [1, 1])
        F.add_filter(+y, [1, 1])
        F.split(x, 32, y, 32)
        fn = F.as_func()
        tl.reset_launches()
        got = fn(torch.from_numpy(img).to(dev)).cpu().numpy()
        assert tl.LAUNCHES == (_only() if clamp else _only(int_scan=2))
        np.testing.assert_array_equal(got, scan_core.oracle_apply(F.spec,
                                                                  img))


@pytest.mark.parametrize("precision,bound", [
    ("f32x3", 2e-4), ("f32x4", 8e-5), ("f32x6", 4e-6), ("high", 2e-4),
    ("f32x9", 4e-6)])
def test_headline_at_the_split_einsum_grades_on_the_card(precision, bound,
                                                         dev):
    """The headline Gaussian at 512² at each split-einsum grade: the
    rotation chain's einsum passes (no kernel), within the grade's bound
    of the f64 oracle."""
    from recfilter_tpu_torch import scan_core
    from recfilter_tpu_torch.bench import _build_filter

    F = _build_filter(512, 512)
    F.set_plan(matmul_precision=precision)
    img = (np.random.default_rng(0).standard_normal((512, 512)) * 0.01
           ).astype(np.float32)
    fn = F.as_func()
    tl.reset_launches()
    y = fn(torch.from_numpy(img).to(dev)).cpu().numpy()
    assert tl.LAUNCHES == _only()
    want = scan_core.oracle_apply(F.spec, img.astype(np.float64))
    assert np.abs(y - want).max() <= bound * np.abs(want).max()


# ------------------------------------------ the rotated emit at the grades

@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("nprod", [1, 3, 4, 6])
@pytest.mark.parametrize("S,q", [(6, 300), (29, 77), (56, 8), (2, 5001),
                                 (13, 50)])
def test_completion_rot_at_the_grades(kind, nprod, S, q, dev):
    """``completion_rot`` at each grade (one to four carry k16 steps,
    ragged 64-line items, rows not 16-byte aligned at q = 5001, one and
    three variants) within 1e-5 of its split twin's peak and within
    ``split_exact``'s bound of its chunk products' exact sum at every
    output; without the level-1 pair (0, 1) (px3, px4, px6) the exact sum
    lies outside that bound at some output."""
    rng = np.random.default_rng(S * 10 + nprod)
    n = 3
    mod = tc.CompletionPass(_stack(kind, T, T, n, rng, 0.1),
                            _stack(kind, T, S, n, rng), n, rot=True,
                            nprod=nprod).to(dev)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(np.float32))
    N = torch.zeros((n, mod.sl, q))
    N[:, :S] = torch.from_numpy(rng.standard_normal((n, S, q)).astype(
        np.float32))
    x, N = x.to(dev), N.to(dev)
    tl.reset_launches()
    y = mod(x, N)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(completion_rot=1)
    assert y.shape == (n * T, q)
    assert _rel(y, mod.split_plain(x, N)) <= 1e-5
    assert _within(y, *mod.split_exact(x, N))
    if nprod > 1:
        assert not _within(y, *mod.split_exact(x, N, (0, 1)))


@pytest.mark.parametrize("nprod", [1, 3, 4, 6])
@pytest.mark.parametrize("taps,start,end", [
    ([(10, 0.25), (-1, -2.0), (-12, 1.0)], "zero", "clamp"),
    ([(3, 1.0), (0, -0.5)], "clamp", "zero"),
    ([(-128, 1.0), (128, 0.5), (0, 2.0)], "clamp", "clamp")])
def test_completion_rot_stencil_at_the_grades(taps, start, end, nprod, dev):
    """The fused stencil at each grade (its reach up to a whole tile each
    way), alone and with an affine epilogue of two aux arrays after it:
    within 1e-5 of the split twin's peak (the twin's stencil on the same
    halo strips: the same float32 arithmetic on the tile)."""
    rng = np.random.default_rng(nprod)
    n, S, q = 4, 3, 1030
    Btot, Rcat = _stack("clamp", T, T, n, rng, 0.1), _stack("clamp", T, S,
                                                            n, rng)
    st = {"taps": taps, "start": start, "end": end}
    flat = tc.CompletionPass(Btot, Rcat, n, rot=True).to(dev)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(np.float32)
                         ).to(dev)
    N = torch.from_numpy(rng.standard_normal((n, 8, q)).astype(np.float32)
                         ).to(dev)
    for aff in (None, _affine(2)):
        mod = tc.CompletionPass(Btot, Rcat, n, rot=True, stencil=st,
                                affine=aff, nprod=nprod).to(dev)
        halos = _halos_flat(flat.plain(x, N), n, mod.hp, mod.hn)
        aux = _aux((n * T, q), 0 if aff is None else aff.k, dev, 40)
        tl.reset_launches()
        y = mod(x, N, *halos, *aux)
        torch.cuda.synchronize()
        entry = "completion_rot" if aff is None else "completion_rot_epi"
        assert tl.LAUNCHES == _only(**{entry: 1})
        assert _rel(y, mod.split_plain(x, N, *halos, *aux)) <= 1e-5


@pytest.mark.parametrize("nprod", [1, 3, 4, 6])
@pytest.mark.parametrize("ra,n2,kind", [(1, 3, "clamp"), (5, 2, "uniform"),
                                        (2, 3, "clamp")],
                         ids=["image", "volume", "volume-3"])
def test_completion_rot_tails_at_the_grades(ra, n2, kind, nprod, dev):
    """``completion_rot_tails`` at each grade on N(0,1) input: its output
    bit-equal to ``completion_rot``'s (the same products), its tails
    bit-equal to the ``tails`` kernel's on that output (fp64, one fma a
    line ascending: what the next pass would read unchained), pad slots
    zero; the output within 1e-5 of the split twin's peak."""
    rng = np.random.default_rng(ra * 10 + n2 + nprod)
    n, S, S2 = 3, 6, 5
    q = ra * n2 * T
    Btot, Rcat = _stack(kind, T, T, n, rng, 0.1), _stack(kind, T, S, n, rng)
    G2 = _stack(kind, S2, T, n2, rng, 0.1)
    chained = tc.CompletionPass(Btot, Rcat, n, rot=True, next_tails=(G2, n2),
                                nprod=nprod).to(dev)
    flat = tc.CompletionPass(Btot, Rcat, n, rot=True, nprod=nprod).to(dev)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(np.float32)
                         ).to(dev)
    N = torch.zeros((n, 8, q), device=dev)
    N[:, :S] = torch.from_numpy(rng.standard_normal((n, S, q)).astype(
        np.float32)).to(dev)
    tl.reset_launches()
    y, t2 = chained(x, N)
    yf = flat(x, N)
    t_un = tc.TailsPass(G2, n2).to(dev)(yf.reshape(-1, n2, T))
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(completion_rot_tails=1, completion_rot=1,
                                tails=1)
    assert t2.shape == (n2, 8, n * T * ra) and not t2[:, S2:].any()
    assert torch.equal(y, yf) and torch.equal(t2, t_un)
    assert _rel(y, chained.split_plain(x, N)[0]) <= 1e-5


@pytest.mark.parametrize("grade", ["px3", "px4", "default"])
def test_rotation_chain_at_the_grades(grade, dev):
    """The rotation chain at the grade through ``as_func``: K1's filter
    (ΣK = 12 a axis) at 256², a volume chained x → y (40 × 128 × 256), and
    a volume whose trailing pair declines after its rows pass (128 × 16 ×
    128, the chain per z slice); launch counts (at ``default`` the passes
    with no structural win run their einsum form), within the grade's
    bound of the f64 oracle, chained = unchained bit for bit."""
    bound = {"px3": 1e-4, "px4": 8e-5, "default": 3e-2}[grade]
    w3 = rft.gaussian_weights(5.0, 3)
    g = lambda ax, c=True: (ax, c, w3[0], tuple(w3[1:]))  # noqa: E731
    px = grade != "default"
    cases = [  # (shape, scans, tiles, launches)
        ((256, 256), [g(1), g(1, False), g(1), g(1, False), g(0),
                      g(0, False), g(0), g(0, False)], None,
         dict(tails=2, completion_rot=2) if px else {}),
        ((40, 128, 256), [g(0), g(1), g(2)], (0, T, T),
         dict(tails=1, completion_rot_tails=1, completion_rot=1)),
        ((128, 16, 128), [g(0), g(2), g(2, False), g(1)], None,
         dict(rows_tails=1, rows_final=1,
              **(dict(tails=128, completion_rot=128) if px else {})))]
    rng = np.random.default_rng(1)
    for shape, scans, tiles, launches in cases:
        spec = _chain_spec(shape, scans, tiles=tiles)
        img = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        mod = tdf.fused_filter_module(spec, grade).to(dev)
        x = torch.from_numpy(img).to(dev)
        tl.reset_launches()
        got = mod(x)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(**launches), (shape, tl.LAUNCHES)
        want = rft.oracle_apply(spec, img.astype(np.float64))
        err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
        assert err <= bound, (shape, err)
        if isinstance(mod, tdf.RotationChain) and any(
                p.completion_nt is not None for p in mod.passes):
            for p in mod.passes:
                p.completion_nt = None  # unchained: each pass its tails
            assert torch.equal(mod(x), got)


# ---------------------------------------------------------------------------
# The fused consumers' reduced-grade forms: fir_band, final2d_stencil and
# the epilogue entries at nprod 1, 3, 4
# ---------------------------------------------------------------------------

FIR_FORMS = [("plain", False, None), ("plain", True, [11.0 ** 3]),
             ("bank", True, None), ("bank", False, [7.0 ** 3, 19.0 ** 3]),
             ("contract", False, None),
             ("contract", True, [7.0 ** 3, 19.0 ** 3])]


@pytest.mark.parametrize("form,rot,scale", FIR_FORMS)
@pytest.mark.parametrize("nprod", [1, 3, 4])
def test_fir_band_at_the_grades_matches_twin(form, rot, scale, nprod, dev):
    """fir_band at nprod 1, 3, 4 — flat, bank, contraction and rotated,
    with and without ``tap_scale`` (the radius-3 box³ channel exact, the
    radius-9 one not) — against its twin: 1e-5 of the twin's peak, one
    launch."""
    from recfilter_tpu_torch.fir import _align_taps, box_taps
    from recfilter_tpu_torch.kernels import fir_band

    taps = _align_taps([box_taps(5, 3)] if form == "plain"
                       else [box_taps(3, 3), box_taps(9, 3)])
    contract = form == "contract"
    band = fir_band.FirBand(taps, rot=rot, contract=contract,
                            signs=[1.0, -1.0] if contract else None,
                            nprod=nprod, tap_scale=scale).to(dev)
    rng = np.random.default_rng(nprod)
    shape = (2, 77, 1000) if contract else (77, 1000)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    tl.reset_launches()
    y = band(x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(fir_band=1)
    assert _rel(y, band.plain(x)) <= 1e-5


@pytest.mark.parametrize("nprod,K", [(1, 65), (3, 65), (4, 65), (6, 257)])
def test_fir_band_stages_what_it_fits(nprod, K, dev):
    """A 16-channel bank: where the kernel stages it (its tap rows the most
    chunk pairs a channel takes) it matches its twin within 1e-5 of the
    twin's peak in one launch; where it does not fit (px4 at K = 65, px6 at
    K = 257) the launcher refuses it and ``FirPass`` routes the bank to the
    einsum form, with no launch."""
    from recfilter_tpu_torch import fir
    from recfilter_tpu_torch.kernels import fir_band

    taps = np.random.default_rng(K).standard_normal((16, K)) / K
    band = fir_band.FirBand(taps, nprod=nprod).to(dev)
    rng = np.random.default_rng(nprod)
    x = torch.from_numpy(rng.standard_normal((40, 512)).astype(
        np.float32)).to(dev)
    tl.reset_launches()
    if band.fits:
        y = band(x)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(fir_band=1)
        assert _rel(y, band.plain(x)) <= 1e-5
        return
    with pytest.raises(RuntimeError):
        band(x)
    grade = {4: "px4", 6: "px6"}[nprod]
    mod = fir.FirPass(taps, tuple(x.shape), bank=True,
                      matmul_precision=grade).to(dev)
    tl.reset_launches()
    y = mod(x)
    torch.cuda.synchronize()
    assert mod.band is None and not any(tl.LAUNCHES.values())
    assert y.shape == (16, 40, 512) and bool(torch.isfinite(y).all())


def _stencil_inputs(fin, dev, ints):
    """x, the carries and the halo strips of the twin's own output rows
    (integer-valued with ``ints``: every sum exact at every grade)."""
    rng = np.random.default_rng(7)
    if ints:
        shapes = [(P, NA, T, NB * T), (P, NA, 8, NB * T), (P, NA, NB * 8, T)]
        x, NA_t, NB_t = [torch.from_numpy(rng.integers(-8, 9, s).astype(
            np.float32)).to(dev) for s in shapes]
    else:
        x, NA_t, NB_t = _inputs(dev, seed=5)
    h8 = fin.h8
    Y = fin.final.plain(x, NA_t, NB_t)
    z = torch.zeros_like(Y[:, :1, :h8])
    top = torch.cat([z, Y[:, :-1, T - h8:]], dim=1).contiguous()
    bot = torch.cat([Y[:, 1:, :h8], z], dim=1).contiguous()
    return x, NA_t, NB_t, top, bot


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("nprod", [1, 3, 4])
def test_final2d_stencil_at_the_grades_matches_twin(kind, nprod, dev):
    """final2d_stencil at nprod 1, 3, 4 (C1's bank, radii 5 and 9, h8 =
    16; the lane neighbours' columns from their own split tiles): within
    1e-5 of the twin's peak per output, plus the bank over the resplit
    bound at one product; bit for bit on integer matrices and inputs."""
    bank = [[(5, 5, 1.0), (5, -6, -1.0), (-6, 5, -1.0), (-6, -6, 1.0)],
            [(9, 9, 0.5), (9, -10, -0.5), (-10, 9, -0.5), (-10, -10, 0.5)]]
    for rng, ints in ((None, False), (np.random.default_rng(2), True)):
        fin = tk2d.Final2DStencil(*_split_mats(kind, rng), NA, NB, bank, 16,
                                  nprod).to(dev)
        args = _stencil_inputs(fin, dev, ints)
        tl.reset_launches()
        got = fin(*args)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(final2d_stencil=1)
        want = fin.plain(*args)
        if ints:
            assert torch.equal(got, want)
            continue
        lim = (1e-5 * want.abs().amax(dim=(1, 2, 3, 4), keepdim=True)
               + fin.resplit_bound(*args[:2]))
        assert bool(((got - want).abs() <= lim).all())


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("nprod", [1, 3, 4])
@pytest.mark.parametrize("i", [0, 2, 4])
def test_split_epilogue_entries_match_twins(kind, nprod, i, dev):
    """final2d_split_epi and completion_split_epi, k = 0, 2, 4 aux arrays,
    against their twins (the split products, then the form): 1e-5 of the
    twin's peak (plus |a| × the resplit bound at one product for the 2-D
    entry), one launch each."""
    aff = _affine(i)
    mod = tk2d.Final2DSplit(*_split_mats(kind), NA, NB, nprod,
                            affine=aff).to(dev)
    x, NA_t, NB_t = _inputs(dev, seed=i)
    aux = _aux(x.shape, aff.k, dev, 40 + i)
    tl.reset_launches()
    y = mod(x, NA_t, NB_t, *aux)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(final2d_split_epi=1)
    want = mod.plain(x, NA_t, NB_t, *aux)
    lim = (1e-5 * want.abs().max()
           + abs(aff.scale) * mod.resplit_bound(x, NA_t))
    assert bool(((y - want).abs() <= lim).all())
    rng = np.random.default_rng(i)
    n, S, q = 4, 6, 300
    Btot, Rcat = _stack(kind, T, T, n, rng, 0.1), _stack(kind, T, S, n, rng)
    comp = tc.CompletionPass(Btot, Rcat, n, affine=aff, nprod=nprod).to(dev)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(np.float32)
                         ).to(dev)
    N = torch.zeros((n, comp.sl, q), device=dev)
    N[:, :S] = torch.from_numpy(rng.standard_normal((n, S, q)).astype(
        np.float32)).to(dev)
    aux = _aux((q, n, T), aff.k, dev, 50 + i)
    tl.reset_launches()
    y = comp(x, N, *aux)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(completion_split_epi=1)
    assert _rel(y, comp.plain(x, N, *aux)) <= 1e-5


@pytest.mark.parametrize("grade,bound", [("px3", 1e-4), ("px4", 8e-5),
                                         ("default", 3e-2)])
def test_fused_consumers_at_the_grades_on_the_card(grade, bound, dev):
    """At each reduced grade through the public API: box ×3 and the DoG
    (FIR) on two ``fir_band`` launches within the grade's bound of the
    separable f64 oracle; the Gaussian at 512² with a Sobel ``stencil2d``
    bank (moments2d, final2d_stencil) and with an affine epilogue
    (moments2d, final2d_split_epi) within it of the bank (the combine)
    over the f64 oracle."""
    from recfilter_tpu_torch.apps import box_filter_3, difference_of_gaussians
    from recfilter_tpu_torch.bench import _build_filter
    from recfilter_tpu_torch.fir import box_taps, fir_oracle
    from recfilter_tpu_torch.kernels.stencil2d import stencil2d_ref

    img = np.random.default_rng(8).random((384, 512)).astype(np.float32)
    x = torch.from_numpy(img).to(dev)
    for mod, taps in (
            (box_filter_3(512, 384, 5, matmul_precision=grade),
             [(1.0, box_taps(5, 3))]),
            (difference_of_gaussians(512, 384, 5, 9, matmul_precision=grade),
             [(1.0, box_taps(5, 3)), (-1.0, box_taps(9, 3))])):
        tl.reset_launches()
        got = mod(x)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(fir_band=2)
        want = sum(s * fir_oracle(fir_oracle(img, t, 1), t, 0)
                   for s, t in taps)
        err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
        assert err <= bound
    img = (np.random.default_rng(9).standard_normal((512, 512)) * 0.01
           ).astype(np.float32)
    x = torch.from_numpy(img).to(dev)
    F = _build_filter(512, 512)
    F.set_plan(matmul_precision=grade)
    y64 = rft.oracle_apply(F.spec, img.astype(np.float64))
    sobel = [[(-1, -1, -1.0), (0, -1, -2.0), (1, -1, -1.0), (-1, 1, 1.0),
              (0, 1, 2.0), (1, 1, 1.0)]]
    tl.reset_launches()
    (got,) = F.as_func(stencil2d=sobel)(x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(moments2d=1, final2d_stencil=1)
    (want,) = stencil2d_ref(torch.from_numpy(y64), sobel)
    err = (got.cpu().double() - want).abs().max() / want.abs().max()
    assert err <= bound
    fn = F.as_func(epilogue=lambda o, a: 2.0 * a - o)
    assert fn.epilogue_route == "kernel"
    tl.reset_launches()
    got = fn(x, x)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(moments2d=1, final2d_split_epi=1)
    want = 2.0 * img - y64
    err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
    assert err <= bound


# --------------------------------------------- bf16 storage (the bf16 forms)

def _bf16_ulp(t):
    """One bf16 step at each value of the bf16 tensor ``t`` (float64; the
    smallest normal step at zero)."""
    _, e = torch.frexp(t.double())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float64),
                       (e - 8).clamp(min=-133))


def _one_ulp(label, got, want, extra=None):
    """Every element of the bf16 ``got`` within one bf16 step of the bf16
    twin ``want``, beyond the float32 kernel's own distance from the
    twin's float32 sums: 1e-5 of the twin's peak (the float32 forms'
    bound, their sums in another order — where cancellation leaves an
    output far below the peak, that exceeds its bf16 step) plus
    ``extra`` (a float64 tensor bound). Prints the share of elements
    that differ and of those past one bf16 step alone."""
    d = (got.double() - want.double()).abs()
    ulp = _bf16_ulp(want)
    lim = ulp + 1e-5 * want.double().abs().max() + (
        0.0 if extra is None else extra)
    share = (d > 0).double().mean().item()
    past = (d > ulp).double().mean().item()
    print(f"{label}: {share:.6f} of the elements differ from the twin, "
          f"{past:.6f} by more than one bf16 step, max|k-t| "
          f"{d.max().item():.3e}")
    assert bool((d <= lim).all())


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("naf", [False, True])
def test_moments2d_bf16_is_the_float32_kernel_on_its_values(kind, naf, dev):
    """moments2d_bf16 and moments2d_naf_bf16 on a bf16 x: the float32
    entries' outputs on the same values bit for bit (the tile is widened
    as it is staged), one launch of the bf16 entry; edge rows too."""
    ma, _, Ga_cat, Gb_cat, _, (CMa, _) = _carry_mats(kind, NA, NB)
    mods = [tk2d.Moments2D(Ga_cat, Gb_cat, ma.Btot, NA, NB,
                           solve=CMa if naf else None).to(dev)]
    if not naf:
        mods.append(tk2d.Moments2D(Ga_cat, Gb_cat, ma.Btot, NA, NB,
                                   edge=(ma.Btot, 16)).to(dev))
    xb = _inputs(dev)[0].to(torch.bfloat16)
    entry = "moments2d_naf_bf16" if naf else "moments2d_bf16"
    for mod in mods:
        tl.reset_launches()
        got = mod(xb)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(**{entry: 1})
        for g, f, t in zip(got, mod(xb.float()), mod.plain(xb)):
            assert g.dtype == torch.float32 and torch.equal(g, f)
            assert _rel(g, t) <= 1e-5


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("p,n,nl", [(2, 3, 2), (1, 2, 512), (3, 2, 1)])
def test_rows_kernels_bf16_match_the_float32_kernels_and_twins(kind, p, n,
                                                               nl, dev):
    """rows_tails_bf16: rows_tails' bits on the same values; rows_final_bf16
    (one product): rows_final's float32 outputs on the same values
    rounded once to bf16, bit for bit, and each element within one bf16
    step of its twin (beyond the float32 forms' 1e-5 of the peak). (1, 2,
    512) is V1's rows pass."""
    rng = np.random.default_rng(p * 100 + n * 10 + nl + 7)
    K = 6
    tails = tk2d.RowsTails(_stack(kind, K, T, n, rng), n).to(dev)
    fin = tk2d.RowsFinal(_stack(kind, T, T, n, rng, 0.1),
                         _stack(kind, T, K, n, rng), n, 1).to(dev)
    xb = torch.from_numpy(rng.standard_normal((p, n, T, nl * T)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    tl.reset_launches()
    b = tails(xb)
    y = fin(xb, b)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(rows_tails_bf16=1, rows_final_bf16=1)
    assert torch.equal(b, tails(xb.float()))
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, fin(xb.float(), b).to(torch.bfloat16))
    _one_ulp(f"rows_final_bf16 {kind} {(p, n, nl)}", y, fin.plain(xb, b))
    with pytest.raises(ValueError, match="one product"):
        tk2d.RowsFinal(_stack(kind, T, T, n, rng), _stack(kind, T, K, n, rng),
                       n, 6).to(dev)(xb, b)


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("i", [None, 0, 2, 4])
def test_final2d_split_bf16_matches_the_float32_kernel_and_twin(kind, i,
                                                                dev):
    """final2d_split_bf16 (i None) and final2d_split_epi_bf16 (k = i aux
    arrays, float32) on a bf16 x at one product: the float32 entry's
    output on the same values rounded once to bf16, bit for bit; each
    element within one bf16 step of the twin's beyond the float32 forms'
    1e-5 of the peak and |a| × the resplit bound (kernel and twin round
    their own Z); a bf16 output."""
    aff = None if i is None else _affine(i)
    mod = tk2d.Final2DSplit(*_split_mats(kind), NA, NB, 1,
                            affine=aff).to(dev)
    x, NA_t, NB_t = _inputs(dev, seed=5 if i is None else i)
    xb = x.to(torch.bfloat16)
    aux = [] if aff is None else _aux(x.shape, aff.k, dev, 60 + i)
    tl.reset_launches()
    y = mod(xb, NA_t, NB_t, *aux)
    torch.cuda.synchronize()
    entry = "final2d_split_bf16" if aff is None else "final2d_split_epi_bf16"
    assert tl.LAUNCHES == _only(**{entry: 1})
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, mod(xb.float(), NA_t, NB_t, *aux).to(
        torch.bfloat16))
    scale = 1.0 if aff is None else abs(aff.scale)
    _one_ulp(f"{entry} {kind}", y, mod.plain(xb, NA_t, NB_t, *aux),
             scale * mod.resplit_bound(xb, NA_t).double())


@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_bf16_pair_and_volume_on_the_card(border, dev):
    """The headline Gaussian at 512² and a 128 × 128 × 256 volume with bf16
    images through ``as_func``: the bf16 entries once each, a bf16
    output within 3e-2 of the f64 oracle's peak; the pair's output the
    float32 ``default`` route's on the same image rounded to bf16, bit for
    bit."""
    import dataclasses

    def gauss(image):
        dims = [rft.Dim(n, e) for n, e in zip("zyx"[-image.ndim:],
                                              image.shape)]
        G = rft.RecFilter("Gaussian")
        if border == "clamp":
            G.set_clamped_image_border()
        G[tuple(dims)] = image
        for d in dims:
            G.add_filter(+d, rft.gaussian_weights(5.0, 3))
            G.add_filter(-d, rft.gaussian_weights(5.0, 3))
        G.split({d: 128 for d in dims})
        return G

    rng = np.random.default_rng(11)
    img, vol = (torch.from_numpy((rng.standard_normal(s) * 0.01).astype(
        np.float32)).to(torch.bfloat16) for s in ((512, 512),
                                                  (128, 128, 256)))
    F32 = gauss(img.float())
    F32.set_plan(matmul_precision="default")
    for x, launches in (
            (img, _only(moments2d_bf16=1, final2d_split_bf16=1)),
            (vol, _only(rows_tails_bf16=1, rows_final_bf16=1,
                        moments2d_bf16=1, final2d_split_bf16=1))):
        H = gauss(x)
        assert H.spec.dtype == "bfloat16"
        fn = H.as_func()
        tl.reset_launches()
        y = fn(x.to(dev))
        torch.cuda.synchronize()
        assert tl.LAUNCHES == launches and y.dtype == torch.bfloat16
        want = rft.oracle_apply(dataclasses.replace(H.spec, dtype="float32"),
                                x.double().numpy())
        err = (np.abs(y.double().cpu().numpy() - want).max()
               / np.abs(want).max())
        assert err <= 3e-2
        if x.ndim == 2:
            y32 = F32.as_func()(x.float().to(dev))
            assert torch.equal(y, y32.to(torch.bfloat16))


# ------------------------- bf16 storage: the chain, the loop, rotate_emit

def _pass_bf16(kind, n, q, S, seed, dev):
    """A bf16 x (q, n, 128) of scale 1, carries N (n, sl, q) and the stacks
    Btot, Rcat of a pass."""
    rng = np.random.default_rng(seed)
    Btot = _stack(kind, T, T, n, rng, 0.1)
    Rcat = _stack(kind, T, S, n, rng, 0.5)
    x = torch.from_numpy(rng.standard_normal((q, n, T)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    N = np.zeros((n, tc.slots_for(S), q), np.float32)
    N[:, :S] = rng.standard_normal((n, S, q))
    return Btot, Rcat, x, torch.from_numpy(N).to(dev)


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("S,q", [(6, 4096), (12, 1000), (3, 7)])
def test_tails_bf16_is_the_float32_kernel_on_its_values(kind, S, q, dev):
    """tails_bf16: the float32 entry's tails on the same values, bit for
    bit (one or two slots, lines past a 128-line item, fewer than 8
    lines), within 1e-5 of the twin's peak; it refuses the fp32-summing
    probe."""
    rng = np.random.default_rng(S * 1000 + q)
    n = 3
    mod = tc.TailsPass(_stack(kind, S, T, n, rng, 0.1), n).to(dev)
    xb = torch.from_numpy(rng.standard_normal((q, n, T)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    tl.reset_launches()
    b = mod(xb)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(tails_bf16=1)
    assert b.dtype == torch.float32 and torch.equal(b, mod(xb.float()))
    assert _rel(b, mod.plain(xb)) <= 1e-5
    mod.fp64 = False
    with pytest.raises(ValueError, match="fp64"):
        mod(xb)


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("rot", [False, True], ids=["split", "rot"])
@pytest.mark.parametrize("i", [None, 1, 3])
def test_completion_bf16_matches_the_float32_kernel_and_twin(kind, rot, i,
                                                             dev):
    """completion_split_bf16 / completion_rot_bf16 (i None) and their _epi
    forms (k = i aux arrays, float32) at one product on a bf16 x: the
    float32 entry's output on the same values rounded once to bf16, bit
    for bit; every element within one bf16 step of the twin's (beyond the
    float32 forms' 1e-5 of the peak), the share that differ printed; one
    launch of the bf16 entry. Rotated at q = 4096 (the packed store), q =
    1000 (rows 8-byte aligned, a partial item) and q = 998 (2-byte
    stores)."""
    aff = None if i is None else _affine(i)
    for q in ((4096, 1000, 998) if rot else (4096, 998)):
        Btot, Rcat, xb, N = _pass_bf16(kind, 3, q, 12, q + (i or 0), dev)
        mod = tc.CompletionPass(Btot, Rcat, 3, rot=rot, nprod=1,
                                affine=aff).to(dev)
        shape = (3 * T, q) if rot else (q, 3, T)
        aux = [] if aff is None else _aux(shape, aff.k, dev, 70 + q)
        tl.reset_launches()
        y = mod(xb, N, *aux)
        torch.cuda.synchronize()
        base = "completion_rot" if rot else "completion_split"
        entry = base + ("_bf16" if aff is None else "_epi_bf16")
        assert tl.LAUNCHES == _only(**{entry: 1})
        assert y.dtype == torch.bfloat16 and tuple(y.shape) == shape
        assert torch.equal(y, mod(xb.float(), N, *aux).to(torch.bfloat16))
        _one_ulp(f"{entry} {kind} q={q}", y, mod.plain(xb, N, *aux))
    with pytest.raises(ValueError, match="one product"):
        tc.CompletionPass(Btot, Rcat, 3, rot=rot, nprod=6).to(dev)(xb, N)


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("ra", [1, 2], ids=["image", "volume"])
def test_completion_rot_tails_bf16_is_the_unchained_pair(kind, ra, dev):
    """completion_rot_tails_bf16: its y is completion_rot_bf16's bit for
    bit, within one bf16 step of the twin's; its next-pass tails are what
    tails_bf16 reads from that y, bit for bit (the chained and unchained
    routes agree), and the float32 entry's tails of the same bf16 values
    (K3's x pass has q = 4 · 128 and n2 = 4: ra = 1)."""
    n, n2, S, S2 = 3, 4, 6, 6
    q = ra * n2 * T
    Btot, Rcat, xb, N = _pass_bf16(kind, n, q, S, 40 + ra, dev)
    G2 = _stack(kind, S2, T, n2, np.random.default_rng(ra), 0.1)
    chained = tc.CompletionPass(Btot, Rcat, n, rot=True, nprod=1,
                                next_tails=(G2, n2)).to(dev)
    plain = tc.CompletionPass(Btot, Rcat, n, rot=True, nprod=1).to(dev)
    tails2 = tc.TailsPass(G2, n2).to(dev)
    tl.reset_launches()
    y, t2 = chained(xb, N)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(completion_rot_tails_bf16=1)
    assert y.dtype == torch.bfloat16 and torch.equal(y, plain(xb, N))
    _one_ulp(f"completion_rot_tails_bf16 {kind} ra={ra}", y,
             chained.plain(xb, N)[0])
    assert torch.equal(t2, tails2(y.reshape(-1, n2, T)))
    assert torch.equal(t2, tails2(y.float().reshape(-1, n2, T)))


@pytest.mark.parametrize("case", ["K3", "S4", "E", "rotate_emit"])
def test_bf16_chain_loop_and_rotated_on_the_card(case, dev):
    """The routes through ``as_func`` on bf16 images, shrunk: K3's
    chained volume (chained bit-equal to unchained, tails_in taken on y),
    S4's per-axis loop, E's 1-D pass with the dry/wet mix in the kernel,
    and a rotate_emit x pass with an affine epilogue; the bf16 entries
    launched as the route says, a bf16 output within 3e-2 of the f64
    oracle's peak."""
    import dataclasses

    w3 = rft.gaussian_weights(5.0, 3)
    rng = np.random.default_rng(len(case))
    shape, axes, eaux = {"K3": ((136, 128, 256), (0, 1, 2), 0),
                         "S4": ((128, 32, 512), (0, 2), 0),
                         "E": ((16, 8192), (1,), 1),
                         "rotate_emit": ((512, 1024), (1,), 1)}[case]
    x = torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(
        np.float32)).to(torch.bfloat16)
    dims = [rft.Dim(nm, e) for nm, e in zip("zyx"[-len(shape):], shape)]
    F = rft.RecFilter(case)
    F[tuple(dims)] = x
    for ax in axes:
        if case == "E":
            F.add_filter(+dims[ax], [1.0, 1.6, -0.64])
        else:
            F.add_filter(+dims[ax], w3)
            F.add_filter(-dims[ax], w3)
    F.split({dims[ax]: 128 for ax in axes})
    if case == "rotate_emit":
        F.set_plan(rotate_emit=2)
    mix = (lambda y, a: 0.7 * y + 0.3 * a) if eaux else None
    fn = F.as_func(epilogue=mix)
    a = (torch.from_numpy((rng.standard_normal(
        shape[::-1] if case == "rotate_emit" else shape) * 0.1).astype(
            np.float32)).to(dev),) if eaux else ()
    tl.reset_launches()
    y = fn(x.to(dev), *a)
    torch.cuda.synchronize()
    launches = {
        "K3": _only(tails_bf16=2, completion_rot_tails_bf16=1,
                    completion_rot_bf16=2),
        "S4": _only(rows_tails_bf16=1, rows_final_bf16=1, tails_bf16=1,
                    completion_split_bf16=1),
        "E": _only(tails_bf16=1, completion_split_epi_bf16=1),
        "rotate_emit": _only(tails_bf16=1, completion_rot_epi_bf16=1)}[case]
    assert tl.LAUNCHES == launches and y.dtype == torch.bfloat16
    want = rft.oracle_apply(dataclasses.replace(F.spec, dtype="float32"),
                            x.double().numpy())
    if case == "rotate_emit":
        want = want.T
    if eaux:
        want = mix(want, a[0].double().cpu().numpy())
    err = np.abs(y.double().cpu().numpy() - want).max() / np.abs(want).max()
    print(f"{case} bf16: {err:.3e} of the oracle's peak")
    assert err <= 3e-2
    if case == "K3":
        assert fn.tails_in_taken == [False, True, False]
        for p in fn.passes:
            p.completion_nt = None
        tl.reset_launches()
        yu = fn(x.to(dev))
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(tails_bf16=3, completion_rot_bf16=3)
        assert torch.equal(yu, y)


# ------------------------------- bf16 storage: the stencil consumers

SOBEL = [[(-1, -1, -1.0), (0, -1, -2.0), (1, -1, -1.0), (-1, 1, 1.0),
          (0, 1, 2.0), (1, 1, 1.0)],
         [(-1, -1, -1.0), (-1, 0, -2.0), (-1, 1, -1.0), (1, -1, 1.0),
          (1, 0, 2.0), (1, 1, 1.0)]]
C1_BANK = [[(5, 5, 1.0), (5, -6, -1.0), (-6, 5, -1.0), (-6, -6, 1.0)],
           [(9, 9, 0.5), (9, -10, -0.5), (-10, 9, -0.5), (-10, -10, 0.5)]]
DERIV = [(-1, -0.5), (1, 0.5)]  # a central difference


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("h8", [8, 16])
def test_moments2d_bf16_edge_rows(kind, h8, dev):
    """moments2d_bf16 with edge rows (h8 = 8, GS's bank; 16, C1's): every
    output the float32 entry's on the same values, bit for bit; within
    one bf16 step of the twin's (the share that differ printed)."""
    ma, _, Ga_cat, Gb_cat, _, _ = _carry_mats(kind, NA, NB)
    mod = tk2d.Moments2D(Ga_cat, Gb_cat, ma.Btot, NA, NB,
                         edge=(ma.Btot, h8)).to(dev)
    xb = _inputs(dev, seed=h8)[0].to(torch.bfloat16)
    tl.reset_launches()
    got = mod(xb)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(moments2d_bf16=1) and len(got) == 4
    for i, (g, f, t) in enumerate(zip(got, mod(xb.float()), mod.plain(xb))):
        assert g.dtype == torch.float32 and torch.equal(g, f)
        _one_ulp(f"moments2d_bf16 {kind} h8={h8} output {i}", g, t)


@pytest.mark.parametrize("kind", list(STACKS))
@pytest.mark.parametrize("bank,h8", [(SOBEL, 8), (C1_BANK, 16)],
                         ids=["sobel", "c1"])
def test_final2d_stencil_bf16_matches_the_float32_kernel_and_twin(kind, bank,
                                                                  h8, dev):
    """final2d_stencil_bf16 (one product; x bf16 for the tile and both
    lane neighbours): the float32 entry's banks on the same values rounded
    once to bf16, bit for bit; each element within one bf16 step of the
    twin's beyond the float32 forms' 1e-5 of the peak and the bank over
    the resplit bound; one launch; px6 refuses a bf16 x."""
    fin = tk2d.Final2DStencil(*_split_mats(kind), NA, NB, bank, h8,
                              1).to(dev)
    x, NA_t, NB_t = _inputs(dev, seed=h8 + 1)
    xb = x.to(torch.bfloat16)
    Y = fin.final.plain(xb.float(), NA_t, NB_t)
    z = torch.zeros_like(Y[:, :1, :h8])
    top = torch.cat([z, Y[:, :-1, T - h8:]], dim=1).contiguous()
    bot = torch.cat([Y[:, 1:, :h8], z], dim=1).contiguous()
    tl.reset_launches()
    got = fin(xb, NA_t, NB_t, top, bot)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(final2d_stencil_bf16=1)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fin(xb.float(), NA_t, NB_t, top, bot).to(
        torch.bfloat16))
    _one_ulp(f"final2d_stencil_bf16 {kind} h8={h8}", got,
             fin.plain(xb, NA_t, NB_t, top, bot),
             fin.resplit_bound(xb, NA_t).double())
    px6 = tk2d.Final2DStencil(*_split_mats(kind), NA, NB, bank, h8).to(dev)
    with pytest.raises(ValueError, match="one product"):
        px6(xb, NA_t, NB_t, top, bot)


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
@pytest.mark.parametrize("S,He,q", [(6, 2, 4096), (12, 38, 1000),
                                    (3, 256, 7)])
def test_tails_extra_bf16_is_the_float32_kernel_on_its_values(kind, S, He,
                                                              q, dev):
    """tails_extra_bf16 (D1's two halo rows; C6's reach; a whole tile each
    way): the float32 entry's slot and extra rows on the same values, bit
    for bit; within one bf16 step of the twin's; the fp32-summing probe
    refused."""
    rng = np.random.default_rng(S * 100 + He)
    n = 3
    mod = tc.TailsPass(_stack(kind, S, T, n, rng, 0.1), n,
                       extra_rows=_stack(kind, He, T, n, rng, 0.1)).to(dev)
    xb = torch.from_numpy(rng.standard_normal((q, n, T)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    tl.reset_launches()
    b = mod(xb)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(tails_extra_bf16=1)
    assert b.dtype == torch.float32 and torch.equal(b, mod(xb.float()))
    _one_ulp(f"tails_extra_bf16 {kind} S={S} He={He} q={q}", b,
             mod.plain(xb))
    mod.fp64 = False
    with pytest.raises(ValueError, match="fp64"):
        mod(xb)


@pytest.mark.parametrize("taps,start,end", [
    (DERIV, "zero", "clamp"),
    ([(10, 0.25), (-1, -2.0), (-12, 1.0)], "zero", "clamp"),
    ([(-128, 1.0), (128, 0.5), (0, 2.0)], "clamp", "clamp")],
    ids=["d1", "c6", "tile"])
@pytest.mark.parametrize("i", [None, 1, 2])
def test_completion_rot_stencil_bf16_matches_the_float32_kernel_and_twin(
        taps, start, end, i, dev):
    """completion_rot_stencil_bf16 (i None) and
    completion_rot_stencil_epi_bf16 (k = i aux arrays, float32) at one
    product on a bf16 x: the float32 entry's output on the same values
    rounded once, bit for bit; every element within one bf16 step of the
    twin's (the share that differ printed); one launch. q = 4096 (16-byte
    halo copies), 1030 and 998 (4-byte ones)."""
    aff = None if i is None else _affine(i)
    st = {"taps": taps, "start": start, "end": end}
    for q in (4096, 1030, 998):
        Btot, Rcat, xb, N = _pass_bf16("clamp", 4, q, 3, q + (i or 0), dev)
        mod = tc.CompletionPass(Btot, Rcat, 4, rot=True, stencil=st, nprod=1,
                                affine=aff).to(dev)
        flat = tc.CompletionPass(Btot, Rcat, 4, rot=True, nprod=1).to(dev)
        halos = _halos_flat(flat.plain(xb.float(), N), 4, mod.hp, mod.hn)
        aux = [] if aff is None else _aux((4 * T, q), aff.k, dev, 90 + q)
        tl.reset_launches()
        y = mod(xb, N, *halos, *aux)
        torch.cuda.synchronize()
        entry = ("completion_rot_stencil_bf16" if aff is None
                 else "completion_rot_stencil_epi_bf16")
        assert tl.LAUNCHES == _only(**{entry: 1})
        assert y.dtype == torch.bfloat16 and tuple(y.shape) == (4 * T, q)
        assert torch.equal(y, mod(xb.float(), N, *halos, *aux).to(
            torch.bfloat16))
        _one_ulp(f"{entry} {taps} q={q}", y, mod.plain(xb, N, *halos, *aux))


@pytest.mark.parametrize("bank", [SOBEL, C1_BANK, [[(40, -40, 1.0),
                                                     (-3, 120, 0.5)]]],
                         ids=["sobel", "c1", "wide"])
@pytest.mark.parametrize("shape", [(1080, 1920), (96, 200)])
def test_stencil2d_bf16_is_the_float32_kernel_rounded_once(bank, shape, dev):
    """stencil2d_bf16 (staged, and the wide bank's direct reads): the
    float32 entry's channels on the same values rounded once, bit for
    bit; within one bf16 step of the twin's; one launch."""
    from recfilter_tpu_torch.kernels.stencil2d import Stencil2D

    rng = np.random.default_rng(shape[0])
    mod = Stencil2D(bank).to(dev)
    yb = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    tl.reset_launches()
    got = mod(yb)
    torch.cuda.synchronize()
    assert tl.LAUNCHES == _only(stencil2d_bf16=1)
    for c, (g, f, t) in enumerate(zip(got, mod(yb.float()), mod.plain(yb))):
        assert g.dtype == torch.bfloat16 and torch.equal(g, f.to(g.dtype))
        _one_ulp(f"stencil2d_bf16 {shape} channel {c}", g, t)


def _bank64(y, bank):
    """The bank over the trailing two axes of a float64 array (the border
    rule: clamp past the far edges, zeros before the first)."""
    def shift(f, off, ax):
        n = f.shape[ax]
        lo, hi = max(off, 0), max(-off, 0)
        pads = [(0, 0)] * f.ndim
        pads[ax] = (hi, lo)
        g = np.pad(f, pads, mode="edge" if off > 0 else "constant")
        return np.take(g, np.arange(lo, lo + n), axis=ax)

    return [sum(c * shift(shift(y, dy, y.ndim - 2), dx, y.ndim - 1)
                for dy, dx, c in taps) for taps in bank]


@pytest.mark.parametrize("case", ["GS", "HS", "D1", "D1e", "C6b"])
def test_bf16_stencil_consumers_on_the_card(case, dev):
    """The stencil consumers through ``as_func`` on bf16 images, shrunk: GS
    (the Sobel bank fused into the pair: moments2d_bf16 with edge rows,
    final2d_stencil_bf16), HS (a padded frame: the chain, then
    stencil2d_bf16), D1 and D1e (a central difference fused into the
    rotated x pass; D1e's combine y′ + 0.25·x in the kernel) and C6b (the
    per-slice branch); the bf16 entries launched as the route says, bf16
    outputs within 3e-2 of the f64 oracle's peak (the oracle of the bf16
    image: the kernels' own error)."""
    import dataclasses

    from recfilter_tpu_torch.apps.dog import _stencil

    w3 = rft.gaussian_weights(5.0, 3)
    shape, axes = {"GS": ((512, 512), (0, 1)), "HS": ((200, 384), (0, 1)),
                   "D1": ((256, 1024), (1,)), "D1e": ((256, 1024), (1,)),
                   "C6b": ((2, 128, 512), (2,))}[case]
    rng = np.random.default_rng(len(case) + 30)
    x = torch.from_numpy((rng.standard_normal(shape) * 0.01).astype(
        np.float32)).to(torch.bfloat16)
    dims = [rft.Dim(nm, e) for nm, e in zip("zyx"[-len(shape):], shape)]
    F = rft.RecFilter(case)
    F[tuple(dims)] = x
    for ax in axes:
        F.add_filter(+dims[ax], w3)
        F.add_filter(-dims[ax], w3)
    F.split({dims[ax]: 128 for ax in axes})
    combine = (lambda y, a: y + 0.25 * a) if case == "D1e" else None
    if case in ("GS", "HS"):
        fn = F.as_func(stencil2d=SOBEL)
    else:
        F.set_plan(rotate_emit=2)
        taps = ([_stencil(5)["taps"], _stencil(9)["taps"]] if case == "C6b"
                else DERIV)
        st = {"taps": taps, "start": "zero", "end": "clamp"}
        fn = F.as_func(stencil=st, epilogue=combine)
    xr = x.float().transpose(-1, -2).contiguous()  # the rotated image
    aux = (xr.to(dev),) if combine else ()
    tl.reset_launches()
    y = fn(x.to(dev), *aux)
    torch.cuda.synchronize()
    launches = {
        "GS": _only(moments2d_bf16=1, final2d_stencil_bf16=1),
        "HS": _only(tails_bf16=2, completion_rot_bf16=2, stencil2d_bf16=1),
        "D1": _only(tails_extra_bf16=1, completion_rot_stencil_bf16=1),
        "D1e": _only(tails_extra_bf16=1, completion_rot_stencil_epi_bf16=1),
        "C6b": _only(tails_extra_bf16=2, completion_rot_stencil_bf16=2),
    }[case]
    assert tl.LAUNCHES == launches
    z = rft.oracle_apply(dataclasses.replace(F.spec, dtype="float32"),
                         x.double().numpy())
    if case in ("GS", "HS"):
        outs, wants = y, _bank64(z, SOBEL)
    else:
        zr = torch.from_numpy(np.swapaxes(z, -1, -2).copy())
        if case == "C6b":
            want = torch.stack([tdf.apply_stencil(zr[p], -2, t, "zero",
                                                  "clamp")
                                for p, t in enumerate(taps)])
        else:
            want = tdf.apply_stencil(zr, -2, taps, "zero", "clamp")
        if combine:
            want = combine(want, xr.double())
        outs, wants = (y,), (want.numpy(),)
    for c, (g, w) in enumerate(zip(outs, wants)):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        err = np.abs(g.double().cpu().numpy() - w).max() / np.abs(w).max()
        print(f"{case} bf16 channel {c}: {err:.3e} of the oracle's peak")
        assert err <= 3e-2


# ------------------- the last TPU kernel forms: fir_band_bf16, final2d_k_bf16

@pytest.mark.parametrize("form,L", [("plain", 1001), ("plain", 512),
                                    ("plain", 1000), ("bank", 512),
                                    ("contract", 1000)])
def test_fir_band_bf16_is_the_float32_kernel_at_one_product(form, L, dev):
    """fir_band_bf16 on a bf16 x, rotated and flat: the float32 entry at
    one product on the same values rounded once, bit for bit (a bf16
    value is its own one chunk), within one bf16 step of its twin
    (:func:`_one_ulp`), one launch; L = 1001 takes the one-value loads,
    L = 512 and 1000 the 16-byte ones (their windows' words a multiple of
    eight a line and not)."""
    from recfilter_tpu_torch.fir import _align_taps, box_taps
    from recfilter_tpu_torch.kernels import fir_band

    taps = _align_taps([box_taps(3, 3)] if form == "plain"
                       else [box_taps(3, 3), box_taps(9, 3)])
    contract = form == "contract"
    rng = np.random.default_rng(L)
    x = torch.from_numpy(rng.standard_normal(
        (2, 40, L) if contract else (40, L)).astype(np.float32)).to(
            dev).to(torch.bfloat16)
    for rot in (True, False):
        band = fir_band.FirBand(taps, rot=rot, contract=contract,
                                signs=[1.0, -1.0] if contract else None,
                                nprod=1).to(dev)
        tl.reset_launches()
        y = band(x)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(fir_band_bf16=1)
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, band(x.float()).to(torch.bfloat16))
        _one_ulp(f"fir_band_bf16 {form} L={L} rot={rot}", y, band.plain(x))
    with pytest.raises(TypeError):
        fir_band.FirBand(taps, contract=contract, nprod=3).to(dev)(x)


def test_final2d_k_bf16_matches_its_twin_within_the_z_rounding(dev):
    """final2d_k_bf16 against its twin: within the Z-rounding bound — a Z
    element whose fp32 sum lies within the two forms' summation distance
    (2⁻¹⁶ of the sum of its terms' magnitudes) of a bf16 rounding
    boundary may round to the other neighbour in one of them, moving y by
    that step times |Btot_b| — plus 2⁻¹⁶ of the second products' term
    magnitudes (their fp32 sums in another order). An all-zero output
    fails the bound; one launch, a float32 y."""
    bf = torch.bfloat16
    w3 = rft.gaussian_weights(5.0, 3)
    for Ta, K in ((32, 6), (128, 12)):
        a = [Scan(0, c, w3[0], tuple(w3[1:])) for _ in range(K // 6)
             for c in (True, False)]
        b = [Scan(1, c, 0.9, (0.6, 0.25, -0.1)) for _ in range(K // 6)
             for c in (True, False)]
        ma = tdf.prepare_dim_pass(a, Ta, NA, True)
        mb = tdf.prepare_dim_pass(b, T, NB, True)
        cat = lambda ms, ax: np.concatenate([np.asarray(m) for m in ms],
                                            axis=ax)
        fin = tk2d.Final2DK(ma.Btot, cat(ma.Rhat, 2), mb.Btot,
                            cat(mb.Rhat, 2), NA, NB,
                            matmul_dtype="bfloat16").to(dev)
        rng = np.random.default_rng(Ta)
        x, NAk, NBk = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev) for s in ((P, NA, Ta, NB * T),
                                           (P, NA, K, NB * T),
                                           (P, NA, NB, Ta, K)))
        tl.reset_launches()
        y = fin(x, NAk, NBk)
        torch.cuda.synchronize()
        assert tl.LAUNCHES == _only(final2d_k_bf16=1)
        assert y.dtype == torch.float32
        want = fin.plain(x, NAk, NBk)
        Ba, Bb = fin.Ban.to(bf).float(), fin.Bbn.to(bf).float()
        xb = x.to(bf).float()
        z = (torch.einsum("aos,pasw->paow", Ba, xb)
             + torch.einsum("aok,pakw->paow", fin.Ran, NAk))
        mag = (torch.einsum("aos,pasw->paow", Ba.abs(), xb.abs())
               + torch.einsum("aok,pakw->paow", fin.Ran.abs(), NAk.abs()))
        step = ((z + mag * 2.0 ** -16).to(bf).float()
                - (z - mag * 2.0 ** -16).to(bf).float()).abs()

        def dim_b(M, V):
            return torch.einsum("bot,pasbt->pasbo", M, V.reshape(
                P, NA, Ta, NB, T)).reshape(y.shape)

        lim = dim_b(Bb.abs(), step) + 2.0 ** -16 * (
            dim_b(Bb.abs(), z.to(bf).float().abs())
            + torch.einsum("bok,pabsk->pasbo", fin.Rbn.abs(),
                           NBk.abs()).reshape(y.shape))
        d = (y - want).abs()
        print(f"final2d_k_bf16 Ta={Ta} K={K}: max|k-t| {d.max().item():.3e},"
              f" {(d > 0).double().mean().item():.6f} of the elements "
              f"differ")
        assert bool((d <= lim).all())
        assert not bool((want.abs() <= lim).all())
