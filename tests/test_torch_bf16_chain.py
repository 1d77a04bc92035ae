"""bf16 storage on the rotation chain, the per-axis loop and the rotated
emit: ``TailsPass`` and ``CompletionPass`` (unrotated, rotated, with an
affine epilogue, with the next pass's tails) on a bf16 x, then the routes —
the chain on an image (the JAX package's own bf16 test filter, and the
Gaussian twice per axis, ΣK = 12), a volume whose rows gates decline, a
volume whose trailing pair declines after its rows pass, the per-axis loop
(y only; x and z of a volume), the 1-D pass with and without an affine
epilogue, and ``rotate_emit``.

Same seeded numpy inputs through the JAX package (its Pallas kernels in
interpret mode, as ``tests/test_dimfuse.py:819`` runs its bf16 mode; its
3-touch executor switched off where its chain is the reference, as that
test's ``old_px_chain`` fixture does) and through the port's plain twins on
the CPU. Bounds (:func:`_held`): both packages within 3e-2 of the f64
oracle's peak, the port within twice the JAX package's own error or 2⁻⁸ of
the peak, whichever is larger. ``TailsPass`` on bf16 equals its float32
path bit for bit, each bf16 completion is its float32 path on the same
values rounded once, and a chained run equals the unchained one bit for
bit (the chained tails are summed from the rounded outputs). The refusals
of the forms still to port are in ``tests/test_torch_bf16_storage.py``;
the CUDA kernels are held to these twins on a card by
``tests/test_torch_cuda.py``.
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

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf
from recfilter_tpu_torch import spec as tspec
from recfilter_tpu_torch.epilogue import affine_form
from recfilter_tpu_torch.kernels import completion as tc

T = 128
BF16_BOUND = 3e-2  # the JAX package's bound of its bf16 mode


def _mix(y, a):  # E1's dry/wet mix
    return 0.7 * y + 0.3 * a


def _img(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16(a):
    """A float32 array rounded to bf16 (round to nearest even), as float32
    values."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _err(got, want):
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _held(got, jax_out, want):
    """Both outputs within :data:`BF16_BOUND` of the float64 reference
    ``want``'s peak, the port within twice the JAX package's error or 2⁻⁸
    of the peak. Returns the two errors."""
    e_port, e_jax = _err(_np(got), want), _err(_np(jax_out), want)
    assert e_jax <= BF16_BOUND, e_jax
    assert e_port <= BF16_BOUND, e_port
    assert e_port <= max(2.0 * e_jax, 2.0 ** -8), (e_port, e_jax)
    return e_port, e_jax


# ------------------------------------------------------------- the kernels

def _stack(kind, rows, cols, n, rng, scale=1.0):
    M = [rng.standard_normal((rows, cols)) * scale for _ in range(3)]
    if kind == "uniform":
        return M[0][None]
    return np.stack([M[1]] + [M[0]] * (n - 2) + [M[2]])


def _pass_inputs(kind, n, q, S, seed):
    """Btot, Rcat, a bf16-valued x (q, n, T) and carries N (n, 8, q)."""
    rng = np.random.default_rng(seed)
    Btot = _stack(kind, T, T, n, rng, 0.1)
    Rcat = _stack(kind, T, S, n, rng, 0.5)
    x = _bf16(rng.standard_normal((q, n, T)).astype(np.float32))
    N = np.zeros((n, 8, q), np.float32)
    N[:, :S] = rng.standard_normal((n, S, q))
    return Btot, Rcat, x, N


def _f64_product(Btot, Rcat, x, N):
    """Y (q, n, T) in float64."""
    n, S = x.shape[1], Rcat.shape[-1]
    pick = lambda M: M[np.minimum(np.arange(n), M.shape[0] - 1)]  # noqa
    return (np.einsum("nos,qns->qno", pick(Btot), x.astype(np.float64))
            + np.einsum("nou,nuq->qno", pick(Rcat),
                        N[:, :S].astype(np.float64)))


@pytest.mark.parametrize("kind", ["uniform", "clamp"])
def test_tails_takes_bf16_to_the_float32_bits(kind):
    """``TailsPass`` on a bf16 x: float32 tails, bit-equal to its float32
    path on the same values, within 1e-6 of the float64 tails, and
    against ``tails_pass(nprod=1)`` on the bf16 x as :func:`_held` says."""
    n, q, S = 3, 24, 6
    rng = np.random.default_rng(len(kind))
    G = _stack(kind, S, T, n, rng, 0.1)
    x = _bf16(rng.standard_normal((q, n, T)).astype(np.float32))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    mod = tc.TailsPass(G, n)
    got = mod(xb)
    assert got.dtype == torch.float32 and got.shape == (n, 8, q)
    assert torch.equal(got, mod(torch.from_numpy(x)))
    want = np.einsum("nst,qnt->nsq", tc._per_tile(G, n),
                     x.astype(np.float64))
    jax_out = jc.tails_pass(jnp.asarray(x, jnp.bfloat16), G, nprod=1,
                            interpret=True)
    e_port, _ = _held(got[:, :S], _np(jax_out)[:, :S], want)
    assert e_port <= 1e-6


EPIS = {"plain": None, "affine": _mix}


def _clip_mix(y, a):
    """A non-affine epilogue, max(y, a) − 0.3·y, on torch, numpy or jax
    arrays."""
    m = (torch if isinstance(y, torch.Tensor)
         else np if isinstance(y, np.ndarray) else jnp)
    return m.maximum(y, a) - 0.3 * y


# the routes' epilogues: none, the affine mix (in the kernel's store) and
# a non-affine one (torch ops on the kernel's bf16 output, in float32)
ROUTE_EPIS = {**EPIS, "clip": _clip_mix}


@pytest.mark.parametrize("epi", list(EPIS))
@pytest.mark.parametrize("rot", [False, True], ids=["split", "rot"])
def test_completion_takes_bf16_at_one_product(rot, epi):
    """``CompletionPass(nprod=1)`` on a bf16 x returns bf16 — unrotated
    (``completion_split_bf16``, ``_epi_bf16``) and rotated
    (``completion_rot_bf16``, ``_epi_bf16``): its float32 path on the same
    values, the affine epilogue (aux float32) included, rounded once; and
    against ``completion_pass(nprod=1)`` on the bf16 x as :func:`_held`
    says. px6 refuses a bf16 x (the stencil on bf16:
    ``tests/test_torch_bf16_stencil.py``)."""
    n, q, S = 3, 40, 6
    Btot, Rcat, x, N = _pass_inputs("clamp", n, q, S, seed=3 + rot)
    fn = EPIS[epi]
    shape = (n * T, q) if rot else (q, n, T)
    aux = _img(*shape, seed=9, scale=0.5)
    mod = tc.CompletionPass(Btot, Rcat, n, rot=rot, nprod=1,
                            affine=affine_form(fn) if fn else None)
    xb, tN = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(N)
    ex = (torch.from_numpy(aux),) if fn else ()
    got = mod(xb, tN, *ex)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    assert torch.equal(got, mod(torch.from_numpy(x), tN, *ex).to(
        torch.bfloat16))
    flat = (n * T, q) if rot else (q, n * T)
    kw = dict(epilogue=fn, eaux=(jnp.asarray(aux.reshape(flat)),)) \
        if fn else {}
    jax_out = jc.completion_pass(jnp.asarray(x, jnp.bfloat16), Btot, Rcat,
                                 jnp.asarray(N), rot=rot, nprod=1,
                                 interpret=True, carries_transposed=True,
                                 **kw)
    assert jax_out.dtype == jnp.bfloat16
    want = _f64_product(Btot, Rcat, x, N)
    if rot:
        want = want.transpose(1, 2, 0).reshape(n * T, q)
    if fn:
        want = fn(want, aux.astype(np.float64))
    _held(got, _np(jax_out).reshape(shape), want)
    with pytest.raises(ValueError, match="one product"):
        tc.CompletionPass(Btot, Rcat, n, rot=rot, nprod=6)(xb, tN)


def test_next_tails_take_bf16_from_the_rounded_output():
    """``CompletionPass(rot=True, next_tails=, nprod=1)`` on a bf16 x: a
    bf16 output, its float32 path rounded once, and next-pass tails that
    are ``TailsPass``'s float32 tails of that bf16 output, bit for bit —
    what the next pass would read from it unchained (the JAX package sums
    them from its float32 accumulators: ROADMAP Queue 3); both against
    ``completion_pass(next_tails=)`` as :func:`_held` says."""
    n, n2, S, S2, ra = 3, 2, 6, 5, 2
    q = ra * n2 * T
    Btot, Rcat, x, N = _pass_inputs("clamp", n, q, S, seed=5)
    rng = np.random.default_rng(6)
    G2 = _stack("clamp", S2, T, n2, rng, 0.1)
    mod = tc.CompletionPass(Btot, Rcat, n, rot=True, next_tails=(G2, n2),
                            nprod=1)
    xb, tN = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(N)
    y, t2 = mod(xb, tN)
    assert y.dtype == torch.bfloat16 and t2.dtype == torch.float32
    assert torch.equal(y, mod(torch.from_numpy(x), tN)[0].to(
        torch.bfloat16))
    G2f = G2.astype(np.float32)  # the rows the kernels read
    assert torch.equal(t2, tc.TailsPass(G2f, n2)(y.reshape(-1, n2, T)))
    yj, tj = jc.completion_pass(jnp.asarray(x, jnp.bfloat16), Btot, Rcat,
                                jnp.asarray(N), rot=True, nprod=1,
                                interpret=True, carries_transposed=True,
                                next_tails=(G2, n2, T))
    want = _f64_product(Btot, Rcat, x, N).transpose(1, 2, 0).reshape(
        n * T, q)
    _held(y, _np(yj).reshape(n * T, q), want)
    want2 = np.einsum("cst,lct->csl", tc._per_tile(G2, n2),
                      want.reshape(-1, n2, T))
    _held(t2[:, :S2], _np(tj).reshape(n2, 8, -1)[:, :S2], want2)


# ------------------------------------------------------------ the routes

def _spec(m, shape, scans, tiles=None, border="zero", dtype="bfloat16"):
    names = "wzyx"[-len(shape):]
    return m.FilterSpec("B", tuple(m.Dim(nm, e) for nm, e in
                                   zip(names, shape)),
                        tuple(m.Scan(*s) for s in scans), border=border,
                        dtype=dtype, tile_widths=tiles or (T,) * len(shape))


def _gauss(axes, times=1):
    w3 = rft.gaussian_weights(5.0, 3)
    return [(ax, c, w3[0], tuple(w3[1:])) for ax in axes
            for _ in range(times) for c in (True, False)]


# the JAX package's own bf16 chain filter (tests/test_dimfuse.py:819)
JAX_BF16 = [(1, True, 0.9, (0.6, 0.2)), (0, False, 1.05, (0.4, 0.15))]


def _oracle(js, x):
    return jsc.oracle_apply(dataclasses.replace(js, dtype="float32"),
                            x.astype(np.float64))


def _jax_run(js, x, monkeypatch, chain=False):
    """The JAX package's ``apply_filter_fused`` on the bf16 x (its 3-touch
    executor off where ``chain``), counting its ``tails_pass`` calls and
    each ``completion_pass``'s x dtype and product count."""
    tails, comps = [], []
    orig_t, orig_c = jc.tails_pass, jc.completion_pass

    def spy_t(*a, **k):
        tails.append(1)
        return orig_t(*a, **k)

    def spy_c(xq, *a, **k):
        comps.append((xq.dtype, k.get("nprod")))
        return orig_c(xq, *a, **k)

    monkeypatch.setattr(jc, "tails_pass", spy_t)
    monkeypatch.setattr(jc, "completion_pass", spy_c)
    if chain:
        monkeypatch.setattr(jdf, "_OVERLAP_PX_2D", False)
    y = jdf.apply_filter_fused(js, jnp.asarray(x, jnp.bfloat16))
    assert y.dtype == jnp.bfloat16
    assert all(c == (jnp.bfloat16, 1) for c in comps), comps
    return _np(y), len(tails), len(comps)


def _port_chain(ts):
    groups = {ax: [ts.scans[i] for i in ids]
              for ax, ids in ts.scans_by_axis().items()}
    return tdf.RotationChain(groups, [d.extent for d in ts.dims],
                             ts.tile_widths, ts.border, "px6",
                             dtype=torch.bfloat16)


def _unchained(mod, xb):
    """``mod``'s output with every pass's next-tails completion off."""
    for p in mod.passes:
        p.completion_nt = None
    return mod(xb)


CHAINS = {
    # name: (shape, scans, border, the port's tails_in per pass, JAX's
    # tails_pass calls, whether the JAX package needs its pair switched off;
    # on the volume the JAX package reads y's tails where the port chains
    # them: its gate asks its line block to hold whole next-pass extents,
    # kernels/completion.py's next_tails_ok)
    "jax-bf16-filter": ((256, 256), JAX_BF16, "zero", [False, True], 1,
                        True),
    "sigma5-twice-clamp": ((256, 256), _gauss((0, 1), 2), "clamp",
                           [False, False], 2, False),
    "volume-rows-decline": ((136, 128, 256), _gauss((0, 1, 2)), "zero",
                            [False, True, False], 3, False),
}


@pytest.mark.parametrize("case", list(CHAINS))
def test_the_chain_in_bf16_matches_jax_and_the_oracle(case, monkeypatch):
    """The rotation chain at bf16 storage: every pass on ``tails_bf16`` /
    ``completion_rot_bf16`` (``completion_rot_tails_bf16`` where it hands
    the next pass its tails) at one product, a bf16 output; the JAX
    package's chain on the bf16 image, every completion on bf16 at one
    product, as many tails reads; chained equal to unchained bit for bit;
    :func:`_held` against the oracle of the bf16 input."""
    shape, scans, border, taken, jax_tails, off = CHAINS[case]
    js, ts = (_spec(m, shape, scans, border=border) for m in (jspec, tspec))
    x = _bf16(_img(*shape, seed=sum(shape), scale=0.1))
    jax_out, n_tails, n_comp = _jax_run(js, x, monkeypatch, chain=off)
    assert n_comp == len(shape)
    mod = _port_chain(ts) if off else tdf.fused_filter_module(ts)
    assert isinstance(mod, tdf.RotationChain)
    assert all(p.nprod == 1 and p.completion is not None
               for p in mod.passes)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mod(xb)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    assert mod.tails_in_taken == taken and n_tails == jax_tails
    assert torch.equal(got, mod.forward_plain(xb))
    assert torch.equal(got, _unchained(mod, xb))
    _held(got, jax_out, _oracle(js, x))


def test_a_volume_whose_pair_declines_after_its_rows_pass():
    """A bf16 volume whose trailing pair (the Gaussian twice per axis, ΣK
    = 12) the 3-touch executor declines: the rows pass on bf16, then the
    chain on the pair in bf16, per leading slice (the JAX package's
    route; its interpret mode would run two passes of 128 slices' kernels
    here, so it is not run), within 3e-2 of the oracle's peak."""
    shape = (128, 128, 128)
    scans = _gauss((0,)) + _gauss((1, 2), 2)
    ts = _spec(tspec, shape, scans)
    x = _bf16(_img(*shape, seed=31, scale=0.1))
    mod = tdf.fused_filter_module(ts)
    assert isinstance(mod, tdf.StagedPass) and mod.route == "volume"
    rows, chain = mod.stages
    assert isinstance(chain, tdf.RotationChain)
    assert rows.dtype == chain.dtype == torch.bfloat16
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mod(xb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mod.forward_plain(xb))
    assert _err(_np(got), _oracle(_spec(jspec, shape, scans), x)) <= \
        BF16_BOUND


LOOPS = {
    # name: (shape, scans, the port's stage types)
    "y-only": ((256, 128), _gauss((0,)), ["FusedRowsPx"]),
    "x-and-z": ((128, 8, 256), _gauss((0, 2)),
                ["FusedRowsPx", "FusedLastAxis"]),
    "y-only-rows-decline": ((136, 128), _gauss((0,)), ["FusedAxisPass"]),
}


@pytest.mark.parametrize("case", list(LOOPS))
def test_the_per_axis_loop_in_bf16(case, monkeypatch):
    """The per-axis loop at bf16 storage: the rows pass on a non-last axis
    (``rows_tails_bf16``, ``rows_final_bf16``; where the rows gates decline,
    ``FusedAxisPass`` on the rotated kernels), ``tails_bf16`` +
    ``completion_split_bf16`` on the last axis; a bf16 output, and
    :func:`_held` against the JAX package's loop on the bf16 image."""
    shape, scans, kinds = LOOPS[case]
    js, ts = (_spec(m, shape, scans) for m in (jspec, tspec))
    x = _bf16(_img(*shape, seed=len(case), scale=0.1))
    jax_out, _, _ = _jax_run(js, x, monkeypatch)
    mod = tdf.fused_filter_module(ts)
    stages = list(getattr(mod, "stages", [mod]))
    assert [type(s).__name__ for s in stages] == kinds
    assert all(s.dtype == torch.bfloat16 for s in stages)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mod(xb)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    assert torch.equal(got, mod.forward_plain(xb))
    _held(got, jax_out, _oracle(js, x))


def _epilogue_in_float32(mod, fn, xb, ex, got):
    """A non-affine epilogue runs as torch ops on the kernel's bf16 output
    taken to float32 and rounds once more: ``got`` is ``fn`` of the pass's
    output without the epilogue, in float32, rounded to bf16."""
    if fn is None or mod.body.epilogue_route == "kernel":
        return
    mod.body.epilogue = None
    y = mod(xb)
    assert y.dtype == torch.bfloat16
    assert torch.equal(got, fn(y.float(), *ex).to(torch.bfloat16))


@pytest.mark.parametrize("epi", list(ROUTE_EPIS))
def test_the_1d_pass_in_bf16(epi, monkeypatch):
    """The order-2 audio filter on 8 channels × 4096 samples at bf16
    storage, alone, with E1's dry/wet mix as an affine epilogue and with a
    non-affine one: ``tails_bf16`` then ``completion_split_bf16``
    (``_epi_bf16``, its aux float32, ``epilogue_route`` "kernel", for the
    mix; the non-affine one as torch ops in float32 on the kernel's
    output); against the JAX package's ``fused_dim_pass`` kernel route on
    the bf16 signal (which applies any epilogue to the float32
    accumulator) and the oracle."""
    shape = (8, 4096)
    scans = [(1, True, 1.0, (1.6, -0.64))]
    js, ts = (_spec(m, shape, scans) for m in (jspec, tspec))
    x = _bf16(_img(*shape, seed=11, scale=0.1))
    aux = _img(*shape, seed=12, scale=0.1)
    fn = ROUTE_EPIS[epi]
    mod = tdf.fused_filter_module(ts, epilogue=fn)
    assert isinstance(mod, tdf.FusedLastAxis)
    body = mod.body
    assert isinstance(body, tdf.LastAxisPass) and body.nprod == 1
    assert body.epilogue_route == {"plain": None, "affine": "kernel",
                                   "clip": "torch"}[epi]
    ex = (torch.from_numpy(aux),) if fn else ()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mod(xb, *ex)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, mod.forward_plain(xb, *ex))
    kw = dict(epilogue=fn, eaux=(jnp.asarray(aux),)) if fn else {}
    jax_out = jdf.apply_filter_fused(js, jnp.asarray(x, jnp.bfloat16), **kw)
    want = _oracle(js, x)
    if fn:
        want = fn(want, aux.astype(np.float64))
    _held(got, jax_out, want)
    _epilogue_in_float32(mod, fn, xb, ex, got)


@pytest.mark.parametrize("epi", list(ROUTE_EPIS))
def test_rotate_emit_in_bf16(epi):
    """``rotate_emit=2`` on a bf16 image (``RotatedPass``: the x pass
    emitted rotated on ``completion_rot_bf16``, with E1's mix as an affine
    epilogue on ``completion_rot_epi_bf16``, aux in the rotated layout, and
    with a non-affine epilogue as torch ops in float32 on the kernel's
    output); against ``apply_filter_rotated`` on the bf16 image and the
    oracle."""
    h, w = 64, 256
    scans = _gauss((1,))
    js, ts = (_spec(m, (h, w), scans) for m in (jspec, tspec))
    x = _bf16(_img(h, w, seed=13, scale=0.1))
    aux = _img(w, h, seed=14, scale=0.1)
    fn = ROUTE_EPIS[epi]
    mod = tdf.RotatedPass(ts, 2, epilogue=fn)
    assert mod.body.nprod == 1 and mod.body.completion is not None
    ex = (torch.from_numpy(aux),) if fn else ()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = mod(xb, *ex)
    assert got.dtype == torch.bfloat16 and got.shape == (w, h)
    kw = dict(epilogue=fn, eaux=(jnp.asarray(aux),)) if fn else {}
    jax_out = jdf.apply_filter_rotated(js, jnp.asarray(x, jnp.bfloat16),
                                       rot_axes=2, **kw)
    want = _oracle(js, x).T
    if fn:
        want = fn(want, aux.astype(np.float64))
    _held(got, jax_out, want)
    _epilogue_in_float32(mod, fn, xb, ex, got)


def test_realize_runs_the_chain_in_bf16():
    """``RecFilter.realize()`` on a bf16 image whose pair declines (ΣK =
    12): the rotation chain, a bf16 output equal to ``as_func``'s module
    on the same image."""
    h, w = 128, 256
    x = _bf16(_img(h, w, seed=17, scale=0.1))
    X, Y = rft.Dim("x", w), rft.Dim("y", h)
    F = rft.RecFilter("K1")
    F[Y, X] = torch.from_numpy(x).to(torch.bfloat16)
    wts = rft.gaussian_weights(5.0, 3)
    for d in (+X, -X, +Y, -Y) * 2:
        F.add_filter(d, wts)
    F.split(X, T, Y, T)
    got = F.realize(device="cpu")
    mod = F.as_func(device="cpu")
    assert isinstance(mod, tdf.RotationChain) and got.dtype == torch.bfloat16
    assert torch.equal(got, mod(torch.from_numpy(x)))


# ----------------------------------------------------- the kernels' layouts

def test_bf16_stages_are_conflict_free():
    """Models of the bf16 shared-memory reads. ``completion_tc.cuh``'s x
    stage (rows of LDX = 144 bf16): a half warp's 8-byte fragment reads —
    rows r = lane / 4 and r + 8, four samples at k0 + 4·(lane % 4) — touch
    32 distinct banks. ``tails.cu``'s ring (rows of 136 bf16, one row a
    thread): a quarter warp's 16-byte reads touch distinct banks, and each
    row starts 16-byte aligned for cp.async."""
    ldx = 144
    for k0 in range(0, T, 16):
        for half in range(2):
            for h in range(2):
                banks = []
                for lane in range(16 * half, 16 * half + 16):
                    r, qd = lane // 4 + 8 * h, lane % 4
                    byte = (r * ldx + k0 + 4 * qd) * 2
                    banks += [(byte // 4 + i) % 32 for i in range(2)]
                assert sorted(banks) == list(range(32))
    rs = T + 8
    assert rs * 2 % 16 == 0 and ldx * 2 % 16 == 0
    for tau in range(0, T, 8):
        for quarter in range(4):
            banks = []
            for tid in range(8 * quarter, 8 * quarter + 8):
                byte = (tid * rs + tau) * 2
                banks += [(byte // 4 + i) % 32 for i in range(4)]
            assert sorted(banks) == list(range(32))


def test_packed_rotated_store_writes_whole_sectors():
    """A model of ``completion_rot.cuh``'s ``rot_store_packed``: for each j,
    lane L (r = L / 4, qd = L % 4) holds v[e][h], output 8j + 2qd + e at
    line r + 8h; after the xor-4 and xor-8 shuffles and the byte selects,
    every lane stores four consecutive lines of one output, all 128 values
    once, and the four lanes of an output cover its 16 lines: 32
    consecutive bytes a row an instruction."""
    val = {(lane, e, h): (2 * (lane % 4) + e, lane // 4 + 8 * h)
           for lane in range(32) for e in range(2) for h in range(2)}
    w = {}
    for lane in range(32):
        c = (lane >> 2) & 1
        for h in range(2):
            p = [val[(lane, 0, h)], val[(lane, 1, h)]]
            o = [val[(lane ^ 4, 0, h)], val[(lane ^ 4, 1, h)]]
            w[(lane, h)] = [o[1], p[1]] if c else [p[0], o[0]]
    stores = {}
    for lane in range(32):
        b = (lane >> 3) & 1
        got = w[(lane ^ 8, 0 if (lane ^ 8) >> 3 & 1 else 1)]
        words = got + w[(lane, 1)] if b else w[(lane, 0)] + got
        c = (lane >> 2) & 1
        line = 8 * b + 4 * (lane >> 4)
        out = 2 * (lane % 4) + c
        assert words == [(out, line + i) for i in range(4)], (lane, words)
        stores.setdefault(out, []).append(line)
    assert sorted(stores) == list(range(8))
    assert all(sorted(v) == [0, 4, 8, 12] for v in stores.values())
