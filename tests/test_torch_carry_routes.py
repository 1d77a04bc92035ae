"""The 2-D executor's optional carry routes against the JAX package's.

``RECFILTER_PX2D_BK=1`` runs the dim-B carry glue and its solve as one
kernel (the JAX package's ``bsolve_pass``, the port's ``bsolve``),
``RECFILTER_PXM_NAF=1`` solves the dim-A carries inside pass 1 (the NAF
branch of ``moments2d_px``, the port's ``moments2d_naf``). The same numpy
inputs go through ``recfilter_tpu.overlap2d.fused_2d_px`` (px6, Pallas
interpret mode) and the port's ``Fused2DPx`` (plain twins on the CPU),
both built under the same variables. Bounds: 1e-5 of the peak against
the JAX package (as ``tests/test_torch_overlap2d.py``: its fp32 glue sits
a few 1e-6 off), 2e-6 (px6) against the f64 oracle. Spies on the JAX
package's ``bsolve_pass`` and ``moments2d_px`` tell which route it took,
and the port's ``carry_route`` / ``moments_route`` must agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recfilter_tpu import iir as jiir
from recfilter_tpu import overlap2d as jo2
from recfilter_tpu import scan_core as jsc
from recfilter_tpu import spec as jspec
from recfilter_tpu.kernels import final2d as jk2d

from recfilter_tpu_torch import overlap2d as to2
from recfilter_tpu_torch import spec as tspec

BK, NAF = "RECFILTER_PX2D_BK", "RECFILTER_PXM_NAF"
ROUTES = {"bk": (BK,), "naf": (NAF,), "both": (BK, NAF)}


def _scans(mod, kind):
    """Scans on x (axis 1) and y (axis 0): ``g3`` the σ=3 Gaussian,
    causal + anticausal per axis (ΣK = 6 each); ``o1`` one 1st-order scan
    per axis; ``o2`` 2nd-order scans (ΣK = 4 on x, 2 on y); ``k8`` ΣK = 8
    per axis (3 + 3 + 2)."""
    g = jiir.gaussian_weights(3.0, 3)
    gs = lambda ax, c: mod.Scan(ax, c, g[0], tuple(g[1:]))
    if kind == "g3":
        return [gs(1, True), gs(1, False), gs(0, True), gs(0, False)]
    if kind == "o1":
        return [mod.Scan(1, True, 0.4, (0.6,)),
                mod.Scan(0, False, 0.5, (0.5,))]
    if kind == "o2":
        return [mod.Scan(1, True, 1.0, (0.5, 0.2)),
                mod.Scan(1, False, 0.8, (0.6, -0.1)),
                mod.Scan(0, True, 1.0, (0.4, 0.3))]
    assert kind == "k8"
    o2 = lambda ax, c: mod.Scan(ax, c, 0.7, (0.5, 0.2))
    return [gs(1, True), gs(1, False), o2(1, True),
            gs(0, True), gs(0, False), o2(0, False)]


def _img(h, w, seed):
    return np.random.default_rng(seed).standard_normal((h, w)).astype(
        np.float32)


def _split(scans):
    return ([s for s in scans if s.axis == 0],
            [s for s in scans if s.axis == 1])


def _jax_routes(monkeypatch):
    """Spy on the JAX package's executor: which of its optional kernels
    ran in the last ``fused_2d_px``."""
    seen = {"bk": False, "naf": False}
    bsolve, moments = jk2d.bsolve_pass, jk2d.moments2d_px

    def bsolve_spy(*a, **k):
        seen["bk"] = True
        return bsolve(*a, **k)

    def moments_spy(*a, **k):
        out = moments(*a, **k)
        seen["naf"] = bool(out[-1])
        return out

    monkeypatch.setattr(jk2d, "bsolve_pass", bsolve_spy)
    monkeypatch.setattr(jk2d, "moments2d_px", moments_spy)
    return seen


def _both(monkeypatch, x, kind, border, env, **port_kw):
    """(JAX output, the JAX routes, the port's module) for ``x`` under the
    variables ``env``."""
    for var in (BK, NAF):
        monkeypatch.delenv(var, raising=False)
    for var in env:
        monkeypatch.setenv(var, "1")
    seen = _jax_routes(monkeypatch)
    ja, jb = _split(_scans(jspec, kind))
    ta, tb = _split(_scans(tspec, kind))
    want = jo2.fused_2d_px(jnp.asarray(x), 0, ja, 1, jb, border, 6, True)
    assert want is not None
    mod = to2.Fused2DPx(ta, tb, *x.shape, border, **port_kw)
    return np.asarray(want), dict(seen), mod


def _oracle(x, kind, border):
    h, w = x.shape
    spec = jspec.FilterSpec("R", (jspec.Dim("y", h), jspec.Dim("x", w)),
                            tuple(_scans(jspec, kind)), border=border)
    return jsc.oracle_apply(spec, x.astype(np.float64))


def _err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / \
        np.abs(want).max()


CASES = [(256, 512, "zero", "g3"), (256, 512, "clamp", "o1"),
         (256, 512, "zero", "o2"), (256, 512, "clamp", "k8"),
         (384, 1024, "clamp", "g3"), (384, 1024, "zero", "k8")]


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("h,w,border,kind", CASES)
def test_route_matches_jax_and_oracle(h, w, border, kind, route,
                                      monkeypatch):
    x = _img(h, w, seed=h + w)
    want, seen, mod = _both(monkeypatch, x, kind, border, ROUTES[route])
    assert seen == {"bk": "bk" in route or route == "both",
                    "naf": "naf" in route or route == "both"}
    assert mod.carry_route == ("bsolve" if seen["bk"] else "glue")
    assert mod.moments_route == ("naf" if seen["naf"] else "raw")
    got = mod(torch.from_numpy(x))
    assert got.shape == (h, w) and got.dtype == torch.float32
    assert _err(got.numpy(), want) <= 1e-5
    assert _err(got.numpy(), _oracle(x, kind, border)) <= 2e-6


@pytest.mark.parametrize("border", ["zero", "clamp"])
def test_twins_equal_the_glue(border):
    """``BSolve.plain64`` and ``Moments2D.solve_plain`` (the twins of the
    two kernels' solves) give the glue route's float64 carries at
    1e-12, and each route's ``forward_plain`` the glue's output at 1e-6
    (its carries pass through float32 between kernels)."""
    h, w = 256, 512
    ta, tb = _split(_scans(tspec, "g3"))
    glue = to2.Fused2DPx(ta, tb, h, w, border, bsolve=False, naf=False)
    fused = to2.Fused2DPx(ta, tb, h, w, border, bsolve=True, naf=True)
    assert (glue.carry_route, glue.moments_route) == ("glue", "raw")
    assert (fused.carry_route, fused.moments_route) == ("bsolve", "naf")
    x = torch.from_numpy(_img(h, w, seed=3))
    X4 = glue.tile(x)
    NA64, NB64 = glue._carries(X4)
    assert NA64.dtype == NB64.dtype == torch.float64
    bA, term1 = glue.moments.plain(X4)
    peak = lambda t: t.abs().max().item()
    NA = fused.moments.solve_plain(bA)
    assert (NA - NA64).abs().max().item() <= 1e-12 * peak(NA64)
    NB = fused.bsolve.plain64(NA64, term1)
    assert (NB - NB64).abs().max().item() <= 1e-12 * peak(NB64)
    # the NAF twin's first output is that solve, rounded once
    assert torch.equal(fused.moments.plain(X4)[0], NA.float())
    # NB's pad slots are zero
    assert not NB.reshape(1, 2, 4, 8, 128)[:, :, :, 6:].any()
    want = glue.forward_plain(x)
    for bs, nf in ((True, False), (False, True), (True, True)):
        mod = to2.Fused2DPx(ta, tb, h, w, border, bsolve=bs, naf=nf)
        got = mod.forward_plain(x)
        assert torch.equal(got, mod(x))  # the CPU forward runs the twins
        assert (got - want).abs().max().item() <= 1e-6 * peak(want)


def test_gradient_through_the_fused_routes():
    """autograd through both routes' twins equals the glue route's."""
    ta, tb = _split(_scans(tspec, "o2"))
    x = torch.from_numpy(_img(256, 256, seed=9))
    grads = []
    for bs, nf in ((False, False), (True, True)):
        mod = to2.Fused2DPx(ta, tb, 256, 256, "zero", bsolve=bs, naf=nf)
        xg = x.clone().requires_grad_()
        (g,) = torch.autograd.grad((mod(xg) ** 2).sum(), xg)
        grads.append(g)
    assert (grads[0] - grads[1]).abs().max().item() <= \
        1e-5 * grads[0].abs().max().item()


@pytest.mark.parametrize("h,w,border,kind,bank,bk,naf", [
    # 64 tiles on x: dim B banded (and term1 past 6 MiB), no bsolve
    (256, 8192, "zero", "g3", None, False, True),
    # 64 tiles on y: dim A banded, no NAF
    (8192, 256, "clamp", "g3", None, True, False),
    # one tile on y: no carries cross a tile, the zero solve matrix is its
    # own band (banded_solve_blocks), no NAF
    (128, 512, "zero", "o2", None, True, False),
    # a stencil bank: neither
    (256, 256, "zero", "g3", [[(-1, 0, 1.0), (1, 1, -0.5)]], False, False),
], ids=["banded-b", "banded-a", "one-tile-a", "stencil2d"])
def test_gates_agree_with_jax(h, w, border, kind, bank, bk, naf,
                              monkeypatch):
    """Both variables set: each route where the JAX gate holds, the glue
    where it declines; asking for a declined route raises, naming the
    gate."""
    x = _img(h, w, seed=1)
    for var in (BK, NAF):
        monkeypatch.setenv(var, "1")
    seen = _jax_routes(monkeypatch)
    ja, jb = _split(_scans(jspec, kind))
    ta, tb = _split(_scans(tspec, kind))
    jo2.fused_2d_px(jnp.asarray(x), 0, ja, 1, jb, border, 6, True,
                    stencil2d=bank)
    assert seen == {"bk": bk, "naf": naf}
    mod = to2.Fused2DPx(ta, tb, h, w, border, stencil2d=bank)
    assert mod.carry_route == ("bsolve" if bk else "glue")
    assert mod.moments_route == ("naf" if naf else "raw")
    if not bk:
        with pytest.raises(NotImplementedError, match="bsolve: .*(banded|"
                           "stencil2d)"):
            to2.Fused2DPx(ta, tb, h, w, border, stencil2d=bank, bsolve=True)
    if not naf:
        with pytest.raises(NotImplementedError, match="naf: .*(banded|"
                           "stencil2d)"):
            to2.Fused2DPx(ta, tb, h, w, border, stencil2d=bank, naf=True)


def test_variables_unset_keep_the_glue(monkeypatch):
    """Neither variable set (or set to anything but "1"): the glue on both
    packages; False keeps the glue even where a variable asks."""
    x = _img(256, 512, seed=2)
    monkeypatch.setenv(NAF, "0")
    want, seen, mod = _both(monkeypatch, x, "g3", "zero", ())
    assert seen == {"bk": False, "naf": False}
    assert (mod.carry_route, mod.moments_route) == ("glue", "raw")
    assert mod.bsolve is None and not mod.moments.solve
    monkeypatch.setenv(BK, "1")
    monkeypatch.setenv(NAF, "1")
    ta, tb = _split(_scans(tspec, "g3"))
    off = to2.Fused2DPx(ta, tb, 256, 512, "zero", bsolve=False, naf=False)
    assert (off.carry_route, off.moments_route) == ("glue", "raw")
    assert _err(off(torch.from_numpy(x)).numpy(), want) <= 1e-5


def test_route_is_read_once_at_construction(monkeypatch):
    """The variables are read when the module is built, not per call."""
    ta, tb = _split(_scans(tspec, "o1"))
    monkeypatch.setenv(BK, "1")
    mod = to2.Fused2DPx(ta, tb, 256, 256, "zero")
    monkeypatch.delenv(BK)
    assert mod.carry_route == "bsolve"
    x = torch.from_numpy(_img(256, 256, seed=4))
    assert torch.equal(mod(x), mod.forward_plain(x))
