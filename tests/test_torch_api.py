"""The port's public API: the headline filter through ``RecFilter``, what
it refuses, and that the package never imports jax.

The headline filter is ``bench.py::_build_filter``: a 3rd-order Gaussian
(σ=5), causal and anticausal on x and y, 128-wide tiles, zero border,
float32, precision px6 — here at 256² so it runs in a second on the CPU.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recfilter_tpu as jrf
from recfilter_tpu import dimfuse as jdf
from recfilter_tpu import scan_core as jsc

import recfilter_tpu_torch as rft
from recfilter_tpu_torch import dimfuse as tdf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build(rf, h, w, image, clamp=False, tile=128, precision=None):
    """``bench.py::_build_filter`` written once against either package."""
    wts = rf.gaussian_weights(5.0, 3)
    x, y = rf.Dim("x", w), rf.Dim("y", h)
    F = rf.RecFilter("GaussianIIR")
    if clamp:
        F.set_clamped_image_border()
    F[y, x] = image
    for d in (+x, -x, +y, -y):
        F.add_filter(d, wts)
    F.split(x, tile, y, tile)
    if precision:
        F.set_plan(matmul_precision=precision)
    return F


def _img(h, w, seed=0):
    return (np.random.default_rng(seed).standard_normal((h, w)) * 0.01
            ).astype(np.float32)


@pytest.mark.parametrize("clamp", [False, True])
def test_headline_filter_matches_jax_and_oracle(clamp):
    img = _img(256, 256)
    Ft = _build(rft, 256, 256, img, clamp)
    Fj = _build(jrf, 256, 256, img, clamp)
    got = Ft.realize(device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    oracle = jsc.oracle_apply(Fj.spec, img.astype(np.float64))
    peak = np.abs(oracle).max()
    # the px6 bound (tests/test_dimfuse.py) against the f64 oracle
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    # the JAX px6 path itself sits ~4e-6·peak from the oracle on this
    # σ=5 filter, so the two packages agree to 1e-5·peak
    want = np.asarray(Fj.realize(jnp.asarray(img)))
    assert np.abs(got - want).max() <= 1e-5 * peak


def test_as_func_is_a_module_with_buffers():
    img = _img(256, 256, seed=1)
    F = _build(rft, 256, 256, img, precision="px6")
    mod = F.as_func(device="cpu")
    assert isinstance(mod, rft.Fused2DPx)
    names = {n for n, _ in mod.named_buffers()}
    assert {"CMa_p", "CMb_p", "moments.Ga_v", "final.A1_v"} <= names
    y = mod(torch.from_numpy(img))
    np.testing.assert_array_equal(
        y.detach().numpy(), F.realize(device="cpu").numpy())


def test_highest_runs_the_einsum_chain():
    """At ``highest`` the JAX package's ``apply_filter_fused`` skips its
    3-touch executor (nprod = 0) and runs the rotation chain of einsum
    passes: so does the port, launching no kernel, within the px6 bound
    of the oracle and 1e-5 of the JAX package."""
    from recfilter_tpu_torch.kernels import launch as tl

    img = _img(256, 256, seed=1)
    F = _build(rft, 256, 256, img, precision="highest")
    mod = F.as_func(device="cpu")
    assert isinstance(mod, tdf.RotationChain)
    assert all(p.tails is None and p.completion is None for p in mod.passes)
    tl.reset_launches()
    got = mod(torch.from_numpy(img)).numpy()
    assert not any(tl.LAUNCHES.values())
    Fj = _build(jrf, 256, 256, img, precision="highest")
    oracle = jsc.oracle_apply(Fj.spec, img.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    want = np.asarray(Fj.realize(jnp.asarray(img)))
    assert np.abs(got - want).max() <= 1e-5 * peak


def test_split_width_does_not_change_the_result():
    """As in the JAX package's 2-D px executor, the kernels' 128 × 128 tile
    replaces the split widths: tiling is never part of the result."""
    img = _img(256, 256, seed=2)
    y64 = _build(rft, 256, 256, img, tile=64).realize(device="cpu")
    y128 = _build(rft, 256, 256, img).realize(device="cpu")
    assert torch.equal(y64, y128)


def _spec(dims, scans, mod=rft, **kw):
    return mod.FilterSpec("S", tuple(mod.Dim(n, e) for n, e in dims),
                          tuple(mod.Scan(*s) for s in scans), **kw)


_G = (0.1, (0.5, 0.3, 0.1))
# name: (dims, scans (axis, causal, b0, feedback), keywords)
UNSUPPORTED = {
    # a prime clamp extent has no tile plan: the sequential core's case
    "one-dim": ([("x", 509)], [(0, True, *_G)],
                dict(border="clamp", tile_widths=(128,))),
    # a volume whose depth is not a multiple of 128: the rows pass
    # declines and the rotation chain runs
    "volume": ([("z", 100), ("y", 128), ("x", 128)],
               [(i, True, *_G) for i in range(3)],
               dict(tile_widths=(128, 128, 128))),
    # scans on axes 0 and 1 of (y, x, c): the rows pass on y, the einsum
    # pass on x (3 lanes)
    "leading-axes": ([("y", 128), ("x", 128), ("c", 3)],
                     [(0, True, *_G), (1, True, *_G)],
                     dict(tile_widths=(128, 128, 0))),
    "float64": ([("y", 128), ("x", 128)], [(0, True, *_G), (1, True, *_G)],
                dict(dtype="float64", tile_widths=(128, 128))),
    # an integer filter under a clamp border: the JAX package's limb route
    "int32": ([("y", 128), ("x", 128)],
              [(0, True, 1.0, (1.0,)), (1, True, 1.0, (1.0,))],
              dict(border="clamp", dtype="int32", tile_widths=(128, 128))),
    # the 3-touch executor's gates decline the next four: the chain runs
    "clamp-non-dividing": ([("y", 200), ("x", 256)],
                           [(0, True, *_G), (1, True, *_G)],
                           dict(border="clamp", tile_widths=(128, 128))),
    "too-many-tiles": ([("y", 128), ("x", 257 * 128)],
                       [(0, True, *_G), (1, True, *_G)],
                       dict(tile_widths=(128, 128))),
    "carries-over-8": ([("y", 128), ("x", 256)],
                       [(0, True, *_G)] + [(1, c, *_G)
                                           for c in (True, False, True)],
                       dict(tile_widths=(128, 128))),
    "small-extent": ([("y", 64), ("x", 256)],
                     [(0, True, *_G), (1, True, *_G)],
                     dict(tile_widths=(128, 128))),
}
STILL_UNSUPPORTED = ("float64",)


@pytest.mark.parametrize("case", list(UNSUPPORTED))
def test_unsupported_filters_raise(case):
    """The filters the port refused before the rotation chain and the
    sequential core: those the port still does not run raise; the rest
    run the JAX package's route (the rotation chain, the rows pass and
    the einsum pass, or the sequential core on an axis with no tile plan)
    within the px6 bound of the oracle and 1e-5 of the JAX package."""
    dims, scans, kw = UNSUPPORTED[case]
    spec = _spec(dims, scans, **kw)
    if case in STILL_UNSUPPORTED:
        with pytest.raises(NotImplementedError):
            tdf.fused_filter_module(spec)
        return
    js = _spec(dims, scans, mod=jrf, **kw)
    if case == "int32":  # the limb route, bit-exact
        img = np.random.default_rng(5).integers(
            -2 ** 20, 2 ** 20, [e for _, e in dims]).astype(np.int32)
        mod = tdf.fused_filter_module(spec)
        assert isinstance(mod, tdf.IntUnitPass) and mod.route == "exact"
        assert all(r[0] == "limb" for _, rs in mod.plan for r in rs)
        got = mod(torch.from_numpy(img)).numpy()
        np.testing.assert_array_equal(got, jsc.oracle_apply(js, img))
        np.testing.assert_array_equal(
            got, np.asarray(jdf.apply_filter_fused(js, img)))
        return
    x = np.random.default_rng(len(case)).standard_normal(
        [e for _, e in dims]).astype(np.float32)
    mod = tdf.fused_filter_module(spec)
    assert type(mod).__name__ == {"leading-axes": "StagedPass",
                                  "one-dim": "FusedLastAxis"}.get(
                                      case, "RotationChain")
    if case == "one-dim":
        assert type(mod.body).__name__ == "ScanAxis"
    got = mod(torch.from_numpy(x)).numpy()
    oracle = jsc.oracle_apply(js, x.astype(np.float64))
    peak = np.abs(oracle).max()
    assert np.abs(got - oracle).max() <= 2e-6 * peak
    want = np.asarray(jdf.apply_filter_fused(js, jnp.asarray(x),
                                             matmul_precision="px6"))
    assert np.abs(got - want).max() <= 1e-5 * peak


@pytest.mark.parametrize("precision", ["px3", "px4", "default", "f32x6",
                                       "high"])
def test_unported_precisions_raise(precision):
    """``f32x6`` and ``high`` run (the split-einsum grades: the rotation
    chain's einsum forms at six and three bf16 products), within their
    bounds of the oracle (4e-6, 2e-4: the random-filter bounds of
    ``tests/test_fuzz.py``) and twice those of the JAX package. The
    reduced grades (px3, px4, default) run the 3-touch executor, the
    last-axis passes and the rotation chain: here the rotated emit
    (``rotate_emit=2``: ``completion_rot`` at px3 and px4, its einsum form
    at ``default``), within the grade's bound of the oracle and twice it
    of the JAX package's ``realize()``. A fused ``stencil2d`` bank on the
    same filter runs at the grade too (``final2d_stencil``'s split form),
    within the grade's bound of the bank over the oracle and twice it of
    the JAX package's ``apply_filter_fused``."""
    F = _build(rft, 256, 256, _img(256, 256))
    if precision in ("f32x6", "high"):
        bound = {"f32x6": 4e-6, "high": 2e-4}[precision]
        F.set_plan(matmul_precision=precision)
        mod = F.as_func(device="cpu")
        assert isinstance(mod, tdf.RotationChain)
        img = _img(256, 256)
        got = mod(torch.from_numpy(img)).numpy()
        want = jsc.oracle_apply(F.spec, img.astype(np.float64))
        peak = np.abs(want).max()
        assert np.abs(got - want).max() <= bound * peak
        Fj = _build(jrf, 256, 256, img, precision=precision)
        assert np.abs(got - np.asarray(Fj.realize())).max() <= 2 * bound * peak
        got2 = rft.apply_filter_fused(F.spec, torch.from_numpy(img),
                                      precision).numpy()
        np.testing.assert_array_equal(got2, got)
        return
    F.set_plan(matmul_precision=precision)
    bound = {"px3": 1e-4, "px4": 8e-5, "default": 3e-2}[precision]
    img = _img(256, 256)
    bank = [[(0, 1, 1.0)]]
    (got,) = F.as_func(stencil2d=bank, device="cpu")(torch.from_numpy(img))
    y = jsc.oracle_apply(F.spec, img.astype(np.float64))
    want = np.concatenate([y[:, 1:], y[:, -1:]], 1)  # dx = 1, edge clamped
    peak = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= bound * peak
    (jw,) = jdf.apply_filter_fused(_build(jrf, 256, 256, img).spec,
                                   jnp.asarray(img),
                                   matmul_precision=precision,
                                   stencil2d=bank)
    assert np.abs(got.numpy() - np.asarray(jw)).max() <= 2 * bound * peak
    outs = []
    for rf in (rft, jrf):
        Fx = rf.RecFilter("XOnly")
        x, y = rf.Dim("x", 256), rf.Dim("y", 256)
        Fx[y, x] = img
        Fx.add_filter(+x, rf.gaussian_weights(5.0, 3))
        Fx.split(x, 128)
        Fx.set_plan(matmul_precision=precision, rotate_emit=2)
        outs.append(Fx)
    Fx, Fj = outs
    mod = Fx.as_func(device="cpu")
    assert isinstance(mod, tdf.RotatedPass)
    comp = mod.body.completion
    if precision == "default":
        assert comp is None  # no structural win: the einsum form
    else:
        assert comp.rot and comp.nprod == {"px3": 3, "px4": 4}[precision]
    got = mod(torch.from_numpy(img)).numpy()
    want = jsc.oracle_apply(Fx.spec, img.astype(np.float64)).T
    peak = np.abs(want).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= bound * peak
    jout = np.asarray(Fj.realize(jnp.asarray(img)))
    assert np.abs(got - jout).max() <= 2 * bound * peak


def test_untiled_and_other_backends_raise():
    """An untiled filter, which the port refused before the sequential
    core, now runs it as the JAX package does (``auto`` resolves to
    ``scan``), and ``set_plan(backend="scan")`` takes the same core: both
    match the JAX package's ``realize()`` at 1e-5 of the peak and the f64
    oracle at 2e-6. An unknown backend still raises."""
    img = _img(64, 48)
    Fs = []
    for rf in (rft, jrf):
        F = rf.RecFilter("U")
        x, y = rf.Dim("x", 48), rf.Dim("y", 64)
        F[y, x] = img
        F.add_filter(+x, [0.5, 0.5])
        F.add_filter(+y, [0.5, 0.5])
        Fs.append(F)
    Ft, Fj = Fs
    mod = Ft.as_func(device="cpu")
    assert type(mod).__name__ == "ScanFilter"
    oracle = jsc.oracle_apply(Fj.spec, img.astype(np.float64))
    peak = np.abs(oracle).max()
    want = np.asarray(Fj.realize(jnp.asarray(img)))
    for got in (mod(torch.from_numpy(img)),
                Ft.set_plan(backend="scan").realize(device="cpu")):
        got = got.numpy()
        assert np.abs(got - oracle).max() <= 2e-6 * peak
        assert np.abs(got - want).max() <= 1e-5 * peak
    with pytest.raises(ValueError, match="unknown backend"):
        Ft.set_plan(backend="cuda-graphs")


def test_cuda_request_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal applies without it")
    F = _build(rft, 256, 256, _img(256, 256))
    with pytest.raises(RuntimeError, match="cuda"):
        F.realize(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        F.profile(device="cuda")


def test_port_never_imports_jax():
    """With jax made unimportable, the port imports and runs the 256²
    headline filter, a 1-D audio filter, the staged Gaussian cascade
    (x on the last-axis pass, y on the rows pass) and the merged unsharp
    mask on the CPU within the px6 bound, a Tuple filter whose linear
    combine folds (2u − v of (I, 2I): zero), and the headline on every
    other backend (and ``overlap_k`` at ``highest``) within the px6
    bound, ``compute_locally`` selecting ``pallas``; and imports the
    headline benchmark (``recfilter_tpu_torch.bench``) and its copy
    kernel's module."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import torch
        import recfilter_tpu_torch as rft
        h = w = 256
        img = (np.random.default_rng(0).standard_normal((h, w)) * 0.01
               ).astype(np.float32)
        x, y = rft.Dim("x", w), rft.Dim("y", h)
        F = rft.RecFilter("GaussianIIR")
        F[y, x] = img
        for d in (+x, -x, +y, -y):
            F.add_filter(d, rft.gaussian_weights(5.0, 3))
        F.split(x, 128, y, 128)
        got = F.realize(device="cpu").numpy()
        want = rft.oracle_apply(F.spec, img.astype(np.float64))
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
        from recfilter_tpu_torch.apps import audio_filter_high_order
        sig = np.random.default_rng(1).random(40_000).astype(np.float32)
        A = audio_filter_high_order(40_000, 3, 128)  # the supertile hierarchy
        got = A.realize(sig, device="cpu").numpy()
        want = rft.oracle_apply(A.spec, sig.astype(np.float64))
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
        from recfilter_tpu_torch.apps import (gaussian_3x_3y, gaussian_3xy,
                                              run_cascade)
        got = run_cascade(gaussian_3x_3y(w, h), img, device="cpu").numpy()
        want = rft.oracle_apply(gaussian_3xy(w, h).spec,
                                img.astype(np.float64))
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
        from recfilter_tpu_torch.apps import unsharp_mask
        usm = unsharp_mask(w, h, device="cpu")
        assert usm.usm_route == "merged"
        got = usm(torch.from_numpy(img)).numpy()
        blur = rft.oracle_apply(gaussian_3xy(w, h).spec,
                                img.astype(np.float64))
        want = 2.0 * img - blur
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
        T = rft.RecFilter("Tup")
        T[y, x] = (img, 2 * img)
        for d in (+x, +y):
            T.add_filter(d, [0.8, 0.4])
        T.split(x, 128, y, 128)
        fold = T.as_func(epilogue=lambda u, v: 2.0 * u - v, device="cpu")
        assert fold.tuple_route == "linear-folded"
        assert float(fold((torch.from_numpy(img),
                           torch.from_numpy(2 * img))).abs().max()) < 1e-6
        for backend in ("pallas", "overlap", "overlap_k", "blocked", "scan",
                        "oracle"):
            F.set_plan(backend=backend, matmul_precision="px6")
            got = F.realize(device="cpu").numpy()
            want = rft.oracle_apply(F.spec, img.astype(np.float64))
            assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max(), \
                backend
        F.set_plan(backend="overlap_k", matmul_precision="highest")
        got = F.realize(device="cpu").numpy()
        assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
        F.intra_schedule(1).compute_locally()
        assert F.plan.backend == "pallas"
        assert "compute_locally" in F.print_schedule()
        import recfilter_tpu_torch.bench
        import recfilter_tpu_torch.kernels.copy
        assert not any(m == "jax" or m.startswith(("jax.", "recfilter_tpu."))
                       or m == "recfilter_tpu" for m in sys.modules
                       if sys.modules[m] is not None)
        print("port-ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "port-ok" in out.stdout


def test_entry_points_default_to_the_card():
    """``as_func`` and the module builders run on the card by default:
    without CUDA that default raises, and ``device="cpu"`` runs the
    twins."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal applies without it")
    from recfilter_tpu_torch.apps import (box_filter_3, box_filter_6,
                                          box_filter_order_1,
                                          box_filter_order_2,
                                          difference_of_gaussians)

    F = _build(rft, 256, 256, _img(256, 256))
    for make in (F.as_func,
                 lambda: box_filter_order_1(256, 256, 3),
                 lambda: box_filter_order_1(256, 256, 3, variant="sat"),
                 lambda: box_filter_order_2(256, 256, 3),
                 lambda: box_filter_3(256, 256, 3),
                 lambda: box_filter_3(256, 256, 3, variant="sat"),
                 lambda: box_filter_6(256, 256, 3, variant="sat"),
                 lambda: difference_of_gaussians(256, 256, 3, 5),
                 lambda: difference_of_gaussians(256, 256, 3, 5,
                                                 variant="sat")):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    mod = F.as_func(device="cpu")
    assert all(b.device.type == "cpu" for b in mod.buffers())
