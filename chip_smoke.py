#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU: build, check, time.

    python3 chip_smoke.py

Drives ``recfilter_tpu_torch`` (never jax) through its public API on its
two paths, and fails (non-zero exit, traceback) if any phase fails.

The 2-D path: the headline filter of ``bench.py::_build_filter`` — a
3rd-order Gaussian (σ=5), causal and anticausal on x and y, 128-wide
tiles, float32, px6 — at 4096², on ``moments2d`` and ``final2d``.

The 1-D last-axis path, on ``tails`` and ``completion``:

  A  10,000,000 samples, ``audio_filter_high_order(order=2)``, tile 1000,
     zero border — the supertile hierarchy, dense level-2 solve;
  B  the same at order 29 — 4 carry slots, Kogge–Stone level 2;
  C  1,000,001 samples, the σ=5 Gaussian causal + anticausal, clamp,
     tile 1000 — the hierarchy with pad, clamp edges and couplings;
  D  64 channels × 30,000 samples, the Gaussian of C, tile 128, zero —
     one tiled pass with pad variants;
  E  64 channels × 32,768 samples, the Gaussian of C, tile 128, clamp —
     one tiled pass with first/last variants.

The rows path (a scan on a non-last axis, everything after it flattened
into lanes), on ``rows_tails`` and ``rows_final``, with the σ=5 Gaussian
causal + anticausal on every scanned axis, float32, px6, tiles of 128:

  V1  256³, zero border, ``scripts/bench_volume.py``'s filter and input
      (N(0,1)·0.01, seed 0): the rows pass on z, then the 2-D executor on
      (y, x) with the depth as its batch;
  V2  512³ (a CT volume: 0.5 GB in, 0.5 GB out), clamp border;
  S1  ``apps.gaussian_3x_3y(4096, 4096)``: x on the 1-D kernels, then y on
      the rows kernels — timed against ``gaussian_3xy``, the same filter on
      the 3-touch path;
  S2  ``apps.gaussian_1xy_2x_2y(4096, 4096)``: its three stages run all six
      kernels;
  S3  y only on 8192 × 4096, zero border: 64 tiles, the banded carry solve;
  S4  axes {0, 2} of 256 × 512 × 1024, zero border: a rows pass with
      524,288 lanes, then a last-axis pass (x split at 128).

Phases:

  1. the card, its power limit and the fp32 matmul settings; build the
     six CUDA kernels from ``recfilter_tpu_torch/kernels/csrc`` (one
     ``nvcc`` each, all at once);
  2. each kernel against its plain PyTorch twin on the card at its path's
     shapes (2-D: 4096² zero and clamp, 1080×1920 padded; 1-D: A, B, E;
     rows: V1, V2, S3): max|kernel − twin| ≤ 1e-5·max|twin|, carry pad
     slots written as zeros;
  3. each path end to end through ``RecFilter.as_func()`` (the cascades
     through ``RecFilter.realize`` / ``apps.run_cascade``) on the card, the
     launch counts set to 0 just before each call and read just after: the
     2-D cases launch moments2d and final2d once each and no 1-D kernel;
     A, B, D, E launch tails and completion once each, C twice (one per
     scan), and no 2-D kernel; V1 and V2 launch rows_tails, rows_final,
     moments2d and final2d once each; S1's second stage and S3 the two
     rows kernels only; S2 all six once; S4 the rows and 1-D kernels once.
     Error against the f64 reference ≤ 2e-6 of the peak (5e-6 for C) — the
     JAX package's bounds. The 10M cases are held to
     ``scipy.signal.lfilter`` in float64, itself checked against the
     definitional oracle on a 100,000-sample prefix; every other case to
     the oracle itself (a cascade to the oracle of its whole filter);
  4. gradients of sum(y²) through the kernel path against the plain path,
     within rtol = atol = 1e-4: 2-D at 512², 1-D at 300,000 samples (order
     3, the hierarchy), a 128 × 128 × 256 volume;
  5. device times (CUDA events, median of single calls) of the whole call
     and of each kernel, beside their plain twins and, where one PyTorch
     call computes a kernel's function, beside that call; for A, B and V1
     also a profile of one call (device ops, busy time, idle share); for
     A and B the first-call host build; for A–E the error of the
     fp32-accumulating tails variant, end to end.

The last line is the JSON result; the line before it is the card's name
and power limit; before that a JSON line describes each kernel, with its
bound: the larger of its bytes over 3.35 TB/s and its operations over the
fp32 (67 TFLOP/s) or fp64 (33.5 TFLOP/s, the fp64-summing tails kernels)
peak of an H100 SXM.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H = W = 4096
N_TIMED = 25
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, fp32 and fp64 FLOP/s
PEAK_BYTES, PEAK_FP32, PEAK_FP64 = 3.35e12, 67e12, 33.5e12


def check(ok, what):
    if not ok:
        raise RuntimeError(f"FAILED: {what}")
    print(f"  ok: {what}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_filter(rft, h, w, image, clamp=False):
    """``bench.py::_build_filter`` against the port's RecFilter."""
    wts = rft.gaussian_weights(5.0, 3)
    x, y = rft.Dim("x", w), rft.Dim("y", h)
    F = rft.RecFilter("GaussianIIR")
    if clamp:
        F.set_clamped_image_border()
    F[y, x] = image
    for d in (+x, -x, +y, -y):
        F.add_filter(d, wts)
    F.split(x, 128, y, 128)
    return F


def image(*shape, seed=0):
    import numpy as np

    # bench.py's input: N(0,1)·0.01 from np.random.default_rng(seed)
    return (np.random.default_rng(seed).standard_normal(shape) * 0.01
            ).astype(np.float32)


def gauss_axes(rft, shape, axes, clamp=False, name="GaussianND"):
    """The σ=5 3rd-order Gaussian, causal + anticausal on each of
    ``axes`` (in that order), tiles of 128, bound to ``image(*shape)``:
    ``scripts/bench_volume.py``'s filter for ``axes = (0, 1, 2)``."""
    wts = rft.gaussian_weights(5.0, 3)
    dims = [rft.Dim(nm, e) for nm, e in zip("wzyx"[-len(shape):], shape)]
    F = rft.RecFilter(name)
    if clamp:
        F.set_clamped_image_border()
    F[tuple(dims)] = image(*shape)
    for ax in axes:
        F.add_filter(+dims[ax], wts)
        F.add_filter(-dims[ax], wts)
    F.split({dims[ax]: 128 for ax in axes})
    return F


def counted(fn, *args):
    """``fn(*args)`` with every launch count set to 0 just before the call
    and read just after: (output, counts)."""
    import torch

    from recfilter_tpu_torch.kernels import launch

    torch.cuda.synchronize()
    launch.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, dict(launch.LAUNCHES)


def roofline(nbytes, flops, rate):
    """(bound_ms, bound_by): the least time for ``nbytes`` of traffic and
    ``flops`` operations at ``rate`` — the larger of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def median_ms(fn, *args):
    """Median single-call CUDA-event time of ``fn(*args)``."""
    from recfilter_tpu_torch.utils import timing

    return statistics.median(timing.call_times_ms(
        fn, *args, iterations=2 * N_TIMED, warmup=3))


def device_ms(fn, *args):
    """Device time per call of ``fn(*args)`` from the profiler — the sum
    of its kernels and copies, free of the host's launch gaps that a
    host-bound single call adds to its CUDA-event time."""
    from recfilter_tpu_torch.utils import timing

    busy = timing.device_profile(fn, *args, iterations=10)["busy_ms"]
    check(busy is not None, "the profiler recorded device time")
    return busy


def oracle_err(spec, x_np, y):
    """max|y − oracle| / max|oracle| against the f64 oracle of ``spec``."""
    import numpy as np

    from recfilter_tpu_torch import scan_core

    want = scan_core.oracle_apply(spec, x_np.astype(np.float64))
    got = y.cpu().numpy().astype(np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def gauss_1d(rft, shape, tile, clamp):
    """The σ=5 3rd-order Gaussian, causal + anticausal, on the last axis
    of ``shape``; channels on a leading axis."""
    dims = [rft.Dim("t", shape[-1])]
    if len(shape) == 2:
        dims.insert(0, rft.Dim("c", shape[0]))
    F = rft.RecFilter("Gaussian1D")
    if clamp:
        F.set_clamped_image_border()
    F[tuple(dims)] = signal(shape)
    wts = rft.gaussian_weights(5.0, 3)
    F.add_filter(+dims[-1], wts)
    F.add_filter(-dims[-1], wts)
    F.split(dims[-1], tile)
    return F


def signal(shape, seed=6):
    import numpy as np

    return (np.random.default_rng(seed).standard_normal(shape) * 0.1
            ).astype(np.float32)


def rel_err(got, want):
    """max|got − want| / max|want| (both torch tensors)."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


def paired_times(kernel_fn, plain_fn, *args):
    """Medians (kernel, plain) of single-call CUDA-event times, taken in
    turns plain, kernel, kernel, plain."""
    from recfilter_tpu_torch.utils import timing

    k, p = [], []
    for fn, acc in ((plain_fn, p), (kernel_fn, k), (kernel_fn, k),
                    (plain_fn, p)):
        acc += timing.call_times_ms(fn, *args, iterations=N_TIMED, warmup=3)
    return statistics.median(k), statistics.median(p)


def lfilter_reference(spec, x):
    """Zero-border causal single-scan filters: scipy's lfilter in float64
    with b = [b0], a = [1, −a1, …, −ak]."""
    import numpy as np
    from scipy.signal import lfilter

    (s,) = spec.scans
    assert s.causal and spec.border == "zero"
    return lfilter([s.feedfwd], [1.0] + [-a for a in s.feedback],
                   x.astype(np.float64))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "recfilter_tpu_torch")):
        print(f"chip_smoke: no recfilter_tpu_torch package beside {__file__}"
              " — run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np
    import torch.nn.functional as F_

    import recfilter_tpu_torch as rft
    from recfilter_tpu_torch import scan_core
    from recfilter_tpu_torch.apps import (audio_filter_high_order,
                                          gaussian_1xy_2x_2y, gaussian_3x_3y,
                                          gaussian_3xy, run_cascade)
    from recfilter_tpu_torch.kernels import _build
    from recfilter_tpu_torch.kernels import launch
    from recfilter_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    print("== phase 1: card, settings, kernel build", flush=True)
    print(f"card (name, power limit): {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "fp32 matmuls do not use TF32")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is 'highest'")
    t0 = time.perf_counter()
    _build.build(list(launch.SIGNATURES))
    print(f"nvcc, {len(launch.SIGNATURES)} kernels in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for name, sig in launch.SIGNATURES.items():
        _build.load(name, sig)
        log = _build.build_logs.get(name, "(library was already built)")
        print(f"built {name}:\n" + "\n".join(
            "    " + ln for ln in log.strip().splitlines()))

    print("== phase 2a: 2-D kernels against their plain twins on the card",
          flush=True)
    cases = {"4096x4096 zero": (H, W, False),
             "4096x4096 clamp": (H, W, True),
             "1080x1920 zero (padded)": (1080, 1920, False)}
    modules = {}
    max_abs = {name: 0.0 for name in launch.SIGNATURES}
    for label, (h, w, clamp) in cases.items():
        img = image(h, w)
        F = build_filter(rft, h, w, img, clamp)
        mod = F.as_func().to(dev)
        modules[label] = (F, mod, img)
        with torch.no_grad():
            X4 = mod.tile(torch.from_numpy(img).to(dev))
            for got, want, what in zip(mod.moments(X4),
                                       mod.moments.plain(X4),
                                       ("bA_t", "term1")):
                torch.cuda.synchronize()
                err = rel_err(got, want)
                print(f"  {label} moments2d {what}: max|k-p|/max|p| = "
                      f"{err:.3e}")
                check(err <= 1e-5, f"{label} moments2d {what} within 1e-5")
                if label.startswith("4096x4096 zero"):
                    max_abs["moments2d"] = max(
                        max_abs["moments2d"],
                        (got - want).abs().max().item())
            NA_t, NB_t = mod.carries(X4, mod.moments.plain)
            got = mod.final(X4, NA_t, NB_t)
            want = mod.final.plain(X4, NA_t, NB_t)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            print(f"  {label} final2d Y: max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} final2d within 1e-5")
            if label.startswith("4096x4096 zero"):
                max_abs["final2d"] = (got - want).abs().max().item()

    print("== phase 2b: build the 1-D cases; tails and completion against "
          "their twins on the card", flush=True)
    n10 = 10_000_000
    cases_1d = {}
    build_s = {}
    for label, make in (
            ("A", lambda: audio_filter_high_order(n10, 2, 1000)),
            ("B", lambda: audio_filter_high_order(n10, 29, 1000)),
            ("C", lambda: gauss_1d(rft, (1_000_001,), 1000, True)),
            ("D", lambda: gauss_1d(rft, (64, 30_000), 128, False)),
            ("E", lambda: gauss_1d(rft, (64, 32_768), 128, True))):
        F = make()
        t0 = time.perf_counter()
        mod = F.as_func()
        build_s[label] = time.perf_counter() - t0
        cases_1d[label] = (F, mod.to(dev))
        print(f"  {label}: {F.spec.dims}, ΣK = "
              f"{sum(s.order for s in F.spec.scans)}, route "
              f"{type(mod.body).__name__}, host build {build_s[label]:.2f} s")

    def local_inputs(label):
        """The case's first tiled pass, and x as its kernels see it."""
        F, mod = cases_1d[label]
        body = mod.body
        loc = body.locals[0] if hasattr(body, "locals") else body
        x = torch.from_numpy(signal(F._image.shape)).to(dev)
        X = F_.pad(x, (0, body.pad)).reshape(-1, loc.n, loc.T).contiguous()
        return loc, X

    for label in ("A", "B", "E"):
        loc, X = local_inputs(label)
        with torch.no_grad():
            b = loc.tails(X)
            bp = loc.tails.plain(X)
            torch.cuda.synchronize()
            err = rel_err(b, bp)
            print(f"  {label} tails {tuple(X.shape)} -> {tuple(b.shape)}: "
                  f"max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} tails within 1e-5")
            check(not b[:, loc.S:].any(), f"{label} tails pad slots zero")
            Nt = loc._solve_t(bp.double()).float()
            y = loc.completion(X, Nt)
            yp = loc.completion.plain(X, Nt)
            torch.cuda.synchronize()
            err = rel_err(y, yp)
            print(f"  {label} completion: max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} completion within 1e-5")
            if label == "A":
                max_abs["tails"] = (b - bp).abs().max().item()
                max_abs["completion"] = (y - yp).abs().max().item()

    print("== phase 2c: build the rows-path cases; rows_tails and rows_final "
          "against their twins on the card", flush=True)
    rows_cases = {}  # label: (filter, module on the card, input)
    for label, make in (
            ("V1", lambda: gauss_axes(rft, (256, 256, 256), (0, 1, 2))),
            ("V2", lambda: gauss_axes(rft, (512, 512, 512), (0, 1, 2),
                                      clamp=True)),
            ("S3", lambda: gauss_axes(rft, (8192, 4096), (0,))),
            ("S4", lambda: gauss_axes(rft, (256, 512, 1024), (0, 2)))):
        F = make()
        t0 = time.perf_counter()
        mod = F.as_func()
        rows = mod if isinstance(mod, rft.FusedRowsPx) else mod.stages[0]
        print(f"  {label}: {F.spec.dims}, border {F.spec.border}, route "
              f"{getattr(mod, 'route', type(mod).__name__)} "
              f"[{', '.join(type(m).__name__ for m in getattr(mod, 'stages', [mod]))}]"
              f", rows pass n = {rows.n} tiles x W = {rows.W} lanes, solve "
              f"{'banded' if rows.offsets else 'dense'}, host build "
              f"{time.perf_counter() - t0:.2f} s")
        rows_cases[label] = (F, mod.to(dev), F._image)
    check(isinstance(rows_cases["S3"][1], rft.FusedRowsPx)
          and rows_cases["S3"][1].offsets is not None,
          "S3 runs the rows pass alone, on the banded carry solve")

    def rows_of(label):
        mod = rows_cases[label][1]
        return mod if isinstance(mod, rft.FusedRowsPx) else mod.stages[0]

    for label in ("V1", "V2", "S3"):
        rows = rows_of(label)
        with torch.no_grad():
            X4 = rows.tile(torch.from_numpy(rows_cases[label][2]).to(dev))
            b = rows.tails(X4)
            bp = rows.tails.plain(X4)
            torch.cuda.synchronize()
            err = rel_err(b, bp)
            print(f"  {label} rows_tails {tuple(X4.shape)} -> "
                  f"{tuple(b.shape)} ({rows.tails.G_v.shape[0]} variants): "
                  f"max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} rows_tails within 1e-5")
            check(not b[:, :, rows.K:].any(),
                  f"{label} rows_tails pad slots zero")
            N = rows.carries(X4, rows.tails.plain)
            y = rows.final(X4, N)
            yp = rows.final.plain(X4, N)
            torch.cuda.synchronize()
            err = rel_err(y, yp)
            print(f"  {label} rows_final: max|k-p|/max|p| = {err:.3e}")
            check(err <= 1e-5, f"{label} rows_final within 1e-5")
            if label == "V1":
                max_abs["rows_tails"] = (b - bp).abs().max().item()
                max_abs["rows_final"] = (y - yp).abs().max().item()
            del X4, b, bp, N, y, yp

    print("== phase 3a: the 2-D path end to end through RecFilter.as_func()",
          flush=True)
    main_launches = {}

    def only(**kw):
        """Launch counts with every kernel not named at 0."""
        return {k: kw.get(k, 0) for k in launch.SIGNATURES}

    for label, (F, mod, img) in modules.items():
        with torch.no_grad():
            y, launches = counted(mod, torch.from_numpy(img).to(dev))
        print(f"  {label}: launches {launches}")
        check(launches == only(moments2d=1, final2d=1),
              f"{label}: each 2-D kernel launched once by the call, no 1-D "
              "kernel")
        if label == "4096x4096 zero":
            main_launches.update(moments2d=launches["moments2d"],
                                 final2d=launches["final2d"])
        check(tuple(y.shape) == img.shape and bool(torch.isfinite(y).all()),
              f"{label}: output finite, shape {img.shape}")
        err = oracle_err(F.spec, img, y)
        print(f"  {label}: max|y - oracle|/max|oracle| = {err:.3e}")
        check(err <= 2e-6, f"{label}: within the px6 bound 2e-6 of the "
              "f64 oracle")

    print("== phase 3b: the 1-D path end to end through RecFilter.as_func()",
          flush=True)
    for order in (2, 29):
        spec = audio_filter_high_order(100_000, order, 1000).spec
        xs = signal((100_000,))
        ref = lfilter_reference(spec, xs)
        orc = scan_core.oracle_apply_scan(
            xs.astype(np.float64), 0, True, spec.scans[0].feedfwd,
            list(spec.scans[0].feedback))
        err = float(np.abs(ref - orc).max() / np.abs(orc).max())
        print(f"  lfilter stand-in vs oracle, order {order}, 100,000 "
              f"samples: {err:.3e}")
        check(err <= 1e-12, f"lfilter equals the oracle at order {order}")
    expect = {"A": 1, "B": 1, "C": 2, "D": 1, "E": 1}
    refs = {}  # label: (signal on the card, f64 reference) for phase 5
    for label, (F, mod) in cases_1d.items():
        xs = signal(F._image.shape)
        x = torch.from_numpy(xs).to(dev)
        with torch.no_grad():
            y, launches = counted(mod, x)
        print(f"  {label}: launches {launches}")
        k = expect[label]
        check(launches == only(tails=k, completion=k),
              f"{label}: tails and completion launched {k}x by the call, no "
              "2-D kernel")
        if label == "A":
            main_launches.update(tails=launches["tails"],
                                 completion=launches["completion"])
        check(tuple(y.shape) == xs.shape and bool(torch.isfinite(y).all()),
              f"{label}: output finite, shape {xs.shape}")
        if label in ("A", "B"):
            want, what = lfilter_reference(F.spec, xs), "lfilter f64"
        else:
            want, what = rft.oracle_apply(F.spec, xs.astype(np.float64)), \
                "f64 oracle"
        bound = 5e-6 if label == "C" else 2e-6
        err = float(np.abs(y.cpu().numpy().astype(np.float64) - want).max()
                    / np.abs(want).max())
        print(f"  {label}: max|y - ref|/max|ref| = {err:.3e} ({what})")
        check(err <= bound, f"{label}: within {bound:g} of the {what}")
        refs[label] = (x, want)

    print("== phase 3c: the rows path end to end through RecFilter.as_func()"
          " and the cascades' realize", flush=True)
    expect_rows = {
        "V1": only(rows_tails=1, rows_final=1, moments2d=1, final2d=1),
        "V2": only(rows_tails=1, rows_final=1, moments2d=1, final2d=1),
        "S3": only(rows_tails=1, rows_final=1),
        "S4": only(rows_tails=1, rows_final=1, tails=1, completion=1)}
    for label, (F, mod, xs) in rows_cases.items():
        with torch.no_grad():
            y, launches = counted(mod, torch.from_numpy(xs).to(dev))
        print(f"  {label}: launches {launches}")
        check(launches == expect_rows[label],
              f"{label}: launches {expect_rows[label]}")
        if label == "V1":
            main_launches.update(rows_tails=launches["rows_tails"],
                                 rows_final=launches["rows_final"])
        check(tuple(y.shape) == xs.shape and bool(torch.isfinite(y).all()),
              f"{label}: output finite, shape {xs.shape}")
        err = oracle_err(F.spec, xs, y)
        print(f"  {label}: max|y - oracle|/max|oracle| = {err:.3e}")
        check(err <= 2e-6, f"{label}: within the px6 bound 2e-6 of the f64 "
              "oracle")
        del y
    img = image(H, W)
    # S1, stage by stage through realize: x on the 1-D kernels, y on rows
    fc = gaussian_3x_3y(W, H)
    out = img
    for f, want in zip(fc, (only(tails=1, completion=1),
                            only(rows_tails=1, rows_final=1))):
        with torch.no_grad():
            out, launches = counted(
                lambda v, f=f: f.realize(v, device=dev), out)
        print(f"  S1 stage {f.name} ({[str(s) for s in f.spec.scans]}): "
              f"launches {launches}")
        check(launches == want, f"S1 stage {f.name}: launches {want}")
    err = oracle_err(gaussian_3xy(W, H).spec, img, out)
    print(f"  S1: max|y - oracle of gaussian_3xy|/max = {err:.3e}")
    check(err <= 2e-6, "S1: within 2e-6 of the whole filter's oracle")
    # S2, the whole chain through run_cascade: all six kernels once
    fc = gaussian_1xy_2x_2y(W, H)
    with torch.no_grad():
        out, launches = counted(
            lambda v: run_cascade(fc, v, device=dev), img)
    print(f"  S2: launches {launches}")
    check(launches == {k: 1 for k in launch.SIGNATURES},
          "S2: each of the six kernels launched once by the cascade")
    whole = rft.FilterSpec("G", fc[0].spec.dims,
                           sum((f.spec.scans for f in fc), ()),
                           border="clamp", tile_widths=(128, 128))
    err = oracle_err(whole, img, out)
    print(f"  S2: max|y - oracle of the whole filter|/max = {err:.3e}")
    check(err <= 2e-6, "S2: within 2e-6 of the whole filter's oracle")
    del out

    print("== phase 4: gradients through the kernel paths", flush=True)
    img = image(512, 512, seed=1)
    grad_cases = [
        ("2-D 512²", build_filter(rft, 512, 512, img).as_func().to(dev),
         img),
        ("1-D 300,000 order 3",
         audio_filter_high_order(300_000, 3, 1000).as_func().to(dev),
         signal((300_000,), seed=1)),
        ("volume 128x128x256",
         gauss_axes(rft, (128, 128, 256), (0, 1, 2)).as_func().to(dev),
         image(128, 128, 256, seed=1))]
    for label, mod, xin in grad_cases:
        grads = []
        for fwd in (mod.forward, mod.forward_plain):
            x = torch.from_numpy(xin).to(dev).requires_grad_()
            (g,) = torch.autograd.grad((fwd(x) ** 2).sum(), x)
            grads.append(g)
        dg = (grads[0] - grads[1]).abs()
        bound = 1e-4 + 1e-4 * grads[1].abs()
        print(f"  {label}: max|g_kernel - g_plain| = {dg.max().item():.3e} "
              f"(max|g| = {grads[1].abs().max().item():.3e})")
        check(bool((dg <= bound).all()),
              f"{label}: gradient within rtol=atol=1e-4")

    print("== phase 5a: 2-D device times at 4096² (CUDA events, median of "
          f"{4 * N_TIMED // 2} calls each)", flush=True)
    F, mod, img = modules["4096x4096 zero"]
    x = torch.from_numpy(img).to(dev)
    px = H * W
    with torch.no_grad():
        X4 = mod.tile(x)
        NA_t, NB_t = mod.carries(X4, mod.moments.plain)
        times = {
            "filter": paired_times(mod, mod.forward_plain, x),
            "moments2d": paired_times(mod.moments, mod.moments.plain, X4),
            "final2d": paired_times(mod.final, mod.final.plain, X4, NA_t,
                                    NB_t),
        }
        # bounds: bA_t and term1 have NA_t's and NB_t's shapes; moments2d
        # sums in fp64, final2d multiplies in fp32; no one PyTorch call
        # computes either function
        Ka, Kb, pix = mod.Ka, mod.moments.Kb, X4.numel()
        dev_t = {
            "moments2d": (device_ms(mod.moments, X4),
                          device_ms(mod.moments.plain, X4), None),
            "final2d": (device_ms(mod.final, X4, NA_t, NB_t),
                        device_ms(mod.final.plain, X4, NA_t, NB_t), None)}
        extra = {
            "moments2d": (*roofline(
                tensor_bytes(X4, NA_t, NB_t, mod.moments.Ga_v, mod.moments.Gb_v,
                       mod.moments.Ba1T_v),
                2.0 * (Ka + 2 * Kb) * pix, PEAK_FP64), None),
            "final2d": (*roofline(
                tensor_bytes(X4, NA_t, NB_t, X4, mod.final.A1_v, mod.final.B2_v),
                2.0 * (2 * 128 + Ka + Kb) * pix, PEAK_FP32), None)}
    for name, (k_ms, p_ms) in times.items():
        print(f"  {name}: kernel path {k_ms:.4f} ms "
              f"({timing.mpix_per_sec(k_ms, px):.0f} Mpix/s), plain "
              f"{p_ms:.4f} ms ({timing.mpix_per_sec(p_ms, px):.0f} Mpix/s)"
              f" on {card}")

    print("== phase 5b: 1-D device times at 10M samples (CUDA events, "
          f"median of {4 * N_TIMED // 2} calls each)", flush=True)
    for label in ("A", "B"):
        F, mod = cases_1d[label]
        x, want = refs[label]
        loc, X = local_inputs(label)
        q, n, S, sl = X.shape[0], loc.n, loc.S, loc.sl
        with torch.no_grad():
            Nt = loc._solve_t(loc.tails.plain(X).double()).float()
            t = {"filter": paired_times(mod, mod.forward_plain, x),
                 "tails": paired_times(loc.tails, loc.tails.plain, X),
                 "completion": paired_times(loc.completion,
                                            loc.completion.plain, X, Nt)}
            if label == "A":
                times.update(tails=t["tails"], completion=t["completion"])
                # one PyTorch call each: the tails as an einsum, the
                # completion as one matmul of [x, Nᵀ] against [Btotᵀ; Rᵀ]
                # (one variant: A has zero border and no pad)
                check(loc.tails.G_v.shape[0] == 1
                      and loc.completion.BR_v.shape[0] == 1,
                      "A's tiles share one matrix variant")
                G0, BR0 = loc.tails.G_v[0], loc.completion.BR_v[0]
                XN = torch.cat([X, Nt.permute(2, 0, 1)], dim=2)
                check(rel_err(torch.einsum("st,qnt->nsq", G0, X),
                              loc.tails(X)) <= 1e-5
                      and rel_err(torch.matmul(XN, BR0),
                                  loc.completion(X, Nt)) <= 1e-5,
                      "A: the library calls compute the kernels' functions")
                tails_lib = (
                    lambda g, v: torch.einsum("st,qnt->nsq", g, v))
                dev_t["tails"] = (device_ms(loc.tails, X),
                                  device_ms(loc.tails.plain, X),
                                  device_ms(tails_lib, G0, X))
                dev_t["completion"] = (
                    device_ms(loc.completion, X, Nt),
                    device_ms(loc.completion.plain, X, Nt),
                    device_ms(torch.matmul, XN, BR0))
                extra["tails"] = (*roofline(
                    tensor_bytes(X, Nt, loc.tails.G_v), 2.0 * S * X.numel(),
                    PEAK_FP64), median_ms(tails_lib, G0, X))
                extra["completion"] = (*roofline(
                    tensor_bytes(X, Nt, X, loc.completion.BR_v),
                    2.0 * (128 + S) * X.numel(), PEAK_FP32),
                    median_ms(torch.matmul, XN, BR0))
                del XN
            prof = timing.device_profile(mod, x, iterations=10)
        nbytes = X.numel() * 4 + n * sl * q * 4
        flops = 2.0 * q * n * 128 * (128 + sl)
        for name, (k_ms, p_ms) in t.items():
            print(f"  {label} {name}: kernel path {k_ms:.4f} ms "
                  f"({timing.mpix_per_sec(k_ms, n10):.0f} Msamples/s), "
                  f"plain {p_ms:.4f} ms "
                  f"({timing.mpix_per_sec(p_ms, n10):.0f} Msamples/s) on "
                  f"{card}")
        print(f"  {label} tails: {nbytes / 1e6:.1f} MB in "
              f"{t['tails'][0]:.4f} ms = "
              f"{nbytes / t['tails'][0] / 1e9:.3f} TB/s, "
              f"{100 * nbytes / t['tails'][0] / 1e9 / 3.35:.1f} % of 3.35 TB/s")
        print(f"  {label} completion: {flops / 1e9:.2f} GFLOP in "
              f"{t['completion'][0]:.4f} ms = "
              f"{flops / t['completion'][0] / 1e9:.2f} TFLOP/s, "
              f"{100 * flops / t['completion'][0] / 1e9 / 67:.1f} % of the "
              "67 TFLOP/s fp32 peak")
        print(f"  {label} first-call host build (as_func): "
              f"{build_s[label]:.2f} s")
        busy = ("not measured" if prof["busy_ms"] is None else
                f"{prof['busy_ms']:.4f} ms, idle {100 * prof['idle']:.1f} %")
        print(f"  {label} profile: call {prof['call_ms']:.4f} ms, device "
              f"busy {busy}, {prof['device_ops']:.0f} device ops per call; "
              "top: " + ", ".join(f"{nm[:40]} {ms:.4f} ms"
                                  for nm, ms in prof["top"]))

    print("== phase 5c: the fp32-accumulating tails variant, end to end",
          flush=True)
    for label, (F, mod) in cases_1d.items():
        x, want = refs[label]
        body = mod.body
        locs = list(body.locals) if hasattr(body, "locals") else [body]
        with torch.no_grad():
            for loc in locs:
                loc.tails.fp64 = False  # the kernel's fp32 instantiation
            y32 = mod(x)
            for loc in locs:
                loc.tails.fp64 = True
        err = float(np.abs(y32.cpu().numpy().astype(np.float64) - want).max()
                    / np.abs(want).max())
        print(f"  {label}: fp32 tails sums, max|y - ref|/max|ref| = "
              f"{err:.3e} (fp64 sums: phase 3b)")

    print("== phase 5d: rows-path device times (CUDA events, median of "
          f"{4 * N_TIMED // 2} calls each)", flush=True)
    for label in ("V1", "V2", "S3"):
        F, mod, xs = rows_cases[label]
        rows = rows_of(label)
        x = torch.from_numpy(xs).to(dev)
        with torch.no_grad():
            X4 = rows.tile(x)
            N = rows.carries(X4, rows.tails.plain)
            t = {"filter": paired_times(mod, mod.forward_plain, x),
                 "rows_tails": paired_times(rows.tails, rows.tails.plain,
                                            X4),
                 "rows_final": paired_times(rows.final, rows.final.plain,
                                            X4, N)}
            K, vox = rows.K, X4.numel()
            tb = tensor_bytes(X4, N, rows.tails.G_v)
            fb = tensor_bytes(X4, N, X4, rows.final.A1_v)
            flops = 2.0 * (128 + K) * vox
            if label == "V2":
                print(f"  V2 device times (profiler): rows_tails "
                      f"{device_ms(rows.tails, X4):.4f} ms, rows_final "
                      f"{device_ms(rows.final, X4, N):.4f} ms")
            if label == "V1":
                times.update(rows_tails=t["rows_tails"],
                             rows_final=t["rows_final"])
                # one PyTorch call each (one variant at zero border): G·x
                # as a matmul (fp32 sums), and [Btot | Rhat]·[x; N]
                check(rows.tails.G_v.shape[0] == 1,
                      "V1's tiles share one matrix variant")
                G0, A0 = rows.tails.G_v[0], rows.final.A1_v[0].T
                XN = torch.cat([X4, N], dim=2)
                check(rel_err(torch.matmul(G0, X4), rows.tails(X4)) <= 1e-5
                      and rel_err(torch.matmul(A0, XN),
                                  rows.final(X4, N)) <= 1e-5,
                      "V1: the library calls compute the kernels' functions")
                dev_t["rows_tails"] = (
                    device_ms(rows.tails, X4), device_ms(rows.tails.plain, X4),
                    device_ms(torch.matmul, G0, X4))
                dev_t["rows_final"] = (
                    device_ms(rows.final, X4, N),
                    device_ms(rows.final.plain, X4, N),
                    device_ms(torch.matmul, A0, XN))
                extra["rows_tails"] = (*roofline(tb, 2.0 * K * vox, PEAK_FP64),
                                       median_ms(torch.matmul, G0, X4))
                extra["rows_final"] = (*roofline(fb, flops, PEAK_FP32),
                                       median_ms(torch.matmul, A0, XN))
                del XN
                prof = timing.device_profile(mod, x, iterations=10)
            del X4, N
        for name, (k_ms, p_ms) in t.items():
            print(f"  {label} {name}: kernel path {k_ms:.4f} ms "
                  f"({timing.mpix_per_sec(k_ms, xs.size):.0f} Mvox/s), "
                  f"plain {p_ms:.4f} ms "
                  f"({timing.mpix_per_sec(p_ms, xs.size):.0f} Mvox/s) on "
                  f"{card}")
        print(f"  {label} rows_tails: {tb / 1e6:.1f} MB in "
              f"{t['rows_tails'][0]:.4f} ms = "
              f"{tb / t['rows_tails'][0] / 1e9:.3f} TB/s, "
              f"{100 * tb / t['rows_tails'][0] / 1e9 / 3.35:.1f} % of "
              "3.35 TB/s")
        print(f"  {label} rows_final: {flops / 1e9:.2f} GFLOP in "
              f"{t['rows_final'][0]:.4f} ms = "
              f"{flops / t['rows_final'][0] / 1e9:.2f} TFLOP/s, "
              f"{100 * flops / t['rows_final'][0] / 1e9 / 67:.1f} % of the "
              "67 TFLOP/s fp32 peak")
        if label == "V1":
            busy = ("not measured" if prof["busy_ms"] is None else
                    f"{prof['busy_ms']:.4f} ms, idle "
                    f"{100 * prof['idle']:.1f} %")
            print(f"  V1 profile: call {prof['call_ms']:.4f} ms, device busy "
                  f"{busy}, {prof['device_ops']:.0f} device ops per call; "
                  "top: " + ", ".join(f"{nm[:40]} {ms:.4f} ms"
                                      for nm, ms in prof["top"]))
        del x
    fc = gaussian_3x_3y(W, H)
    stages = [f.as_func().to(dev) for f in fc]
    three = gaussian_3xy(W, H).as_func().to(dev)

    def staged(v):
        for m in stages:
            v = m(v)
        return v

    with torch.no_grad():
        x = torch.from_numpy(image(H, W)).to(dev)
        check(rel_err(staged(x), three(x)) <= 2e-6,
              "S1 staged equals gaussian_3xy within 2e-6")
        s_ms, t_ms = paired_times(staged, three, x)
        s_prof = timing.device_profile(staged, x, iterations=10)
        t_prof = timing.device_profile(three, x, iterations=10)
    print(f"  S1 gaussian_3x_3y, both stages: {s_ms:.4f} ms "
          f"({timing.mpix_per_sec(s_ms, H * W):.0f} Mpix/s); gaussian_3xy "
          f"(3-touch): {t_ms:.4f} ms "
          f"({timing.mpix_per_sec(t_ms, H * W):.0f} Mpix/s); ratio "
          f"{s_ms / t_ms:.3f} on {card}")
    for what, pr in (("S1 both stages", s_prof), ("gaussian_3xy", t_prof)):
        check(pr["busy_ms"] is not None, "the profiler recorded device time")
        print(f"  {what} profile: call {pr['call_ms']:.4f} ms, device busy "
              f"{pr['busy_ms']:.4f} ms, idle {100 * pr['idle']:.1f} %, "
              f"{pr['device_ops']:.0f} device ops per call")
    print(f"  S1 / gaussian_3xy device busy: "
          f"{s_prof['busy_ms'] / t_prof['busy_ms']:.3f}")

    kernels = [
        {"name": name, "route": "cuda",
         "source": f"recfilter_tpu_torch/kernels/csrc/{name}.cu",
         "replaces": replaces, "launches": main_launches[name],
         "max_abs_err": max_abs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": extra[name][0],
         "bound_by": extra[name][1], "library_ms": extra[name][2]}
        for name, replaces in (
            ("moments2d", "recfilter_tpu/kernels/final2d.py:409"),
            ("final2d", "recfilter_tpu/kernels/final2d.py:853"),
            ("tails", "recfilter_tpu/kernels/completion.py:750"),
            ("completion", "recfilter_tpu/kernels/completion.py:464"),
            ("rows_tails", "recfilter_tpu/kernels/final2d.py:1185"),
            ("rows_final", "recfilter_tpu/kernels/final2d.py:1251"))
    ]
    print("== summary: each kernel at its main-path shape — CUDA-event "
          "median of single calls, and device time from the profiler",
          flush=True)
    for k in kernels:
        d_k, d_p, d_l = dev_t[k["name"]]
        print(f"  {k['name']}: event {k['ms']:.4f} ms, device {d_k:.4f} ms;"
              f" bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
              f"({100 * k['bound_ms'] / k['ms']:.1f} % of the event time, "
              f"{100 * k['bound_ms'] / d_k:.1f} % of the device time); "
              f"twin event {k['plain_ms']:.4f}, device {d_p:.4f} ms; library "
              + ("none" if k["library_ms"] is None else
                 f"event {k['library_ms']:.4f}, device {d_l:.4f} ms"))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
