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

Phases:

  1. the card, its power limit and the fp32 matmul settings; build the
     four CUDA kernels from ``recfilter_tpu_torch/kernels/csrc`` (one
     ``nvcc`` each, all at once);
  2. each kernel against its plain PyTorch twin on the card at its path's
     shapes (2-D: 4096² zero and clamp, 1080×1920 padded; 1-D: A, B, E):
     max|kernel − twin| ≤ 1e-5·max|twin|;
  3. each path end to end through ``RecFilter.as_func()`` on the card, the
     launch counts set to 0 just before each call and read just after: the
     2-D cases launch moments2d and final2d once each and no 1-D kernel;
     A, B, D, E launch tails and completion once each, C twice (one per
     scan), and no 2-D kernel. Error against the f64 reference ≤ 2e-6 of
     the peak (5e-6 for C) — the JAX package's bounds. The 10M cases are
     held to ``scipy.signal.lfilter`` in float64, itself checked against
     the definitional oracle on a 100,000-sample prefix; C, D, E to the
     oracle itself;
  4. gradients of sum(y²) through the kernel path against the plain path,
     within rtol = atol = 1e-4: 2-D at 512², 1-D at 300,000 samples (order
     3, the hierarchy);
  5. device times (CUDA events, median of single calls) of the whole call
     and of each kernel, beside their plain twins; for A and B also the
     first-call host build and a profile of one call (device ops, busy
     time, idle share); for A–E the error of the fp32-accumulating tails
     variant, end to end.

The last line is the JSON result; the line before it is the card's name
and power limit; before that a JSON line describes each kernel.
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


def image(h, w, seed=0):
    import numpy as np

    # bench.py's input: N(0,1)·0.01 from np.random.default_rng(seed)
    return (np.random.default_rng(seed).standard_normal((h, w)) * 0.01
            ).astype(np.float32)


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
    from recfilter_tpu_torch.apps import audio_filter_high_order
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

    print("== phase 3a: the 2-D path end to end through RecFilter.as_func()",
          flush=True)
    main_launches = {}

    def only(**kw):
        """Launch counts with every kernel not named at 0."""
        return {k: kw.get(k, 0) for k in launch.SIGNATURES}

    for label, (F, mod, img) in modules.items():
        x = torch.from_numpy(img).to(dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            launch.reset_launches()
            y = mod(x)
            torch.cuda.synchronize()
            launches = dict(launch.LAUNCHES)
        print(f"  {label}: launches {launches}")
        check(launches == only(moments2d=1, final2d=1),
              f"{label}: each 2-D kernel launched once by the call, no 1-D "
              "kernel")
        if label == "4096x4096 zero":
            main_launches.update(moments2d=launches["moments2d"],
                                 final2d=launches["final2d"])
        check(tuple(y.shape) == img.shape and bool(torch.isfinite(y).all()),
              f"{label}: output finite, shape {img.shape}")
        oracle = rft.oracle_apply(F.spec, img.astype(np.float64))
        peak = float(np.abs(oracle).max())
        err = float(np.abs(y.cpu().numpy().astype(np.float64)
                           - oracle).max()) / peak
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
            torch.cuda.synchronize()
            launch.reset_launches()
            y = mod(x)
            torch.cuda.synchronize()
            launches = dict(launch.LAUNCHES)
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

    print("== phase 4: gradients through the kernel paths", flush=True)
    img = image(512, 512, seed=1)
    grad_cases = [
        ("2-D 512²", build_filter(rft, 512, 512, img).as_func().to(dev),
         img),
        ("1-D 300,000 order 3",
         audio_filter_high_order(300_000, 3, 1000).as_func().to(dev),
         signal((300_000,), seed=1))]
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

    kernels = [
        {"name": name, "route": "cuda",
         "source": f"recfilter_tpu_torch/kernels/csrc/{name}.cu",
         "replaces": replaces, "launches": main_launches[name],
         "max_abs_err": max_abs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, replaces in (
            ("moments2d", "recfilter_tpu/kernels/final2d.py:409"),
            ("final2d", "recfilter_tpu/kernels/final2d.py:853"),
            ("tails", "recfilter_tpu/kernels/completion.py:750"),
            ("completion", "recfilter_tpu/kernels/completion.py:464"))
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
