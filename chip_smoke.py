#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU: build, check, time.

    python3 chip_smoke.py

Drives ``recfilter_tpu_torch`` (never jax) through its public API on the
headline filter of ``bench.py::_build_filter`` — a 3rd-order Gaussian
(σ=5), causal and anticausal on x and y, 128-wide tiles, float32, px6 —
at 4096², and fails (non-zero exit, traceback) if any phase fails:

  1. the card, its power limit and the fp32 matmul settings; build both
     CUDA kernels from ``recfilter_tpu_torch/kernels/csrc``;
  2. each kernel against its plain PyTorch twin on the card at the main
     path's shapes (4096² zero border, 4096² clamp, 1080×1920 padded):
     max|kernel − twin| ≤ 1e-5·max|twin|;
  3. the filter end to end through ``RecFilter.as_func()`` on the card
     against the f64 numpy oracle, max|y − oracle| ≤ 2e-6·max|oracle| (the
     JAX package's px6 bound), with each kernel launched exactly once per
     call;
  4. the gradient of sum(y²) at 512² through the kernel path against the
     plain path, within 1e-4;
  5. device times (CUDA events, median of single calls) of the whole call
     and of each kernel, beside their plain twins.

The last line is the JSON result; the line before it is the card's name
and power limit; before that a JSON line describes each kernel.
"""

import json
import os
import statistics
import subprocess
import sys

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

    import recfilter_tpu_torch as rft
    from recfilter_tpu_torch.kernels import _build
    from recfilter_tpu_torch.kernels import final2d as k2d
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
    for name, sig in k2d._SIGNATURES.items():
        _build.load(name, sig)
        log = _build.build_logs.get(name, "(library was already built)")
        print(f"built {name}:\n" + "\n".join(
            "    " + ln for ln in log.strip().splitlines()))

    print("== phase 2: kernels against their plain twins on the card",
          flush=True)
    cases = {"4096x4096 zero": (H, W, False),
             "4096x4096 clamp": (H, W, True),
             "1080x1920 zero (padded)": (1080, 1920, False)}
    modules, max_abs = {}, {"moments2d": 0.0, "final2d": 0.0}
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

    print("== phase 3: end to end through RecFilter.as_func() on the card",
          flush=True)
    headline_launches = None
    for label, (F, mod, img) in modules.items():
        x = torch.from_numpy(img).to(dev)
        with torch.no_grad():
            torch.cuda.synchronize()
            k2d.reset_launches()
            y = mod(x)
            torch.cuda.synchronize()
            launches = dict(k2d.LAUNCHES)
        print(f"  {label}: launches {launches}")
        check(launches == {"moments2d": 1, "final2d": 1},
              f"{label}: each kernel launched once by the call")
        if headline_launches is None:
            headline_launches = launches
        check(tuple(y.shape) == img.shape and bool(torch.isfinite(y).all()),
              f"{label}: output finite, shape {img.shape}")
        oracle = rft.oracle_apply(F.spec, img.astype(np.float64))
        peak = float(np.abs(oracle).max())
        err = float(np.abs(y.cpu().numpy().astype(np.float64)
                           - oracle).max()) / peak
        print(f"  {label}: max|y - oracle|/max|oracle| = {err:.3e}")
        check(err <= 2e-6, f"{label}: within the px6 bound 2e-6 of the "
              "f64 oracle")

    print("== phase 4: gradient through the kernel path, 512²", flush=True)
    img = image(512, 512, seed=1)
    mod = build_filter(rft, 512, 512, img).as_func().to(dev)
    grads = []
    for fwd in (mod.forward, mod.forward_plain):
        x = torch.from_numpy(img).to(dev).requires_grad_()
        (g,) = torch.autograd.grad((fwd(x) ** 2).sum(), x)
        grads.append(g)
    dg = (grads[0] - grads[1]).abs()
    bound = 1e-4 + 1e-4 * grads[1].abs()
    print(f"  max|g_kernel - g_plain| = {dg.max().item():.3e} "
          f"(max|g| = {grads[1].abs().max().item():.3e})")
    check(bool((dg <= bound).all()), "gradient within rtol=atol=1e-4")

    print("== phase 5: device times at 4096² (CUDA events, median of "
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

    kernels = [
        {"name": name, "route": "cuda",
         "source": f"recfilter_tpu_torch/kernels/csrc/{name}.cu",
         "replaces": replaces, "launches": headline_launches[name],
         "max_abs_err": max_abs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, replaces in (
            ("moments2d", "recfilter_tpu/kernels/final2d.py:409"),
            ("final2d", "recfilter_tpu/kernels/final2d.py:853"))
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
