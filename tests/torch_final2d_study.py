"""Study of the 2-D executor's two kernels on the card, ``moments2d`` and
``final2d`` (px6), at the headline's shape: the yardsticks of their
redesign, run on any checkout of the port.

    python tests/torch_final2d_study.py [--root DIR] [--tag NAME]
        [--out rows.jsonl] [--check] [--heat SECONDS]

``--root`` is the checkout whose ``recfilter_tpu_torch`` is measured (by
default this one): an older checkout unpacked beside it measures its
kernels on the same inputs, so two versions compare within one call to
the card, in turns (parent, change, change, parent: one process each).

Rows (one JSON object each, printed and appended to ``--out``):
  * ``build``: each kernel's registers, spills and stack from ``nvcc
    -Xptxas -v`` (the lines of the two sources' kernels), and any note
    that ptxas serialized a kernel's ``wgmma`` products;
  * ``time``: device time per call of ``moments2d`` (float32, bf16, and
    with C1's 16 edge rows), ``final2d`` and ``final2d_epi`` (the unsharp
    combine, k = 1) at the 4096² headline (the σ=5 Gaussian, zero border,
    its tiles and carries), each the CUDA-event time of 100 back-to-back
    calls queued behind a sleeping kernel (the device's work alone); and
    each kernel's bound at the card's peaks
    (3.35 TB/s; ``final2d``: six split-bf16 products of 136-deep
    contractions on both axes at 989 TFLOP/s; ``moments2d``: Ka + 2·Kb
    fp64 MACs a pixel at 67 TFLOP/s), with the card's SM clock,
    temperature, power draw and clock-limiting reasons
    (``chip_smoke.card_state``) read after it;
  * ``heat`` (with ``--heat``): ``final2d`` under a sustained load —
    rounds of 4000 back-to-back calls, the card's state read while they
    run, then a queued window of 100 — for that many seconds: how the
    kernel's time follows the card's clock as it warms;
  * ``call``: the whole calls that launch both kernels — the headline,
    V1 (256³, zero border) and V2 (512³, clamp), the Gaussian on every
    axis — their launches, CUDA events (median of 10), queued device time
    (20 calls) and a profile of 10 (``utils.timing.device_profile``: busy
    time, idle share, device ops, top ops; busy None where every window
    lost events);
  * ``digest``: sha256 of ``final2d``'s and ``final2d_epi``'s outputs at
    the headline, and of ``moments2d_naf``'s and ``moments2d_k``'s on
    seeded inputs (equal digests across two checkouts mean equal bits);
  * with ``--check`` (the checkout's own kernels against its twins):
    ``final2d`` and ``final2d_epi`` within 1e-5 of the float32 twin's
    peak and, where the module has it, within ``split_exact``'s bound
    per output (and a control with the level-2 pair (0, 2) left out
    outside it), on the 4096² zero and clamp stacks and the padded 1080 ×
    1920 frame; ``moments2d`` (float32, bf16, edge rows) within 1e-5 of
    its twin, bf16 equal to float32 on the same values.
"""

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import chip_smoke as cs  # noqa: E402  (its helpers and the card's peaks)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="this")
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--heat", type=float, default=0.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the study measures the card", flush=True)
        return 1
    import recfilter_tpu_torch as rft
    from recfilter_tpu_torch import dimfuse as tdf
    from recfilter_tpu_torch.epilogue import Affine
    from recfilter_tpu_torch.spec import Scan
    from recfilter_tpu_torch.kernels import _build
    from recfilter_tpu_torch.kernels import final2d as tk2d
    from recfilter_tpu_torch.kernels import launch
    from recfilter_tpu_torch.utils import timing

    dev = torch.device("cuda")
    card = cs.card_line()
    rows = []

    def emit(row):
        row = {"tag": args.tag, "card": card, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    emit({"row": "package", "path": os.path.dirname(rft.__file__)})
    t0 = time.perf_counter()
    _build.build(["final2d", "moments2d"])
    for name in ("final2d", "moments2d"):
        log = _build.build_logs.get(name, "")
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "serializ")):
                emit({"row": "build", "kernel": name, "ptxas": line.strip()})
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    def build(h, w, clamp, seed=0):
        """The headline Gaussian at (h, w) through as_func(), its input,
        and the modules' matrices."""
        img = (np.random.default_rng(seed).standard_normal((h, w)) * 0.01
               ).astype(np.float32)
        wts = rft.gaussian_weights(5.0, 3)
        x, y = rft.Dim("x", w), rft.Dim("y", h)
        F = rft.RecFilter("GaussianIIR")
        if clamp:
            F.set_clamped_image_border()
        F[y, x] = img
        for d in (+x, -x, +y, -y):
            F.add_filter(d, wts)
        F.split(x, 128, y, 128)
        mod = F.as_func()
        ms = []
        for ax, n, pad in ((0, mod.na, mod.pad_a), (1, mod.nb, mod.pad_b)):
            scans = [Scan(ax, c, wts[0], tuple(wts[1:]))
                     for c in (True, False)]
            m = tdf.prepare_dim_pass(scans, 128, n, clamp, pad_slots=pad)
            ms += [np.asarray(m.Btot),
                   np.concatenate([np.asarray(g) for g in m.G], 1),
                   np.concatenate([np.asarray(r) for r in m.Rhat], 2)]
        return mod, img, ms

    def queued_ms(fn, *a, n=100):
        """(ms per call, whether the host enqueued faster than the sleep)."""
        ms, host, sleep = cs.queued_ms(fn, *a, n=n)
        return ms, host < sleep

    def event_ms(fn, *a, n=30):
        ts = []
        for _ in range(n):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            fn(*a)
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        return statistics.median(ts)

    nbytes, rel = cs.tensor_bytes, cs.rel_err

    fails = []

    def check(ok, what):
        print(f"  {'ok' if ok else 'FAIL'}: {what}", flush=True)
        if not ok:
            fails.append(what)

    mod, img, (Ba, Ga, Ra, Bb, Gb, Rb) = build(4096, 4096, False)
    with torch.no_grad():
        xi = torch.from_numpy(img).to(dev)
        X4 = mod.tile(xi)
        NA_t, NB_t = mod.carries(X4, mod.moments.plain)
        fin, mom = mod.final, mod.moments
        Ka, Kb, pix = mom.Ka, mom.Kb, X4.numel()
        na, nb = mom.na, mom.nb
        edge = tk2d.Moments2D(Ga, Gb, Ba, na, nb, edge=(Ba, 16)).to(dev)
        fin_epi = tk2d.Final2D(Ba, Ra, Bb, Rb, na, nb, affine=Affine(
            -1.0, (2.0,), 0.0)).to(dev)  # 2·image − blur
        Xb = X4.to(torch.bfloat16)
        cases = {
            "moments2d": (mom, (X4,), nbytes(X4, NA_t, NB_t),
                          2.0 * (Ka + 2 * Kb) * pix, cs.PEAK_FP64),
            "moments2d_bf16": (mom, (Xb,), nbytes(Xb, NA_t, NB_t),
                               2.0 * (Ka + 2 * Kb) * pix, cs.PEAK_FP64),
            "moments2d_edge16": (edge, (X4,), nbytes(X4, NA_t, NB_t)
                                 + 2 * 16 * pix // 128 * 4,
                                 2.0 * (Ka + 2 * Kb + 32) * pix, cs.PEAK_FP64),
            "final2d": (fin, (X4, NA_t, NB_t), nbytes(X4, NA_t, NB_t, X4),
                        2.0 * 2 * 6 * 136 * pix, cs.PEAK_BF16),
            "final2d_epi": (fin_epi, (X4, NA_t, NB_t, X4),
                            nbytes(X4, NA_t, NB_t, X4, X4),
                            2.0 * 2 * 6 * 136 * pix, cs.PEAK_BF16),
        }
        for name, (m, a, nb_, fl, rate) in cases.items():
            launch.reset_launches()
            ms, clean = queued_ms(m, *a)
            bound = max(nb_ / cs.PEAK_BYTES, fl / rate) * 1e3
            emit({"row": "time", "kernel": name, "queued_ms": ms,
                  "queued_clean": clean, "event_ms": event_ms(m, *a),
                  "bound_ms": bound, "share": bound / ms,
                  "card_state": cs.card_state()})
        # the card under a sustained load: final2d's calls back to back
        # for --heat seconds, each round 4000 calls (the card's state read
        # while they run), then a queued window of 100
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < args.heat:
            for _ in range(4000):
                fin(X4, NA_t, NB_t)
            state = cs.card_state()
            torch.cuda.synchronize()
            ms, clean = queued_ms(fin, X4, NA_t, NB_t)
            emit({"row": "heat", "kernel": "final2d",
                  "s": time.perf_counter() - t_start, "queued_ms": ms,
                  "queued_clean": clean, "card_state": state})
        # whole calls that launch both kernels: the headline, V1 (256³,
        # zero border) and V2 (512³, clamp) — the σ=5 Gaussian on every
        # axis — each its events, its queued device time and a profile
        calls = [("headline 4096²", mod, xi)]
        for label, shape, clamp in (("V1 256³", (256,) * 3, False),
                                    ("V2 512³", (512,) * 3, True)):
            wts = rft.gaussian_weights(5.0, 3)
            dims = [rft.Dim(nm, e) for nm, e in zip("zyx", shape)]
            Fv = rft.RecFilter("GaussianND")
            if clamp:
                Fv.set_clamped_image_border()
            vol = (np.random.default_rng(0).standard_normal(shape) * 0.01
                   ).astype(np.float32)
            Fv[tuple(dims)] = vol
            for d in dims:
                Fv.add_filter(+d, wts)
                Fv.add_filter(-d, wts)
            Fv.split({d: 128 for d in dims})
            calls.append((label, Fv.as_func(), torch.from_numpy(vol).to(
                dev)))
        for label, fn, arg in calls:
            launch.reset_launches()
            fn(arg)
            torch.cuda.synchronize()
            used = {k: v for k, v in launch.LAUNCHES.items() if v}
            prof = timing.device_profile(fn, arg, iterations=10, attempts=3)
            q, clean = queued_ms(fn, arg, n=20)
            emit({"row": "call", "call": label, "launches": used,
                  "event_ms": event_ms(fn, arg, n=10),
                  "queued_ms": q, "queued_clean": clean,
                  "busy_ms": prof["busy_ms"], "idle": prof["idle"],
                  "device_ops": prof["device_ops"],
                  "top": [[n[:40], ms] for n, ms in prof["top"]]})

        # the kernels not redesigned: their bits
        def digest(*ts):
            h = hashlib.sha256()
            for t in ts:
                h.update(t.contiguous().cpu().numpy().tobytes())
            return h.hexdigest()[:16]

        emit({"row": "digest", "kernel": "final2d",
              "sha256": digest(fin(X4, NA_t, NB_t)),
              "epi": digest(fin_epi(X4, NA_t, NB_t, X4))})
        sm, _, (sBa, sGa, _, _, sGb, _) = build(1024, 1024, True, seed=3)
        xs = sm.tile(torch.from_numpy(np.random.default_rng(5).standard_normal(
            (1024, 1024)).astype(np.float32)).to(dev))
        naf = tk2d.Moments2D(sGa, sGb, sBa, sm.na, sm.nb, solve=np.eye(
            sm.na * 8) * 0.5 + 0.01).to(dev)
        emit({"row": "digest", "kernel": "moments2d_naf",
              "sha256": digest(*naf(xs)), "bf16": digest(*naf(
                  xs.to(torch.bfloat16)))})
        if hasattr(tk2d, "Moments2DK"):
            rng = np.random.default_rng(7)
            Ga = rng.standard_normal((1, 12, 128)) * 0.1
            Gb = rng.standard_normal((1, 10, 128)) * 0.1
            mk = tk2d.Moments2DK(Ga, Gb, 8, 8).to(dev)
            xk = torch.from_numpy(rng.standard_normal(
                (1, 8, 128, 1024)).astype(np.float32)).to(dev)
            emit({"row": "digest", "kernel": "moments2d_k",
                  "sha256": digest(*mk(xk))})

        if args.check:
            stacks = {"4096 zero": (4096, 4096, False),
                      "4096 clamp": (4096, 4096, True),
                      "1080x1920 padded": (1080, 1920, False)}
            for label, (h, w, clamp) in stacks.items():
                mc, imc, (cBa, _, cRa, cBb, _, cRb) = build(h, w, clamp,
                                                            seed=1)
                Xc = mc.tile(torch.from_numpy(imc).to(dev))
                Nc = mc.carries(Xc, mc.moments.plain)
                for got, want in zip(mc.moments(Xc), mc.moments.plain(Xc)):
                    check(rel(got, want) <= 1e-5, f"{label} moments2d "
                          f"{rel(got, want):.3e} within 1e-5")
                gb = mc.moments(Xc.to(torch.bfloat16))
                check(all(torch.equal(g, f) for g, f in zip(
                    gb, mc.moments(Xc.to(torch.bfloat16).float()))),
                    f"{label} moments2d_bf16 = moments2d on its values")
                launch.reset_launches()
                y = mc.final(Xc, *Nc)
                torch.cuda.synchronize()
                check(launch.LAUNCHES["final2d"] == 1, "one final2d launch")
                e = rel(y, mc.final.plain(Xc, *Nc))
                check(e <= 1e-5, f"{label} final2d {e:.3e} within 1e-5")
                if hasattr(mc.final, "split_exact"):
                    ref, bnd = mc.final.split_exact(Xc, *Nc)
                    d = (y.double() - ref).abs()
                    check(bool((d <= bnd).all()), f"{label} final2d within "
                          f"split_exact's bound (max d/bound "
                          f"{(d / bnd).max().item():.3f}, bound/peak "
                          f"{(bnd.max() / ref.abs().max()).item():.3e})")
                    ref2, bnd2 = mc.final.split_exact(Xc, *Nc, drop=(0, 2))
                    out = ((y.double() - ref2).abs() > bnd2).double().mean()
                    check(out.item() > 0, f"{label} control (0, 2) left "
                          f"out: {out.item():.4f} of outputs outside")
                    sp = mc.final.split_plain(Xc, *Nc)
                    print(f"  {label} kernel vs six-product twin: "
                          f"{rel(y, sp):.3e} of its peak", flush=True)
                    del ref, bnd, ref2, bnd2, d, sp
                fe = tk2d.Final2D(cBa, cRa, cBb, cRb, mc.na, mc.nb,
                                  affine=Affine(0.75, (1.0, 2.0), 0.5)
                                  ).to(dev)
                aux = [Xc * 0.5, Xc.flip(-1).contiguous()]
                ye = fe(Xc, *Nc, *aux)
                e = rel(ye, fe.plain(Xc, *Nc, *aux))
                check(e <= 1e-5, f"{label} final2d_epi k=2 {e:.3e} within "
                      "1e-5")
                del Xc, Nc, y, ye, aux
                torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    print(json.dumps({"fails": fails, "tag": args.tag}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
