"""Study of the rotated completion and the tails kernels on the card, each
beside the one PyTorch call that emits its own layout: the yardsticks of
their redesign, run on any checkout of the port.

    python tests/torch_rot_tails_study.py [--root DIR] [--tag NAME]
        [--out rows.jsonl] [--calls-only] [--parts LETTERS]

``--root`` is the checkout whose ``recfilter_tpu_torch`` is measured (by
default this one): an older checkout unpacked beside it measures its
kernels with the same inputs, so two versions compare within one run
(``--tag`` names the rows). Every shape is a main path's:

A  C1's x pass (DoG SAT 4096², the SAT's x scan, feedback (2, −1): x
   (4096, 32, 128), sl = 8, one matrix variant): ``completion_rot`` with
   the radius-5 stencil (3 taps, reach 12 / 10) and without one,
   ``completion_rot_epi`` (the DoG's subtraction a − o, k = 1, c = 0) with
   and without the stencil. Yardsticks: ``torch.matmul(BR0ᵀ, XNᵀ)`` → (n,
   128, q), the rotated layout (no stencil; its device ops listed, so a
   copy of the permuted operand shows), the unrotated ``torch.matmul(XN,
   BR0)`` of earlier PRs, and ``torch.baddbmm`` with the mix as alpha and
   beta (the epilogue, no stencil).
B  L1's x pass (4096², S = 6 runtime tail rows): ``tails_traced`` beside
   ``torch.matmul(G, Xᵀ)`` → (n, S, q) and the earlier ``torch.matmul(x
   (q·n, 128), Gᵀ)``; ``tails`` at the same shape with fp64 and with fp32
   sums (the latter a probe, on no path).
C  A's kernel pass (``audio_filter_high_order(10M, 2, 1000)``: x (306,
   256, 128)): ``tails`` with fp64 and fp32 sums beside the einsum of the
   slot rows.
D  The unrotated completions at their main paths' shapes: ``completion``
   at A's kernel pass (S = 2, sl = 8, one variant) beside ``torch.matmul
   ([x, Nᵀ], [Btotᵀ; Rcatᵀ])``; ``completion_epi`` there with the mix
   0.7·y + 0.3·x (k = 1) beside ``torch.addmm``; ``completion_traced`` at
   L1's x pass (S = 6) beside the same ``matmul`` of its runtime
   matrices. Their bound counts the six split-bf16 products of the
   tensor-core kernels (at 989 TFLOP/s) against the bytes; the fp32
   bound of the earlier kernels is kept beside it (``fp32_bound_ms``).
F  The rows pass (a scan on a non-last axis): ``rows_tails`` and
   ``rows_final`` at V1's rows pass (256³, zero border, the σ=5 Gaussian
   on z: x (1, 2, 128, 65536), K = 6, ``chip_smoke.py``'s input) and
   V2's (512³, clamp: x (1, 4, 128, 262144), three matrix variants), the
   carries solved by the twins; yardsticks ``torch.matmul(G, x)`` (fp32
   sums) and ``torch.matmul([Btot | Rhat], [x; N])``. ``rows_final``'s
   bound counts of N only the K real slot rows, and the six split-bf16
   products of the tensor-core kernel over 128 + K (the fp32 bound of the
   earlier kernel beside it), ``rows_tails``'s its
   fp64 MACs at 67 TFLOP/s. Before them, each volume's whole call as E
   measures it. Where the checkout's ``RowsFinal`` takes ``nprod``, each
   volume's whole call also at px4, px3 and ``default``, and
   ``rows_final`` at V1 at those grades (bound: the
   bytes and the grade's bf16 products, nprod on x and at least three on
   N's K rows; yardstick the ``matmul`` by the grade's constant, the sum
   of its chunks). Then ``completion_split`` at E (64 × 32,768, clamp,
   three matrix variants) at px3, px4 and ``default``, beside one batched
   ``matmul`` of [x, Nᵀ] by the grade's [Btotᵀ; Rᵀ], as ``chip_smoke.py``
   phase 3m times it.
G  Output digests: the sha256 of the outputs of ``completion`` and
   ``completion_epi`` (A's kernel-pass shape, seeded matrices),
   ``completion_traced`` and ``completion_rot`` (L1's x pass), the rows
   kernels (V1), ``final2d`` and ``final2d_stencil`` (the headline
   Gaussian at 1024², C1's bank on it) and ``fir_band`` (F1's and F3's
   passes at 1024², px6), and of the float32 forms that bf16 storage
   shares a source with: ``moments2d`` and ``final2d_split`` at
   ``default`` (the headline at 1024²) and ``rows_final`` at ``default``
   (V1), on seeded inputs, so two checkouts' kernels are bit-equal where
   the digests agree. Also ``tails`` and ``completion_split`` at
   ``default`` (A's shape), ``completion_rot`` and
   ``completion_rot_tails`` at ``default`` (L1's), and where the checkout
   has them the bf16 storage entries on the same inputs rounded to bf16:
   ``tails_bf16``, ``completion_split_bf16`` and ``_epi_bf16`` (A's),
   ``completion_rot_bf16``, ``_epi_bf16`` and ``completion_rot_tails_bf16``
   (L1's). The stencil consumers: ``final2d_stencil`` at ``default``,
   px3 and px4 (C1's bank on the 1024² headline), ``tails_extra`` and
   ``completion_rot`` with C1's radius-5 stencil at px6 and ``default``
   (L1's x pass) and ``stencil2d`` (C4's Sobel bank on a 1024 × 2048
   image), and where the checkout has them their bf16 entries on the
   same inputs rounded to bf16: ``final2d_stencil_bf16``,
   ``tails_extra_bf16``, ``completion_rot_stencil_bf16`` and
   ``_epi_bf16``, ``stencil2d_bf16``.
I  The fused consumers at px6 and each grade (px4, px3, ``default``),
   where the checkout's app builders take ``matmul_precision``:
   ``fir_band`` at F1's x pass and F3's two passes (4096², box³ radius 5;
   radii 5 and 9 with the apps' ``tap_scale``) beside ``conv1d``,
   ``final2d_stencil`` at C1's SAT stage, U1's final pass with the
   combine in its store (``final2d_epi``, ``final2d_split_epi``) and E1's
   completion with the mix (64 × 32,768: ``completion_epi``,
   ``completion_split_epi``) beside one ``addmm`` by the grade's constant.
   Bounds: the bytes, the grade's bf16 products or fp32 FMAs (the bank's
   and the epilogue's operations at the fp32 peak).
H  The rotated kernels at each grade (px6, px4, px3, ``default``), where
   the checkout's ``CompletionPass`` takes ``nprod`` (else K3's
   ``completion_rot_tails`` at px6 alone): ``completion_rot`` at
   C1's x pass without a stencil (beside one ``matmul`` by the grade's
   constant, held to the float32 product by it) and with the radius-5
   stencil; ``completion_rot_tails`` at K3's first
   pass (102,400 lines, 4 tiles, the σ=5 Gaussian's matrices) and K6's
   (the 512 × 40,960 panorama's: 512 lines, 320 tiles, as the module at
   the grade builds it) beside ``completion_rot`` + ``tails`` at the
   grade. Bounds: the bytes and the
   grade's bf16 products (the stencil's and the tails' operations at
   their own peaks).
E  (run first) The whole calls those completions serve: A
   (``audio_filter_high_order(10M, 2, 1000)`` through ``as_func()``) and
   L1 (the σ=5 Gaussian's ``LearnableRecFilter`` forward at 4096², no
   gradient): CUDA-event median of single calls, the profiler's call
   time, device busy time, idle share, device ops per call and largest
   ops, the host's time a call (calls issued back to back, unsynchronised:
   what the host takes to issue one, ``host_ms``) and the CUDA runtime
   calls' host time in it (``runtime_api_us``).

Each row: CUDA-event median of single calls, the host's time a call
(``host_ms``, as in E), the profiler's device time
per call, the bound (bytes over 3.35 TB/s, or operations at their type's
peak: fp32 67 TFLOP/s, bf16 989) and its share, the error against the library call (rel. to its peak;
held ≤ 1e-5 before it is timed), the SM clock and power draw that
nvidia-smi reads while the kernel runs back to back, and the card's name
and power limit.
Inputs N(0,1) from numpy seeds. Not a pytest module: it needs the card
and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES, PEAK_FP32, PEAK_BF16 = 3.35e12, 67e12, 989e12


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="checkout whose recfilter_tpu_torch is measured")
    ap.add_argument("--tag", default="this", help="names the rows")
    ap.add_argument("--out", help="also append each row here (JSON lines)")
    ap.add_argument("--calls-only", action="store_true",
                    help="only part E, the whole calls")
    ap.add_argument("--parts", default="EABCD",
                    help="the parts to run, as letters (A-D run together)")
    args = ap.parse_args()
    parts = "E" if args.calls_only else args.parts
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch
    import torch.nn.functional as F_

    if not torch.cuda.is_available():
        print("torch_rot_tails_study: needs a CUDA device", file=sys.stderr)
        return 1
    import recfilter_tpu_torch as rft
    from recfilter_tpu_torch import dimfuse as tdf
    from recfilter_tpu_torch.apps import audio_filter_high_order
    from recfilter_tpu_torch.apps.dog import _stencil
    from recfilter_tpu_torch.kernels import completion as kc
    from recfilter_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    card = card_line()
    rows = []

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def event_ms(fn, *a):
        return statistics.median(timing.call_times_ms(fn, *a, iterations=50,
                                                      warmup=3))

    def host_ms(fn, *a, launches=1):
        """Host time a call: ``time.perf_counter`` over calls issued back
        to back without a sync (at most ~800 launches, which the device's
        queue takes without blocking), after three warm-up calls."""
        calls = max(1, int(800 // launches))
        for _ in range(3):
            fn(*a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*a)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / calls

    def api_us(fn, *a, iterations=10):
        """The CUDA runtime calls' host time a call (µs; the profiler's CPU
        events named cuda*), largest first."""
        from torch.profiler import ProfilerActivity, profile

        fn(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iterations):
                fn(*a)
            torch.cuda.synchronize()
        got = [[e.key, e.cpu_time_total / iterations, e.count / iterations]
               for e in prof.key_averages() if e.key.startswith("cuda")]
        return sorted(got, key=lambda g: -g[1])[:6]

    def dev_ms(fn, *a):
        prof = timing.device_profile(fn, *a, iterations=10)
        return prof["busy_ms"], prof["top"]

    def clocks_under(fn, a):
        """The SM clock (MHz) and power draw (W) nvidia-smi reads while
        ``fn(*a)`` runs back to back; None without nvidia-smi."""
        got = {}

        def query():
            try:
                got["smi"] = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=30).stdout.strip().splitlines()[0]
            except (OSError, IndexError, subprocess.SubprocessError):
                pass

        reader = threading.Thread(target=query)
        for _ in range(20):
            fn(*a)
        reader.start()
        while reader.is_alive():
            for _ in range(20):
                fn(*a)
            torch.cuda.synchronize()
        if "smi" not in got:
            return None, None
        mhz, watts = (float(v) for v in got["smi"].split(","))
        return mhz, watts

    def row(label, fn, a, nb, flops, lib=None, lib_name=None, ref=None,
            rate=PEAK_FP32, fp32_flops=None):
        """Time ``fn(*a)`` (and ``lib(*a)``, held to it first); print and
        keep the row. ``flops`` operations at ``rate``; ``fp32_flops``: the
        fp32 bound of the same function, kept beside it."""
        with torch.no_grad():
            out = fn(*a)
            r = {"tag": args.tag, "case": label, "card": card}
            if lib is not None:
                got = lib(*a)
                want = out if ref is None else ref(out)
                err = ((got.double() - want.double()).abs().max()
                       / want.double().abs().max()).item()
                if not err <= 1e-5:
                    raise SystemExit(f"{label}: {lib_name} is not the "
                                     f"kernel's function ({err:.3e})")
                r.update(library=lib_name, library_err=err,
                         library_event_ms=event_ms(lib, *a))
                r["library_device_ms"], top = dev_ms(lib, *a)
                r["library_ops"] = [[nm[:48], ms] for nm, ms in top]
                r["library_sm_clock_mhz"], _ = clocks_under(lib, a)
            r["event_ms"] = event_ms(fn, *a)
            r["host_ms"] = host_ms(fn, *a)
            r["device_ms"], _ = dev_ms(fn, *a)
            r["sm_clock_mhz"], r["power_w"] = clocks_under(fn, a)
        t_b, t_o = nb / PEAK_BYTES * 1e3, flops / rate * 1e3
        r["bound_ms"], r["bound_by"] = max(t_b, t_o), (
            "bytes" if t_b >= t_o else "operations")
        if fp32_flops is not None:
            r["fp32_bound_ms"] = max(t_b, fp32_flops / PEAK_FP32 * 1e3)
        d = r["device_ms"] or r["event_ms"]
        r["share"] = r["bound_ms"] / d
        rows.append(r)
        print(json.dumps(r), flush=True)

    def whole(label, fn, v):
        with torch.no_grad():
            prof = timing.device_profile(fn, v, iterations=10)
            r = {"tag": args.tag, "case": label, "card": card,
                 "event_ms": event_ms(fn, v), "call_ms": prof["call_ms"],
                 "busy_ms": prof["busy_ms"], "idle": prof["idle"],
                 "device_ops": prof["device_ops"],
                 "host_ms": host_ms(fn, v,
                                    launches=max(1, prof["device_ops"])),
                 "runtime_api_us": api_us(fn, v),
                 "top": [[nm[:48], ms] for nm, ms in prof["top"]]}
        rows.append(r)
        print(json.dumps(r), flush=True)

    if "F" in parts:
        rows_pass(torch, np, rft, dev, row, whole, nbytes)
    if "G" in parts:
        digests(torch, np, rft, tdf, kc, dev, args.tag, card, rows)
    if "H" in parts:
        grades(torch, np, rft, tdf, kc, dev, row, nbytes)
    if "I" in parts:
        consumers(torch, np, rft, dev, row, nbytes)
    if "E" not in parts and not set("ABCD") & set(parts):
        return finish(rows, args.out, card)
    # E (first: a long run's profiles lose device events now and then):
    # the whole calls of A and L1
    F = audio_filter_high_order(10_000_000, 2, 1000)
    modA = F.as_func()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        F._image.shape).astype(np.float32) * 0.1).to(dev)

    if "E" in parts:
        whole("A whole call, 10M samples", modA, x)
    from recfilter_tpu_torch.learnable import LearnableRecFilter

    size = 4096
    img = (np.random.default_rng(0).standard_normal((size, size)) * 0.01
           ).astype(np.float32)
    xd, yd = rft.Dim("x", size), rft.Dim("y", size)
    G = rft.RecFilter("GaussianIIR")
    G[yd, xd] = img
    for d in (+xd, -xd, +yd, -yd):
        G.add_filter(d, rft.gaussian_weights(5.0, 3))
    G.split(xd, 128, yd, 128)
    if "E" in parts:
        whole("L1 LearnableRecFilter forward 4096²",
              LearnableRecFilter(G.spec, tile_width=128, device=dev),
              torch.from_numpy(img).to(dev))
    del img, G
    if not set("ABCD") & set(parts):
        return finish(rows, args.out, card)

    def operand(comp):
        """[Btotᵀ; Rcatᵀ] of one variant, (128 + sl, 128), from the twin's
        float32 matrices (every checkout has them)."""
        R = F_.pad(comp.R_v[0], (0, comp.sl - comp.R_v.shape[2]))
        return torch.cat([comp.B_v[0].t(), R.t()]).contiguous()

    # A: C1's x pass
    q, n, S = 4096, 32, 2
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    X = f32(q, n, 128)
    Nt = torch.zeros((n, 8, q), device=dev)
    Nt[:, :S] = f32(n, S, q)
    aux = f32(n * 128, q)
    scans = [rft.Scan(1, True, 1.0, (2.0, -1.0))]
    mods = {}
    for st in (None, _stencil(5)):
        for epi in (None, lambda o, a_: a_ - o):
            le = tdf.LastAxisPass(scans, (128, n, 0), False, "px6",
                                  rot_axes=2, stencil=st, epilogue=epi
                                  ).to(dev)
            mods[st is not None, epi is not None] = (
                le.completion if st is None else le.st_comp[0])
    comp = mods[False, False]
    if comp.B_v.shape[0] != 1:
        raise SystemExit("C1's x pass: one matrix variant expected")
    BR0 = operand(comp)
    XN = torch.cat([X, Nt.permute(2, 0, 1)], dim=2)
    XNt = XN.permute(1, 2, 0)  # (n, 128 + sl, q), a view
    hp, hn = mods[True, False].hp, mods[True, False].hn
    halos = (f32(n, hp, q), f32(n, hn, q))
    flops = 2.0 * (128 + comp.sl) * X.numel()
    rot = lambda y: y.reshape(n, 128, q)
    row("C1 completion_rot, no stencil", comp, (X, Nt),
        nbytes(X, Nt, X), flops,
        lambda x_, n_: torch.matmul(BR0.t(), XNt),
        "matmul(BR0^T, XN^T) -> (n, 128, q)", rot)
    row("C1 completion_rot, no stencil [unrotated matmul]", comp, (X, Nt),
        nbytes(X, Nt, X), flops,
        lambda x_, n_: torch.matmul(XN, BR0),
        "matmul(XN, BR0) -> (q, n, 128)",
        lambda y: y.reshape(n, 128, q).permute(2, 0, 1))
    st = mods[True, False]
    row("C1 completion_rot, 3-tap stencil", st, (X, Nt, *halos),
        nbytes(X, Nt, *halos, X), flops + 2.0 * 3 * X.numel())
    epi = mods[False, True]
    a_, (b_,) = epi.affine.scale, epi.affine.aux_weights
    BRt = BR0.t().expand(n, -1, -1)
    row("C1 completion_rot_epi (a - o), no stencil", epi, (X, Nt, aux),
        nbytes(X, Nt, aux, X), flops + 4.0 * X.numel(),
        lambda x_, n_, u_: torch.baddbmm(u_.view(n, 128, q), BRt, XNt,
                                         beta=b_, alpha=a_),
        "baddbmm(aux, BR0^T, XN^T, beta=b, alpha=a)", rot)
    row("C1 completion_rot_epi (a - o), 3-tap stencil", mods[True, True],
        (X, Nt, *halos, aux), nbytes(X, Nt, *halos, aux, X),
        flops + (6.0 + 4.0) * X.numel())
    del XN, XNt, aux, halos, mods, comp, st, epi

    # B: L1's x pass
    S = 6
    G = f32(S, 128) * 0.1
    out_b = 4 * n * 8 * q
    row("L1 tails_traced", kc.tails_traced, (X, G), nbytes(X, G) + out_b,
        0.0, lambda x_, g_: torch.matmul(g_, x_.permute(1, 2, 0)),
        "matmul(G, X^T) -> (n, S, q)", lambda b: b[:, :S])
    row("L1 tails_traced [flat matmul]", kc.tails_traced, (X, G),
        nbytes(X, G) + out_b, 0.0,
        lambda x_, g_: torch.matmul(x_.reshape(-1, 128), g_.t()),
        "matmul(x (q n, 128), G^T) -> (q n, S)",
        lambda b: b[:, :S].permute(2, 0, 1).reshape(-1, S))
    tails = kc.TailsPass(G.cpu().numpy()[None], n).to(dev)
    for fp64 in (True, False):
        tails.fp64 = fp64
        row(f"L1 shape tails, fp{64 if fp64 else 32} sums", tails, (X,),
            nbytes(X, tails.G_v) + out_b, 0.0)
    del X

    # C: A's kernel pass
    body = modA.body
    loc = body.locals[0] if hasattr(body, "locals") else body
    XA = F_.pad(x, (0, body.pad)).reshape(-1, loc.n, loc.T).contiguous()
    ta = loc.tails
    if ta.G_v.shape[0] != 1:
        raise SystemExit("A: one matrix variant expected")
    G0 = ta.G_v[0]
    out_a = 4 * loc.n * ta.sl * XA.shape[0]
    for fp64 in (True, False):
        ta.fp64 = fp64
        row(f"A tails {tuple(XA.shape)} S = {ta.S}, "
            f"fp{64 if fp64 else 32} sums", ta, (XA,),
            nbytes(XA, ta.G_v) + out_a, 0.0,
            lambda v: torch.einsum("st,qnt->nsq", G0, v),
            "einsum(G0, x) -> (n, sl, q)")
    ta.fp64 = True

    # D: the unrotated completions (A's kernel pass, L1's x pass)
    q, n = XA.shape[0], loc.n
    NA = torch.zeros((n, 8, q), device=dev)
    NA[:, :2] = f32(n, 2, q)
    comp = loc.completion
    if comp.B_v.shape[0] != 1 or comp.sl != 8:
        raise SystemExit("A: one matrix variant and one carry slot expected")
    BR0 = operand(comp)
    XN = torch.cat([XA, NA.permute(2, 0, 1)], dim=2)
    spl = 2.0 * 6 * (128 + 2) * XA.numel()
    row(f"A completion {tuple(XA.shape)}", comp, (XA, NA),
        nbytes(XA, NA[:, :2], XA), spl,
        lambda x_, n_: torch.matmul(XN, BR0),
        "matmul([x, N^T], [Btot^T; Rcat^T])", rate=PEAK_BF16,
        fp32_flops=2.0 * (128 + 2) * XA.numel())
    le = tdf.LastAxisPass(body.scans, (loc.T, loc.n, 0), False, "px6",
                          epilogue=lambda y_, x_: 0.7 * y_ + 0.3 * x_
                          ).to(dev)
    epi = le.completion
    a_, (b_,) = epi.affine.scale, epi.affine.aux_weights
    XN2 = XN.reshape(-1, 136)
    row(f"A completion_epi (0.7 y + 0.3 x) {tuple(XA.shape)}", epi,
        (XA, NA, XA), nbytes(XA, NA[:, :2], XA, XA),
        spl + 4.0 * XA.numel(),
        lambda x_, n_, u_: torch.addmm(u_.reshape(-1, 128), XN2, BR0,
                                       beta=b_, alpha=a_),
        "addmm(x, [x, N^T], [Btot^T; Rcat^T], beta=b, alpha=a)",
        lambda y: y.reshape(-1, 128), rate=PEAK_BF16,
        fp32_flops=2.0 * (128 + 2) * XA.numel() + 4.0 * XA.numel())
    del XN, XN2, NA, XA, le, epi
    q, n, S = 4096, 32, 6
    X = f32(q, n, 128)
    Btot, Rcat = f32(128, 128) * 0.1, f32(128, S)
    N8 = torch.zeros((n, 8, q), device=dev)
    N8[:, :S] = f32(n, S, q)
    XN = torch.cat([X, N8[:, :S].permute(2, 0, 1)], dim=2)
    BR = torch.cat([Btot.t(), Rcat.t()])
    row("L1 completion_traced (4096, 32, 128), S = 6", kc.completion_traced,
        (X, Btot, Rcat, N8), nbytes(X, Btot, Rcat, N8[:, :S], X),
        2.0 * 6 * (128 + S) * X.numel(),
        lambda *a_: torch.matmul(XN, BR), "matmul([x, N^T], [Btot^T; "
        "Rcat^T])", rate=PEAK_BF16, fp32_flops=2.0 * (128 + S) * X.numel())

    return finish(rows, args.out, card)


def gauss_volume(rft, np, shape, clamp):
    """The σ=5 Gaussian, causal + anticausal on every axis, tiles of 128,
    on ``chip_smoke.py``'s volume input (N(0,1)·0.01, seed 0)."""
    wts = rft.gaussian_weights(5.0, 3)
    dims = [rft.Dim(nm, e) for nm, e in zip("zyx", shape)]
    F = rft.RecFilter("GaussianND")
    if clamp:
        F.set_clamped_image_border()
    F[tuple(dims)] = (np.random.default_rng(0).standard_normal(shape)
                      * 0.01).astype(np.float32)
    for d in dims:
        F.add_filter(+d, wts)
        F.add_filter(-d, wts)
    F.split({d: 128 for d in dims})
    return F


def rows_of(rft, mod):
    """The rows pass of a volume's module (its first stage)."""
    return mod if isinstance(mod, rft.FusedRowsPx) else mod.stages[0]


def rows_pass(torch, np, rft, dev, row, whole, nbytes):
    """Part F (module docstring)."""
    import inspect

    from recfilter_tpu_torch import dimfuse as tdf
    from recfilter_tpu_torch.kernels import final2d as k2d

    # the checkout runs the rows pass at the reduced grades
    grades = "nprod" in inspect.signature(k2d.RowsFinal).parameters
    for label, shape, clamp in (("V1", (256, 256, 256), False),
                                ("V2", (512, 512, 512), True)):
        F = gauss_volume(rft, np, shape, clamp)
        mod = F.as_func()
        rows = rows_of(rft, mod)
        x = torch.from_numpy(F._image).to(dev)
        whole(f"{label} whole call {shape}", mod, x)
        for g in ("px4", "px3", "default") if grades else ():
            F.set_plan(matmul_precision=g)
            whole(f"{label} whole call {shape} {g}", F.as_func(), x)
        F.set_plan(matmul_precision="px6")
        with torch.no_grad():
            X4 = rows.tile(x)
            N = rows.carries(X4, rows.tails.plain)
        K, vox = rows.K, X4.numel()
        G0 = rows.tails.G_v64[0].float()
        one = rows.final.B_v.shape[0] == 1
        row(f"{label} rows_tails {tuple(X4.shape)}, K = {K}", rows.tails,
            (X4,), nbytes(X4, N, G0), 2.0 * K * vox,
            (lambda v: torch.matmul(G0, v)) if one else None,
            "matmul(G, x), fp32 sums", rate=67e12)
        A0 = torch.cat([rows.final.B_v[0], rows.final.R_v[0]], 1)
        XN = torch.cat([X4, N], dim=2) if one else None
        row(f"{label} rows_final {tuple(X4.shape)}", rows.final, (X4, N),
            nbytes(X4, N[:, :, :K], X4), 12.0 * (128 + K) * vox,
            (lambda *a_: torch.matmul(A0, XN)) if one else None,
            "matmul([Btot | Rhat], [x; N])", rate=PEAK_BF16,
            fp32_flops=2.0 * (128 + K) * vox)
        # rows_final at the reduced grades, where the checkout has them
        # (its RowsFinal takes nprod): bound by the bytes and the grade's
        # bf16 products; yardstick the matmul by the grade's constant
        if label == "V1" and grades:
            scans = [s_ for s_ in F.spec.scans if s_.axis == 0]
            for g, n_i in (("px4", 4), ("px3", 3), ("default", 1)):
                fin = rft.FusedRowsPx(scans, rows.L, rows.trailing,
                                      F.spec.border, n_i).final.to(dev)
                Ag = fin.chunks()[0, :, :, :128 + 8].float().sum(0)
                row(f"{label} rows_final {g} {tuple(X4.shape)}", fin,
                    (X4, N), nbytes(X4, N[:, :, :K], X4),
                    2.0 * vox * (128 * n_i + K * max(n_i, 3)),
                    lambda *a_, A=Ag: torch.matmul(A, XN),
                    "matmul(grade's [Btot | Rhat], [x; N])", ref=lambda _,
                    f=fin: f._twin(X4, N), rate=PEAK_BF16)
        del X4, N, XN, rows, mod, x, F
    # completion_split at E (64 × 32,768, clamp: three matrix variants) at
    # px3, px4 and default, beside one matmul of [x, Nᵀ] by the grade's
    # [Btotᵀ; Rᵀ] (the sum of its chunks; E's variants as a per-tile
    # batch), as chip_smoke.py phase 3m times it
    w = rft.gaussian_weights(5.0, 3)
    scans = [rft.Scan(1, True, w[0], tuple(w[1:])),
             rft.Scan(1, False, w[0], tuple(w[1:]))]
    n = 32768 // 128
    X = torch.from_numpy((np.random.default_rng(6).standard_normal(
        (64, n, 128)) * 0.1).astype(np.float32)).to(dev)
    for g, n_i in (("px3", 3), ("px4", 4), ("default", 1)):
        loc = tdf.LastAxisPass(scans, (128, n, 0), True, g).to(dev)
        comp, K_ = loc.completion, 128 + loc.completion.sl
        with torch.no_grad():
            Nt = loc._solve_t(loc.tails.plain(X).double()).float()
            # the packed constant's chunks, or the row-major one of the
            # checkouts before completion_split ran the tensor-core core
            C = comp.chunks() if hasattr(comp, "chunks") else comp.Bc
            Bs = C[..., :K_].float().sum(1)  # (nv, 128, K)
            vi = [0 if Bs.shape[0] == 1 else 1 if t == 0 else
                  2 if t == n - 1 else 0 for t in range(n)]
            BRn = Bs[vi].transpose(1, 2).contiguous()
            XNt = torch.cat([X, Nt.permute(2, 0, 1)], dim=2).transpose(0, 1)
        row(f"E completion_split {g} {tuple(X.shape)}", comp, (X, Nt),
            nbytes(X, Nt[:, :loc.S], X),
            2.0 * X.numel() * (128 * n_i + loc.S * max(n_i, 3)),
            lambda *a_, A=XNt, B=BRn: torch.matmul(A, B).transpose(0, 1),
            "matmul([x, Nᵀ], grade's [Btotᵀ; Rᵀ]) per tile",
            ref=lambda _, c=comp, N_=Nt: c._twin(X, N_), rate=PEAK_BF16)
        del loc, comp, Nt, XNt, BRn


def digests(torch, np, rft, tdf, kc, dev, tag, card, rows_out):
    """Part G (module docstring)."""
    import hashlib

    from recfilter_tpu_torch.spec import Scan

    def digest(t):
        torch.cuda.synchronize()
        if t.dtype == torch.bfloat16:  # its bits (numpy has no bf16)
            t = t.view(torch.int16)
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()[:16]

    from recfilter_tpu_torch.kernels import launch

    rng = np.random.default_rng(1)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    mix = lambda y_, x_: 0.7 * y_ + 0.3 * x_  # noqa: E731 (E1's)
    out = {}
    with torch.no_grad():
        q, n = 306, 256
        w2 = rft.gaussian_weights(5.0, 2)
        scans = [Scan(0, True, w2[0], tuple(w2[1:])),
                 Scan(0, False, w2[0], tuple(w2[1:]))]
        loc = tdf.LastAxisPass(scans, (128, n, 0), False, "px6").to(dev)
        X, Nt = f32(q, n, 128), torch.zeros((n, 8, q), device=dev)
        Nt[:, :loc.S] = f32(n, loc.S, q)
        out["completion (306, 256, 128)"] = digest(loc.completion(X, Nt))
        le = tdf.LastAxisPass(scans, (128, n, 0), False, "px6",
                              epilogue=mix).to(dev)
        out["completion_epi (306, 256, 128)"] = digest(
            le.completion(X, Nt, X))
        out["tails (306, 256, 128)"] = digest(loc.tails(X))
        ld = tdf.LastAxisPass(scans, (128, n, 0), False, "default").to(dev)
        out["completion_split default (306, 256, 128)"] = digest(
            ld.completion(X, Nt))
        # bf16 storage's entries where the checkout has them, on X rounded
        bf16 = "tails_bf16" in launch.ENTRIES
        if bf16:
            Xb = X.to(torch.bfloat16)
            lb, lbe = (tdf.LastAxisPass(scans, (128, n, 0), False, "px6",
                                        epilogue=e, dtype=torch.bfloat16
                                        ).to(dev) for e in (None, mix))
            out["tails_bf16 (306, 256, 128)"] = digest(lb.tails(Xb))
            out["completion_split_bf16 (306, 256, 128)"] = digest(
                lb.completion(Xb, Nt))
            out["completion_split_epi_bf16 (306, 256, 128)"] = digest(
                lbe.completion(Xb, Nt, X))
        q, n, S = 4096, 32, 6
        X, Btot, Rcat = f32(q, n, 128), f32(128, 128) * 0.1, f32(128, S)
        N8 = torch.zeros((n, 8, q), device=dev)
        N8[:, :S] = f32(n, S, q)
        out["completion_traced (4096, 32, 128)"] = digest(
            kc.completion_traced(X, Btot, Rcat, N8))
        rot = tdf.LastAxisPass(scans, (128, n, 0), False, "px6",
                               rot_axes=2).to(dev)
        out["completion_rot (4096, 32, 128)"] = digest(rot.completion(X, N8))
        # at default where the chain's structural rule puts the kernels
        # (tails chained in; tails chained out, 32 next tiles)
        for label, kw in (("completion_rot default", dict(tails_in=True)),
                          ("completion_rot_tails default", dict(
                              next_tails=(rot.Gcat, n, 128))),
                          *((("completion_rot_bf16", {}),
                             ("completion_rot_tails_bf16", dict(
                                 next_tails=(rot.Gcat, n, 128))))
                            if bf16 else ())):
            pb = tdf.LastAxisPass(scans, (128, n, 0), False, "default",
                                  rot_axes=2, **kw, **(
                                      dict(dtype=torch.bfloat16)
                                      if "bf16" in label else {})).to(dev)
            xin = X.to(torch.bfloat16) if "bf16" in label else X
            comp = pb.completion_nt or pb.completion
            y = comp(xin, N8)
            out[f"{label} (4096, 32, 128)"] = digest(
                torch.cat([t.float().reshape(-1) for t in y])
                if isinstance(y, tuple) else y)
        if bf16:
            pe = tdf.LastAxisPass(scans, (128, n, 0), False, "px6",
                                  rot_axes=2, epilogue=mix,
                                  dtype=torch.bfloat16).to(dev)
            out["completion_rot_epi_bf16 (4096, 32, 128)"] = digest(
                pe.completion(X.to(torch.bfloat16), N8,
                              X.reshape(q, -1).t().contiguous()))
        # the fused stencil (C1's radius-5 double difference): tails with
        # its extra rows, the rotated emit with its taps, at px6 and
        # default, and the bf16 entries where the checkout has them
        from recfilter_tpu_torch.apps.dog import _stencil

        st_bf16 = "completion_rot_stencil_bf16" in launch.ENTRIES
        for grade, dt in (("px6", None), ("default", None),
                          *((("bf16", torch.bfloat16),) if st_bf16
                            else ())):
            ps = tdf.LastAxisPass(scans, (128, n, 0), False,
                                  "px6" if grade == "bf16" else grade,
                                  rot_axes=2, stencil=_stencil(5), **(
                                      dict(dtype=dt) if dt else {})
                                  ).to(dev)
            xin = X if dt is None else X.to(dt)
            sfx = "_bf16" if dt else f" {grade}"
            braw = ps.st_tails[0](xin)
            out[f"tails_extra{sfx} (4096, 32, 128)"] = digest(braw)
            b64 = ps.st_tails[0].plain(X).double()
            Nt = ps._solve_t(b64[:, :ps.sl])
            hlo, hhi = ps.st_reach[0]
            halos = tdf._stencil_halo(b64[:, ps.sl:], Nt, ps.st_R0, hlo, hhi)
            comp = ps.st_comp[0]
            name = ("completion_rot_stencil_bf16" if dt
                    else f"completion_rot stencil {grade}")
            out[f"{name} (4096, 32, 128)"] = digest(
                comp(xin, Nt.float().contiguous(), *halos))
            if dt:
                pe = tdf.LastAxisPass(scans, (128, n, 0), False, "px6",
                                      rot_axes=2, stencil=_stencil(5),
                                      epilogue=mix, dtype=dt).to(dev)
                out["completion_rot_stencil_epi_bf16 (4096, 32, 128)"] = \
                    digest(pe.st_comp[0](xin, Nt.float().contiguous(),
                                         *halos, X.reshape(q, -1).t()
                                         .contiguous()))
        F = gauss_volume(rft, np, (256, 256, 256), False)
        rows = rows_of(rft, F.as_func())
        X4 = rows.tile(torch.from_numpy(F._image).to(dev))
        N = rows.carries(X4, rows.tails.plain)
        out["rows_tails V1"] = digest(rows.tails(X4))
        out["rows_final V1"] = digest(rows.final(X4, N))
        F.set_plan(matmul_precision="default")
        out["rows_final default V1"] = digest(
            rows_of(rft, F.as_func()).final(X4, N))
        # the 2-D pair at px6, and its stencil bank (C1's, radii 5 and 9)
        w3 = rft.gaussian_weights(5.0, 3)
        x, y = rft.Dim("x", 1024), rft.Dim("y", 1024)
        F = rft.RecFilter("G2")
        F[y, x] = rng.standard_normal((1024, 1024)).astype(np.float32)
        for d in (+x, -x, +y, -y):
            F.add_filter(d, w3)
        F.split(x, 128, y, 128)
        img = torch.from_numpy(F._image).to(dev)
        m = F.as_func()
        X4 = m.tile(img)
        NA, NB = m.carries(X4, m.moments.plain)
        out["final2d 1024²"] = digest(m.final(X4, NA, NB))
        out["moments2d 1024²"] = digest(torch.cat(
            [t.reshape(-1) for t in m.moments(X4)]))
        F.set_plan(matmul_precision="default")
        md = F.as_func()
        F.set_plan(matmul_precision="px6")
        out["final2d_split default 1024²"] = digest(md.final(X4, NA, NB))
        bank = [[(B, B, 1.0), (B, -B - 1, -1.0), (-B - 1, B, -1.0),
                 (-B - 1, -B - 1, 1.0)] for B in (5, 9)]
        ms = F.as_func(stencil2d=bank)
        NA, NB, ht, hb = ms._carries(X4, ms.moments.plain)
        top, bot = ms.halo_strips(ht, hb, NA, NB)
        out["final2d_stencil 1024²"] = digest(ms.final(
            X4, NA.float(), NB.float(), top, bot))
        for g in ("default", "px3", "px4"):
            F.set_plan(matmul_precision=g)
            mg = F.as_func(stencil2d=bank)
            out[f"final2d_stencil {g} 1024²"] = digest(mg.final(
                X4, NA.float(), NB.float(), top, bot))
        if "final2d_stencil_bf16" in launch.ENTRIES:
            Fb = rft.RecFilter("G2b")
            Fb[y, x] = torch.from_numpy(F._image).to(torch.bfloat16)
            for d in (+x, -x, +y, -y):
                Fb.add_filter(d, w3)
            Fb.split(x, 128, y, 128)
            mb = Fb.as_func(stencil2d=bank)
            out["final2d_stencil_bf16 1024²"] = digest(mb.final(
                X4.to(torch.bfloat16), NA.float(), NB.float(), top, bot))
        F.set_plan(matmul_precision="px6")
        from recfilter_tpu_torch.kernels.stencil2d import Stencil2D

        sobel = [[(-1, -1, -1.0), (0, -1, -2.0), (1, -1, -1.0),
                  (-1, 1, 1.0), (0, 1, 2.0), (1, 1, 1.0)],
                 [(-1, -1, -1.0), (-1, 0, -2.0), (-1, 1, -1.0),
                  (1, -1, 1.0), (1, 0, 2.0), (1, 1, 1.0)]]
        img2 = f32(1024, 2048)
        st2 = Stencil2D(sobel).to(dev)
        out["stencil2d (1024, 2048)"] = digest(torch.stack(st2(img2)))
        if "stencil2d_bf16" in launch.ENTRIES:
            out["stencil2d_bf16 (1024, 2048)"] = digest(torch.stack(
                st2(img2.to(torch.bfloat16))))
        from recfilter_tpu_torch.apps import box_filter_3
        from recfilter_tpu_torch.apps import difference_of_gaussians

        for name, app in (("F1", box_filter_3(1024, 1024, 5)),
                          ("F3", difference_of_gaussians(1024, 1024, 5, 9))):
            mid = app.x_pass.band(img)
            out[f"fir_band {name} x pass 1024²"] = digest(mid)
            out[f"fir_band {name} y pass 1024²"] = digest(
                app.y_pass.band(mid))
    r = {"tag": tag, "case": "digests", "card": card, "digests": out}
    rows_out.append(r)
    print(json.dumps(r), flush=True)


def grades(torch, np, rft, tdf, kc, dev, row, nbytes):
    """Part H (module docstring): the rotated kernels at each grade, where
    the checkout's ``CompletionPass`` takes ``nprod``."""
    import inspect

    from recfilter_tpu_torch.apps.dog import _stencil
    from recfilter_tpu_torch.kernels import split

    graded = "nprod" in inspect.signature(kc.CompletionPass).parameters
    if not graded:
        print("part H: this checkout's rotated completion has no grades: "
              "K3's completion_rot_tails at px6 alone")
    rng = np.random.default_rng(2)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    peak = {True: 989e12, False: 67e12}
    scans = [rft.Scan(1, True, 1.0, (2.0, -1.0))]
    q, n = 4096, 32
    loc = tdf.LastAxisPass(scans, (128, n, 0), False, "px6", rot_axes=2,
                           stencil=_stencil(5))
    Bm, Rm = loc.B_v.numpy(), loc.R_v.numpy()
    X = f32(q, n, 128)
    N = torch.zeros((n, 8, q), device=dev)
    N[:, :loc.S] = f32(n, loc.S, q)
    st = dict(_stencil(5), start="zero", end="clamp")
    for nprod in (6, 4, 3, 1) if graded else ():
        ops = 2.0 * (128 * nprod + split.carry_nprod(nprod) * loc.S
                     ) * X.numel()
        flat = kc.CompletionPass(Bm, Rm, n, rot=True, nprod=nprod).to(dev)
        B0 = flat.grade_constant()[0]
        XNt = torch.cat([X, N.permute(2, 0, 1)], dim=2).permute(1, 2, 0)
        row(f"C1 completion_rot nprod {nprod}, no stencil", flat, (X, N),
            nbytes(X, N[:, :loc.S], X), ops,
            lambda x_, n_: torch.matmul(B0, XNt),
            "matmul(grade's [Btot | R], XN^T) -> (n, 128, q)",
            lambda y: flat._twin(X, N).reshape(n, 128, q),
            rate=peak[True])
        sten = kc.CompletionPass(Bm, Rm, n, rot=True, stencil=st,
                                 nprod=nprod).to(dev)
        Y = flat(X, N).reshape(n, 128, q)
        z = torch.zeros((1, 16, q), device=dev)
        halos = (torch.cat([z[:, :sten.hp], Y[:-1, 128 - sten.hp:]]
                           ).contiguous(),
                 torch.cat([Y[1:, :sten.hn], z[:, :sten.hn]]).contiguous())
        row(f"C1 completion_rot nprod {nprod}, 3-tap stencil", sten,
            (X, N, *halos), nbytes(X, N[:, :loc.S], *halos, X),
            ops + 2.0 * 3 * X.numel() * 989e12 / 67e12, rate=peak[True])
        del flat, sten, Y, halos, XNt
    # K3's first pass: completion_rot_tails at each grade, beside
    # completion_rot + tails at the same grade
    w = rft.gaussian_weights(5.0, 3)
    sc = [rft.Scan(2, c, w[0], tuple(w[1:])) for c in (True, False)]
    m = tdf.prepare_dim_pass(sc, 128, 4, False)
    Rc = np.concatenate([np.asarray(r) for r in m.Rhat], 2)
    G2 = np.concatenate([np.asarray(g) for g in m.G], 1)
    q, n, n2 = 102400, 4, 4
    X = f32(q, n, 128)
    N = torch.zeros((n, 8, q), device=dev)
    N[:, :6] = f32(n, 6, q)
    nxt = kc.TailsPass(G2, n2).to(dev)
    for nprod in (6, 4, 3, 1) if graded else (6,):
        grade = dict(nprod=nprod) if graded else {}
        crt = kc.CompletionPass(m.Btot, Rc, n, rot=True, next_tails=(G2, n2),
                                **grade).to(dev)
        rot = kc.CompletionPass(m.Btot, Rc, n, rot=True, **grade).to(dev)
        ops = 2.0 * (128 * nprod + split.carry_nprod(nprod) * 6
                     ) * X.numel()
        yk, tk = crt(X, N)
        def unchained(x_, n_):
            """completion_rot, then the tails kernel on its output (held
            to the chained output; the tails are bit-equal: card tests)."""
            y_ = rot(x_, n_)
            nxt(y_.reshape(-1, n2, 128))
            return y_

        row(f"K3 completion_rot_tails nprod {nprod}", crt, (X, N),
            nbytes(X, N[:, :6], crt.Bc_k if graded else crt.BR_v,
                   crt.G2_v, yk, tk),
            ops + 2.0 * 5 * X.numel() * 989e12 / 67e12, unchained,
            "completion_rot + tails kernels", lambda o: o[0],
            rate=peak[True])
        del crt, rot, yk, tk
    # K6's first pass (the panorama 512 x 40960: 320 tiles of the last
    # axis, the next pass 4 tiles, ra = 1), the passes as the module at the
    # grade builds them
    x6 = f32(512, 40960)
    for g in ("px6", "px4", "px3", "default") if graded else ("px6",):
        F = gauss_volume(rft, np, (512, 40960), False)
        F.set_plan(matmul_precision=g)
        p0, p1 = F.as_func().passes[:2]
        crt, rot, nxt = p0.completion_nt, p0.completion, p1.tails
        nprod = getattr(crt, "nprod", 6)
        X = x6.reshape(-1, p0.n, 128)
        q = X.shape[0]
        N = torch.zeros((p0.n, 8, q), device=dev)
        N[:, :p0.S] = f32(p0.n, p0.S, q)
        yk, tk = crt(X, N)
        n2 = crt.n2

        def unchained6(x_, n_):
            """completion_rot, then the tails kernel on its output."""
            y_ = rot(x_, n_)
            nxt(y_.reshape(-1, n2, 128))
            return y_

        ops = 2.0 * (128 * nprod + split.carry_nprod(nprod) * p0.S
                     ) * X.numel()
        row(f"K6 completion_rot_tails nprod {nprod}", crt, (X, N),
            nbytes(X, N[:, :p0.S], crt.Bc_k if graded else crt.BR_v,
                   crt.G2_v, yk, tk),
            ops + 2.0 * crt.S2 * X.numel() * 989e12 / 67e12, unchained6,
            "completion_rot + tails kernels", lambda o: o[0],
            rate=peak[True])
        del F, p0, p1, crt, rot, nxt, yk, tk


def consumers(torch, np, rft, dev, row, nbytes):
    """Part I (module docstring): the fused consumers' kernels at px6 and
    each reduced grade, where the checkout's app builders take
    ``matmul_precision``."""
    import inspect

    import torch.nn.functional as F_

    from recfilter_tpu_torch.apps import (box_filter_3,
                                          difference_of_gaussians,
                                          unsharp_mask)
    from recfilter_tpu_torch.fir import _align_taps, box_taps
    from recfilter_tpu_torch.kernels import split

    if "matmul_precision" not in inspect.signature(box_filter_3).parameters:
        print("part I: this checkout's consumers have no grades")
        return
    rng = np.random.default_rng(3)
    img = (rng.standard_normal((4096, 4096)) * 0.01).astype(np.float32)
    x = torch.from_numpy(img).to(dev)
    peak = {"bf16": 989e12, "fp32": 67e12}
    # E1's filter: A's order-2 coefficients on 64 x 32,768, the mix 0.7y +
    # 0.3x its epilogue
    ce, xe = rft.Dim("c", 64), rft.Dim("x", 32768)
    FE = rft.RecFilter("MixAudio")
    FE[ce, xe] = np.zeros((64, 32768), np.float32)
    FE.add_filter(+xe, [1.0, 0.01, 0.01])
    FE.split(xe, 128)
    sig = torch.from_numpy((rng.standard_normal((64, 32768)) * 0.1).astype(
        np.float32)).to(dev)
    for g in ("px6", "px4", "px3", "default"):
        nprod = split.NPROD[g]
        n_c = split.carry_nprod(nprod)
        # fir_band at F1's x pass and F3's two passes (conv1d beside it)
        for label, mod, taps in (
                ("F1", box_filter_3(4096, 4096, 5, matmul_precision=g),
                 [box_taps(5, 3)]),
                ("F3", difference_of_gaussians(4096, 4096, 5, 9,
                                               matmul_precision=g),
                 _align_taps([box_taps(5, 3), box_taps(9, 3)]))):
            mid = mod.x_pass.band(x)
            for name, band, v in (("x pass", mod.x_pass.band, x),
                                  ("y pass", mod.y_pass.band, mid)
                                  )[:1 if label == "F1" else 2]:
                w = torch.from_numpy(np.asarray(taps, np.float32))[:, None]
                w, K = w.to(dev), w.shape[-1]
                if band.contract:
                    w = w * torch.tensor([1.0, -1.0], device=dev)[:, None,
                                                                  None]
                    lib = lambda v_, w=w, K=K: F_.conv1d(  # noqa: E731
                        v_.permute(1, 0, 2), w.view(1, 2, K),
                        padding=(K - 1) // 2)
                else:
                    lib = lambda v_, w=w, K=K: F_.conv1d(  # noqa: E731
                        v_[:, None], w, padding=(K - 1) // 2)
                pairs = getattr(band, "pairs", [[(0, 0)]] * len(taps))
                row(f"{label} {name} fir_band {g} (pairs "
                    f"{[len(p) for p in pairs]})", band, (v,),
                    nbytes(v, band(v)),
                    2.0 * K * v.shape[-2] * v.shape[-1] * sum(
                        len(p) for p in pairs), lib, "conv1d",
                    # held to the float32 band product (the kernel at a
                    # grade rounds x and the taps to its chunks)
                    lambda y, b=band, v=v: (
                        b._twin(v).transpose(-1, -2).transpose(0, 1)
                        if b.Cout > 1 else
                        b._twin(v).transpose(-1, -2)[:, None]),
                    rate=peak["fp32"])
            del mod, mid
        # final2d_stencil at C1's SAT stage
        sat = difference_of_gaussians(4096, 4096, 5, 9, variant="sat",
                                      matmul_precision=g).sat_box
        X4 = sat.tile(x)
        NA, NB, ht, hb = sat._carries(X4)
        top, bot = sat.halo_strips(ht, hb, NA, NB)
        NA, NB = NA.float(), NB.float()
        out = sat.final(X4, NA, NB, top, bot)
        taps = sum(len(t) for t in sat.final.bank.taps_c)
        prod = 2.0 * X4.numel() * (256 * nprod + (sat.Ka + sat.Kb) * n_c)
        row(f"C1 final2d_stencil {g}", sat.final, (X4, NA, NB, top, bot),
            nbytes(X4, NA, NB, top, bot, out),
            prod + 2.0 * taps * X4.numel() * peak["bf16"] / peak["fp32"],
            rate=peak["bf16"])
        del sat, X4, NA, NB, ht, hb, top, bot, out
        # U1's final pass with the combine in its store
        fu = unsharp_mask(4096, 4096, matmul_precision=g).stages[0]
        X4 = fu.tile(x)
        NA, NB = fu.carries(X4)
        entry = "final2d_epi" if g == "px6" else "final2d_split_epi"
        row(f"U1 {entry} {g}", fu.final, (X4, NA, NB, X4),
            nbytes(X4, NA, NB, X4, X4),
            2.0 * X4.numel() * (256 * nprod + (fu.Ka + fu.Kb) * n_c)
            + 4.0 * X4.numel() * peak["bf16"] / peak["fp32"],
            rate=peak["bf16"])
        del fu, X4, NA, NB
        # E1's completion with the mix, beside one addmm by the grade's
        # constant (the mix's a and b as alpha and beta)
        FE.set_plan(matmul_precision=g)
        loc = FE.as_func(epilogue=lambda y_, x_: 0.7 * y_ + 0.3 * x_).body
        comp = loc.completion
        X = F_.pad(sig, (0, loc.pad)).reshape(-1, loc.n, loc.T)
        Nt = loc._solve_t(loc.tails.plain(X).double()).float()
        XN = torch.cat([X, Nt.permute(2, 0, 1)], dim=2).reshape(
            -1, 128 + comp.sl)
        BR = comp.grade_constant()[0].t().contiguous() if g != "px6" else \
            torch.cat([comp.B_v[0], torch.nn.functional.pad(
                comp.R_v[0], (0, comp.sl - comp.S))], 1).t().contiguous()
        entry = "completion_epi" if g == "px6" else "completion_split_epi"
        row(f"E1 {entry} {g}", comp, (X, Nt, X),
            nbytes(X, Nt[:, :comp.S], X, X),
            2.0 * X.numel() * (128 * nprod + comp.S * n_c)
            + 4.0 * X.numel() * peak["bf16"] / peak["fp32"],
            lambda x_, n_, a_: torch.addmm(a_.reshape(-1, 128), XN, BR,
                                           beta=0.3, alpha=0.7),
            "addmm(aux, [x, N^T], grade's [Btot^T; R^T])",
            lambda y: comp._twin(X, Nt, X).reshape(-1, 128),
            rate=peak["bf16"])
        del loc, comp, X, Nt, XN, BR


def finish(rows, out, card) -> int:
    """Append the rows to ``out`` (JSON lines), print the card."""
    if out:
        with open(out, "a") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
