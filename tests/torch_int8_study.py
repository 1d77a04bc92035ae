"""Design study of the int8 and integer-scan probes of ``scripts/`` on the
card: can the 2-D headline's true-f32 dual completion run on Hopper's
integer tensor cores, and what does the integer scan's wrapper cost?

    python tests/torch_int8_study.py [--out rows.jsonl]

A  The dual completion at 4096² (``scripts/int8_ozaki_exp.py``: x (1, 32,
   128, 4096)·0.7 from seed 0, Ba = Bb the σ=5 Gaussian pair's Btot):
   ``ozaki_i8`` (int8 Ozaki slicing, ten int8 products on ``mma.sync``
   m16n8k32), ``dual_px6`` (six split-bf16 products, m16n8k16) and the
   port's ``final2d`` with zero carries (what px6 runs: six split-bf16
   products on ``wgmma``, its twin the float32 product).
B  The GEMM pair at 4096³ (``scripts/int8_rate_probe.py``): ``gemm_i8``
   (int8 → int32 sums, ``>> 13`` to int8) and ``gemm_bf16`` (bf16 → fp32
   sums, stored bf16) on one tiling; beside them ``torch._int_mm`` (int32
   out; the shift as a second op, timed apart) and ``torch.matmul`` on
   bf16. The int8 / bf16 rate ratio against the Ozaki scheme's break-even
   of 10 / 6 ≈ 1.67 products.
C  The integer scan on the probes' grids (``scripts/int_kernel_probe2.py``,
   ``int_kernel_probe3.py``): one causal unit scan along the last axis of
   19584 × 4096 and 19528 × 4096 int32, through
   ``kernels/int_scan.int_unit_dim_pass`` and through the ``int_scan``
   entry launched directly (no layout, no contiguity copy, no checks).

Every variant prints its error (A: against the float64 product, as a
share of its peak; B: the int32 sums' exact agreement with the int64
product; C: bit-exact against an int64 cumsum masked to 32 bits), its time
(CUDA events around 20 back-to-back launches, the median of three windows;
and the profiler's device time per call), its bound (the larger of its
bytes over 3.35 TB/s and its operations over 1979 int8 TOPS, 989 bf16
TFLOP/s, 67 fp32 TFLOP/s or the int32 add rate) and its share of it, and
the library time where one PyTorch call computes it. Each kernel is also
held to its plain twin. At the end: the rate ratio, the Ozaki verdict at
4096² and the ragged-grid answer.

Not a pytest module: it needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from recfilter_tpu_torch.kernels import _build, launch  # noqa: E402
from recfilter_tpu_torch.kernels import final2d as k2d  # noqa: E402
from recfilter_tpu_torch.kernels import int8_mm as im  # noqa: E402
from recfilter_tpu_torch.utils import timing  # noqa: E402

BREAK_EVEN = 10 / 6


def per_launch_ms(fn, *args, windows=3, launches=20):
    """Median over windows of the CUDA-event time of ``launches``
    back-to-back calls, per call."""
    fn(*args)
    out = []
    for _ in range(windows):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(launches):
            fn(*args)
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / launches)
    return statistics.median(out)


def device_ms(fn, *args):
    """The profiler's device time per call, or None where no window
    recorded every device event."""
    return timing.device_profile(fn, *args, iterations=10)["busy_ms"]


def measure(rows, label, fn, args, nbytes, ops, rate, err, card,
            lib=None):
    """Time ``fn(*args)`` (and ``lib``), print and record the row."""
    with torch.no_grad():
        ms, dev = per_launch_ms(fn, *args), device_ms(fn, *args)
        lib_ms = None if lib is None else per_launch_ms(lib, *args)
    bound, by = cs.roofline(nbytes, ops, rate)
    share = bound / (dev if dev else ms)
    print(f"  {label}: error {err}; event {ms:.4f} ms, device "
          + ("not measured" if dev is None else f"{dev:.4f} ms")
          + f"; bound {bound:.4f} ms by {by} ({100 * share:.1f} %); library "
          + ("none" if lib_ms is None else f"{lib_ms:.4f} ms") + f" on {card}",
          flush=True)
    rows.append({"variant": label, "error": err, "event_ms": ms,
                 "device_ms": dev, "bound_ms": bound, "bound_by": by,
                 "share": share, "library_ms": lib_ms, "card": card})
    return ms, dev


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write each variant's row here, "
                    "one JSON object a line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_study: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card (name, power limit): {card}", flush=True)
    _build.build(["ozaki", "gemm_pair", "int_scan", "final2d"])
    for name in ("ozaki", "gemm_pair"):
        _build.load(name, launch.SIGNATURES[name])
    rows = []
    probes = cs.int8_probes(dev)

    print("== A: the dual completion at 4096² (scripts/int8_ozaki_exp.py)",
          flush=True)
    x = probes["ozaki_i8"][3][0]
    _, B = cs.dual_block()
    pix = x.numel()
    with torch.no_grad():
        y64 = cs.dual_f64(B, x)
        T = 128
        zeros_r = np.zeros((1, T, 8))
        fin = k2d.Final2D(B[None], zeros_r, B[None], zeros_r, x.shape[1],
                          x.shape[3] // T).to(dev)
        NA = torch.zeros(1, x.shape[1], 8, x.shape[3], device=dev)
        NB = torch.zeros(1, x.shape[1], x.shape[3] // T * 8, T, device=dev)
        dual = {
            "ozaki_i8": (probes["ozaki_i8"][0], probes["ozaki_i8"][1], (x,),
                         probes["ozaki_i8"][4], probes["ozaki_i8"][5],
                         cs.PEAK_INT8),
            "dual_px6": (probes["dual_px6"][0], probes["dual_px6"][1], (x,),
                         probes["dual_px6"][4], probes["dual_px6"][5],
                         cs.PEAK_BF16),
            "final2d (wgmma, zero carries)": (
                fin, fin.plain, (x, NA, NB), cs.tensor_bytes(x, x),
                2.0 * 2 * 6 * 144 * pix, cs.PEAK_BF16),
        }
        res = {}
        for label, (fn, plain, a, nbytes, ops, rate) in dual.items():
            got, want = fn(*a), plain(*a)
            torch.cuda.synchronize()
            kt = cs.rel_err(got, want)
            e64 = cs.rel_err(got, y64)
            print(f"  {label}: max|k-twin|/max|twin| = {kt:.3e}", flush=True)
            # the split-bf16 kernels sum their products in another order
            # than their float32 twins: 1e-5, chip_smoke.py's bound
            if kt > (1e-5 if label.startswith("final2d") else 1e-6):
                raise RuntimeError(f"{label}: kernel off its twin ({kt:.3e})")
            res[label] = (e64, *measure(rows, label, fn, a, nbytes, ops,
                                        rate, f"{e64:.3e}", card))
            del got, want
        del y64

    print("== B: the GEMM pair at 4096³ (scripts/int8_rate_probe.py)",
          flush=True)
    gi, gb = probes["gemm_i8"], probes["gemm_bf16"]
    a8, b8 = gi[3]
    with torch.no_grad():
        raw = im.gemm_i8(a8, b8, raw=True)
        exact = torch.equal(raw, im.gemm_i8_plain(a8, b8, raw=True))
        lib_raw = torch._int_mm(a8, b8.t())
        exact_lib = torch.equal(lib_raw, raw)
        if not (exact and exact_lib and torch.equal(im.gemm_i8(a8, b8),
                                                    im.gemm_i8_plain(a8, b8))):
            raise RuntimeError("gemm_i8: int32 sums or the >> 13 store off "
                               "the int64 product")
        eb = cs.rel_err(gb[0](*gb[3]), gb[1](*gb[3]))
        print(f"  int32 sums equal to the int64 product: kernel {exact}, "
              f"torch._int_mm {exact_lib}; gemm_bf16 against its twin "
              f"{eb:.3e} (bf16 output)", flush=True)
        ti = measure(rows, "gemm_i8", gi[0], gi[3], gi[4], gi[5], gi[6],
                     "exact", card, lib=gi[2])
        tb = measure(rows, "gemm_bf16", gb[0], gb[3], gb[4], gb[5], gb[6],
                     f"{eb:.3e}", card, lib=gb[2])
        shift = per_launch_ms(lambda c: (c >> 13).to(torch.int8), lib_raw)
        lib_i = rows[-2]["library_ms"]
        lib_b = rows[-1]["library_ms"]
    print(f"  torch._int_mm {lib_i:.4f} ms + the shift as a second op "
          f"{shift:.4f} ms; torch.matmul bf16 {lib_b:.4f} ms", flush=True)
    r_k, r_l = tb[0] / ti[0], lib_b / lib_i
    r_l2 = lib_b / (lib_i + shift)
    print(f"  rate ratio int8 / bf16 (time bf16 / time int8): hand-written "
          f"{r_k:.3f}, library {r_l:.3f} ({r_l2:.3f} with the shift) — "
          f"break-even {BREAK_EVEN:.3f}", flush=True)
    rows.append({"variant": "rate ratio", "hand_written": r_k,
                 "library": r_l, "library_with_shift": r_l2,
                 "break_even": BREAK_EVEN, "card": card})

    print("== C: the integer scan on the probes' grids "
          "(scripts/int_kernel_probe2.py, int_kernel_probe3.py)", flush=True)
    per_row = {}
    with torch.no_grad():
        for name in ("int_scan/probe2", "int_scan/probe3"):
            fn, plain, lib, (v,), nbytes, ops, rate, _ = probes[name]
            want = v.long().cumsum(1) & 0xFFFFFFFF
            for label, f in (("int_unit_dim_pass", fn),
                             ("entry launched directly", cs.raw_int_scan)):
                ok = torch.equal(f(v).long() & 0xFFFFFFFF, want)
                if not ok:
                    raise RuntimeError(f"{name} {label}: not bit-exact")
                ms, dev_ms = measure(rows, f"{name} {v.shape[0]} x "
                                     f"{v.shape[1]}, {label}", f, (v,),
                                     nbytes, ops, rate, "bit-exact", card,
                                     lib=lib if f is fn else None)
                per_row[(name, label)] = (ms, dev_ms, v.shape[0])
            del want

    print("== verdicts", flush=True)
    e8, t8, d8 = res["ozaki_i8"]
    e6, t6, d6 = res["dual_px6"]
    ef, tf, df = res["final2d (wgmma, zero carries)"]
    best = min(res, key=lambda k: res[k][1])
    print(f"  Ozaki at 4096²: ozaki_i8 {t8:.4f} ms (error {e8:.3e}), "
          f"dual_px6 {t6:.4f} ms ({e6:.3e}), final2d {tf:.4f} ms "
          f"({ef:.3e}); ozaki_i8 "
          + ("beats" if t8 < min(t6, tf) else "does not beat")
          + f" both; the fastest is {best}", flush=True)
    print(f"  rate: the hand-written int8 GEMM runs {r_k:.3f}x the bf16 "
          f"one's rate, the library pair {r_l:.3f}x: "
          + ("above" if r_k > BREAK_EVEN else "below")
          + f" the {BREAK_EVEN:.3f} break-even on the hand-written pair, "
          + ("above" if r_l > BREAK_EVEN else "below") + " on the library's",
          flush=True)
    for label in ("int_unit_dim_pass", "entry launched directly"):
        m2, _, r2 = per_row[("int_scan/probe2", label)]
        m3, _, r3 = per_row[("int_scan/probe3", label)]
        print(f"  ragged grid ({label}): 19528 rows {m3:.4f} ms against "
              f"19584 rows {m2:.4f} ms: time ratio {m3 / m2:.4f}, row ratio "
              f"{r3 / r2:.4f}", flush=True)
    w2 = per_row[("int_scan/probe2", "int_unit_dim_pass")][0]
    r2 = per_row[("int_scan/probe2", "entry launched directly")][0]
    print(f"  wrapper: int_unit_dim_pass {w2:.4f} ms against the entry "
          f"launched directly {r2:.4f} ms at 19584 rows "
          f"({100 * (w2 / r2 - 1):+.1f} %)", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
