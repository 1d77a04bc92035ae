"""Design study of the reduced precision grades' mechanism on the card: the
split-bf16 probes of ``scripts/`` at their own shapes, beside the Hopper
answers the TPU did not have (TF32 tensor cores, fp32 FMA).

    python tests/torch_split_study.py [--out rows.jsonl]

Every variant is one launch of ``kernels/split_mm.py``'s entries
(``csrc/split_mm.cu``): for each 128-wide tile t of x (L lines) and each
line l, ``C[l][o] = Σ_k Bn[o][k]·x[l, t·128 + k] (+ Σ_s R[o][s]·N[l][s])``,
emitted in place or transposed. The probes, each with its question:

  A  ``pallas_split_mm`` (scripts/pallas_split_matmul.py:70): y = x·B,
     x (131072, 128), in place — what each grade costs on a pure product;
  B  ``pallas_split_mm_t`` (:113): the completion shape, 4096², transposed
     emit, the carry term R·Nᵀ (S = 6) — in the contraction at the
     product's grade, or in fp32 after it;
  C  ``px3t_sweep.build`` (scripts/px3t_sweep.py:74): B at px3 over lines
     a block (128–1024), tiles a block (1, 2), orientation (the
     transposed product straight from the accumulators, or the product
     then a shared-memory transpose) and the carry's precision;
  D  ``px6_stack_exp.build`` (scripts/px6_stack_exp.py:56): px6 at
     4096², transposed emit, six products one after another or from one
     load of every chunk's fragments (the stacked contraction), over lines
     a block.

At each probe's shape the mechanisms: bf16 chunks at 1 (default), 3
(px3), 4 (px4) and 6 (px6) products; 1xTF32 and 3xTF32 on ``mma.sync``
m16n8k8; fp32 FMA on the CUDA cores (the port's px6 kernels'
arithmetic); and, where one call computes the same function, one
``torch.matmul`` in fp32.

Each variant's error against the float64 product (share of its peak), its
time (CUDA events around 20 back-to-back launches, the median of three
windows; and the profiler's device time per launch), its bound (the
larger of its bytes over 3.35 TB/s and its products over 989 TFLOP/s
bf16, 495 TF32 or 67 fp32) and its share of the bound. Every bf16, TF32
and fp32 variant is also held to its plain twin (1e-5 of the twin's
peak). At the end, for each grade's bound (2e-6 px6, 8e-5 px4, 1e-4 px3,
3e-2 default) and each probe, the variant that holds it at the least
device time; then (E) the headline at ``default`` with its carry rows at
one product (the JAX package's arithmetic) and at three (the port's),
against the f64 oracle.

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
from recfilter_tpu_torch.kernels import split_mm as smm  # noqa: E402
from recfilter_tpu_torch.utils import timing  # noqa: E402

T, S = 128, 6
RATE = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
BOUNDS = {"px6": 2e-6, "px4": 8e-5, "px3": 1e-4, "default": 3e-2}


# (tag, probe, its Pallas kernel's function, L, W, emit, carry, seed)
PROBES = [
    ("A", "pallas_split_mm", "scripts/pallas_split_matmul.py:70", 131072, T,
     0, 0, 0),
    ("B", "pallas_split_mm_t", "scripts/pallas_split_matmul.py:113", 4096,
     4096, 1, 1, 1),
    ("C", "px3t_sweep", "scripts/px3t_sweep.py:74", 4096, 4096, 1, 1, 2),
    ("D", "px6_stack", "scripts/px6_stack_exp.py:56", 4096, 4096, 1, 0, 3),
]


def per_launch_ms(fn, windows=3, launches=20):
    """Median over windows of the CUDA-event time of ``launches``
    back-to-back calls, per call."""
    fn()
    out = []
    for _ in range(windows):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(launches):
            fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e) / launches)
    return statistics.median(out)


class Probe:
    """One probe's shape, inputs and float64 product on the card."""

    def __init__(self, tag, name, replaces, L, W, emit, carry, seed):
        self.tag, self.name, self.replaces = tag, name, replaces
        self.L, self.n, self.emit = L, W // T, emit
        rng = np.random.default_rng(seed)
        B = (rng.standard_normal((T, T)) / np.sqrt(T)).astype(np.float32)
        # probe A's y = x·B is Bn = Bᵀ; the completion shapes take B·xᵀ
        self.Bn = B.T.copy() if emit == 0 else B
        x = (rng.standard_normal((L, W)) * 0.01).astype(np.float32)
        self.R = (rng.standard_normal((T, S)) * 0.1).astype(np.float32)
        N = (rng.standard_normal((L, S)) * 0.01).astype(np.float32)
        dev = torch.device("cuda", 0)
        self.x = torch.from_numpy(x).to(dev)
        self.N = torch.from_numpy(N).to(dev) if carry else None
        self.Rt = torch.from_numpy(self.R).to(dev)
        self.carry = carry
        C = torch.einsum("ok,lnk->lno", torch.from_numpy(self.Bn).double()
                         .to(dev), self.x.double().reshape(L, self.n, T))
        if carry:
            C = C + (self.N.double() @ self.Rt.double().t())[:, None, :]
        self.want = smm._emit(C, emit)
        self.peak = self.want.abs().max().item()
        del C

    def bytes(self, const_bytes):
        io = 2 * self.x.numel() * 4 + const_bytes
        return io + (0 if self.N is None else self.N.numel() * 4)

    def products(self, k):
        """FLOPs of one product with a contraction of ``k`` rows."""
        return 2.0 * self.L * self.n * T * k


def variants(p):
    """(label, mechanism, kernel call, twin call, {rate: FLOPs}, constant
    bytes) for probe ``p``."""
    x, N, Rt = p.x, p.N, p.Rt
    dev = x.device
    out = []

    def bf16(nprod, emit, carry, stack=False, nt=1, lb=T):
        C = smm.bf16_operand(p.Bn, nprod, p.R if carry == 1 else None
                             ).to(dev)
        kw = dict(nprod=nprod, emit=emit, carry=carry, stack=stack, nt=nt,
                  lb=lb, N=N if carry else None, R=Rt if carry == 2
                  else None)
        ops = {"bf16": nprod * p.products(T + (S if carry == 1 else 0))}
        if carry == 2:
            ops["fp32"] = p.products(S)
        grade = {1: "default", 3: "px3", 4: "px4", 6: "px6"}[nprod]
        label = (f"bf16 {grade} emit {emit} carry {carry}"
                 + (" stacked" if stack else "")
                 + (f" lb {lb} nt {nt}" if (nt, lb) != (1, T) else ""))
        out.append((label, "bf16 " + grade,
                    lambda: smm.split_mm(x, C, **kw),
                    lambda: smm.split_mm_plain(x, C, **kw), ops,
                    C.numel() * 2))

    def tf32(npass, emit, carry, nt=1, lb=T):
        Bf = smm.tf32_operand(p.Bn, p.R if carry else None).to(dev)
        kw = dict(npass=npass, emit=emit, carry=carry, nt=nt, lb=lb,
                  N=N if carry else None)
        out.append((f"{npass}xTF32 emit {emit} carry {carry}"
                    + (f" lb {lb} nt {nt}" if (nt, lb) != (1, T) else ""),
                    f"{npass}xTF32",
                    lambda: smm.split_mm_tf32(x, Bf, **kw),
                    lambda: smm.split_mm_tf32_plain(x, Bf, **kw),
                    {"tf32": npass * p.products(T + (S if carry else 0))},
                    Bf.numel() * 4))

    def fp32(emit, carry):
        Bk = smm.fp32_operand(p.Bn, p.R if carry else None).to(dev)
        kw = dict(emit=emit, carry=carry, N=N if carry else None)
        out.append((f"fp32 FMA emit {emit} carry {carry}", "fp32 FMA",
                    lambda: smm.split_mm_fp32(x, Bk, **kw),
                    lambda: smm.split_mm_fp32_plain(x, Bk, **kw),
                    {"fp32": p.products(T + (S if carry else 0))},
                    Bk.numel() * 4))

    e, c = p.emit, p.carry
    if p.tag == "A":
        for nprod in (1, 3, 4, 6):
            bf16(nprod, 0, 0)
        bf16(6, 0, 0, stack=True)
    elif p.tag == "B":
        for nprod in (1, 3, 4):
            bf16(nprod, 1, 1)
        bf16(3, 1, 2)
        bf16(6, 1, 2)
    elif p.tag == "C":
        for emit in (1, 2):
            for carry in (1, 2):
                for lb in (128, 256, 512, 1024):
                    for nt in (1, 2):
                        bf16(3, emit, carry, nt=nt, lb=lb)
    else:
        for stack in (False, True):
            for lb in (128, 512, 2048):
                bf16(6, 1, 0, stack=stack, lb=lb)
        for nprod in (1, 3, 4):
            bf16(nprod, 1, 0)
    if p.tag != "C":
        tf32(1, min(e, 1), min(c, 1))
        tf32(3, min(e, 1), min(c, 1))
        fp32(min(e, 1), min(c, 1))
    else:
        tf32(3, 1, 1, lb=512)
        fp32(1, 1)
    return out


def library(p):
    """One ``torch.matmul`` computing probe ``p``'s function, or None."""
    if p.carry:
        return None
    Bn = torch.from_numpy(p.Bn).to(p.x.device)
    if p.emit == 0:
        B = Bn.t().contiguous()
        return lambda: torch.matmul(p.x, B)
    X = p.x.reshape(p.L, p.n, T).permute(1, 2, 0)  # (n, 128 k, L)
    return lambda: torch.matmul(Bn, X).reshape(p.n * T, p.L)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write each variant's row here, "
                    "one JSON object a line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card (name, power limit): {card}", flush=True)
    _build.build(["split_mm"])
    _build.load("split_mm", launch.SIGNATURES["split_mm"])
    probes = [Probe(*a) for a in PROBES]
    rows = []
    with torch.no_grad():
        for p in probes:
            print(f"== {p.tag} {p.name} ({p.replaces}): L {p.L}, "
                  f"{p.n} tile(s), emit {p.emit}, carry {p.carry}",
                  flush=True)
            runs = variants(p)
            lib = library(p)
            if lib is not None:
                runs.append(("torch.matmul fp32", "library", lib, None,
                             {"fp32": p.products(T)}, T * T * 4))
            for label, mech, fn, twin, ops, cbytes in runs:
                y = fn()
                torch.cuda.synchronize()
                err = ((y.double() - p.want).abs().max() / p.peak).item()
                tw_err = None
                if twin is not None:
                    w = twin()
                    tw_err = cs.rel_err(y, w)
                    cs.check(tw_err <= 1e-5, f"{p.tag} {label}: within "
                             f"1e-5 of its twin ({tw_err:.2e})")
                    del w
                del y
                ev = per_launch_ms(fn)
                prof = timing.device_profile(lambda _: fn(), p.x,
                                             iterations=10)
                dev_ms = prof["busy_ms"]
                t_ops = sum(v / RATE[k] for k, v in ops.items()) * 1e3
                t_bytes = p.bytes(cbytes) / cs.PEAK_BYTES * 1e3
                bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                             else (t_ops, "operations"))
                row = {"probe": p.tag, "replaces": p.replaces,
                       "variant": label, "mechanism": mech,
                       "err": err, "twin_err": tw_err, "event_ms": ev,
                       "device_ms": dev_ms, "bound_ms": bound,
                       "bound_by": by, "share": (None if dev_ms is None
                                                 else bound / dev_ms),
                       "card": card}
                rows.append(row)
                print(f"  {label}: err {err:.3e}; event {ev:.4f} ms, device "
                      + ("not measured" if dev_ms is None else
                         f"{dev_ms:.4f} ms") + f"; bound {bound:.4f} ms by "
                      f"{by}" + ("" if dev_ms is None else
                                 f" ({100 * bound / dev_ms:.1f} %)")
                      + f" on {card}", flush=True)
            del p.want
    print("== the least device time that holds each grade's bound",
          flush=True)
    for p in probes:
        mine = [r for r in rows if r["probe"] == p.tag]
        for grade, b in BOUNDS.items():
            ok = [r for r in mine if r["err"] <= b]
            key = lambda r: (r["device_ms"] if r["device_ms"] is not None
                             else r["event_ms"])  # noqa: E731
            if ok:
                r = min(ok, key=key)
                print(f"  {p.tag} {grade} ({b:g}): {r['variant']}, err "
                      f"{r['err']:.3e}, device {key(r):.4f} ms on {card}")
            else:
                print(f"  {p.tag} {grade} ({b:g}): no variant holds it")
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    carry_grade(card)
    return 0


def carry_grade(card, n=4096, seeds=(0, 1, 2)):
    """The headline (``bench.py::_build_filter(4096, 4096)``) at
    ``default``: its error against the f64 oracle with the carry rows at
    one product, as the JAX package's ``final2d_px`` takes them (the
    twin's arithmetic with every row at one product), and at three, as
    ``final2d_split`` takes them (``split.carry_nprod``), on
    ``bench.py``'s image at each seed."""
    from recfilter_tpu_torch import bench, scan_core
    from recfilter_tpu_torch.kernels import split
    from recfilter_tpu_torch.kernels.final2d import TILE

    print(f"== E the carry rows' grade at default: the headline at {n}²",
          flush=True)
    F = bench._build_filter(n, n)
    F.set_plan(matmul_precision="default")
    m = F.as_func()
    fin = m.final
    A, B = fin._tiles()

    def one_product(X4, NA, NB):
        """``Final2DSplit.plain`` with the carries at one product."""
        p, na, Ta, W = X4.shape
        z = split.pair_sum(1, lambda i, d: torch.einsum(
            "ask,pakw->pasw", A[:, i], d), torch.cat([X4, NA], dim=2))
        nbr = NB.reshape(p, na, fin.nb, 8, Ta).permute(0, 1, 4, 2, 3)
        ins = torch.cat([z.reshape(p, na, Ta, fin.nb, TILE), nbr], dim=-1)
        y = split.pair_sum(1, lambda i, d: torch.einsum(
            "bok,pasbk->pasbo", B[:, i], d), ins)
        return y.reshape(p, na, Ta, W)

    for seed in seeds:
        img = cs.image(n, n, seed=seed)
        want = scan_core.oracle_apply(F.spec, img.astype(np.float64))
        peak = np.abs(want).max()
        x = torch.from_numpy(img).to(torch.device("cuda", 0))
        with torch.no_grad():
            X4 = m.tile(x)
            NA, NB = m.carries(X4, m.moments.plain)
            ys = {"carries at 1 product (the JAX kernel's)":
                  one_product(X4, NA, NB),
                  "carries at 3 products (final2d_split)":
                  fin(X4, NA, NB)}
        for label, y in ys.items():
            got = y.reshape(n, n).cpu().numpy().astype(np.float64)
            err = np.abs(got - want).max() / peak
            print(f"  seed {seed}, {label}: max|y - oracle|/max|oracle| = "
                  f"{err:.4e} on {card}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
