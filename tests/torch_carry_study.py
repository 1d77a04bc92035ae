"""Design study of the 2-D executor's carry kernels and the bench's copy,
on the card, at the 4096² headline's shapes.

    python tests/torch_carry_study.py

Builds variants of ``csrc/bsolve.cu``, ``csrc/moments2d.cu`` and
``csrc/copy.cu`` — each the committed source with one constant or loop
changed by text replacement — into ``kernels/_build/study/``, checks each
against its twin (1e-5 of the twin's peak; the walk-only variant's N_A is
not a result) and prints its time: CUDA events around 20 back-to-back
launches made straight through ctypes (no Python wrapper between them),
the median of six windows taken in turns. The variants:

  bsolve         C, the output columns a block: 32 (the source), 16, 8;
  moments2d_naf  the cluster size CL: 16 (the source), 8, 4; the walk
                 alone (CL 16, no solve); the raw moments2d entry; and,
                 for each CL, how many clusters the card keeps resident
                 (cudaOccupancyMaxActiveClusters) against the 32 column
                 strips of 4096²;
  copy           the source against one ``torch.mul`` of the same tensor.

Not a pytest module: it needs the card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import recfilter_tpu_torch as rft  # noqa: E402
from recfilter_tpu_torch import overlap2d  # noqa: E402
from recfilter_tpu_torch.kernels import _build, launch  # noqa: E402

CSRC = os.path.join(REPO, "recfilter_tpu_torch", "kernels", "csrc")
OUT = os.path.join(REPO, "recfilter_tpu_torch", "kernels", "_build", "study")

# the residency probe, compiled into each moments2d variant
PROBE = r'''
extern "C" int naf_resident_clusters(int CL, int na, int nb) {
  int active = -1;
  cudaError_t err = naf_launch(CL, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, nullptr, 1, na, nb, 6, 6,
                               1, 1, 0, &active);
  return err == cudaSuccess ? active : -(int)err;
}
'''


def variant(name, tag, edits=(), probe=""):
    """``csrc/<name>.cu`` with each (old, new) of ``edits`` replaced
    (exactly once), built and loaded."""
    src = open(os.path.join(CSRC, f"{name}.cu")).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{tag}: {old!r} is not in {name}.cu once")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    cu, so = (os.path.join(OUT, f"{name}_{tag}{ext}") for ext in (".cu",
                                                                   ".so"))
    with open(cu, "w") as f:
        f.write(src + probe)
    # the variant's source sits beside the shared headers' copies
    for h in os.listdir(CSRC):
        if h.endswith(".cuh"):
            with open(os.path.join(CSRC, h)) as a, \
                    open(os.path.join(OUT, h), "w") as b:
                b.write(a.read())
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {tag}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(so)
    for fn, (argtypes, restype) in launch.SIGNATURES[name].items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, \
            restype
    return lib


def turns(fns, windows=3, launches=20):
    """{label: median ms a launch} over windows taken in turns."""
    res = {k: [] for k in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(windows):
        for k in order:
            for _ in range(3):
                fns[k]()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(launches):
                fns[k]()
            e.record()
            torch.cuda.synchronize()
            res[k].append(s.elapsed_time(e) / launches)
    return {k: statistics.median(v) for k, v in res.items()}


def rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    h = w = 4096
    wts = rft.gaussian_weights(5.0, 3)
    sc = lambda ax: [rft.Scan(ax, c, wts[0], tuple(wts[1:]))  # noqa: E731
                     for c in (True, False)]
    mod = overlap2d.Fused2DPx(sc(0), sc(1), h, w, "zero", bsolve=True,
                              naf=True).cuda()
    glue = overlap2d.Fused2DPx(sc(0), sc(1), h, w, "zero", bsolve=False,
                               naf=False).cuda()
    bs, nm = mod.bsolve, mod.moments
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.from_numpy(cs.image(h, w)).cuda()
    with torch.no_grad():
        X4 = glue.tile(x)
        NA = glue._carries(X4, glue.moments.plain)[0].float()
        term1 = glue.moments.plain(X4)[1]
        NB = torch.empty_like(term1)
        NAo, t1o = torch.empty_like(NA), torch.empty_like(term1)
        want_b, want_n = bs.plain(NA, term1), nm.plain(X4)

    print(f"card: {card}")
    print("== bsolve: output columns a block (4096², M = 192)")
    fns = {}
    for C in (32, 16, 8):
        lib = variant("bsolve", f"C{C}", () if C == 32 else (
            ("constexpr int C = 32;", f"constexpr int C = {C};"),))

        def run(lib=lib):
            return lib.bsolve_launch(
                NA.data_ptr(), term1.data_ptr(), bs.Gb_v.data_ptr(),
                bs.RaT_v.data_ptr(), bs.CMT.data_ptr(), NB.data_ptr(), 1,
                32, 32, bs.Ka, bs.Kb, bs.RaT_v.shape[0], bs.Gb_v.shape[0],
                stream)
        if run():
            raise RuntimeError(f"bsolve C={C}: launch refused")
        torch.cuda.synchronize()
        print(f"  C={C}: max|k-p|/max|p| = {rel(NB, want_b):.3e}")
        if rel(NB, want_b) > 1e-5:
            raise RuntimeError(f"bsolve C={C} disagrees with its twin")
        fns[f"C={C}"] = run
    for k, ms in turns(fns).items():
        print(f"  {k}: {ms:.4f} ms a launch on {card}")

    print("== moments2d_naf: cluster size, the walk alone, the raw entry "
          "(4096²)")
    fns = {}
    cl_edit = ("constexpr int NAF_CLUSTER = 16;", "constexpr int NAF_CLUSTER")
    for tag, edits in (
            ("CL16", ()),
            ("CL8", ((cl_edit[0], cl_edit[1] + " = 8;"),)),
            ("CL4", ((cl_edit[0], cl_edit[1] + " = 4;"),)),
            ("walk", (("for (int a2 = rank; a2 < na; a2 += CL) {",
                       "for (int a2 = rank; a2 < 0; a2 += CL) {"),))):
        lib = variant("moments2d", tag, edits, PROBE)
        lib.naf_resident_clusters.argtypes = [ctypes.c_int] * 3
        lib.naf_resident_clusters.restype = ctypes.c_int
        if tag.startswith("CL"):
            cl = int(tag[2:])
            print(f"  clusters of {cl}: {lib.naf_resident_clusters(cl, 32, 32)}"
                  f" resident, {32} needed (one a column strip)")

        def run(lib=lib):
            return lib.moments2d_naf_launch(
                X4.data_ptr(), nm.Ga_v.data_ptr(), nm.Gb_v.data_ptr(),
                nm.Ba1T_v.data_ptr(), nm.CMaT.data_ptr(), NAo.data_ptr(),
                t1o.data_ptr(), 1, 32, 32, nm.Ka, nm.Kb, nm.Ga_v.shape[0],
                nm.Gb_v.shape[0], stream)
        if run():
            raise RuntimeError(f"moments2d_naf {tag}: launch refused")
        torch.cuda.synchronize()
        errs = (rel(NAo, want_n[0]), rel(t1o, want_n[1]))
        print(f"  {tag}: max|k-p|/max|p| N_A {errs[0]:.3e}, term1 "
              f"{errs[1]:.3e}")
        if errs[1] > 1e-5 or (tag != "walk" and errs[0] > 1e-5):
            raise RuntimeError(f"moments2d_naf {tag} disagrees with its twin")
        fns[tag] = run
    raw = glue.moments
    fns["raw moments2d"] = lambda: raw._kernel(X4)
    for k, ms in turns(fns).items():
        print(f"  {k}: {ms:.4f} ms a launch on {card}")

    print("== copy against torch.mul (4096² float32)")
    lib = variant("copy", "src")
    y = torch.empty_like(x)
    fns = {"copy": lambda: lib.copy_launch(x.data_ptr(), y.data_ptr(),
                                           x.numel(), stream),
           "torch.mul": lambda: torch.mul(x, 1.0001)}
    fns["copy"]()
    torch.cuda.synchronize()
    if not torch.equal(y, x * 1.0001):
        raise RuntimeError("copy disagrees with its twin")
    for k, ms in turns(fns, launches=50).items():
        print(f"  {k}: {ms:.4f} ms a launch, {2 * x.numel() * 4 / ms / 1e6:.0f}"
              f" GB/s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
