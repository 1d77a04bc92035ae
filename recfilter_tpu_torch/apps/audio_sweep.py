"""The audio order sweep on a CUDA device, through the port's public API.

    python -m recfilter_tpu_torch.apps.audio_sweep [--samples 10000000]
        [--tile 1000] [--max-order 29] [--biquads 15] [--iter 10]

The reference's audio benchmark (``apps/audio_filter.py``: 10M samples,
tile 1000, orders 1..29) on ``audio_filter_high_order`` for every order up
to ``--max-order`` and on ``audio_filter_biquads(--biquads)``. For each
filter it runs ``realize(signal, device="cuda")`` once and prints that
first call's wall time (host matrix builds, the copy to the card and the
run), its kernel launches, its error against ``scipy.signal.lfilter`` in
float64 (bound 2e-6 of the peak, the JAX package's px6 bound), and the
median single-call device time (CUDA events) of the kernel path and of the
plain path, in ms and Msamples/s. The input is the reference app's:
uniform [0, 1) from seed 6. Needs a CUDA device; prints the card's name
and power limit first, and exits non-zero if a filter misses its bound.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--samples", type=int, default=10_000_000)
    p.add_argument("--tile", type=int, default=1000)
    p.add_argument("--max-order", type=int, default=29)
    p.add_argument("--biquads", type=int, default=15)
    p.add_argument("--iter", type=int, default=10)
    ns = p.parse_args(argv)

    import numpy as np
    import torch
    from scipy.signal import lfilter

    from . import audio_filter_biquads, audio_filter_high_order
    from ..kernels import launch
    from ..utils import testing, timing

    if not torch.cuda.is_available():
        print("audio_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip())
    n = ns.samples
    x = testing.generate_random_image(n, lo=0, hi=1, seed=6)
    xt = torch.from_numpy(x).to(dev)
    jobs = [(f"order {k}", lambda k=k: audio_filter_high_order(n, k, ns.tile))
            for k in range(1, ns.max_order + 1)]
    if ns.biquads:
        jobs.append((f"biquads {ns.biquads}",
                     lambda: audio_filter_biquads(n, ns.biquads, ns.tile)))
    print("filter\tΣK\tfirst_call_s\tlaunches\tmax_rel_err\tkernel_ms"
          "\tplain_ms\tkernel_Msamples/s\tplain_Msamples/s")
    ok = True
    for name, make in jobs:
        F = make()
        (s,) = F.spec.scans
        torch.cuda.synchronize()
        launch.reset_launches()
        t0 = time.perf_counter()
        y = F.realize(x, device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {k: v for k, v in launch.LAUNCHES.items() if v}
        ref = lfilter([s.feedfwd], [1.0] + [-a for a in s.feedback],
                      x.astype(np.float64))
        err = float(np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max())
        mod = F._func(dev)  # the module realize built, on the card
        with torch.no_grad():
            k_ms = statistics.median(timing.call_times_ms(
                mod, xt, iterations=ns.iter))
            p_ms = statistics.median(timing.call_times_ms(
                mod.forward_plain, xt, iterations=ns.iter))
        ok = ok and err <= 2e-6 and set(launches) == {"tails", "completion"}
        print(f"{name}\t{s.order}\t{first_s:.2f}\t{launches}\t{err:.3e}\t"
              f"{k_ms:.4f}\t{p_ms:.4f}\t{timing.mpix_per_sec(k_ms, n):.0f}\t"
              f"{timing.mpix_per_sec(p_ms, n):.0f}", flush=True)
        del F, mod, y
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
