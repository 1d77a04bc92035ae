"""The SAT DoG's accuracy at large sizes, in both packages, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_sat_interior.py --size 1024 --size 4096

Runs ``difference_of_gaussians(n, n, 5, 9, variant="sat")`` (tile 128) of
the JAX package (on the CPU its Pallas kernels run in interpret mode) and
of the port (``device="cpu"``: the plain twins) on the same inputs, and
prints, per package and input, the JAX test's metric — max|y − oracle|
over the whole image against the oracle's peak — and the error short of
the far margin, max|y − oracle| on [0, n − 21)², against the peak there.
The oracle is the six-stage formulation untiled in float64
(``chip_smoke.dog_oracle``). Inputs, each with a 21-pixel zero margin:

  uniform    [0, 1) (image-like; seed 10, as ``chip_smoke.py``'s C1 input
             before the bounded one);
  zero-mean  uniform [-0.5, 0.5);
  bounded    ``chip_smoke.bounded_image`` (C1's checked input): every
             integral the pipeline takes of it stays bounded.

Not a pytest module: a study that imports both packages, as the tests do.
``--no-jax`` runs the port alone.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

MARGIN, B1, B2, TILE = 21, 5, 9, 128


def inputs(n):
    rng = np.random.default_rng(10)
    return {
        "uniform": cs.zero_margin(rng.random((n, n)).astype(np.float32),
                                  MARGIN),
        "zero-mean": cs.zero_margin(
            (rng.random((n, n)) - 0.5).astype(np.float32), MARGIN),
        "bounded": cs.bounded_image(n, MARGIN, seed=10)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, action="append")
    ap.add_argument("--no-jax", action="store_true")
    args = ap.parse_args()
    import torch

    from recfilter_tpu_torch.apps import dog as tdog

    runs = [("port", lambda n: (lambda x: tdog.difference_of_gaussians(
        n, n, B1, B2, TILE, variant="sat", device="cpu")(
            torch.from_numpy(x)).numpy()))]
    if not args.no_jax:
        import jax.numpy as jnp

        from recfilter_tpu.apps import dog as jdog

        runs.append(("jax", lambda n: (lambda x, f=jdog.difference_of_gaussians(
            n, n, B1, B2, TILE, variant="sat"): np.asarray(f(jnp.asarray(x))))))
    for n in args.size or [1024]:
        for kind, img in inputs(n).items():
            want = cs.dog_oracle(img, B1, B2)
            peak = float(np.abs(want).max())
            for name, build in runs:
                t0 = time.time()
                got = build(n)(img)
                ie, ip = cs.interior_err(got, want, MARGIN)
                print(f"n = {n} {kind:9s} {name}: whole image "
                      f"{np.abs(got - want).max() / peak:.4e} of the peak "
                      f"{peak:.4g}; short of the far margin max|y - oracle| "
                      f"= {ie:.4g} against a peak of {ip:.4g} "
                      f"({ie / ip:.4e}); {time.time() - t0:.1f} s",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
