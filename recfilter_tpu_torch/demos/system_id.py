"""System identification by gradient descent through a recursive filter.

    python -m recfilter_tpu_torch.demos.system_id [--samples 8192]
        [--steps 400] [--device cuda]

A noise signal passes through an "unknown" 2nd-order audio IIR filter (a
biquad); a trainable biquad (``learnable.LearnableRecFilter``) is then
fitted with Adam so that model(input) ≈ observed output — the tiled scan
algebra is differentiable end to end in the filter's coefficients. The
port of the JAX package's ``demo/demo_system_id.py``, with the same
arguments, defaults (64-wide tiles: the float64 einsum route) and output;
``torch.optim.Adam`` in place of optax's ``adam``. Runs on the card unless
``--device cpu``.
"""

import argparse

import numpy as np
import torch

from recfilter_tpu_torch.learnable import LearnableRecFilter
from recfilter_tpu_torch.spec import Dim, FilterSpec, Scan


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=8192)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--device", default="cuda")
    ns = p.parse_args()

    n = ns.samples
    rng = np.random.default_rng(0)
    signal = rng.standard_normal((8, n)).astype(np.float32)

    # The "unknown" system: a biquad with poles inside the unit circle.
    true = {"b0": 0.3, "a": (0.9, -0.45)}
    spec = FilterSpec(
        "SysId", (Dim("c", 8), Dim("t", n)), (Scan(1, True, 1.0, (0.0, 0.0)),)
    )
    model = LearnableRecFilter(spec, tile_width=64, device=ns.device)
    signal = torch.from_numpy(signal).to(model.device)
    truth = {"scan0": {"b0": torch.tensor(true["b0"], device=model.device),
                       "a": torch.tensor(true["a"], device=model.device)}}
    with torch.no_grad():
        observed = model.apply(truth, signal)

    # the model's own parameters start at b0=1, a=(0,0): identity-ish
    opt = torch.optim.Adam(model.parameters(), 2e-2)
    for i in range(ns.steps):
        opt.zero_grad()
        loss = ((model(signal) - observed) ** 2).mean()
        loss.backward()
        opt.step()
        if i % 100 == 0:
            print(f"step {i:4d}  loss {loss.item():.8f}")

    got = model.params["scan0"]
    print(f"final loss {loss.item():.2e}")
    print(f"true    b0={true['b0']:+.4f}  a={np.round(true['a'], 4)}")
    print(
        f"learned b0={got['b0'].item():+.4f}  "
        f"a={np.round(got['a'].detach().cpu().numpy(), 4)}"
    )


if __name__ == "__main__":
    main()
