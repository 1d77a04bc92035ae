"""Unsharp mask: a Gaussian blur cascade and a pointwise combine, as the
JAX package's ``recfilter_tpu/apps/usm.py`` builds it (the reference's
``apps/usm/``):

    USM(x, y) = (1 + w)·I(x, y) − w·Blur(x, y)

Three routes, each a module tagged with ``usm_route``:

  merged — :func:`..api.fuse_cascade` merges ``gaussian_3x_3y``'s two
           stages back into one filter (scans ±x, ±y: the 3-touch 2-D
           executor where its gates hold) and the combine is its epilogue.
           The combine is affine, so it runs inside the final kernel's
           store loop (``final2d_epi``) with the image as its one aux: the
           blur never touches device memory. The reference's hand
           ``compute_at`` into the consumer's blocks
           (``unsharp_mask_optimized.cpp:61-71``).
  staged — the stages one after another, the combine the last one's
           epilogue.
  naive  — (``fused=False``) the stages, then the combine as torch ops
           (``unsharp_mask_naive.cpp``).

As in the JAX package, the fused route gates on the built filters' own
precision: the px grades and ``default`` merge, ``highest`` (the einsum
passes) stages.
"""

from __future__ import annotations

from torch import nn

from ..api import fuse_cascade
from .gaussian import gaussian_3x_3y


class UnsharpMask(nn.Module):
    """``forward(image)``: the sharpened image on ``stages``' route —
    ``usm_route`` "merged" (one fused module, the combine its epilogue),
    "staged" (the last stage's epilogue) or "naive" (the combine after
    the last stage)."""

    def __init__(self, stages, combine, route: str):
        super().__init__()
        self.stages, self.combine = nn.ModuleList(stages), combine
        self.usm_route = route

    def forward(self, image):
        return self._run(image, False)

    def forward_plain(self, image):
        return self._run(image, True)

    def _run(self, image, plain):
        *blur, last = [m.forward_plain if plain else m for m in self.stages]
        b = image
        for fn in blur:
            b = fn(b)
        if self.usm_route == "naive":
            return self.combine(last(b), image)
        return last(b, image)  # the combine is last's epilogue


def unsharp_mask(width: int, height: int, tile_width: int = 0,
                 sigma: float = 5.0, weight: float = 1.0, fused: bool = True,
                 *, matmul_precision: str = "px6",
                 device="cuda") -> UnsharpMask:
    """The unsharp mask of a (height, width) float32 image as a module on
    ``device`` (the card unless the caller asks for the CPU):
    ``module(image)``. ``matmul_precision`` is the blur stages' plan (px6,
    the default), the JAX package's global default made explicit."""
    fc = gaussian_3x_3y(width, height, tile_width, sigma)
    for f in fc:
        f.set_plan(matmul_precision=matmul_precision)

    def combine(blur, image):
        return (1.0 + weight) * image - weight * blur

    if not fused:
        return UnsharpMask([f.as_func(device=device) for f in fc], combine,
                           "naive")
    mp = fc[0].plan.matmul_precision
    if mp.startswith("px") or mp == "default":
        return UnsharpMask([fuse_cascade(fc, epilogue=combine,
                                         device=device)], combine, "merged")
    return UnsharpMask([f.as_func(device=device) for f in fc[:-1]]
                       + [fc[-1].as_func(epilogue=combine, device=device)],
                       combine, "staged")
