"""B-spline interpolation prefilters — the JAX package's
``recfilter_tpu/apps/bspline.py`` (the reference's ``apps/bspline/``),
against the port's :class:`RecFilter`.

Bicubic: a 1st-order causal + anticausal scan per dimension with pole
a = 2 − √3, coefficients {1 + a, −a}. Biquintic: 2nd-order, as one
overlapped filter or cascaded by dimension. All clamp the image border, so
extents that are not multiples of 128 (an HD frame's 1080 rows) take the
rotation chain (``dimfuse.RotationChain``) instead of the 3-touch
executor. The builders return the filter; its ``as_func``/``realize`` run
on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ..api import RecFilter
from ..planner import auto_tile_width
from ..spec import Dim


def _prefilter(name: str, width: int, height: int, coeff,
               tile_width: int) -> RecFilter:
    x, y = Dim("x", width), Dim("y", height)
    F = RecFilter(name)
    F.set_clamped_image_border()
    F[y, x] = np.zeros((height, width), dtype=np.float32)
    for d in (+x, -x, +y, -y):
        F.add_filter(d, coeff)
    F.split_all_dimensions(tile_width)
    return F


def bicubic(width: int, height: int, tile_width: int = 0) -> RecFilter:
    """Bicubic prefilter: 4 first-order scans, overlapped."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    a = 2.0 - math.sqrt(3.0)
    return _prefilter("Bicubic", width, height, [1.0 + a, -a], tile_width)


def _biquintic_coeff():
    """The quintic B-spline's poles z1, z2 (Unser et al.): the prefilter
    is a 2nd-order causal-anticausal filter per dimension, feedback
    (z1 + z2, −z1·z2), unit-gain feed-forward (1 − z1)(1 − z2)."""
    r = math.sqrt(17745.0 / 4.0)
    z1 = math.sqrt(135.0 / 2.0 - r) + math.sqrt(105.0 / 4.0) - 13.0 / 2.0
    z2 = math.sqrt(135.0 / 2.0 + r) - math.sqrt(105.0 / 4.0) - 13.0 / 2.0
    return [(1.0 - z1) * (1.0 - z2), z1 + z2, -z1 * z2]


def biquintic_overlapped(width: int, height: int,
                         tile_width: int = 0) -> RecFilter:
    """Biquintic prefilter, all scans in one overlapped filter."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    return _prefilter("Biquintic", width, height, _biquintic_coeff(),
                      tile_width)


def biquintic_cascaded(width: int, height: int,
                       tile_width: int = 0) -> List[RecFilter]:
    """Biquintic prefilter cascaded by dimension (x, then y); run the
    stages with :func:`.gaussian.run_cascade`."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    fc = biquintic_overlapped(width, height, tile_width).cascade_by_dimension()
    for f in fc:
        f.split_all_dimensions(tile_width)
    return fc
