"""Gaussian IIR blur — the five tiling/cascading strategies of the JAX
package's ``recfilter_tpu/apps/gaussian.py`` (the reference's
``apps/gaussian/``), against the port's :class:`RecFilter`.

All use van Vliet–Young recursive Gaussian weights with clamped image
borders:

  3xy          — one 3rd-order filter, all four scans overlapped
  3x_3y        — cascaded by dimension: x, then y
  1xy_2xy      — 1st-order overlapped, then 2nd-order overlapped
  1xy_2x_2y    — 1st-order overlapped, then 2nd-order x, then 2nd-order y
  1xy_1xy_1xy  — three cascaded 1st-order filters (an approximation study)

The cascades return their stages; :func:`run_cascade` runs them on an
image, on the card unless the caller asks for the CPU. An overlapped stage
runs the 3-touch 2-D executor, an x-only stage the last-axis executor and
a y-only stage the rows pass.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..api import RecFilter
from ..iir import gaussian_weights
from ..planner import auto_tile_width
from ..spec import Dim

SIGMA_DEFAULT = 5.0


def _base(name: str, width: int, height: int):
    x, y = Dim("x", width), Dim("y", height)
    F = RecFilter(name)
    F.set_clamped_image_border()
    F[y, x] = np.zeros((height, width), dtype=np.float32)
    return F, x, y


def _add_xy(F, x, y, w):
    for d in (+x, -x, +y, -y):
        F.add_filter(d, w)


def _split(fc: List[RecFilter], tile_width: int) -> List[RecFilter]:
    for f in fc:
        f.split_all_dimensions(tile_width)
    return fc


def gaussian_3xy(width, height, tile_width=0, sigma=SIGMA_DEFAULT):
    """Single 3rd-order filter, 4 scans, fully tiled."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    F, x, y = _base("Gaussian_3xy", width, height)
    _add_xy(F, x, y, gaussian_weights(sigma, 3))
    F.split(x, tile_width, y, tile_width)
    return F


def gaussian_3xy_rgb(width, height, tile_width=0, channels=3,
                     sigma=SIGMA_DEFAULT):
    """Multi-channel :func:`gaussian_3xy`: channels ride a leading batch
    axis, input (channels, height, width)."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    c, x, y = Dim("c", channels), Dim("x", width), Dim("y", height)
    F = RecFilter("Gaussian_3xy_rgb")
    F.set_clamped_image_border()
    F[c, y, x] = np.zeros((channels, height, width), dtype=np.float32)
    _add_xy(F, x, y, gaussian_weights(sigma, 3))
    F.split(x, tile_width, y, tile_width)
    return F


def gaussian_3x_3y(width, height, tile_width=0,
                   sigma=SIGMA_DEFAULT) -> List[RecFilter]:
    """Cascade by dimension."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    F = gaussian_3xy(width, height, tile_width, sigma)
    return _split(F.cascade_by_dimension(), tile_width)


def _orders_1_2(name, width, height, sigma):
    F, x, y = _base(name, width, height)
    _add_xy(F, x, y, gaussian_weights(sigma, 1))
    _add_xy(F, x, y, gaussian_weights(sigma, 2))
    return F


def gaussian_1xy_2xy(width, height, tile_width=0,
                     sigma=SIGMA_DEFAULT) -> List[RecFilter]:
    """1st-order overlapped then 2nd-order overlapped."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    F = _orders_1_2("Gaussian_1xy_2xy", width, height, sigma)
    return _split(F.cascade([0, 1, 2, 3], [4, 5, 6, 7]), tile_width)


def gaussian_1xy_2x_2y(width, height, tile_width=0,
                       sigma=SIGMA_DEFAULT) -> List[RecFilter]:
    """1st-order overlapped, then 2nd-order x, then 2nd-order y."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    F = _orders_1_2("Gaussian_1xy_2x_2y", width, height, sigma)
    return _split(F.cascade([0, 1, 2, 3], [4, 5], [6, 7]), tile_width)


def gaussian_1xy_1xy_1xy(width, height, tile_width=0,
                         sigma=SIGMA_DEFAULT) -> List[RecFilter]:
    """Three cascaded 1st-order filters ≈ 3rd-order Gaussian."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    F, x, y = _base("Gaussian_1xy_1xy_1xy", width, height)
    for _ in range(3):
        _add_xy(F, x, y, gaussian_weights(sigma, 1))
    return _split(F.cascade([0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]),
                  tile_width)


def run_cascade(fc: List[RecFilter], image, *, device="cuda"):
    """Realize a cascade chain on ``image`` on ``device``: each stage
    filters the previous stage's output."""
    out = image
    for f in fc:
        out = f.realize(out, device=device)
    return out
