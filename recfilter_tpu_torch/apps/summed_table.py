"""Summed-area table (the JAX package's ``recfilter_tpu/apps/
summed_table.py``; the reference's ``apps/summed_table``): first-order
causal scans in x and y with coefficients {1, 1}, 2-D tiled.

A float32 table runs the 3-touch 2-D executor; an int8, int16 or int32
table (an integral image: wrap-around, bit exact) runs the integer unit
route, one ``int_scan`` launch per axis (``dimfuse.IntUnitPass``)."""

from __future__ import annotations

import numpy as np

from ..api import RecFilter
from ..planner import auto_tile_width
from ..spec import Dim


def summed_table(width: int, height: int, tile_width: int = 0,
                 dtype="float32") -> RecFilter:
    """Build the SAT filter over (height, width) images of ``dtype``."""
    tile_width = tile_width or auto_tile_width(min(width, height))
    x = Dim("x", width)
    y = Dim("y", height)
    F = RecFilter("Summed_table")
    F[y, x] = np.zeros((height, width), dtype=dtype)
    F.add_filter(+x, [1.0, 1.0])
    F.add_filter(+y, [1.0, 1.0])
    F.split(x, tile_width, y, tile_width)
    return F
