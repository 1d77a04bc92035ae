"""Application filter builders ported from ``recfilter_tpu.apps``."""

from .audio import audio_filter_biquads, audio_filter_high_order
from .bspline import bicubic, biquintic_cascaded, biquintic_overlapped
from .box import (box_filter_3, box_filter_6, box_filter_order_1,
                  box_filter_order_2, box_oracle)
from .dog import difference_of_gaussians
from .gaussian import (gaussian_1xy_1xy_1xy, gaussian_1xy_2x_2y,
                       gaussian_1xy_2xy, gaussian_3x_3y, gaussian_3xy,
                       gaussian_3xy_rgb, run_cascade)
from .summed_table import summed_table
from .usm import UnsharpMask, unsharp_mask

__all__ = ["audio_filter_biquads", "audio_filter_high_order",
           "bicubic", "biquintic_overlapped", "biquintic_cascaded",
           "box_filter_order_1", "box_filter_order_2", "box_filter_3",
           "box_filter_6", "box_oracle", "difference_of_gaussians",
           "gaussian_3xy", "gaussian_3xy_rgb", "gaussian_3x_3y",
           "gaussian_1xy_2xy", "gaussian_1xy_2x_2y", "gaussian_1xy_1xy_1xy",
           "run_cascade", "summed_table", "UnsharpMask", "unsharp_mask"]
