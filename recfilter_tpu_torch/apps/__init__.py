"""Application filter builders ported from ``recfilter_tpu.apps``."""

from .audio import audio_filter_biquads, audio_filter_high_order
from .gaussian import (gaussian_1xy_1xy_1xy, gaussian_1xy_2x_2y,
                       gaussian_1xy_2xy, gaussian_3x_3y, gaussian_3xy,
                       gaussian_3xy_rgb, run_cascade)

__all__ = ["audio_filter_biquads", "audio_filter_high_order",
           "gaussian_3xy", "gaussian_3xy_rgb", "gaussian_3x_3y",
           "gaussian_1xy_2xy", "gaussian_1xy_2x_2y", "gaussian_1xy_1xy_1xy",
           "run_cascade"]
