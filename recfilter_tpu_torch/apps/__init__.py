"""Application filter builders ported from ``recfilter_tpu.apps``."""

from .audio import audio_filter_biquads, audio_filter_high_order

__all__ = ["audio_filter_biquads", "audio_filter_high_order"]
