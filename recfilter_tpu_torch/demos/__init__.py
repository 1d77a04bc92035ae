"""Demos of the port, each run as ``python -m recfilter_tpu_torch.demos.<name>``."""
