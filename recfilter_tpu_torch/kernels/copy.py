"""The streaming copy ``y = 1.0001·x`` (``csrc/copy.cu``): the bandwidth
probe of the headline benchmark (:mod:`recfilter_tpu_torch.bench`), the
JAX package's ``bench.py::_copy``.

:func:`copy` launches the kernel for a CUDA tensor and runs :func:`plain`
for a CPU tensor; :func:`plain` is the twin, one fp32 multiply, which the
kernel equals bit for bit.
"""

from __future__ import annotations

import torch

from .launch import _check, _launch

SCALE = 1.0001


def plain(x: torch.Tensor) -> torch.Tensor:
    return x * SCALE


def copy(x: torch.Tensor) -> torch.Tensor:
    """``1.0001·x`` of a contiguous float32 tensor, in a new tensor."""
    if not x.is_cuda:
        return plain(x)
    _check(x, "x", x.shape, x.device)
    if x.numel() >= 2**31:
        raise ValueError(f"{x.numel()} elements: the kernel takes fewer "
                         "than 2**31")
    y = torch.empty_like(x)
    _launch("copy", (x.data_ptr(), y.data_ptr(), x.numel()), x.device)
    return y
