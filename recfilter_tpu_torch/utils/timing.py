"""Device timing with CUDA events, and throughput helpers.

Every time here is taken on a CUDA device: a call given CPU tensors raises
rather than timing the host.
"""

from __future__ import annotations

from typing import Callable, List

import torch


def throughput(runtime_ms: float, pixels: int) -> float:
    """MiP/s = pixels·1000 / (runtime_ms · 2^20)."""
    if runtime_ms <= 0.0:
        return float("inf")
    return (float(pixels) * 1000.0) / (runtime_ms * float(2**20))


def mpix_per_sec(runtime_ms: float, pixels: int) -> float:
    """Decimal Mpix/s (10^6 pixels per second)."""
    if runtime_ms <= 0.0:
        return float("inf")
    return (float(pixels) * 1000.0) / (runtime_ms * 1e6)


def _cuda_device(args) -> torch.device:
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(
            f"CUDA-event timing needs tensors on one CUDA device, got {devs}")
    return next(iter(devs))


def call_times_ms(fn: Callable, *args, iterations: int = 20,
                  warmup: int = 3) -> List[float]:
    """Per-call device times: each of ``iterations`` calls is bracketed by
    its own pair of CUDA events on the current stream."""
    dev = _cuda_device(args)
    for _ in range(warmup):
        fn(*args)
    pairs = []
    with torch.cuda.device(dev):
        for _ in range(iterations):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize(dev)
    return [s.elapsed_time(e) for s, e in pairs]


def benchmark(fn: Callable, *args, iterations: int = 10,
              warmup: int = 1) -> float:
    """Total ms of ``iterations`` back-to-back calls between two CUDA
    events, after ``warmup`` calls."""
    dev = _cuda_device(args)
    for _ in range(warmup):
        fn(*args)
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
    return start.elapsed_time(end)


def device_profile(fn: Callable, *args, iterations: int = 10,
                   warmup: int = 3, attempts: int = 3) -> dict:
    """``torch.profiler`` over ``iterations`` back-to-back calls.

    Returns per-call figures: ``call_ms`` (CUDA events around the window),
    ``busy_ms`` (summed device time of kernels and copies — one stream, so
    no overlap), ``idle`` = 1 − busy / call, ``device_ops`` (device kernels
    and copies launched per call) and ``top`` — the five largest device
    ops as (name, ms per call). A trace can come back without its device
    events, or with only some of them, now and then: every call launches
    the same device ops, so a window in which an op's count is not a
    multiple of ``iterations`` lost events. Such a window is profiled
    again, up to ``attempts`` times in all, and ``busy_ms`` and ``idle``
    are None when no attempt recorded every device event."""
    dev = _cuda_device(args)
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize(dev)
    for _ in range(attempts):
        call_ms, ops = _profile_window(fn, args, dev, iterations)
        busy = sum(ms for _, ms, _ in ops)
        if busy > 0 and all(abs(c - round(c)) < 1e-9 for _, _, c in ops):
            break
        busy = 0.0
    ops.sort(key=lambda o: -o[1])
    return {"call_ms": call_ms,
            "busy_ms": busy if busy > 0 else None,
            "idle": 1.0 - busy / call_ms if busy > 0 else None,
            "device_ops": sum(c for _, _, c in ops),
            "top": [(name, ms) for name, ms, _ in ops[:5]]}


def _profile_window(fn: Callable, args, dev, iterations: int):
    """One profiled window: (call_ms, [(op name, device ms per call,
    launches per call)] over the device ops)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iterations):
                fn(*args)
            end.record()
            torch.cuda.synchronize(dev)
    ops = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        ops.append((e.key, us / 1000.0 / iterations, e.count / iterations))
    return start.elapsed_time(end) / iterations, ops
