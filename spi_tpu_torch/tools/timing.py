"""Timing and roofline helpers shared by the probe tools and chip_smoke.py."""

from __future__ import annotations

import time

import torch

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM rate and
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def time_ms(fn, iters: int = 20, warmup: int = 3, device=None) -> float:
    """Mean milliseconds of `fn()` over `iters` calls after `warmup` calls:
    CUDA events on the card, the host clock on the CPU."""
    on_card = device is None or torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    HBM rate and float32 operations over the peak rate, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
