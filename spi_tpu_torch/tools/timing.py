"""Timing and roofline helpers shared by the probe tools and chip_smoke.py,
which time and check kernels; steps are timed by benchmark/run.py alone.

`time_ms` times back-to-back calls with CUDA events: where a call's host
work (checks, allocation, launch) takes longer than its device work, it
reads the host's pace. `device_ms` hides the host's enqueueing behind a
sleep on the stream and reads the device alone; `enqueue_us` reads the
host's part of a call apart."""

from __future__ import annotations

import subprocess
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


_sleep_cycles_per_ms: dict[int, float] = {}


def _cycles_per_ms(dev: torch.device) -> float:
    """Clock cycles of `torch.cuda._sleep` per millisecond on `dev`,
    measured once per process with CUDA events."""
    if dev.index not in _sleep_cycles_per_ms:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # wake the clocks
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        torch.cuda.synchronize(dev)
        _sleep_cycles_per_ms[dev.index] = 20_000_000 / start.elapsed_time(end)
    return _sleep_cycles_per_ms[dev.index]


def _card(device) -> torch.device:
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device-only timing needs a CUDA device, got {dev}")
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


def device_ms(fn, iters: int = 20, warmup: int = 3, device=None) -> float:
    """Mean milliseconds of device time of `fn()` over `iters` calls, with
    the host's enqueueing hidden: a `torch.cuda._sleep` first holds the
    stream for longer than the host takes to enqueue all `iters` calls,
    then CUDA events around the calls time the device alone. Raises on a
    CPU device (there is no host-clock fallback) and where the sleep ran
    out before the host had enqueued the calls, after doubling it twice."""
    dev = _card(device)
    with torch.cuda.device(dev):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(dev)
        host_ms = enqueue_us(fn, iters, dev) * iters / 1e3
        for slack in (2.0, 4.0, 8.0):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int((slack * host_ms + 1.0) * _cycles_per_ms(dev)))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            drained = start.query()  # the sleep had ended before the last call was queued
            torch.cuda.synchronize(dev)
            if not drained:
                return start.elapsed_time(end) / iters
    raise RuntimeError("device_ms: the host could not enqueue the calls ahead of the device")


def enqueue_us(fn, iters: int = 20, device=None) -> float:
    """Mean host microseconds to enqueue one `fn()` call, measured behind a
    `torch.cuda._sleep` that holds the stream, so the host never waits for
    the device. The host work per call of a kernel's wrapper."""
    dev = _card(device)
    with torch.cuda.device(dev):
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(int(50.0 * _cycles_per_ms(dev)))  # 50 ms
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
    return t * 1e6 / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    HBM rate and float32 operations over the peak rate, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi's csv gives them, or
    'cpu'."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={device.index or 0}"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]
