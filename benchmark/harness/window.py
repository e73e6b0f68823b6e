"""The measured window and the traced slice, driven from the loop's own
per-step callback.

Set-up ends when the cell's last warm-up step completes: the device is
synchronised once and the window opens. Each later step's completion is
stamped with a CUDA event recorded on the stream right after the step's
work, with no synchronise. Once `seconds` have passed on the host's
clock the window closes on a synchronise. A traced run then lets the loop
go on untraced to the start of the entry's slice and runs that slice
under torch.profiler. `Stop` ends the loop."""

from __future__ import annotations

import time

import numpy as np
import torch


class Stop(Exception):
    """Raised from the step callback to end the cell's loop."""


class Window:
    def __init__(self, t_start, warmup, seconds, images_per_step, device, profiler=None,
                 slice_steps=0, slice_starts=None):
        self.t_start, self.warmup, self.seconds = t_start, warmup, seconds
        self.images_per_step, self.device = images_per_step, device
        self.profiler, self.slice_steps = profiler, slice_steps
        self.slice_starts = slice_starts or (lambda it: True)
        self.phase, self.done = "setup", 0
        self.events, self.slice_its = [], []
        self.t0 = self.t_end = self.t_slice = None
        self.peak_bytes = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _stamp(self):
        if self.device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)
        else:
            self.events.append(time.perf_counter())

    def on_step(self, it):
        """Call after each step of the loop; `it` is the loop's own step index."""
        if self.phase == "setup":
            self.done += 1
            if self.done == self.warmup:
                self.t0 = self._sync()
                self._stamp()
                self.phase = "window"
        elif self.phase == "window":
            self._stamp()
            if time.perf_counter() - self.t0 >= self.seconds:
                self.t_end = self._sync()
                if self.device.type == "cuda":
                    self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
                if self.profiler is None:
                    raise Stop
                self.phase = "wait"
        if self.phase == "wait" and self.slice_starts(it):
            self._sync()
            self.profiler.start()
            self.t_slice = time.perf_counter()
            self.phase = "slice"
        elif self.phase == "slice":
            self.slice_its.append(it)
            if len(self.slice_its) == self.slice_steps:
                self.t_slice = self._sync() - self.t_slice
                self.profiler.stop()
                raise Stop

    # -- results ------------------------------------------------------------
    @property
    def setup_s(self) -> float:
        return self.t0 - self.t_start

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    @property
    def steps(self) -> int:
        return len(self.events) - 1

    def intervals_ms(self) -> list[float]:
        e = self.events
        if self.device.type == "cuda":
            return [a.elapsed_time(b) for a, b in zip(e[:-1], e[1:])]
        return [1e3 * (b - a) for a, b in zip(e[:-1], e[1:])]

    def halves(self) -> tuple[int, int]:
        """Steps completed in the first and in the second half of the
        window, by the device's stamps: a warm-up too short shows as a
        slower first half."""
        t = np.cumsum(self.intervals_ms())
        first = int((t <= t[-1] / 2).sum()) if len(t) else 0
        return first, len(t) - first

    def end_to_end(self) -> dict:
        iv = self.intervals_ms()
        return {
            "img_steps_per_s": self.steps * self.images_per_step / self.window_s,
            "step_p90_ms": float(np.percentile(iv, 90)) if iv else float("nan"),
            "peak_gib": (self.peak_bytes or 0) / 2 ** 30,
            "setup_s": self.setup_s,
        }
