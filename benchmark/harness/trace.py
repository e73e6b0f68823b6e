"""Reading the traced slice: torch.profiler's Chrome trace, written to the
run's TMPDIR and read back, gives every device operation (kernels,
copies, memsets) with its start and length, and the host's operations
that were running when the device went idle."""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


@dataclasses.dataclass
class Slice:
    """Device operations [(name, start us, length us, category)], host
    operations [(name, start us, length us)], the slice's wall-clock
    seconds (host clock, synchronised at both ends) and its steps (the
    loop's indices)."""

    device_ops: list
    host_ops: list
    wall_s: float
    its: list

    @property
    def steps(self) -> int:
        return len(self.its)

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        total, end = 0.0, None
        for _, ts, dur, _ in sorted(self.device_ops, key=lambda e: e[1]):
            if end is None or ts > end:
                total, end = total + dur, ts + dur
            elif ts + dur > end:
                total, end = total + ts + dur - end, ts + dur
        return total / 1e6

    def kernel_s(self, match) -> tuple[float, int]:
        """Seconds and launches of the device operations whose name `match`
        accepts."""
        hits = [d for name, _, d, _ in self.device_ops if match(name)]
        return sum(hits) / 1e6, len(hits)

    def launches(self) -> int:
        return sum(1 for *_, cat in self.device_ops if cat == "kernel")

    def top_ops(self, n=10):
        by = {}
        for name, _, dur, _ in self.device_ops:
            by[name] = by.get(name, 0.0) + dur / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """Idle seconds between device operations, summed by the innermost
        host operation running at the gap's start."""
        ops = sorted(self.device_ops, key=lambda e: e[1])
        host = sorted(self.host_ops, key=lambda e: e[1])
        starts = [h[1] for h in host]
        by, end = {}, None
        for _, ts, dur, _ in ops:
            if end is not None and ts > end:
                # The latest-starting host operation that spans the gap's
                # start is the innermost one.
                name = "(no host op)"
                for h in reversed(host[max(0, bisect.bisect_right(starts, end) - 4096):
                                       bisect.bisect_right(starts, end)]):
                    if h[1] + h[2] > end:
                        name = h[0]
                        break
                by[name] = by.get(name, 0.0) + (ts - end) / 1e6
            end = ts + dur if end is None else max(end, ts + dur)
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def read(profiler, wall_s, its, device_cats=DEVICE_CATS) -> Slice:
    """The traced slice. `device_cats`: the trace categories that count as
    device operations (a CPU test passes the host's operators)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        profiler.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        item = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
        if cat in device_cats:
            dev.append((*item, cat))
        if cat in HOST_CATS:
            host.append(item)
    if not dev:
        raise RuntimeError("the profiler saw no device operation in the traced slice")
    return Slice(dev, host, wall_s, list(its))
