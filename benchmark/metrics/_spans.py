"""What the readers of the program's spans share. The port opens `spi.*`
spans (`spi_tpu_torch/utils/stats.span`) while a profiler runs: one
`spi.step` a step of its loops, and inside it the step's parts, each
blocking transfer between host and card as `spi.sync`. They reach the
traced slice among its host operations, on the device operations' clock.
A slice without a `spi.step` span (a program without spans) gives None,
and its metrics are left out of the line."""

from __future__ import annotations

import bisect

PREFIX = "spi."


class Spans:
    """The slice's program spans [(name, start us, end us)] by start, its
    `spi.step` spans, and the `spi.sync` spans that lie in a step."""

    def __init__(self, spans):
        self.spans = spans
        self.steps = [s for s in spans if s[0] == "spi.step"]
        starts = [s[1] for s in self.steps]
        self.syncs = []
        for s in spans:
            if s[0] == "spi.sync":
                k = bisect.bisect_right(starts, s[1]) - 1
                if k >= 0 and s[2] <= self.steps[k][2]:
                    self.syncs.append(s)


def read(sl) -> Spans | None:
    spans = sorted(((name, ts, ts + dur) for name, ts, dur in sl.host_ops
                    if name.startswith(PREFIX)), key=lambda s: s[1])
    found = Spans(spans)
    return found if found.steps else None


def idle_ms(sl) -> dict | None:
    """Device-idle ms a step, by where each gap starts: 'sync' in a
    `spi.sync` span, 'dispatch' in any other program span, 'outside' the
    rest of the slice's idle time (gaps under no program span, and the
    slice's leading and trailing edges). A gap lies between consecutive
    intervals of the union of device operations (those `Slice.busy_s`
    merges); it goes whole to the innermost program span open at its
    start, the latest-starting one that contains it. The three add up to
    (wall - busy) ms over the steps."""
    found = read(sl)
    if found is None:
        return None
    ops = sorted((ts, ts + dur) for _, ts, dur, _ in sl.device_ops)
    spans, i, stack = found.spans, 0, []
    by = {"sync": 0.0, "dispatch": 0.0}
    end = None
    for ts, te in ops:
        if end is not None and ts > end:
            # The spans started by the gap's start, in order; once those that
            # ended are dropped, the last is the innermost open one.
            while i < len(spans) and spans[i][1] <= end:
                stack.append(spans[i])
                i += 1
            if stack and stack[-1][2] <= end:
                stack = [s for s in stack if s[2] > end]
            if stack:
                by["sync" if stack[-1][0] == "spi.sync" else "dispatch"] += (ts - end) / 1e3
        end = te if end is None else max(end, te)
    out = {k: v / sl.steps for k, v in by.items()}
    out["outside"] = (sl.wall_s - sl.busy_s()) * 1e3 / sl.steps - out["sync"] - out["dispatch"]
    return out
