"""The share of the traced slice's `spi.step` spans that hold a
`spi.graph_replay` span (one a replay of a step captured as a CUDA graph),
in %: how much of the loop the host issues as one launch. None where the
slice has no such span (a loop issued operator by operator)."""

import bisect

from benchmark.harness import load_module

UNIT = "%"
spans = load_module("metrics", "_spans")


def read(m):
    found = spans.read(m.slice)
    if found is None:
        return None
    starts = [s[1] for s in found.steps]
    held = set()
    for name, s, e in found.spans:
        if name != "spi.graph_replay":
            continue
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and e <= found.steps[k][2]:
            held.add(k)
    return 100.0 * len(held) / len(found.steps) if held else None
