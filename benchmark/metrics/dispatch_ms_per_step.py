"""The host's ms a step spent issuing the loop's work, not waiting on the
card: the traced slice's `spi.step` spans, less the `spi.sync` spans
inside them, over its steps (training/coaches.py, training/projectors.py,
editing/zssgan.py). Larger than the device's busy ms a step, the host
sets the pace."""

from benchmark.harness import load_module

UNIT = "ms"
spans = load_module("metrics", "_spans")


def read(m):
    found = spans.read(m.slice)
    if found is None:
        return None
    step_us = sum(e - s for _, s, e in found.steps)
    sync_us = sum(e - s for _, s, e in found.syncs)
    return (step_us - sync_us) / 1e3 / m.slice.steps
