"""Device-idle ms a step in gaps that start while the host waits on the
card, inside a `spi.sync` span (the steps' blocking transfers)."""

from benchmark.harness import load_module

UNIT = "ms"
spans = load_module("metrics", "_spans")


def read(m):
    idle = spans.idle_ms(m.slice)
    return None if idle is None else idle["sync"]
