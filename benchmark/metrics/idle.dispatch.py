"""Device-idle ms a step in gaps that start while the host issues the
step's work, inside a program span other than `spi.sync`."""

from benchmark.harness import load_module

UNIT = "ms"
spans = load_module("metrics", "_spans")


def read(m):
    idle = spans.idle_ms(m.slice)
    return None if idle is None else idle["dispatch"]
