"""Device-idle ms a step under no program span: the caller's code between
steps (its callback and reads) and the traced slice's leading and
trailing edges. With `idle.sync` and `idle.dispatch` it adds up to the
slice's idle time (`idle_share`) over its steps."""

from benchmark.harness import load_module

UNIT = "ms"
spans = load_module("metrics", "_spans")


def read(m):
    idle = spans.idle_ms(m.slice)
    return None if idle is None else idle["outside"]
