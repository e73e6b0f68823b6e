"""Blocking transfers between host and card in the loop's steps: the
traced slice's `spi.sync` spans inside `spi.step` spans, over its steps."""

from benchmark.harness import load_module

UNIT = "syncs"
spans = load_module("metrics", "_spans")


def read(m):
    found = spans.read(m.slice)
    return None if found is None else len(found.syncs) / m.slice.steps
