"""The per-layer metrics: every `benchmark/metrics/<name>.py` is a reader
with a `UNIT` and `read(m)`, which takes the traced slice (`m.slice`), the
cell (`m.cell`: its counts of work), the window's end-to-end numbers
(`m.e2e`) and the configuration (`m.config`), and returns the metric's
value, or None where it finds nothing to read: the metric is then left
out of the line."""

from __future__ import annotations

import dataclasses
import sys

from benchmark import harness


@dataclasses.dataclass
class Input:
    cell: object
    slice: object
    e2e: dict
    config: dict


def read_all(cell, traced, e2e, config) -> dict:
    """{name: (value, unit)} of every reader that finds something."""
    m = Input(cell, traced, e2e, config)
    out = {}
    for path in sorted((harness.ROOT / "metrics").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        reader = harness.load_module("metrics", path.stem)
        value = reader.read(m)
        if value is None:
            print(f"metric {path.stem}: nothing to read in this cell", file=sys.stderr)
            continue
        out[path.stem] = (float(value), reader.UNIT)
    return out
