"""Training statistics: moment accumulators (counterpart of
spi_tpu/utils/stats.py; spec eg3d/torch_utils/training_stats.py:57-211).

`report` accumulates a [count, sum, sum of squares] triple per name; a
`Collector` exposes mean / std and writes the stats.jsonl lines of the
training loop (training_loop.py:430-447). Across processes the triples
meet in one all-reduce over `torch.distributed` (`cross_device_sum`,
training_stats._sync :245-266); in a single process it changes nothing.
`span` marks a part of the program for torch.profiler's trace.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def moments_of(x) -> torch.Tensor:
    """-> [count, sum, sum(x^2)], a float32 triple of a tensor or number."""
    x = torch.as_tensor(x, dtype=torch.float32).detach()
    return torch.stack([torch.tensor(float(x.numel()), device=x.device), x.sum(),
                        (x * x).sum()])


def accumulate(moments: torch.Tensor, x) -> torch.Tensor:
    return moments + moments_of(x).to(moments.device)


def cross_device_sum(moments_tree: dict) -> dict:
    """The moment triples summed over every process of the default group (one
    all-reduce of their concatenation); unchanged in a single process."""
    if not (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1):
        return dict(moments_tree)
    names = sorted(moments_tree)
    flat = torch.stack([torch.as_tensor(moments_tree[k], dtype=torch.float32).reshape(3)
                        for k in names])
    dist.all_reduce(flat)
    return {k: flat[i] for i, k in enumerate(names)}


def mean_std(moments) -> tuple[float, float]:
    m = np.asarray(torch.as_tensor(moments).cpu(), np.float64)
    if m[0] == 0:
        return float("nan"), float("nan")
    mean = m[1] / m[0]
    var = max(m[2] / m[0] - mean * mean, 0.0)
    return float(mean), float(var**0.5)


class Collector:
    """Host-side accumulator with the reference's report surface."""

    def __init__(self):
        self._moments: dict[str, np.ndarray] = {}

    def report(self, name: str, value):
        m = moments_of(value).cpu().numpy().astype(np.float64)
        self._moments[name] = self._moments.get(name, np.zeros(3)) + m

    def update_from_tree(self, tree: dict):
        """Merge {name: moments triple}, e.g. from `cross_device_sum`."""
        for name, m in tree.items():
            m = np.asarray(torch.as_tensor(m).cpu(), np.float64)
            self._moments[name] = self._moments.get(name, np.zeros(3)) + m

    def mean(self, name: str) -> float:
        return mean_std(self._moments.get(name, np.zeros(3)))[0]

    def std(self, name: str) -> float:
        return mean_std(self._moments.get(name, np.zeros(3)))[1]

    def as_dict(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, m in self._moments.items():
            mean, std = mean_std(m)
            out[name] = {"num": float(m[0]), "mean": mean, "std": std}
        return out

    def reset(self):
        self._moments.clear()

    def write_jsonl(self, path: str, **extra):
        """Append one stats line (training_loop.py:430-447 stats.jsonl)."""
        entry = dict(self.as_dict())
        entry.update(extra)
        entry["timestamp"] = time.time()
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")


def span(name: str):
    """A context manager that marks a span `name` of the program (the
    `spi.*` names: the loops' steps and their parts, the generator's and
    the losses' networks) while a `torch.profiler` runs, as
    `torch.profiler.record_function` (eg3d/torch_utils/misc.py:102-107);
    the profiler keeps it beside the operators and exports it with its
    trace. With no profiler running it returns a shared context that does
    nothing, and calls no profiler operator."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
