"""The workloads of spi_tpu_torch/tools/workloads.py, which chip_smoke.py
drives on the card, run on the CPU at the tiny size: two steps each, one
`on_step` call a step, finite outputs, tuned weights that moved, and
every RotBbox image through both steps (step 0 is a regularizer step).
"""

import pytest
import torch

from spi_tpu_torch.tools import workloads
from spi_tpu_torch.utils.params import trainable_parameters
from torch_threads import few_torch_threads  # noqa: F401

STEPS = 2
B = 2

CASES = [("projection", "sg"), ("projection", "sgw+"), ("projection", "mir"), ("tuning", None),
         ("rotbbox", None), ("projection_batch", "sg"), ("projection_batch", "sgw+"),
         ("projection_batch", "mir"), ("rotbbox_batch", None)]


def _finite(*tensors):
    return all(bool(torch.isfinite(t).all()) for t in tensors)


@pytest.fixture(scope="module")
def pivot():
    """(w, noise) of one 'sg' step on the tiny model, the stage-2 start."""
    w, noise, _ = workloads.projection(workloads.build_model("cpu", tiny=True), "sg", 1, "cpu")(None)
    return w, noise


@pytest.mark.parametrize("workload,mode", CASES,
                         ids=[f"{w}-{m}" if m else w for w, m in CASES])
def test_workload_runs_on_cpu(workload, mode, pivot):
    model = workloads.build_model("cpu", tiny=True)
    g = model[0]
    before = {k: p.detach().clone() for k, p in trainable_parameters(g).items()}
    fn = {"projection": lambda: workloads.projection(model, mode, STEPS, "cpu"),
          "tuning": lambda: workloads.tuning(model, pivot, STEPS, "cpu"),
          "rotbbox": lambda: workloads.rotbbox(model, pivot, STEPS, "cpu"),
          "projection_batch": lambda: workloads.projection_batch(model, mode, STEPS, "cpu", B),
          "rotbbox_batch": lambda: workloads.rotbbox_batch(model, pivot, STEPS, "cpu", B),
          }[workload]()
    calls = []
    out = fn(lambda step, value: calls.append(step))
    assert calls == list(range(STEPS))

    if workload.startswith("projection"):
        w, noise, dists = out
        assert dists.shape == ((B, STEPS) if workload == "projection_batch" else (STEPS,))
        assert _finite(w, dists, *noise.values())
        return
    if workload == "rotbbox_batch":
        weights, steps, lps = out
        assert steps == [STEPS] * B
        assert all(torch.isfinite(torch.tensor(lps)))
        assert _finite(*weights.values())
        moved = [k for k, v in weights.items() if not torch.equal(v, before[k].expand_as(v))]
    else:
        _, (steps, last_lpips) = out
        assert steps == STEPS and torch.isfinite(torch.tensor(last_lpips))
        after = trainable_parameters(g)
        assert _finite(*after.values())
        moved = [k for k, p in after.items() if not torch.equal(p, before[k])]
    assert moved, "no tuned weight moved"
