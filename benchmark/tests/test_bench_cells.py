"""Each cell run whole at the configuration's test sizes on the CPU (the
look for a card skipped): the result line's keys, the traced slice's
readers, and `correct` coming out false under the control (the reference
in the configuration's lower operand precision in the program's place) and
under each fault the cell can have: a step that leaves its state
unchanged, one that leaves one leaf unmoved, and half of the batch left
out."""

import argparse
import contextlib

import pytest
import torch

from benchmark import harness, run

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}
E2E = {"img_steps_per_s", "step_p90_ms", "peak_gib", "setup_s"}


def tiny_run(monkeypatch, cell, trace=0, **overrides):
    """One run at the test sizes; `overrides` change the cell's file."""
    load = harness.load_json

    def patched(kind, name):
        d = load(kind, name)
        if kind == "workloads" and name == cell:
            for k, v in overrides.items():
                d[k] = {**d[k], **v} if isinstance(v, dict) else v
        return d

    monkeypatch.setattr(harness, "load_json", patched)
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 99, seconds=0.5, trace=trace)
    return run.run_cell(args, torch.device("cpu"), tiny=True, log=lambda s: None)


CELLS = {"inv_rotbbox_b4": {"images": 2}, "edit_clip_b2": {}}


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(monkeypatch, cell, trace):
    out = tiny_run(monkeypatch, cell, trace, trace_steps=2, **CELLS[cell])
    assert out["correct"], out["compared"]
    assert REQUIRED <= set(out) and ("breakdown" in out) == bool(trace)
    assert list(out)[-1] == "compared"
    assert set(out) - REQUIRED - {"breakdown"} == {"window", "compared"}
    if trace:
        assert {"launches_per_step", "conv_ms_per_step", "idle_share", "step_mfu"} \
            <= set(out["metrics"])
        assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
    else:
        assert set(out["metrics"]) == E2E


@contextlib.contextmanager
def _patched(obj, name, fn):
    original = getattr(obj, name)
    setattr(obj, name, fn(original))
    try:
        yield
    finally:
        setattr(obj, name, original)


def _unchanged_state(original):
    """Adam's step reads the gradient and writes nothing."""
    def step(self, closure=None):
        return None
    return step


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_state_unchanged(monkeypatch, cell):
    with _patched(torch.optim.Adam, "step", _unchanged_state):
        out = tiny_run(monkeypatch, cell, **CELLS[cell])
    assert not out["correct"]


def _one_leaf_unmoved(original):
    """Adam's step leaves the group's last leaf as it was."""
    def step(self, closure=None):
        leaf = self.param_groups[0]["params"][-1]
        kept = leaf.detach().clone()
        out = original(self, closure)
        with torch.no_grad():
            leaf.copy_(kept)
        return out
    return step


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_one_leaf_unmoved(monkeypatch, cell):
    """A fault confined to one leaf shows in the worst leaf's change."""
    with _patched(torch.optim.Adam, "step", _one_leaf_unmoved):
        out = tiny_run(monkeypatch, cell, **CELLS[cell])
    assert not out["correct"]
    assert out["compared"]["change"]["value"] > out["compared"]["change"]["limit"]


def test_fault_half_batch_editing(monkeypatch):
    from benchmark.calibrate import half_batch

    with half_batch():
        out = tiny_run(monkeypatch, "edit_clip_b2")
    assert not out["correct"]


def test_fault_half_lanes_rotbbox(monkeypatch):
    """Half of the images' updates left out: their weights come back."""
    from benchmark.calibrate import half_lanes

    with half_lanes():
        out = tiny_run(monkeypatch, "inv_rotbbox_b4", images=2)
    assert not out["correct"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(monkeypatch, cell):
    """The control, the reference with the configuration's lower operand
    precision in the program's place, reads above a limit."""
    from benchmark.harness import Ctx, check, load_module

    wl = {**harness.load_json("workloads", cell), **CELLS[cell]}
    config = harness.load_json("configs", wl["config"])
    ctx = Ctx(cell, wl, config, 17, torch.device("cpu"), tiny=True)
    entry = load_module("entries", wl["entry"]).build(ctx)
    entry.release()
    ref = entry.reference()
    control = entry.reference(getattr(torch, config["control_dtype"]))
    ok, lines = check.judge(check.numbers(control, ref), wl["limits"])
    assert not ok, lines


@pytest.mark.chip
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_on_the_card(card, cell):
    """The same at the cell's own size on the card, three seeds."""
    from benchmark.harness import Ctx, check, load_module

    wl = harness.load_json("workloads", cell)
    config = harness.load_json("configs", wl["config"])
    for seed in (101, 102, 103):
        entry = load_module("entries", wl["entry"]).build(Ctx(cell, wl, config, seed, card))
        entry.release()
        ref = entry.reference()
        control = entry.reference(getattr(torch, config["control_dtype"]))
        ok, lines = check.judge(check.numbers(control, ref), wl["limits"])
        assert not ok, lines
