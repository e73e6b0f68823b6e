"""The readers of the program's spans (`benchmark/metrics/_spans.py` and
the five metrics that use it): exact values on a slice built by hand,
None on a slice without spans, the three idle parts adding up to
`idle_share`'s idle time, and both cells' traced lines at the test sizes
on the CPU. On the card (`chip`): every blocking CUDA runtime call inside a
step lies within a `spi.sync` span, but those PyTorch's own backward
functions make, and each step's kernels start after the step and their
launches begin, on the profiler's one clock."""

import json

import pytest
import torch

from benchmark import harness
from benchmark.harness.metrics import Input
from benchmark.harness.trace import Slice

SPAN_METRICS = ("dispatch_ms_per_step", "syncs_per_step", "idle.sync", "idle.dispatch",
                "idle.outside")


def _read(name, sl):
    return harness.load_module("metrics", name).read(Input(None, sl, {}, {}))


def _slice():
    """Two steps (us): step 0 [100, 500] holds draws, recon, a sync [240,
    300] and a rot term [310, 460] with a sync [320, 350]; step 1 [600,
    900] a sync [700, 800]. Before the steps a network's span [20, 50];
    after them the caller's sync [950, 960], in no step. Device gaps start
    at 30 (in the network's span), 150 (recon), 250 and 330 (syncs), 520
    (between the steps), 720 (sync) and 880 (step 1 alone); the slice's
    edges idle 90 us."""
    host = [("spi.lpips", 20, 30), ("spi.step", 100, 400), ("spi.draws", 110, 20),
            ("spi.recon", 130, 100), ("spi.sync", 240, 60), ("aten::_local_scalar_dense", 245, 50),
            ("spi.term.rot", 310, 150), ("spi.sync", 320, 30), ("spi.step", 600, 300),
            ("spi.sync", 700, 100), ("spi.sync", 950, 10), ("aten::mul", 880, 5)]
    dev = [(f"k{i}", ts, dur, "kernel") for i, (ts, dur) in enumerate(
        [(0, 10), (5, 25), (60, 90), (180, 70), (290, 40), (345, 175), (640, 80), (790, 90),
         (1000, 10)])]
    dev.append(("Memcpy HtoD", 800, 20, "gpu_memcpy"))  # inside k7
    return Slice(dev, host, wall_s=1100e-6, its=[7, 8])


def test_readers_exact():
    sl = _slice()
    assert sl.busy_s() == pytest.approx(585e-6)
    # (400 - 60 - 30) + (300 - 100) us of dispatch over 2 steps.
    assert _read("dispatch_ms_per_step", sl) == pytest.approx(0.255)
    assert _read("syncs_per_step", sl) == pytest.approx(1.5)
    assert _read("idle.sync", sl) == pytest.approx((40 + 15 + 70) / 2e3)
    assert _read("idle.dispatch", sl) == pytest.approx((30 + 30 + 120) / 2e3)
    assert _read("idle.outside", sl) == pytest.approx((120 + 90) / 2e3)


def test_idle_parts_add_up_to_idle_share():
    sl = _slice()
    parts = sum(_read(f"idle.{k}", sl) for k in ("sync", "dispatch", "outside"))
    share = _read("idle_share", sl)
    assert parts == pytest.approx(share / 100 * sl.wall_s * 1e3 / sl.steps, rel=1e-12)


def test_no_spans_no_reading():
    sl = _slice()
    sl.host_ops = [h for h in sl.host_ops if not h[0].startswith("spi.")]
    assert [_read(name, sl) for name in SPAN_METRICS] == [None] * 5
    sl = _slice()
    sl.host_ops = [h for h in sl.host_ops if h[0] != "spi.step"]
    assert [_read(name, sl) for name in SPAN_METRICS] == [None] * 5


@pytest.mark.parametrize("cell", ["inv_rotbbox_b4", "edit_clip_b2"])
def test_traced_line_reads_the_spans(monkeypatch, cell):
    """At the test sizes on the CPU (the host's operators stand for the
    device's): the five metrics are in the traced line and the idle parts
    add up to `idle_share` over the slice's steps."""
    from benchmark.tests.test_bench_cells import CELLS, tiny_run

    out = tiny_run(monkeypatch, cell, 1, trace_steps=2, **CELLS[cell])
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(SPAN_METRICS) <= set(m)
    idle_ms = m["idle_share"] / 100 * out["device"]["window_s"] * 1e3 / 2
    assert m["idle.sync"] + m["idle.dispatch"] + m["idle.outside"] == pytest.approx(idle_ms)
    # Two steps of RotBbox (a regularizer step first): 9 + 2 syncs; editing
    # 17 a step (tests/test_torch_port_spans.py counts the sites).
    assert m["syncs_per_step"] == (5.5 if cell == "inv_rotbbox_b4" else 17.0)
    assert m["dispatch_ms_per_step"] > 0


# -- on the card ---------------------------------------------------------
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")


def _card_trace(fn, path):
    """The exported trace of `fn()` under torch.profiler (CPU and CUDA)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def _check_card_trace(events, n_steps):
    """Returns the `spi.sync` spans a step, the blocking calls a step that
    PyTorch's backward functions make ({function: count}), which the
    program cannot mark, and the most a kernel's start precedes its launch
    call's (us; negative where every kernel starts after its launch, as it
    must: a positive value is the error of the profiler's alignment of the
    card's timestamps to the host's). Fails where another blocking runtime
    call inside a step lies outside every `spi.sync` span, or a kernel
    launched in a step starts before the step begins."""
    def iv(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    def within(t, spans_):
        return any(s[0] <= t[0] and t[1] <= s[1] for s in spans_)

    spans = [(e["name"], *iv(e)) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("spi.")]
    steps = sorted(s[1:] for s in spans if s[0] == "spi.step")
    syncs = [s[1:] for s in spans if s[0] == "spi.sync"]
    assert len(steps) == n_steps
    backward_fns = [(e["tid"], *iv(e), e["name"].split(": ")[-1]) for e in events
                    if e.get("cat") == "cpu_op"
                    and e["name"].startswith("autograd::engine::evaluate_function: ")]
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    stray, in_backward = [], [{} for _ in steps]
    for e in runtime:
        t = iv(e)
        if e["name"] not in BLOCKING or not within(t, steps) or within(t, syncs):
            continue
        fn = [b[3] for b in backward_fns if b[0] == e["tid"] and b[1] <= t[0] and t[1] <= b[2]]
        if not fn:
            inner = [s[0] for s in spans if s[1] <= t[0] and t[1] <= s[2]]
            stray.append((e["name"], inner[-1], t[1] - t[0]))
            continue
        k = next(i for i, s in enumerate(steps) if within(t, [s]))
        in_backward[k][fn[-1]] = in_backward[k].get(fn[-1], 0) + 1
    assert stray == [], stray
    kernels = {e["args"]["correlation"]: iv(e) for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    lead, early = -float("inf"), []
    for step in steps:
        launched = [(iv(e)[0], kernels[e["args"]["correlation"]]) for e in runtime
                    if "correlation" in e.get("args", {})
                    and e["args"]["correlation"] in kernels and within(iv(e), [step])]
        assert launched, step
        lead = max(lead, max(t - k[0] for t, k in launched))
        early += [(round(step[0] - k[0], 3), round(t - step[0], 3)) for t, k in launched
                  if k[0] < step[0]]
    print(f"kernels launched in a step that start before it (us before it, launch us into "
          f"it): {early[:8]} ({len(early)} in all)")
    assert early == []  # each step's kernels, its first one too, start after it begins
    return [sum(within(s, [step]) for s in syncs) for step in steps], in_backward, lead


@pytest.mark.chip
def test_blocking_calls_lie_in_sync_spans_on_the_card(card, tmp_path):
    """5 steps of `tune_batch` (bf16, B = 2, all four terms, `rot_bs` 4)
    and 3 editing steps, each on its cell's modules at full width."""
    from benchmark.harness import Ctx, generator, load_module
    from spi_tpu_torch.training.coaches import CoachSettings, tune_batch

    wl = harness.load_json("workloads", "inv_rotbbox_b4")
    wl = {**wl, "images": 2, "coach": {**wl["coach"], "tv_lambda": 0.01}}
    config = harness.load_json("configs", wl["config"])
    seed = 2 ** 31 + 16
    cell = load_module("entries", wl["entry"]).build(Ctx("inv_rotbbox_b4", wl, config, seed, card))
    x = cell.x0
    settings = CoachSettings(num_steps=5, **wl["coach"])

    def rotbbox():
        tune_batch(cell.generator, cell.lpips, cell._coach_inputs(x), settings, noise=x["noise"],
                   rngs=[generator(seed, f"rng/{i}", card) for i in range(2)], device=card,
                   box_cx=cell.box_cx)

    syncs, in_backward, lead = _check_card_trace(_card_trace(rotbbox, tmp_path / "rotbbox.json"),
                                                 5)
    print(f"rotbbox: a kernel's start follows its launch's by at least {-lead:.3f} us")
    # Steps 0 and 4 are regularizer steps (the mirror term on: the yaws are
    # ±0.3-0.5), the sites as tests/test_torch_port_spans.py counts them.
    # `cumprod`'s backward (the ray marcher's transmittance) reads back
    # whether its input has a zero: once a render's backward.
    assert syncs == [9, 2, 2, 2, 9], syncs
    assert in_backward == [{"CumprodBackward0": n} for n in (4, 1, 1, 1, 4)], in_backward
    cell.release()

    wl = harness.load_json("workloads", "edit_clip_b2")
    config = harness.load_json("configs", wl["config"])
    cell = load_module("entries", wl["entry"]).build(Ctx("edit_clip_b2", wl, config, seed, card))

    def editing():
        for _ in range(3):
            float(cell.trainer.step())

    syncs, in_backward, lead = _check_card_trace(_card_trace(editing, tmp_path / "editing.json"),
                                                 3)
    print(f"editing: a kernel's start follows its launch's by at least {-lead:.3f} us")
    # Three canonical cameras of three constants each, two CLIP models'
    # two encodes of two constants each.
    assert syncs == [17, 17, 17], syncs
    assert in_backward == [{"CumprodBackward0": 1}] * 3, in_backward
    cell.release()
