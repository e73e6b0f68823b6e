"""Run one benchmark cell once on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `benchmark/workloads/<cell>.json`: its configuration
(`benchmark/configs/<config>.json`), its entry (`benchmark/entries/
<entry>.py`, the loop the window drives) and every traffic parameter. Set-up
makes weights and inputs on the card from the seed and runs the loop's
warm-up steps; the window then measures `--seconds`. With `--trace 1` the
loop goes on through one profiled slice, and every reader under
`benchmark/metrics/` reports from it. Then the program's state is freed,
the plain reference follows the loop's first steps on the same inputs,
and the numbers that decide `correct` are printed beside their limits,
last on standard error and last in the result line. The last line of
standard output is the result, one JSON object.

It exits with another code than 0, and prints no result, without a CUDA
card (or with fewer than the cell asks for), and when jax, jaxlib, flax or
spi_tpu is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FORBIDDEN = ("jax", "jaxlib", "flax", "spi_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device, tiny=False, t_start=None, log=None):
    """Everything after the look for a card: returns the result line's
    object. `tiny` runs the configuration's test sizes (CPU tests)."""
    import torch

    from benchmark.harness import Ctx, check, load_json, load_module
    from benchmark.harness import metrics as metric_files
    from benchmark.harness import trace as tracing
    from benchmark.harness.window import Stop, Window
    from benchmark.reference import quant

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    wl = load_json("workloads", args.workload)
    config = load_json("configs", wl["config"])
    ctx = Ctx(args.workload, wl, config, args.seed, device, tiny)
    quant.full_float32()
    cell = load_module("entries", wl["entry"]).build(ctx)
    profiler = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        profiler = profile(activities=acts)
    window = Window(T_START if t_start is None else t_start, cell.warmup, args.seconds,
                    cell.images_per_step, device, profiler, cell.slice_steps, cell.slice_starts)
    try:
        cell.run(window.on_step)
    except Stop:
        pass
    e2e = window.end_to_end()
    log(f"window: {window.steps} steps in {window.window_s:.3f} s, set-up {window.setup_s:.3f} s")
    first, second = window.halves()
    log(f"window halves: {first} steps in the first, {second} in the second")

    per_layer, breakdown, traced = {}, None, None
    if args.trace:
        traced = tracing.read(profiler, window.t_slice, window.slice_its,
                              tracing.DEVICE_CATS if device.type == "cuda" else ("cpu_op",))
        per_layer = metric_files.read_all(cell, traced, e2e, config)
        breakdown = {"device_ops": traced.top_ops(), "idle_gaps": traced.idle_gaps()}
    prog = cell.program_readings()
    steps, window_s = window.steps, window.window_s
    cell.release()
    del window, profiler
    ref = cell.reference()
    nums = check.numbers(prog, ref)
    correct, lines = check.judge(nums, wl["limits"])
    for line in lines:
        log(line)

    units = {"img_steps_per_s": "img-steps/s", "step_p90_ms": "ms", "peak_gib": "GiB",
             "setup_s": "s"}
    if args.trace:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in per_layer.items()}
    else:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(e2e["peak_gib"] * 2 ** 30)}
    if traced is not None:
        dev_info.update(busy_s=traced.busy_s(), window_s=traced.wall_s)
    out = {"correct": bool(correct), "attempted": steps, "failed": 0, "metrics": metrics,
           "device": dev_info, "window": {"steps": steps, "seconds": window_s}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {name: {"value": nums[name][0] if math.isfinite(nums[name][0]) else "inf",
                              "limit": lim} for name, lim in wl["limits"].items()}
    return out


def main(argv=None):
    args = parse(argv)
    import torch

    need = json.loads((Path(__file__).parent / "workloads" / f"{args.workload}.json")
                      .read_text()).get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this cell needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    out = run_cell(args, torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
