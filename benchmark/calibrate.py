"""The readings the limits of `correct` are set from, on the card, at the
cell's own sizes: for each seed the program's checked steps against the
plain reference (the lower reading); for the first `--control` seeds the
control, the reference computed with the configuration's lower operand
precision, against the reference (the upper reading); and with `--fault`,
the program with a fault planted under the timed path; with `--dtype`,
the program in another compute dtype than the configuration's (to see
whether a gap is the dtype's rounding).

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control 3] [--fault half_batch] [--dtype float32] [--out calibrate.jsonl]

One JSON line a reading: {seed, kind, dtype, grad, grad_mid, change,
change_median, loss, loss_first}, each number a [gap, where] pair; the
loss gaps (each step's, and the first step's alone, by the worst lane)
are read here only and compared by no cell. Not run by the benchmark's
own runs."""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@contextlib.contextmanager
def half_batch():
    """The editing loss taken over the first half of the batch alone."""
    from spi_tpu_torch.editing.zssgan import TwinGeneratorTrainer

    original = TwinGeneratorTrainer.clip_loss

    def clip_loss(self, frozen_img, trainable_img, patch_centers=None):
        h = frozen_img.shape[0] // 2
        return original(self, frozen_img[:h], trainable_img[:h], patch_centers)

    TwinGeneratorTrainer.clip_loss = clip_loss
    try:
        yield
    finally:
        TwinGeneratorTrainer.clip_loss = original


@contextlib.contextmanager
def half_lanes():
    """Half of a batched stage 2's images left out of every update: their
    weights come back after each optimizer step."""
    import torch

    original = torch.optim.Adam.step

    def step(self, closure=None):
        params = self.param_groups[0]["params"]
        kept = [p.detach()[p.shape[0] // 2:].clone() for p in params]
        out = original(self, closure)
        with torch.no_grad():
            for p, k in zip(params, kept):
                p[p.shape[0] // 2:] = k
        return out

    torch.optim.Adam.step = step
    try:
        yield
    finally:
        torch.optim.Adam.step = original


FAULTS = {"half_batch": half_batch, "half_lanes": half_lanes}


def losses(prog: dict, ref: dict) -> dict:
    """{loss, loss_first: (gap, where)}: the largest relative gap of a
    step's loss, and of the first step's."""
    from benchmark.harness.check import _gap, _keep

    out = {"loss": (math.inf, "steps missing"), "loss_first": (math.inf, "steps missing")}
    if len(prog["loss"]) == len(ref["loss"]) and ref["loss"]:
        out = {}
        for step, (p_lanes, r_lanes) in enumerate(zip(prog["loss"], ref["loss"])):
            for lane, (p, r) in enumerate(zip(p_lanes, r_lanes)):
                _keep(out, "loss", _gap(p, r, abs(r)), f"step {step} lane {lane}")
                if step == 0:
                    _keep(out, "loss_first", _gap(p, r, abs(r)), f"lane {lane}")
    return out


def readings(prog: dict, ref: dict) -> dict:
    from benchmark.harness import check

    return {**check.numbers(prog, ref), **losses(prog, ref)}


def program_readings(ctx, fault=None):
    """The program's readings of the checked steps (set-up and the warm-up
    only), with the cell released after."""
    from benchmark.harness import load_module
    from benchmark.harness.window import Stop, Window

    cell = load_module("entries", ctx.workload["entry"]).build(ctx)
    window = Window(time.perf_counter(), cell.warmup, 0.0, cell.images_per_step, ctx.device)
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        try:
            cell.run(window.on_step)
        except Stop:
            pass
    prog = cell.program_readings()
    cell.release()
    return cell, prog


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds to read the control on")
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--dtype", default=None, help="the program's compute dtype")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import Ctx, load_json
    from benchmark.reference import quant

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    dev = torch.device("cuda", 0)
    quant.full_float32()
    wl = load_json("workloads", args.workload)
    config = load_json("configs", wl["config"])
    if args.dtype:
        config["compute_dtype"] = args.dtype
    lower = getattr(torch, config["control_dtype"])
    out = open(args.out, "a") if args.out else sys.stdout
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx = Ctx(args.workload, wl, config, seed, dev)
        t = time.perf_counter()
        cell, prog = program_readings(ctx)
        ref = cell.reference()
        rows = [("program", readings(prog, ref))]
        if i < args.control:
            rows.append(("control", readings(cell.reference(lower), ref)))
        if args.fault and i < args.control:
            _, faulty = program_readings(ctx, args.fault)
            rows.append((f"fault:{args.fault}", readings(faulty, ref)))
        for kind, nums in rows:
            print(json.dumps({"seed": seed, "kind": kind, "dtype": config["compute_dtype"], **nums,
                              "seconds": time.perf_counter() - t}), file=out, flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
