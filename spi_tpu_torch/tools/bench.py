"""Benchmark: per-image SPI inversion wall-clock on one NVIDIA GPU
(counterpart of the repository's root bench.py, which times spi_tpu).

    python -m spi_tpu_torch.tools.bench [--dtype bfloat16|float32]
        [--s1_steps 50] [--s2_steps 100]
    python -m spi_tpu_torch.tools.bench --device cpu --tiny ...   (tests only)

Measures the two loops of the pipeline at ffhq512_128_config width with
random weights from seed 0 (wall-clock does not depend on them), LPIPS in
the generator's compute dtype (`--dtype`, bfloat16 by default, as
bench.py) and a random 512^2 target, TF32 off (`utils.device`), with the
workload of `tools/step_time.py` (`build_model`):
  stage 1: the 'sg' step of the port's projector (`training/projectors.
           project`, through `step_time.projection`): the synthesis
           forward and backward over (w, noise maps), the VGG16 feature
           distance at 256^2 plus the noise regularizer x 1e5, Adam and
           the noise renormalisation, as bench.py:77-94. It differs from
           bench.py's step as the projector does: the target's features
           are computed once, not in every step, and w gets the
           projector's noise and learning-rate schedule.
  stage 2: RotBbox steps over the rot_bs = 4 cadence of bench.py:99-160,
           run by the port's `tune_generator`: the reconstruction L2 +
           LPIPS every step; rot 0.1 (4 sampled cameras and the depth
           warp) and the depth anchor 1 (4 cameras) every 4th step, step 0
           included; mirror-rot 0 (BoxCX needs landmarks); a face mask of
           ones; the generator's own noise buffers.
Each stage runs N_STEPS + 1 steps twice, a warm-up run and a timed one,
from the same start. A device sync ends every step; the timed run's
seconds from the end of its first step to the end of its last, over
N_STEPS, are its seconds per step, as bench.py's `time_scan_steps`
divides a scan's time by its steps. So the loop's set-up (stage 1's w
statistics, stage 2's frozen planes) and the first step stay out of it,
and stage 2's timed steps 1-8 hold two regularizer steps, as 0-7 do.

The reported value extrapolates to the reference workload, 500 stage-1 +
1000 stage-2 steps. A real-pipeline sample follows, as bench.py's
`bench_real_pipeline`: `InversionPipeline.invert_image` at `--s1_steps`
'mir' + `--s2_steps` RotBbox steps (mirror-rot 0, the LPIPS early stop
off, the pipeline's float32 metric LPIPS), one image to warm up, a second
one measured; its fixed costs (the w statistics, the embedding, the metric
renders and the artifacts) are taken out and its steps extended to 500 +
1000 at the stages' rates. A failure of the sample fails the run.

Prints `# ` lines, then ONE JSON line: {"metric", "value" (s), "unit",
"detail": {stage1_s_per_step, stage2_s_per_step, pipeline_scaled_s, dtype,
device}}, `device` being the card's name and power limit as nvidia-smi
gives them.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

METRIC = "per-image inversion wall-clock (500 sg + 1000 RotBbox steps)"
N_STEPS = 8
S1_SEED = 7
S2_SEED = 9


def card_label(dev: torch.device) -> str:
    """The card's name and power limit (nvidia-smi's csv), or 'cpu'."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={dev.index or 0}"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def stage1(model, n: int, dev):
    """`fn(on_step)` running `n` 'sg' projector steps (bench.py's stage 1)."""
    from spi_tpu_torch.tools.step_time import projection

    return projection(model, "sg", n, dev, seed=S1_SEED)


def stage2(model, n: int, dev):
    """`fn(on_step)` running `n` RotBbox steps of bench.py's stage 2 from
    w = 0, tuning the generator in place; raises if the loop stops early."""
    from spi_tpu_torch.training.coaches import CoachInputs, CoachSettings, tune_generator

    g, lpips, target, camera = model
    res = g.cfg.img_resolution
    settings = CoachSettings(num_steps=n, lpips_threshold=-1.0, mirror_rot_lambda=0.0)
    inputs = CoachInputs(target, camera, torch.zeros(1, g.num_ws, g.w_dim, device=dev),
                         face_mask=torch.ones(1, 1, res, res, device=dev))

    def run(on_step):
        _, (steps, _) = tune_generator(g, lpips, inputs, settings, on_step=on_step,
                                       rng=torch.Generator(device=dev).manual_seed(S2_SEED),
                                       device=dev)
        if steps != n:
            raise RuntimeError(f"stage 2 ran {steps} of {n} steps")

    return run


def time_steps(workload, model, dev) -> float:
    """Seconds per step of `workload(model, N_STEPS + 1, dev)`: a warm-up
    run, then a timed one, each from the generator's initial weights;
    the timed run's time from the end of its first step to the end of its
    last, over N_STEPS."""
    g = model[0]
    state0 = {k: v.detach().clone() for k, v in g.state_dict().items()}
    stamps = []

    def on_step(step, value):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stamps.append(time.perf_counter())

    for _ in range(2):
        stamps.clear()
        workload(model, N_STEPS + 1, dev)(on_step)
        g.load_state_dict(state0)
    return (stamps[-1] - stamps[0]) / N_STEPS


def real_pipeline(generator, dev, s1_steps: int, s2_steps: int, t1: float, t2: float) -> float:
    """bench.py's `bench_real_pipeline`: one InversionPipeline.invert_image
    at s1_steps 'mir' + s2_steps RotBbox on a second synthetic image after a
    first one; its fixed costs are stageN_s - stepsN * tN and the tail
    after stage 2, and the steps are extended to 500 + 1000 at t1 / t2."""
    from spi_tpu_torch.data.dataset import InversionSample
    from spi_tpu_torch.training.pipeline import InversionPipeline, PipelineConfig
    from spi_tpu_torch.utils.camera import canonical_camera

    out_root = tempfile.mkdtemp(prefix="spi_bench_")
    try:
        config = PipelineConfig(
            output_root=out_root, first_inv_type="mir", first_inv_steps=s1_steps,
            G_1_type="RotBbox", G_1_step=s2_steps, pt_rot_lambda=0.1,
            pt_mirror_rot_lambda=0.0,  # BoxCX needs landmarks
            pt_depth_lambda=1.0,
            # random LPIPS heads make the 0.05 early stop fire at random
            lpips_threshold=-1.0)
        pipeline = InversionPipeline(generator, config, device=dev)
        rng = np.random.default_rng(0)
        res = generator.cfg.img_resolution

        def sample(i):
            img = np.tanh(rng.normal(0, 0.5, (1, 3, res, res))).astype(np.float32)
            return InversionSample(name=f"bench{i}", image=img,
                                   camera=canonical_camera().numpy())

        pipeline.invert_image(sample(0))
        t0 = time.perf_counter()
        r = pipeline.invert_image(sample(1))
        total = time.perf_counter() - t0
        tail = total - r["stage1_s"] - r["stage2_s"]
        fixed1 = max(r["stage1_s"] - s1_steps * t1, 0.0)
        fixed2 = max(r["stage2_s"] - max(r["steps_run"], 1) * t2, 0.0)
        print(f"# real pipeline: stage1={r['stage1_s']:.2f}s/{s1_steps} (fixed {fixed1:.2f}s) "
              f"stage2={r['stage2_s']:.2f}s/{r['steps_run']} (fixed {fixed2:.2f}s) "
              f"tail={tail:.2f}s", flush=True)
        return 500 * t1 + fixed1 + 1000 * t2 + fixed2 + tail
    finally:
        shutil.rmtree(out_root, ignore_errors=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="the generator's and LPIPS's compute dtype")
    ap.add_argument("--s1_steps", type=int, default=50, help="the pipeline sample's 'mir' steps")
    ap.add_argument("--s2_steps", type=int, default=100,
                    help="the pipeline sample's RotBbox steps")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--tiny", action="store_true", default=False,
                    help="tiny_test_config in place of ffhq512_128 (tests)")
    args = ap.parse_args(argv)

    from spi_tpu_torch.tools.step_time import build_model
    from spi_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    model = build_model(dev, args.dtype, lpips_dtype=args.dtype, tiny=args.tiny)
    t1 = time_steps(stage1, model, dev)
    t2 = time_steps(stage2, model, dev)
    print(f"# stage 1 {t1:.5f} s/step, stage 2 {t2:.5f} s/step ({args.dtype}, "
          f"{N_STEPS} steps each)", flush=True)
    pipeline_s = real_pipeline(model[0], dev, args.s1_steps, args.s2_steps, t1, t2)
    result = {
        "metric": METRIC,
        "value": 500 * t1 + 1000 * t2,
        "unit": "s",
        "detail": {"stage1_s_per_step": t1, "stage2_s_per_step": t2,
                   "pipeline_scaled_s": pipeline_s, "dtype": args.dtype,
                   "device": card_label(dev)},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
