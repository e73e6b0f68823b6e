"""Wall-clock seconds per inversion step at ffhq512_128_config width on the card.

    python -m spi_tpu_torch.tools.step_time [--mode sg|sgw+|mir|tune|rotbbox] [--steps N]
        [--dtype float32|bfloat16] [--profile]
    PYTHONPATH=<checkout> python spi_tpu_torch/tools/step_time.py --mode sg

Builds the generator at its published widths with random seeded weights
and the compute dtype `--dtype` (float32 by default; the CLI's default
is bfloat16), LPIPS-VGG16 (float32, as the CLI's) and a random 512^2
target, runs N steps of one stage-1 projector mode ('mir' from a camera
yawed by MIR_YAW) or of stage 2 from the pivot of PIVOT_STEPS 'sg' steps
(TF32 off): 'tune' is recon-only, 'rotbbox' SPI's RotBbox request (rot
0.1, mirror-rot 0.05, depth 1) from the yawed camera with a synthetic
face mask and landmarks. It prints one line: the median s/step after
the second step (for 'rotbbox' also that of its regularizer steps, 4, 8,
...), every step's time, and the peak device memory. With --profile, a
second line: one more step (a regularizer step for 'rotbbox') under
torch.profiler, its device ms in all and in the triplane lookup's kernels
(the lookup kernel, PyTorch's `vectorized_gather_kernel`, the splat).
`chip_smoke.py` times the same workload through `build_model`,
`projection`, `tuning`, `rotbbox` and `time_steps` (several images a
step through `projection_batch` and `rotbbox_batch`), and
`tools/bench.py` builds its model and stage 1 from it.
Run as a file (the second form), it imports `spi_tpu_torch` from
PYTHONPATH, so it times another checkout's package on the same card
('sg' only where that tree has no other mode).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import statistics
import time

import torch

# The timed workload's seeds: weights, target, and each run's random draws.
WEIGHT_SEED = 0
TARGET_SEED = 7
RUN_SEEDS = {"sg": 8, "sgw+": 8, "mir": 12, "tune": 13, "rotbbox": 15}
MIR_YAW = 0.4
PIVOT_STEPS = 8


def build_model(dev, dtype="float32", lpips_dtype="float32", tiny=False):
    """ffhq512_128_config at its published widths (tiny_test_config with
    `tiny`, for tests) and compute dtype `dtype`, random seeded weights;
    LPIPS-VGG16 in `lpips_dtype`; a random target at the generator's
    resolution; the canonical camera."""
    from spi_tpu_torch.criteria.lpips import LPIPS
    from spi_tpu_torch.models import TriPlaneGenerator, ffhq512_128_config, tiny_test_config
    from spi_tpu_torch.utils import camera as cam

    config = tiny_test_config if tiny else ffhq512_128_config
    g = TriPlaneGenerator(config(compute_dtype=dtype), device=dev, seed=WEIGHT_SEED)
    lpips = LPIPS(device=dev, compute_dtype=lpips_dtype)
    res = g.cfg.img_resolution
    target = torch.tanh(torch.randn(1, 3, res, res, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(TARGET_SEED)))
    return g, lpips, target, cam.canonical_camera(device=dev)


def projection(model, mode, steps, dev, seed=None):
    """`fn(on_step)` running `steps` steps of projector `mode` on `model`,
    from its camera ('mir': from the camera yawed by MIR_YAW); returns
    project's (w, noise, dists)."""
    from spi_tpu_torch.training.projectors import ProjectorSettings, project

    g, lpips, target, camera = model
    if mode == "mir":
        from spi_tpu_torch.utils import camera as cam

        camera = cam.canonical_camera(yaw=MIR_YAW, device=dev)
    settings = ProjectorSettings(mode=mode, num_steps=steps, w_avg_samples=600)
    seed = RUN_SEEDS[mode] if seed is None else seed
    return lambda on_step: project(g, lpips, target, camera, settings,
                                   rng=torch.Generator(device=dev).manual_seed(seed),
                                   device=dev, on_step=on_step)


def tuning(model, pivot, steps, dev):
    """`fn(on_step)` running `steps` stage-2 recon-only steps from `pivot`
    = (w, noise), with the LPIPS threshold below any value so that random
    weights do not stop it early; returns tune_generator's result."""
    from spi_tpu_torch.training.coaches import CoachInputs, pti_settings, tune_generator

    g, lpips, target, camera = model
    w, noise = pivot
    settings = dataclasses.replace(pti_settings(steps), lpips_threshold=-1.0)
    return lambda on_step: tune_generator(
        g, lpips, CoachInputs(target, camera, w), settings, noise=noise,
        rng=torch.Generator(device=dev).manual_seed(RUN_SEEDS["tune"]), device=dev,
        on_step=on_step)


def synthetic_face(dev, res=512):
    """A face mask (1, 1, res, res) and 68 landmarks (1, 68, 2) at 256 scale
    on one ellipse about the middle of the crop, the layout
    tools/make_smoke_data.py writes: the mouth and eye boxes lie in the
    image."""
    yy, xx = torch.meshgrid(*(torch.arange(res, device=dev) / (res - 1),) * 2, indexing="ij")
    mask = (((xx - 0.5) ** 2) / 0.08 + ((yy - 0.45) ** 2) / 0.12 < 1.0).float()[None, None]
    t = torch.linspace(0, 2 * math.pi, 69, device=dev)[:68]
    lm = torch.stack([128 + 60 * torch.cos(t), 256 * 0.45 * 1.15 + 75 * torch.sin(t)], -1)
    return mask, lm[None]


def write_photo(path, seed=0, size=640):
    """A synthetic size^2 stand-in for a raw portrait photo, from a seed: a
    skin-toned blob on a background, with noise (the preprocess's input in
    `chip_smoke.py` and the tests)."""
    import numpy as np
    from PIL import Image

    yy, xx = np.mgrid[0:size, 0:size] / (size - 1.0)
    blob = np.exp(-(((xx - 0.5) ** 2) + (yy - 0.45) ** 2) / 0.05)
    img = np.stack([0.6 + 0.3 * blob, 0.45 + 0.25 * blob, 0.4 + 0.2 * blob], -1)
    img = img + np.random.default_rng(seed).normal(0, 0.05, img.shape)
    Image.fromarray((img.clip(0, 1) * 255).astype(np.uint8)).save(path)


def rotbbox(model, pivot, steps, dev):
    """`fn(on_step)` running `steps` steps of SPI's RotBbox stage 2 (rot
    0.1, mirror-rot 0.05, depth 1, TV 0: run_inversion.py's request) from
    `pivot` = (w, noise), seen from the camera yawed by MIR_YAW so that
    the mirror term counts, with `synthetic_face`'s mask and landmarks and
    the LPIPS threshold below any value; returns tune_generator's result."""
    from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
    from spi_tpu_torch.training.coaches import CoachInputs, CoachSettings, tune_generator
    from spi_tpu_torch.utils import camera as cam

    g, lpips, target, _ = model
    w, noise = pivot
    camera = cam.canonical_camera(yaw=MIR_YAW, device=dev)
    mask, lm = synthetic_face(dev, g.cfg.img_resolution)
    settings = CoachSettings(num_steps=steps, lpips_threshold=-1.0, rot_lambda=0.1,
                             mirror_rot_lambda=0.05, depth_lambda=1.0, tv_lambda=0.0)
    box_cx = BoxCXLoss(device=dev)
    return lambda on_step: tune_generator(
        g, lpips, CoachInputs(target, camera, w, mask, lm), settings, noise=noise,
        rng=torch.Generator(device=dev).manual_seed(RUN_SEEDS["rotbbox"]), device=dev,
        on_step=on_step, box_cx=box_cx)


def batch_inputs(model, b, dev, yaw=0.0):
    """`b` images for the batched workloads: the model's target and b - 1
    more random targets (seeded), each seen from the canonical camera
    turned by `yaw`. Returns targets (b, 1, 3, R, R), cameras (b, 1, 25)."""
    from spi_tpu_torch.utils import camera as cam

    g, _, target, _ = model
    res = g.cfg.img_resolution
    more = [torch.tanh(torch.randn(1, 3, res, res, device=dev, generator=torch.Generator(
        device=dev).manual_seed(TARGET_SEED + i))) for i in range(1, b)]
    camera = cam.canonical_camera(yaw=yaw, device=dev)
    return torch.stack([target, *more]), camera[None].expand(b, 1, 25).contiguous()


def projection_batch(model, mode, steps, dev, b):
    """`fn(on_step)` running `steps` steps of projector `mode` for `b` images
    at once (`project_batch`, one batched step a step; 'mir' from the camera
    yawed by MIR_YAW), image i drawing from a generator seeded RUN_SEEDS[mode]
    + i; returns project_batch's (w, noise, dists)."""
    from spi_tpu_torch.training.projectors import ProjectorSettings, project_batch

    g, lpips, _, _ = model
    targets, cameras = batch_inputs(model, b, dev, MIR_YAW if mode == "mir" else 0.0)
    settings = ProjectorSettings(mode=mode, num_steps=steps, w_avg_samples=600)
    return lambda on_step: project_batch(
        g, lpips, targets, cameras, settings,
        rngs=[torch.Generator(device=dev).manual_seed(RUN_SEEDS[mode] + i) for i in range(b)],
        device=dev, on_step=on_step)


def rotbbox_batch(model, pivot, steps, dev, b):
    """`rotbbox` for `b` images at once (`tune_batch`): each image starts
    from `pivot` = (w, noise) with its own target (`batch_inputs`), the
    yawed camera, `synthetic_face`'s mask and landmarks, and a generator
    seeded RUN_SEEDS['rotbbox'] + i; returns tune_batch's result."""
    from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
    from spi_tpu_torch.training.coaches import CoachInputs, CoachSettings, tune_batch

    g, lpips, _, _ = model
    w, noise = pivot
    targets, cameras = batch_inputs(model, b, dev, MIR_YAW)
    mask, lm = synthetic_face(dev, g.cfg.img_resolution)
    inputs = CoachInputs(targets, cameras, w[None].expand(b, *w.shape).contiguous(),
                         mask[None].expand(b, *mask.shape), lm[None].expand(b, *lm.shape))
    noise_b = {k: v[None].expand(b, *v.shape).contiguous() for k, v in noise.items()}
    settings = CoachSettings(num_steps=steps, lpips_threshold=-1.0, rot_lambda=0.1,
                             mirror_rot_lambda=0.05, depth_lambda=1.0, tv_lambda=0.0)
    box_cx = BoxCXLoss(device=dev)
    return lambda on_step: tune_batch(
        g, lpips, inputs, settings, noise=noise_b,
        rngs=[torch.Generator(device=dev).manual_seed(RUN_SEEDS["rotbbox"] + i)
              for i in range(b)], device=dev, on_step=on_step, box_cx=box_cx)


def time_steps(fn, after_stamp=None):
    """Run `fn(on_step)` with the peak memory reset just before it; each
    step is stamped after a device sync, then `after_stamp()` is called.
    Returns (fn's result, first step s, [s of each later step], peak bytes)."""
    stamps = []

    def on_step(step, value):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if after_stamp is not None:
            after_stamp()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    result = fn(on_step)
    torch.cuda.synchronize()
    step_s = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    return result, stamps[0] - t_start, step_s, torch.cuda.max_memory_allocated()


def steady_s(step_s):
    """The median s/step after the second step."""
    return statistics.median_high(step_s[1:])


def device_kernels(prof):
    """{kernel name: (device ms, launches)} of a torch.profiler run: the
    events on the card with device time, less user annotations and the
    profiler's own step markers. Raises where there is none."""
    per_kernel = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if (t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and "#" not in evt.key and not evt.key.startswith("ProfilerStep")):
            per_kernel[evt.key] = (t / 1e3, evt.count)
    if not per_kernel:
        raise RuntimeError("the profiler saw no device time")
    return per_kernel


def profile_step(fn, wait):
    """`device_kernels` of step number `wait` + 1 of the workload
    `fn(on_step)` under torch.profiler (after `wait` steps and a warm-up
    step)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=wait, warmup=1, active=1)) as prof:
        fn(lambda step, value: prof.step())
    return device_kernels(prof)


# Kernel name fragments of the triplane lookup's forward and backward.
LOOKUP_KERNELS = (("plane_sample", "lookup kernel"), ("vectorized_gather_kernel", "gather"),
                  ("plane_splat", "splat"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="sg", choices=("sg", "sgw+", "mir", "tune", "rotbbox"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the generator's compute dtype")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more step (a regularizer step for rotbbox)")
    args = ap.parse_args(argv)

    import spi_tpu_torch
    from spi_tpu_torch.utils.device import resolve_device

    dev = resolve_device(torch.device("cuda", 0))
    model = build_model(dev, args.dtype)
    if args.mode in ("tune", "rotbbox"):
        w, noise, _ = time_steps(projection(model, "sg", PIVOT_STEPS, dev))[0]
        stage2 = tuning if args.mode == "tune" else rotbbox
        fn = stage2(model, (w, noise), args.steps, dev)
        profiled, wait = stage2(model, (w, noise), 5, dev), 3  # step 4 has the regularizers
    else:
        fn = projection(model, args.mode, args.steps, dev)
        profiled, wait = projection(model, args.mode, 3, dev, seed=9), 1
    _, _, step_s, peak = time_steps(fn)
    extra = ""
    if args.mode == "rotbbox":
        median = statistics.median_high([step_s[k - 1] for k in range(4, args.steps, 4)])
        extra = f", regularizer steps {median:.5f}"
    print(f"{args.mode} {args.dtype} ({spi_tpu_torch.__file__}, "
          f"{torch.cuda.get_device_name(dev)}): median "
          f"{steady_s(step_s):.5f} s/step after the second{extra}; steps "
          f"{[round(t, 5) for t in step_s]}; peak {peak / 2**30:.3f} GiB", flush=True)
    if args.profile:
        per_kernel = profile_step(profiled, wait)
        total = sum(t for t, _ in per_kernel.values())
        parts = []
        for frag, what in LOOKUP_KERNELS:
            hits = [v for k, v in per_kernel.items() if frag in k]
            parts.append(f"{what} {sum(t for t, _ in hits):.3f} ms in {sum(n for _, n in hits)}")
        print(f"{args.mode} {args.dtype} profiled step: device {total:.3f} ms in "
              f"{sum(n for _, n in per_kernel.values())} launches; " + ", ".join(parts),
              flush=True)


if __name__ == "__main__":
    main()
