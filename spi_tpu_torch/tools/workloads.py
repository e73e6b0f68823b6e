"""The port's inversion workloads at ffhq512_128_config width, for the card
checks of `chip_smoke.py` and the tools.

`build_model` builds the generator at its published widths (the tiny
test config with `tiny`) with random seeded weights and a compute dtype
(float32 by default; the CLI's default is bfloat16), LPIPS-VGG16 and a
random target at the generator's resolution. Each workload returns
`fn(on_step)`, which runs N steps and calls `on_step(step, value)` after
each: one stage-1 projector mode (`projection`; 'mir' from a camera
yawed by MIR_YAW), stage 2 from a pivot (`tuning`, recon-only;
`rotbbox`, SPI's RotBbox request: rot 0.1, mirror-rot 0.05, depth 1,
from the yawed camera with `synthetic_face`'s mask and landmarks), and
the same for several images a step (`projection_batch`,
`rotbbox_batch`). `write_photo` writes a synthetic raw photo for the
preprocess. Steps of the port are timed by `benchmark/run.py` alone.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# The workloads' seeds: weights, target, and each run's random draws.
WEIGHT_SEED = 0
TARGET_SEED = 7
RUN_SEEDS = {"sg": 8, "sgw+": 8, "mir": 12, "tune": 13, "rotbbox": 15}
MIR_YAW = 0.4
PIVOT_STEPS = 8


def build_model(dev, dtype="float32", tiny=False):
    """ffhq512_128_config at its published widths (tiny_test_config with
    `tiny`, for tests) and compute dtype `dtype`, random seeded weights;
    LPIPS-VGG16 in float32; a random target at the generator's resolution;
    the canonical camera."""
    from spi_tpu_torch.criteria.lpips import LPIPS
    from spi_tpu_torch.models import TriPlaneGenerator, ffhq512_128_config, tiny_test_config
    from spi_tpu_torch.utils import camera as cam

    config = tiny_test_config if tiny else ffhq512_128_config
    g = TriPlaneGenerator(config(compute_dtype=dtype), device=dev, seed=WEIGHT_SEED)
    lpips = LPIPS(device=dev)
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
