"""Stage-1 latent projection (counterpart of spi_tpu/training/projectors.py).

- 'sg'  : spi/training/projectors/w_projector.py: one w repeated to every
          layer, VGG16 feature distance at 256^2.
- 'sgw+': spi/training/projectors/w_plus_projector.py: the full
          (num_ws, w_dim) w+, LPIPS loss.
- 'mir' : spi/training/projectors/mirror_projector.py: one backbone pass
          rendered at [c, mirror(c)], LPIPS + yaw-weighted mirror LPIPS
          against the flipped target.

Every mode runs Adam over {w, noise maps} with a cosine-ramped learning
rate, annealed Gaussian noise on w, the noise autocorrelation
regularizer x1e5, and per-step noise renormalization. One plain Python
loop over the steps; each step is one forward and backward of the
generator's synthesis ('mir': one `planes_nhwc` and one two-camera
`synthesis_from_planes`, so each render pass's splat serves both
cameras in one launch).

Randomness (noise init, w noise, render jitter) comes from `rng`, a
`torch.Generator` on the run's device, or from `draws`, so that a test
can give this projector and spi_tpu's the same numbers.

`project_batch` runs B images at once: the same per-image step
(`_image_loss`) under torch.func.vmap, each image drawing from its own
generator in `project`'s order.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.criteria.noise_reg import noise_regularization, normalize_noise
from spi_tpu_torch.models.rendering.renderer import draw_randoms
from spi_tpu_torch.models.triplane import TriPlaneGenerator
from spi_tpu_torch.ops import resize_area
from spi_tpu_torch.utils import camera as cam
from spi_tpu_torch.utils.device import module_device, resolve_device
from spi_tpu_torch.utils.params import (
    extract_noise,
    functional_apply,
    init_noise_like,
    stack_trees,
    vmap_strict,
)
from spi_tpu_torch.utils.stats import span


@dataclasses.dataclass(frozen=True)
class ProjectorSettings:
    mode: str = "sg"  # 'sg' | 'sgw+' | 'mir'
    num_steps: int = 500
    w_avg_samples: int = 600
    initial_lr: float = 5e-3
    initial_noise_factor: float = 0.05
    lr_rampdown_length: float = 0.25
    lr_rampup_length: float = 0.05
    noise_ramp_length: float = 0.75
    regularize_noise_weight: float = 1e5


@torch.no_grad()
def compute_w_stats(generator: TriPlaneGenerator, camera, n_samples: int):
    """w_avg (1, 1, w_dim) and w_std from fixed-seed z samples
    (w_projector.py:34-40; RandomState(123) as the reference)."""
    z = np.random.RandomState(123).randn(n_samples, generator.z_dim).astype(np.float32)
    c = camera[:1].expand(n_samples, camera.shape[-1])
    w_samples = generator.mapping(torch.from_numpy(z).to(camera.device), c)[:, :1, :]
    w_avg = w_samples.mean(dim=0, keepdim=True)
    w_std = float(((w_samples - w_avg).square().sum() / n_samples).sqrt())
    return w_avg, w_std


def _lr_schedule(step: int, settings: ProjectorSettings) -> float:
    """Cosine rampdown x linear rampup (w_projector.py:66-72)."""
    t = step / settings.num_steps
    lr_ramp = min(1.0, (1.0 - t) / settings.lr_rampdown_length)
    lr_ramp = 0.5 - 0.5 * math.cos(lr_ramp * math.pi)
    lr_ramp = lr_ramp * min(1.0, t / settings.lr_rampup_length)
    return settings.initial_lr * lr_ramp


def _w_noise_scale(step: int, w_std: float, settings: ProjectorSettings) -> float:
    t = step / settings.num_steps
    return w_std * settings.initial_noise_factor * max(0.0, 1.0 - t / settings.noise_ramp_length) ** 2


def vgg_feature_distance(lpips: LPIPS, x, y_feats):
    """The StyleGAN projector's VGG16 feature distance (w_projector.py:
    48-51,80-87), which equals the summed LPIPS value:
    sum_l mean_hw sum_c lin_lc (nf_x - nf_y)^2, summed over the batch."""
    total = 0.0
    for a, b, lin in zip(lpips.features(x), y_feats, lpips.lin):
        per_pixel = torch.einsum("nchw,c->nhw", (a - b).square(), lin)
        total = total + per_pixel.mean(dim=(1, 2)).sum()
    return total


def _fixed(lpips: LPIPS, mode: str, target, camera):
    """What stays constant over the steps for one image: the target's
    features and the cameras rendered ('mir': [c, mirror(c)], the flipped
    target's features and the mirror term's yaw weight)."""
    with torch.no_grad():
        if mode == "sg":
            return {"cameras": camera, "feats": lpips.features(
                resize_area(target, (256, 256)) if target.shape[-1] > 256 else target)}
        fixed = {"cameras": camera, "feats": lpips.features(target)}
        if mode == "mir":
            fixed["cameras"] = torch.cat([camera, cam.mirror_camera(camera)], dim=0)
            fixed["weight_m"] = cam.cal_camera_weight(fixed["cameras"][1:])[0]
            fixed["feats_m"] = lpips.features(target.flip(3))
        return fixed


def _image_loss(generator: TriPlaneGenerator, lpips: LPIPS, settings: ProjectorSettings,
                noise, w, w_noise, noise_scale, fixed, render_draws):
    """One image's step: the render of w + w_noise * noise_scale with its
    noise maps, the distance to the target and the loss (distance plus the
    weighted noise regularizer). `project` calls it as it is, `project_batch`
    under torch.func.vmap with every argument batched."""
    mode = settings.mode
    ws = w + w_noise * noise_scale
    if mode == "sg":
        ws = ws.repeat(1, generator.num_ws, 1)

    def render():
        if mode == "mir":
            planes = generator.planes_nhwc(ws)
            return generator.synthesis_from_planes(planes, ws, fixed["cameras"],
                                                   draws=render_draws)["image"]
        return generator.synthesis(ws, fixed["cameras"], noise_mode="const",
                                   draws=render_draws)["image"]

    img = functional_apply(generator, noise, render)
    if mode == "sg":
        x = resize_area(img, (256, 256)) if img.shape[-1] > 256 else img
        dist = vgg_feature_distance(lpips, x, fixed["feats"])
    elif mode == "sgw+":
        dist = lpips(img, y_feats=fixed["feats"])
    else:
        dist = (lpips(img[:1], y_feats=fixed["feats"])
                + fixed["weight_m"] * lpips(img[1:], y_feats=fixed["feats_m"]))
    return dist + noise_regularization(noise) * settings.regularize_noise_weight, dist


def _step_draws(generator: TriPlaneGenerator, settings: ProjectorSettings, draws: dict,
                step: int, w_shape, dev, rng):
    """One step's w noise and renderer draws: those in `draws` (per-step
    lists), the rest drawn from `rng` in the order the step consumes them
    (w noise, then the renderer's)."""
    if "w_noise" in draws:
        w_noise = draws["w_noise"][step].to(dev)
    else:
        w_noise = torch.randn(w_shape, generator=rng, device=dev)
    if draws.get("render") is not None:
        render = {k: v.to(dev) for k, v in draws["render"][step].items()}
    else:
        res = generator.cfg.neural_rendering_resolution
        render = draw_randoms(generator.cfg.rendering, 2 if settings.mode == "mir" else 1,
                              res * res, dev, rng)
    return w_noise, render


def _start(generator: TriPlaneGenerator, settings: ProjectorSettings, camera, initial_w,
           draws: dict, rng):
    """One image's starting w (leaf), w_std and noise maps."""
    w_avg, w_std = compute_w_stats(generator, camera, settings.w_avg_samples)
    noise0 = draws.get("noise0") or init_noise_like(generator, rng)
    if set(noise0) != set(extract_noise(generator)):
        raise ValueError("noise maps do not match the generator's noise_const buffers")
    if initial_w is None:
        initial_w = w_avg if settings.mode == "sg" else w_avg.repeat(1, generator.num_ws, 1)
    noise0 = {k: v.detach().to(camera.device) for k, v in sorted(noise0.items())}
    return initial_w.detach(), w_std, noise0


def _check(generator, lpips, settings, device):
    dev = resolve_device(device)
    for name, module in (("generator", generator), ("lpips", lpips)):
        if module_device(module) != dev:
            raise ValueError(f"{name} is on {module_device(module)}, not {dev}")
    if settings.mode not in ("sg", "sgw+", "mir"):
        raise ValueError(f"unknown projector mode {settings.mode!r}")
    return dev


def _optimize(settings: ProjectorSettings, w, noise: dict, step_fn, on_step):
    """The loop both projectors share: Adam over {w, noise maps} with the
    scheduled learning rate and the noise renormalization after each step.
    step_fn(step) -> (summed loss, distances)."""
    opt = torch.optim.Adam([w, *noise.values()], lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    dists = []
    for step in range(settings.num_steps):
        with span("spi.step"):
            loss, dist = step_fn(step)
            opt.zero_grad(set_to_none=True)
            # Gradients for w and the noise maps only: none for the weights.
            with span("spi.backward"):
                loss.backward(inputs=[w, *noise.values()])
            with span("spi.optimizer"):
                for group in opt.param_groups:
                    group["lr"] = _lr_schedule(step, settings)
                opt.step()
                normalize_noise(noise)
            dists.append(dist.detach())
        if on_step is not None:
            on_step(step, dist.detach())
    return torch.stack(dists, dim=-1)


def project(generator: TriPlaneGenerator, lpips: LPIPS, target, camera,
            settings: ProjectorSettings = ProjectorSettings(), initial_w=None,
            rng: torch.Generator | None = None, draws: dict | None = None, device=None,
            on_step: Callable[[int, torch.Tensor], None] | None = None):
    """Run stage-1 projection of `target` (1, 3, R, R) in [-1, 1] seen by
    `camera` (1, 25). Returns (w (1, num_ws, w_dim), optimised noise maps
    by buffer name, per-step distances (num_steps,)). The generator's own
    buffers are left unchanged.

    device: None means `cuda` (raises without a GPU); the generator and
    LPIPS must already be on it. draws: optional {'noise0': {name:
    map}, 'w_noise': (num_steps, *w.shape) N(0, 1), 'render': [per-step
    renderer draws]}; what is not given is drawn from `rng`. on_step(step,
    dist) is called after each step.
    """
    dev = _check(generator, lpips, settings, device)
    draws = draws or {}
    target = target.to(dev)
    camera = camera.to(dev)
    w0, w_std, noise0 = _start(generator, settings, camera, initial_w, draws, rng)
    w = w0.clone().requires_grad_(True)
    noise = {k: v.clone().requires_grad_(True) for k, v in noise0.items()}
    fixed = _fixed(lpips, settings.mode, target, camera)

    def step_fn(step):
        with span("spi.draws"):
            w_noise, render = _step_draws(generator, settings, draws, step, w.shape, dev, rng)
        return _image_loss(generator, lpips, settings, noise, w, w_noise,
                           _w_noise_scale(step, w_std, settings), fixed, render)

    dists = _optimize(settings, w, noise, step_fn, on_step)
    w_out = w.detach()
    if settings.mode == "sg":  # w_projector.py:113 returns the single w repeated to all layers
        w_out = w_out.repeat(1, generator.num_ws, 1)
    return w_out, {k: v.detach() for k, v in noise.items()}, dists


def project_batch(generator: TriPlaneGenerator, lpips: LPIPS, targets, cameras,
                  settings: ProjectorSettings = ProjectorSettings(),
                  rngs: list | None = None, draws: list | None = None, device=None,
                  on_step: Callable[[int, torch.Tensor], None] | None = None):
    """Stage-1 projection of B images at once, the counterpart of spi_tpu's
    `jax.vmap` of the projector scan (spi_tpu/parallel/mesh.py
    `spmd_invert`): `project`'s step for one image under torch.func.vmap,
    so that every layer, kernel and loss runs once a step for the whole
    batch. The weights are shared; w, the noise maps, the targets, the
    cameras and the draws carry a leading image axis, and one Adam over the
    stacked w and noise maps is B per-image optimizers (it is elementwise).

    targets (B, 1, 3, R, R), cameras (B, 1, 25). rngs: one `torch.Generator`
    per image, drawn from in `project`'s order (w statistics per image
    camera, noise maps, then each step's w noise and renderer draws), so
    image i projects as `project` with rngs[i] does; draws: optional
    per-image dicts as `project` takes.
    Returns (w (B, 1, num_ws, w_dim), noise maps by name (B, H, W),
    distances (B, num_steps)). on_step(step, dists (B,)) after each step.
    """
    dev = _check(generator, lpips, settings, device)
    b = targets.shape[0]
    draws = draws or [{}] * b
    rngs = rngs or [None] * b
    targets, cameras = targets.to(dev), cameras.to(dev)
    starts = [_start(generator, settings, cameras[i], None, draws[i], rngs[i]) for i in range(b)]
    w = torch.stack([s[0] for s in starts]).requires_grad_(True)
    w_stds = [s[1] for s in starts]
    noise = {k: v.requires_grad_(True) for k, v in stack_trees([s[2] for s in starts]).items()}
    fixed = vmap_strict(functools.partial(_fixed, lpips, settings.mode))(targets, cameras)
    loss_fn = vmap_strict(functools.partial(_image_loss, generator, lpips, settings))

    def step_fn(step):
        with span("spi.draws"):
            per_image = [_step_draws(generator, settings, draws[i], step, w.shape[1:], dev,
                                     rngs[i]) for i in range(b)]
            w_noise, render = stack_trees(per_image)
        with span("spi.sync"):
            scale = torch.tensor([_w_noise_scale(step, s, settings) for s in w_stds], device=dev)
        loss, dist = loss_fn(noise, w, w_noise, scale, fixed, render)
        return loss.sum(), dist

    dists = _optimize(settings, w, noise, step_fn, on_step)
    w_out = w.detach()
    if settings.mode == "sg":
        w_out = w_out.repeat(1, 1, generator.num_ws, 1)
    return w_out, {k: v.detach() for k, v in noise.items()}, dists
