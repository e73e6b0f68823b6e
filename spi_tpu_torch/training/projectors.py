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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.criteria.noise_reg import noise_regularization, normalize_noise
from spi_tpu_torch.models.triplane import TriPlaneGenerator
from spi_tpu_torch.ops import resize_area
from spi_tpu_torch.utils import camera as cam
from spi_tpu_torch.utils.device import module_device, resolve_device
from spi_tpu_torch.utils.params import extract_noise, init_noise_like, replace_noise


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
    dev = resolve_device(device)
    for name, module in (("generator", generator), ("lpips", lpips)):
        if module_device(module) != dev:
            raise ValueError(f"{name} is on {module_device(module)}, not {dev}")
    mode = settings.mode
    if mode not in ("sg", "sgw+", "mir"):
        raise ValueError(f"unknown projector mode {mode!r}")
    draws = draws or {}
    target = target.to(dev)
    camera = camera.to(dev)
    num_ws = generator.num_ws

    w_avg, w_std = compute_w_stats(generator, camera, settings.w_avg_samples)
    noise0 = draws.get("noise0") or init_noise_like(generator, rng)
    if set(noise0) != set(extract_noise(generator)):
        raise ValueError("noise maps do not match the generator's noise_const buffers")
    if initial_w is None:
        initial_w = w_avg if mode == "sg" else w_avg.repeat(1, num_ws, 1)
    w = initial_w.detach().clone().requires_grad_(True)
    noise = {k: v.detach().to(dev).clone().requires_grad_(True) for k, v in sorted(noise0.items())}

    with torch.no_grad():
        # The targets are constant over the steps: their features once.
        if mode == "sg":
            target_feats = lpips.features(
                resize_area(target, (256, 256)) if target.shape[-1] > 256 else target)
        else:
            target_feats = lpips.features(target)
        if mode == "mir":
            cameras = torch.cat([camera, cam.mirror_camera(camera)], dim=0)
            weight_m = cam.cal_camera_weight(cameras[1:])[0]
            target_m_feats = lpips.features(target.flip(3))

    opt = torch.optim.Adam([w, *noise.values()], lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    render_draws = draws.get("render")
    dists = []
    for step in range(settings.num_steps):
        if "w_noise" in draws:
            w_noise = draws["w_noise"][step].to(dev)
        else:
            w_noise = torch.randn(w.shape, generator=rng, device=dev)
        ws = w + w_noise * _w_noise_scale(step, w_std, settings)
        if mode == "sg":
            ws = ws.repeat(1, num_ws, 1)
        step_draws = render_draws[step] if render_draws is not None else None
        with replace_noise(generator, noise):
            if mode == "mir":
                planes = generator.planes_nhwc(ws)
                img = generator.synthesis_from_planes(planes, ws, cameras, draws=step_draws,
                                                      generator=rng)["image"]
            else:
                img = generator.synthesis(ws, camera, noise_mode="const", draws=step_draws,
                                          generator=rng)["image"]
        if mode == "sg":
            x = resize_area(img, (256, 256)) if img.shape[-1] > 256 else img
            dist = vgg_feature_distance(lpips, x, target_feats)
        elif mode == "sgw+":
            dist = lpips(img, y_feats=target_feats)
        else:
            dist = (lpips(img[:1], y_feats=target_feats)
                    + weight_m * lpips(img[1:], y_feats=target_m_feats))
        loss = dist + noise_regularization(noise) * settings.regularize_noise_weight

        opt.zero_grad(set_to_none=True)
        # Gradients for w and the noise maps only: none for the weights.
        loss.backward(inputs=[w, *noise.values()])
        for group in opt.param_groups:
            group["lr"] = _lr_schedule(step, settings)
        opt.step()
        normalize_noise(noise)
        dists.append(dist.detach())
        if on_step is not None:
            on_step(step, dist.detach())

    w_out = w.detach()
    if mode == "sg":  # w_projector.py:113 returns the single w repeated to all layers
        w_out = w_out.repeat(1, num_ws, 1)
    return w_out, {k: v.detach() for k, v in noise.items()}, torch.stack(dists)
