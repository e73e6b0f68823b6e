"""Stage-2 generator tuning, reconstruction only (counterpart of
spi_tpu/training/coaches.py; spec spi/training/coaches/pti_coach.py and
rot_bbox_cx_coach.py).

Each step renders the target camera from the pivot w through one
`planes_nhwc` and one `synthesis_from_planes`, takes L2 * l2_lambda +
LPIPS * lpips_lambda against the target (its LPIPS features computed
once), and applies one `torch.optim.Adam` step over the generator's
parameters; the `noise_const` and `w_avg` buffers stay fixed. Early stop
(coaches.py:264-317): a step whose LPIPS is at or under the threshold is
counted but not applied, and the loop ends.

The RotBbox regularizers (rot, mirror-rot, depth anchor, density TV) are
not ported: a nonzero `rot_lambda`, `mirror_rot_lambda`, `depth_lambda`
or `tv_lambda` raises NotImplementedError. The CLI's default request
sets them all to 0, so its stage 2 is this loop.

Randomness (the renderer's jitter) comes from `rng`, a `torch.Generator`
on the run's device, or from per-step `draws`, so that a test can give
this loop and spi_tpu's the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from spi_tpu_torch.criteria.l2_loss import l2_loss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.models.triplane import TriPlaneGenerator
from spi_tpu_torch.utils.device import module_device, resolve_device
from spi_tpu_torch.utils.params import replace_noise, trainable_parameters


@dataclasses.dataclass(frozen=True)
class CoachSettings:
    """Defaults mirror spi/configs/hyperparameters.py."""

    num_steps: int = 1000  # G_1_step
    learning_rate: float = 3e-4  # pti_learning_rate
    lpips_threshold: float = 0.05  # LPIPS_value_threshold
    l2_lambda: float = 1.0
    lpips_lambda: float = 1.0
    rot_lambda: float = 0.1
    mirror_rot_lambda: float = 0.05
    depth_lambda: float = 1.0
    tv_lambda: float = 0.0
    rot_bs: int = 4
    yaw_range: float = 0.2
    pitch_range: float = 0.1
    depth_yaw_range: float = 0.7
    depth_pitch_range: float = 0.4
    warp_eps: float = 5e-2
    # Every N steps, hand the step's reconstruction to the snapshot
    # callback (global_config.py:7 log_snapshot=100). 0 = off.
    log_snapshot: int = 0


def pti_settings(num_steps: int = 1000) -> CoachSettings:
    """PTI = reconstruction only (pti_coach.py:19-32)."""
    return CoachSettings(num_steps=num_steps, rot_lambda=0.0, mirror_rot_lambda=0.0,
                         depth_lambda=0.0, tv_lambda=0.0)


@dataclasses.dataclass(frozen=True)
class CoachInputs:
    """Per-image tensors the tuning loop consumes."""

    target: Any  # (1, 3, R, R) in [-1, 1]
    camera: Any  # (1, 25)
    w_pivot: Any  # (1, num_ws, C)
    face_mask: Any = None  # (1, 1, R, R), read by the RotBbox terms only
    landmarks: Any = None  # (1, 68, 2), read by the RotBbox terms only


def tune_generator(generator: TriPlaneGenerator, lpips: LPIPS, inputs: CoachInputs,
                   settings: CoachSettings = CoachSettings(), noise: dict | None = None,
                   rng: torch.Generator | None = None, draws: list | None = None,
                   device=None, snapshot_cb: Callable[[int, torch.Tensor], None] | None = None,
                   on_step: Callable[[int, float], None] | None = None):
    """Run the stage-2 loop, tuning `generator`'s parameters in place.
    Returns (generator, (steps_run, last_lpips)).

    noise: the stage-1 noise maps by buffer name, rendered in place of
    the generator's `noise_const` buffers (which are left unchanged);
    None renders with the buffers. draws: optional per-step renderer
    draws ({'stratified', 'exponential'}); else drawn from `rng`.
    device: None means `cuda` (raises without a GPU); the generator and
    LPIPS must already be on it. snapshot_cb(step, image) receives the
    step's reconstruction every `log_snapshot` steps; on_step(step,
    lpips) is called after each step.
    """
    s = settings
    unported = {k: getattr(s, k) for k in ("rot_lambda", "mirror_rot_lambda", "depth_lambda",
                                          "tv_lambda") if getattr(s, k) > 0}
    if unported:
        raise NotImplementedError(f"stage-2 regularizers are not ported: {unported}; "
                                  "use pti_settings() for reconstruction-only tuning")
    dev = resolve_device(device)
    for name, module in (("generator", generator), ("lpips", lpips)):
        if module_device(module) != dev:
            raise ValueError(f"{name} is on {module_device(module)}, not {dev}")
    target = inputs.target.to(dev)
    camera = inputs.camera.to(dev)
    ws = inputs.w_pivot.detach().to(dev)
    noise = {k: v.detach().to(dev) for k, v in (noise or {}).items()}

    with torch.no_grad():  # the target is constant over the steps
        target_feats = lpips.features(target)
    params = list(trainable_parameters(generator).values())
    opt = torch.optim.Adam(params, lr=s.learning_rate)

    step, last_lpips = 0, float("inf")
    while step < s.num_steps and last_lpips > s.lpips_threshold:
        with replace_noise(generator, noise):
            planes = generator.planes_nhwc(ws)
            img = generator.synthesis_from_planes(
                planes, ws, camera, draws=draws[step] if draws is not None else None,
                generator=rng)["image"]
        lp = lpips(img, y_feats=target_feats)
        loss = l2_loss(img, target) * s.l2_lambda + lp * s.lpips_lambda
        opt.zero_grad(set_to_none=True)
        loss.backward(inputs=params)  # no gradient for LPIPS's weights
        if snapshot_cb is not None and s.log_snapshot > 0 and step % s.log_snapshot == 0:
            snapshot_cb(step, img.detach())
        last_lpips = float(lp.detach())
        if last_lpips > s.lpips_threshold:  # the reference breaks before optimizer.step()
            opt.step()
        if on_step is not None:
            on_step(step, last_lpips)
        step += 1
    opt.zero_grad(set_to_none=True)
    return generator, (step, last_lpips)
