"""Stage-2 generator tuning: PTI and SPI's RotBbox (counterpart of
spi_tpu/training/coaches.py; spec spi/training/coaches/pti_coach.py and
rot_bbox_cx_coach.py).

Each step computes the planes of the pivot w once (`planes_nhwc`) and
renders the target camera from them: L2 * l2_lambda + LPIPS *
lpips_lambda against the target (its LPIPS features computed once).
Every `rot_bs` steps, step 0 included, the RotBbox regularizers follow,
each rendered from the same planes:
- rot: LPIPS between 4 surrounding cameras' renders and the target
  warped into them by depth (utils/rotate.py), x rot_lambda x rot_bs;
- mirror-rot: BoxCX between the flipped renders of 4 cameras around the
  mirrored camera and the flipped target warped into them, where the
  camera's yaw weight is above 0 and landmarks are given, x
  mirror_rot_lambda x rot_bs;
- depth anchor: L2 between the depth-only renders (no superresolution)
  of the tuned generator and of a frozen copy made before tuning, at 4
  `sample_camera` cameras with one set of renderer draws, x depth_lambda;
- density TV at free points (criteria/tv_loss.py), x tv_lambda.
Then one `torch.optim.Adam` step over the generator's parameters; the
`noise_const` and `w_avg` buffers stay fixed. Early stop
(coaches.py:264-317): a step whose LPIPS is at or under the threshold is
counted but not applied, and the loop ends.

Memory: a regularizer step renders 17 camera views. Rather than one
autograd graph over all of them, the renders read a detached copy of
the planes, each term calls `backward` as soon as it is made (freeing
its graph) and adds into that copy's gradient, and one last `backward`
carries the sum through the backbone. The gradient is the sum of the
terms' gradients, as spi_tpu's single summed loss gives it; the peak is
the largest term's.

Randomness (camera jitter, the renderer's draws, the TV points) comes
from `rng`, a `torch.Generator` on the run's device, or from per-step
`draws`, so that a test can give this loop and spi_tpu's the same
numbers.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch

from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
from spi_tpu_torch.criteria.l2_loss import l2_loss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.criteria.tv_loss import tv_loss
from spi_tpu_torch.models.rendering.renderer import draw_randoms
from spi_tpu_torch.models.triplane import TriPlaneGenerator
from spi_tpu_torch.utils import camera as cam
from spi_tpu_torch.utils import rotate as rot
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
    face_mask: Any = None  # (1, 1, R, R) from parsing (mask_utils.py:4-24)
    landmarks: Any = None  # (1, 68, 2) at 256 scale


def _to(tree, dev):
    """The tensors of a nested dict / tuple of draws, on `dev`."""
    if torch.is_tensor(tree):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return type(tree)(_to(v, dev) for v in tree)


def tune_generator(generator: TriPlaneGenerator, lpips: LPIPS, inputs: CoachInputs,
                   settings: CoachSettings = CoachSettings(), noise: dict | None = None,
                   rng: torch.Generator | None = None, draws: list | None = None,
                   device=None, snapshot_cb: Callable[[int, torch.Tensor], None] | None = None,
                   on_step: Callable[[int, float], None] | None = None,
                   box_cx: BoxCXLoss | None = None):
    """Run the stage-2 loop, tuning `generator`'s parameters in place.
    Returns (generator, (steps_run, last_lpips)).

    noise: the stage-1 noise maps by buffer name, rendered in place of
    the generator's `noise_const` buffers (which are left unchanged, and
    which the depth anchor's frozen copy renders with); None renders
    with the buffers. box_cx: the mirror-rot term's loss; without it, or
    without landmarks, that term is off. draws: optional per-step
    draws, each {'recon': renderer draws ({'stratified',
    'exponential'}), 'rot' / 'mirror' / 'depth': {'cameras': the camera
    sampler's (u_yaw, u_pitch), 'render': renderer draws}, 'tv':
    tv_loss's draws}; what is not given is drawn from `rng`.
    device: None means `cuda` (raises without a GPU); the modules must
    already be on it. snapshot_cb(step, image) receives the step's
    reconstruction every `log_snapshot` steps; on_step(step, lpips) is
    called after each step.
    """
    s = settings
    dev = resolve_device(device)
    for name, module in (("generator", generator), ("lpips", lpips), ("box_cx", box_cx)):
        if module is not None and module_device(module) != dev:
            raise ValueError(f"{name} is on {module_device(module)}, not {dev}")
    target = inputs.target.to(dev)
    camera = inputs.camera.to(dev)
    ws = inputs.w_pivot.detach().to(dev)
    noise = {k: v.detach().to(dev) for k, v in (noise or {}).items()}
    face_mask = inputs.face_mask.to(dev) if inputs.face_mask is not None else None
    landmarks = inputs.landmarks.to(dev) if inputs.landmarks is not None else None
    res = generator.cfg.neural_rendering_resolution

    with torch.no_grad():  # what is constant over the steps
        target_feats = lpips.features(target)
        camera_m = cam.mirror_camera(camera)
        # The mirror term counts where the yaw weight is above 0 (coach :107).
        mirror_on = (s.mirror_rot_lambda > 0 and box_cx is not None and landmarks is not None
                     and float(cam.cal_camera_weight(camera)[0]) > 0)
        has_reg = s.rot_lambda > 0 or mirror_on or s.depth_lambda > 0 or s.tv_lambda > 0
        if s.depth_lambda > 0:  # the depth anchor's frozen generator and its planes
            original = copy.deepcopy(generator).requires_grad_(False)
            stable_planes = original.planes_nhwc(ws)

    def tile(x):
        return None if x is None else x.expand(s.rot_bs, *x.shape[1:])

    def reg_terms(planes, gen_depth, step_draws):
        """The every-rot_bs-steps terms (rot_bbox_cx_coach.py:87-146), each
        weighted, one at a time."""
        if s.rot_lambda > 0:
            d = step_draws.get("rot", {})
            cams = cam.sample_surrounding_camera(camera, s.rot_bs, s.yaw_range, s.pitch_range,
                                                 uniforms=d.get("cameras"), generator=rng)
            out = generator.synthesis_from_planes(planes, ws, cams, draws=d.get("render"),
                                                  generator=rng)
            with torch.no_grad():
                warp_img, warp_mask = rot.rotate(
                    cams, out["image_depth"], tile(target), tile(camera), tile(gen_depth),
                    tile(face_mask), eps=s.warp_eps, depth_resolution=res)
                warp_feats = lpips.features(warp_img)
            yield lpips(out["image"] * warp_mask, y_feats=warp_feats) * s.rot_lambda * s.rot_bs
        if mirror_on:
            d = step_draws.get("mirror", {})
            cams = cam.sample_surrounding_camera(camera_m, s.rot_bs, s.yaw_range, s.pitch_range,
                                                 uniforms=d.get("cameras"), generator=rng)
            out = generator.synthesis_from_planes(planes, ws, cams, draws=d.get("render"),
                                                  generator=rng)
            with torch.no_grad():
                warp_img, warp_mask = rot.rotate(
                    cams, out["image_depth"], tile(target.flip(3)), tile(camera_m),
                    tile(gen_depth.flip(3)),
                    tile(face_mask.flip(3)) if face_mask is not None else None,
                    eps=s.warp_eps, depth_resolution=res)
            loss = box_cx(out["image"].flip(3) * warp_mask.flip(3), warp_img.flip(3),
                          tile(landmarks))
            yield loss * s.mirror_rot_lambda * s.rot_bs
        if s.depth_lambda > 0:
            d = step_draws.get("depth", {})
            cams = cam.sample_camera(4, s.depth_yaw_range, s.depth_pitch_range,
                                     uniforms=d.get("cameras"), generator=rng, device=dev)
            # Both renders take one set of draws, so they jitter alike.
            render = d.get("render") or draw_randoms(generator.cfg.rendering, 4, res * res, dev,
                                                     rng)
            depth = generator.synthesis_from_planes(planes, ws, cams, draws=render,
                                                    want_sr=False)["image_depth"]
            with torch.no_grad():
                stable = original.synthesis_from_planes(stable_planes, ws, cams, draws=render,
                                                        want_sr=False)["image_depth"]
            yield l2_loss(stable, depth) * s.depth_lambda
        if s.tv_lambda > 0:
            yield tv_loss(generator, ws, draws=step_draws.get("tv"), rng=rng,
                          planes=planes) * s.tv_lambda

    params = list(trainable_parameters(generator).values())
    opt = torch.optim.Adam(params, lr=s.learning_rate)

    step, last_lpips = 0, float("inf")
    while step < s.num_steps and last_lpips > s.lpips_threshold:
        step_draws = _to(draws[step], dev) if draws is not None else {}
        # Every render of the step reads the stage-1 noise, superresolution's
        # included; the frozen copy keeps its own buffers.
        with replace_noise(generator, noise):
            planes = generator.planes_nhwc(ws)
            # The terms render from a detached copy of the planes and add
            # into its gradient one at a time; the sum then crosses the
            # backbone once.
            leaf = planes.detach().requires_grad_(True)
            out = generator.synthesis_from_planes(leaf, ws, camera,
                                                  draws=step_draws.get("recon"), generator=rng)
            img, gen_depth = out["image"], out["image_depth"].detach()
            del out
            lp = lpips(img, y_feats=target_feats)
            loss = l2_loss(img, target) * s.l2_lambda + lp * s.lpips_lambda
            last_lpips = float(lp.detach())
            if last_lpips > s.lpips_threshold:  # the reference breaks before optimizer.step()
                opt.zero_grad(set_to_none=True)
                grads = [leaf, *params]  # no gradient for the perception nets' weights
                loss.backward(inputs=grads)
                if has_reg and step % s.rot_bs == 0:
                    for term in reg_terms(leaf, gen_depth, step_draws):
                        term.backward(inputs=grads)
                planes.backward(leaf.grad, inputs=params)
                opt.step()
        del loss, lp, planes, leaf
        if snapshot_cb is not None and s.log_snapshot > 0 and step % s.log_snapshot == 0:
            snapshot_cb(step, img.detach())
        if on_step is not None:
            on_step(step, last_lpips)
        step += 1
    opt.zero_grad(set_to_none=True)
    return generator, (step, last_lpips)
