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
numbers; each step's draws are made before it (`_fill_draws`), in the
order the step consumes them.

`tune_batch` tunes B images at once: the same step pieces (`_Step`) under
torch.func.vmap over stacked per-image weights, with spi_tpu's per-image
early stop (lanes that stop keep their weights and Adam moments).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch

from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
from spi_tpu_torch.criteria.l2_loss import l2_loss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.criteria.tv_loss import tv_draws, tv_loss
from spi_tpu_torch.models.rendering.renderer import draw_randoms
from spi_tpu_torch.models.triplane import TriPlaneGenerator
from spi_tpu_torch.utils import camera as cam
from spi_tpu_torch.utils import rotate as rot
from spi_tpu_torch.utils.device import module_device, resolve_device
from spi_tpu_torch.utils.params import (
    functional_apply,
    stack_trees,
    trainable_parameters,
    vmap_strict,
)
from spi_tpu_torch.utils.stats import span


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


def _fill_draws(generator: TriPlaneGenerator, s: CoachSettings, given: dict, reg: bool,
                mirror: bool, dev, rng) -> dict:
    """One step's draws: those `given`, the rest drawn from `rng` in the
    order the step consumes them (the reconstruction's renderer draws, then
    per regularizer term its camera uniforms and its renderer draws, and
    the TV points)."""
    res = generator.cfg.neural_rendering_resolution
    opts = generator.cfg.rendering
    given = _to(given, dev)
    d = {"recon": given.get("recon") or draw_randoms(opts, 1, res * res, dev, rng)}
    if not reg:
        return d

    def term(name, cam_shape):
        g = given.get(name, {})
        cams = g.get("cameras") or cam.draw_uniforms(cam_shape, dev, rng)
        render = g.get("render") or draw_randoms(opts, cam_shape[0], res * res, dev, rng)
        return {"cameras": tuple(cams), "render": render}

    if s.rot_lambda > 0:
        d["rot"] = term("rot", (s.rot_bs,))
    if mirror:
        d["mirror"] = term("mirror", (s.rot_bs,))
    if s.depth_lambda > 0:
        d["depth"] = term("depth", (4, 1))
    if s.tv_lambda > 0:
        d["tv"] = tv_draws(given.get("tv"), 1, dev=dev, rng=rng)
    return d


@dataclasses.dataclass(frozen=True)
class _Step:
    """One image's pieces of a stage-2 step, shared by `tune_generator` and
    `tune_batch` (which runs each under torch.func.vmap). `tensors` stand
    in for the generator's own (functional_apply): the stage-1 noise maps,
    and in a batch each image's own weights. `x` holds the image's inputs:
    'ws', 'camera', 'target', optionally 'face_mask', 'landmarks' and the
    depth anchor's 'stable_planes'. `original` is the depth anchor's frozen
    generator, a module apart from `generator`."""

    generator: TriPlaneGenerator
    original: TriPlaneGenerator | None
    lpips: LPIPS
    box_cx: BoxCXLoss | None
    s: CoachSettings

    def _render(self, tensors, planes, ws, cams, render, want_sr=True):
        g = self.generator
        return functional_apply(g, tensors, g.synthesis_from_planes, planes, ws, cams,
                                draws=render, want_sr=want_sr)

    def _tile(self, x):
        return None if x is None else x.expand(self.s.rot_bs, *x.shape[1:])

    def planes(self, tensors, ws):
        return functional_apply(self.generator, tensors, self.generator.planes_nhwc, ws)

    def recon(self, tensors, leaf, x, target_feats, render):
        """L2 * l2_lambda + LPIPS * lpips_lambda at the target camera;
        returns (loss, lpips, image, depth detached)."""
        out = self._render(tensors, leaf, x["ws"], x["camera"], render)
        img = out["image"]
        lp = self.lpips(img, y_feats=target_feats)
        loss = l2_loss(img, x["target"]) * self.s.l2_lambda + lp * self.s.lpips_lambda
        return loss, lp, img, out["image_depth"].detach()

    def rot(self, tensors, leaf, x, gen_depth, d):
        s, tile = self.s, self._tile
        cams = cam.sample_surrounding_camera(x["camera"], s.rot_bs, s.yaw_range, s.pitch_range,
                                             uniforms=d["cameras"])
        out = self._render(tensors, leaf, x["ws"], cams, d["render"])
        with torch.no_grad():
            warp_img, warp_mask = rot.rotate(
                cams, out["image_depth"], tile(x["target"]), tile(x["camera"]), tile(gen_depth),
                tile(x.get("face_mask")), eps=s.warp_eps,
                depth_resolution=self.generator.cfg.neural_rendering_resolution)
            warp_feats = self.lpips.features(warp_img)
        return self.lpips(out["image"] * warp_mask, y_feats=warp_feats) * s.rot_lambda * s.rot_bs

    def mirror(self, tensors, leaf, x, gen_depth, d):
        s, tile = self.s, self._tile
        camera_m = cam.mirror_camera(x["camera"])
        face_mask = x.get("face_mask")
        cams = cam.sample_surrounding_camera(camera_m, s.rot_bs, s.yaw_range, s.pitch_range,
                                             uniforms=d["cameras"])
        out = self._render(tensors, leaf, x["ws"], cams, d["render"])
        with torch.no_grad():
            warp_img, warp_mask = rot.rotate(
                cams, out["image_depth"], tile(x["target"].flip(3)), tile(camera_m),
                tile(gen_depth.flip(3)), tile(face_mask.flip(3)) if face_mask is not None else None,
                eps=s.warp_eps, depth_resolution=self.generator.cfg.neural_rendering_resolution)
        loss = self.box_cx(out["image"].flip(3) * warp_mask.flip(3), warp_img.flip(3),
                           tile(x["landmarks"]))
        return loss * s.mirror_rot_lambda * s.rot_bs

    def depth(self, tensors, leaf, x, gen_depth, d):
        s = self.s
        cams = cam.sample_camera(4, s.depth_yaw_range, s.depth_pitch_range,
                                 uniforms=d["cameras"], device=x["camera"].device)
        # Both renders take one set of draws, so they jitter alike.
        depth = self._render(tensors, leaf, x["ws"], cams, d["render"],
                             want_sr=False)["image_depth"]
        with torch.no_grad():
            stable = self.original.synthesis_from_planes(x["stable_planes"], x["ws"], cams,
                                                         draws=d["render"],
                                                         want_sr=False)["image_depth"]
        return l2_loss(stable, depth) * s.depth_lambda

    def tv(self, tensors, leaf, x, gen_depth, d):
        g = self.generator
        return functional_apply(g, tensors, tv_loss, g, x["ws"], draws=d, planes=leaf) \
            * self.s.tv_lambda

    def terms(self, mirror: bool):
        """The regularizer terms of a RotBbox step, in order, each weighted
        (rot_bbox_cx_coach.py:87-146); `mirror`: whether the mirror-rot term
        is on."""
        s = self.s
        return [(name, fn) for name, fn, on in (
            ("rot", self.rot, s.rot_lambda > 0), ("mirror", self.mirror, mirror),
            ("depth", self.depth, s.depth_lambda > 0), ("tv", self.tv, s.tv_lambda > 0)) if on]


def _mirror_weight_on(camera) -> bool:
    """The mirror term counts where the camera's yaw weight is above 0 (coach :107)."""
    return float(cam.cal_camera_weight(camera)[0]) > 0


def _check_devices(dev, **modules):
    for name, module in modules.items():
        if module is not None and module_device(module) != dev:
            raise ValueError(f"{name} is on {module_device(module)}, not {dev}")


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
    _check_devices(dev, generator=generator, lpips=lpips, box_cx=box_cx)
    noise = {k: v.detach().to(dev) for k, v in (noise or {}).items()}
    x = {"ws": inputs.w_pivot.detach().to(dev), "camera": inputs.camera.to(dev),
         "target": inputs.target.to(dev)}
    for key in ("face_mask", "landmarks"):
        if getattr(inputs, key) is not None:
            x[key] = getattr(inputs, key).to(dev)

    with torch.no_grad():  # what is constant over the steps
        target_feats = lpips.features(x["target"])
        mirror_on = (s.mirror_rot_lambda > 0 and box_cx is not None and "landmarks" in x
                     and _mirror_weight_on(x["camera"]))
        original = None
        if s.depth_lambda > 0:  # the depth anchor's frozen generator and its planes
            original = copy.deepcopy(generator).requires_grad_(False)
            x["stable_planes"] = original.planes_nhwc(x["ws"])
    step_fns = _Step(generator, original, lpips, box_cx, s)
    terms = step_fns.terms(mirror_on)

    params = list(trainable_parameters(generator).values())
    opt = torch.optim.Adam(params, lr=s.learning_rate)

    step, last_lpips = 0, float("inf")
    while step < s.num_steps and last_lpips > s.lpips_threshold:
        reg = bool(terms) and step % s.rot_bs == 0
        with span("spi.step"):
            with span("spi.draws"):
                d = _fill_draws(generator, s, draws[step] if draws is not None else {}, reg,
                                mirror_on, dev, rng)
            # Every render of the step reads the stage-1 noise, superresolution's
            # included; the frozen copy keeps its own buffers. The terms render
            # from a detached copy of the planes and add into its gradient one
            # at a time; the sum then crosses the backbone once.
            planes = step_fns.planes(noise, x["ws"])
            leaf = planes.detach().requires_grad_(True)
            with span("spi.recon"):
                loss, lp, img, gen_depth = step_fns.recon(noise, leaf, x, target_feats,
                                                          d["recon"])
            with span("spi.sync"):
                last_lpips = float(lp.detach())
            if last_lpips > s.lpips_threshold:  # the reference breaks before optimizer.step()
                opt.zero_grad(set_to_none=True)
                grads = [leaf, *params]  # no gradient for the perception nets' weights
                with span("spi.backward"):
                    loss.backward(inputs=grads)
                if reg:
                    for name, fn in terms:
                        with span(f"spi.term.{name}"):
                            fn(noise, leaf, x, gen_depth, d[name]).backward(inputs=grads)
                with span("spi.backward"):
                    planes.backward(leaf.grad, inputs=params)
                with span("spi.optimizer"):
                    opt.step()
            del loss, lp, planes, leaf
        if snapshot_cb is not None and s.log_snapshot > 0 and step % s.log_snapshot == 0:
            snapshot_cb(step, img.detach())
        if on_step is not None:
            on_step(step, last_lpips)
        step += 1
    opt.zero_grad(set_to_none=True)
    return generator, (step, last_lpips)


class _Frozen:
    """Lanes of a batched tuning that have stopped: each keeps its weights
    and Adam moments as they were when it stopped, copied back after every
    later optimizer step (spi_tpu/training/coaches.py:264-317 skips the
    update of a lane that is not applied)."""

    def __init__(self, opt: torch.optim.Optimizer, params: list[torch.Tensor]):
        self.opt, self.params = opt, params
        self.saved: dict[int, list] = {}

    def _slots(self, i: int):
        dst, src = [], []
        for p, saved in zip(self.params, self.saved[i]):
            state = self.opt.state.get(p, {})
            for key, value in zip(("param", "exp_avg", "exp_avg_sq"), saved):
                t = p if key == "param" else state.get(key)
                if t is not None:
                    dst.append(t[i])
                    src.append(value if value is not None else torch.zeros_like(t[i]))
        return dst, src

    @torch.no_grad()
    def add(self, i: int) -> None:
        def copy_of(t):
            return None if t is None else t[i].clone()

        self.saved[i] = [
            (p[i].clone(), copy_of(self.opt.state.get(p, {}).get("exp_avg")),
             copy_of(self.opt.state.get(p, {}).get("exp_avg_sq")))
            for p in self.params]

    @torch.no_grad()
    def restore(self) -> None:
        for i in self.saved:
            dst, src = self._slots(i)
            torch._foreach_copy_(dst, src)


def tune_batch(generator: TriPlaneGenerator, lpips: LPIPS, inputs: CoachInputs,
               settings: CoachSettings = CoachSettings(), noise: dict | None = None,
               rngs: list | None = None, draws: list | None = None, device=None,
               on_step: Callable[[int, list], None] | None = None,
               box_cx: BoxCXLoss | None = None):
    """Stage 2 for B images at once, the counterpart of spi_tpu's `jax.vmap`
    of the tuning while_loop (spi_tpu/parallel/mesh.py `spmd_invert`). Every
    image tunes its own copy of `generator`'s weights: the parameters are
    stacked on a leading image axis and each piece of `tune_generator`'s
    step runs under torch.func.vmap through `functional_apply`, so that
    every layer and kernel runs once a step for the whole batch; one Adam
    over the stacked weights is B per-image optimizers while every image is
    applied. The generator module itself is not changed: it holds the
    starting weights, and a frozen copy of it is the depth anchor's.

    inputs: a CoachInputs whose tensors carry a leading image axis (B, 1,
    ...). noise: the stage-1 noise maps (B, H, W) by buffer name. rngs:
    one `torch.Generator` per image, drawn from in `tune_generator`'s
    order; draws: optional per-image lists of per-step draws as
    `tune_generator` takes.

    The images stop apart, as spi_tpu's lanes do: image i is active while
    its steps run < num_steps and its last LPIPS > threshold, and applied
    when active and this step's LPIPS > threshold. A lane that is not
    applied keeps its weights and Adam moments unchanged (`_Frozen`); its
    step count and LPIPS advance only while it is active; the loop ends
    when no image is active. Active images share the step count, so the
    regularizer cadence is the loop's. The mirror-rot term runs where every
    image has landmarks (and `box_cx` is given), counted per image where
    its yaw weight is above 0. No snapshots on this path.

    Returns (tuned weights by name (B, ...), steps run (B,), last LPIPS (B,)).
    """
    s = settings
    dev = resolve_device(device)
    _check_devices(dev, generator=generator, lpips=lpips, box_cx=box_cx)
    b = inputs.target.shape[0]
    rngs = rngs or [None] * b
    x = {"ws": inputs.w_pivot.detach().to(dev), "camera": inputs.camera.to(dev),
         "target": inputs.target.to(dev)}
    for key in ("face_mask", "landmarks"):
        if getattr(inputs, key) is not None:
            x[key] = getattr(inputs, key).to(dev)
    params = {k: v.detach().unsqueeze(0).repeat(b, *([1] * v.ndim)).requires_grad_(True)
              for k, v in trainable_parameters(generator).items()}
    tensors = {**params, **{k: v.detach().to(dev) for k, v in (noise or {}).items()}}

    with torch.no_grad():
        target_feats = vmap_strict(lpips.features)(x["target"])
        mirror_lanes = [s.mirror_rot_lambda > 0 and box_cx is not None and "landmarks" in x
                        and _mirror_weight_on(x["camera"][i]) for i in range(b)]
        original = None
        if s.depth_lambda > 0:
            original = copy.deepcopy(generator).requires_grad_(False)
            x["stable_planes"] = vmap_strict(original.planes_nhwc)(x["ws"])
    step_fns = _Step(generator, original, lpips, box_cx, s)
    terms = step_fns.terms(any(mirror_lanes))
    planes_fn = vmap_strict(step_fns.planes)
    recon_fn = vmap_strict(step_fns.recon)
    term_fns = [(name, vmap_strict(fn)) for name, fn in terms]

    plist = list(params.values())
    opt = torch.optim.Adam(plist, lr=s.learning_rate)
    frozen = _Frozen(opt, plist)
    steps, lps = [0] * b, [float("inf")] * b
    it = 0
    while True:
        active = [steps[i] < s.num_steps and lps[i] > s.lpips_threshold for i in range(b)]
        if not any(active):
            break
        reg = bool(terms) and it % s.rot_bs == 0
        with span("spi.step"):
            with span("spi.draws"):
                lane_draws = {i: _fill_draws(generator, s,
                                             draws[i][it] if draws is not None else {},
                                             reg, mirror_lanes[i], dev, rngs[i])
                              for i in range(b) if active[i]}
                # A lane without a piece of the draws (stopped, or its mirror
                # term off) computes on another lane's; that piece of its
                # result is not applied.
                donor = next(iter(lane_draws.values()))
                mirror_donor = next((d["mirror"] for d in lane_draws.values() if "mirror" in d),
                                    None)
                filled = []
                for i in range(b):
                    d = dict(lane_draws.get(i, donor))
                    if mirror_donor is not None:
                        d.setdefault("mirror", mirror_donor)
                    filled.append(d)
                d = stack_trees(filled)
            step_terms = [(n, fn) for n, fn in term_fns
                          if n != "mirror" or mirror_donor is not None]

            planes = planes_fn(tensors, x["ws"])
            leaf = planes.detach().requires_grad_(True)
            with span("spi.recon"):
                loss, lp, img, gen_depth = recon_fn(tensors, leaf, x, target_feats, d["recon"])
            del img
            with span("spi.sync"):
                lp_now = lp.detach().tolist()
            applied = [active[i] and lp_now[i] > s.lpips_threshold for i in range(b)]
            for i in range(b):
                if active[i]:
                    steps[i] += 1
                    lps[i] = lp_now[i]
            if any(applied):
                with span("spi.sync"):
                    mask = torch.tensor(applied, device=dev)
                opt.zero_grad(set_to_none=True)
                grads = [leaf, *plist]
                with span("spi.backward"):
                    torch.where(mask, loss, 0.0).sum().backward(inputs=grads)
                if reg:
                    for name, fn in step_terms:
                        with span(f"spi.term.{name}"):
                            on = mask
                            if name == "mirror":
                                with span("spi.sync"):
                                    on = mask & torch.tensor(mirror_lanes, device=dev)
                            t = fn(tensors, leaf, x, gen_depth, d[name])
                            torch.where(on, t, 0.0).sum().backward(inputs=grads)
                with span("spi.backward"):
                    planes.backward(leaf.grad, inputs=plist)
                for i in range(b):
                    if not applied[i] and i not in frozen.saved:
                        frozen.add(i)
                with span("spi.optimizer"):
                    opt.step()
                    frozen.restore()
            del loss, lp, planes, leaf
        if on_step is not None:
            on_step(it, list(lps))
        it += 1
    opt.zero_grad(set_to_none=True)
    return {k: v.detach() for k, v in params.items()}, steps, lps
