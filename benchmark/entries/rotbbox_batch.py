"""SPI's RotBbox stage 2 for B images at once: the port's
`spi_tpu_torch.training.coaches.tune_batch`, the loop `--parallel_images
B` runs, as a user's run calls it.

Set-up makes every weight on the device from the seed (generator,
LPIPS-VGG16 and its heads, BoxCX's VGG19) and loads the same tensors into
the port's modules; makes B targets, cameras turned by seeded yaws, the
face mask and landmarks, the pivots (the mapping of seeded z) and the
stage-1 noise maps; and hands `tune_batch` the renderer, camera and draw
numbers of its first `check_steps` steps, so that the plain reference can
follow them. Later steps draw from per-image generators seeded from the
run's seed. The loop runs the workload's full step count; should it end
inside the window, the next seeded batch starts."""

from __future__ import annotations

import gc
import math

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from benchmark.counts import eg3d as work
from benchmark.entries._port import triplane_config
from benchmark.harness import generator
from benchmark.reference import camera as ref_camera
from benchmark.reference import eg3d, perception, quant, steps


def synthetic_face(dev, res):
    """A face mask (1, 1, res, res) and 68 landmarks (1, 68, 2) at 256 scale
    on one ellipse about the middle of the crop: the mouth and eye boxes
    lie in the image."""
    yy, xx = torch.meshgrid(*(torch.arange(res, device=dev) / (res - 1),) * 2, indexing="ij")
    mask = (((xx - 0.5) ** 2) / 0.08 + ((yy - 0.45) ** 2) / 0.12 < 1.0).float()[None, None]
    t = torch.linspace(0, 2 * math.pi, 69, device=dev)[:68]
    lm = torch.stack([128 + 60 * torch.cos(t), 256 * 0.45 * 1.15 + 75 * torch.sin(t)], -1)
    return mask, lm[None]


def _renderer_draws(g, n, dev, gen):
    m = g["neural_rendering_resolution"] ** 2
    return {"stratified": torch.rand((n, m, g["depth_resolution"], 1), generator=gen, device=dev),
            "exponential": torch.empty(n * m, g["depth_resolution_importance"] + 1,
                                       device=dev).exponential_(generator=gen)}


def step_draws(g, coach, seed, image, step, dev):
    """Image `image`'s draws of step `step`, in the coach's format."""
    gen = generator(seed, f"draws/{image}/{step}", dev)
    d = {"recon": _renderer_draws(g, 1, dev, gen)}
    if step % coach["rot_bs"] == 0:
        k = coach["rot_bs"]
        for term in ("rot", "mirror"):
            d[term] = {"cameras": tuple(torch.rand(k, generator=gen, device=dev) for _ in range(2)),
                       "render": _renderer_draws(g, k, dev, gen)}
        d["depth"] = {"cameras": tuple(torch.rand((4, 1), generator=gen, device=dev)
                                       for _ in range(2)),
                      "render": _renderer_draws(g, 4, dev, gen)}
    return d


class _Draws:
    """One image's per-step draws for `tune_batch`: given for the checked
    steps, drawn by the coach from its generator afterwards."""

    def __init__(self, g, coach, seed, image, n, dev):
        self.args, self.n = (g, coach, seed, image), n
        self.dev = dev

    def __getitem__(self, step):
        if step >= self.n:
            return {}
        return step_draws(*self.args, step, self.dev)


def make_inputs(ctx, loop, dev):
    """The batch of loop `loop`: targets, cameras, pivots, stage-1 noise."""
    g, wl = ctx.generator_cfg, ctx.workload
    b, res = wl["images"], g["img_resolution"]
    gen = generator(ctx.seed, f"inputs/{loop}", dev)
    lo, hi = wl["yaw"]
    yaws = (lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)) \
        * torch.where(torch.rand(b, generator=gen, device=dev) < 0.5, -1.0, 1.0)
    cams = torch.stack([ref_camera.canonical(float(y), dev) for y in yaws.tolist()])
    targets = torch.tanh(torch.randn((b, 1, 3, res, res), generator=gen, device=dev))
    z = torch.randn((b, g["z_dim"]), generator=gen, device=dev)
    noise = {}
    for name, shape, _ in eg3d.generator_spec(g):
        if name.startswith("backbone.synthesis.") and name.endswith("noise_const"):
            noise[name] = torch.randn((b, *shape), generator=gen, device=dev)
    mask, lm = synthetic_face(dev, res)
    return {"target": targets, "camera": cams, "z": z, "noise": noise,
            "face_mask": mask[None].expand(b, *mask.shape).contiguous(),
            "landmarks": lm[None].expand(b, *lm.shape).contiguous()}


def weights(ctx, dev):
    """(generator, LPIPS, BoxCX) tensors made from the seed."""
    g = ctx.generator_cfg
    lp_cfg = ctx.config["tiny"]["lpips_vgg"] if ctx.tiny else perception.VGG16_CFG
    return (eg3d.make_tensors(eg3d.generator_spec(g), generator(ctx.seed, "generator", dev), dev),
            eg3d.make_tensors(perception.lpips_spec(lp_cfg), generator(ctx.seed, "lpips", dev), dev),
            eg3d.make_tensors(perception.box_cx_spec(), generator(ctx.seed, "box_cx", dev), dev))


@torch.no_grad()
def pivots(P, g, z, dev):
    """The mapping of seeded z at the frontal camera: (B, 1, num_ws, w_dim)."""
    c = ref_camera.canonical(0.0, dev).expand(z.shape[0], 25)
    return eg3d.mapping(P, g, z, c)[:, None]


class Cell:
    def __init__(self, ctx):
        from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
        from spi_tpu_torch.criteria.lpips import LPIPS
        from spi_tpu_torch.models.triplane import TriPlaneGenerator

        self.ctx, dev = ctx, ctx.device
        g, wl = ctx.generator_cfg, ctx.workload
        self.g, self.coach = g, dict(wl["coach"])
        self.images_per_step = wl["images"]
        self.warmup, self.check_steps = wl["warmup_steps"], wl["check_steps"]
        self.slice_steps = wl["trace_steps"]
        self.dtype = "float32" if ctx.tiny else ctx.config["compute_dtype"]
        cfg = triplane_config(g, self.dtype)
        P, lp, box = weights(ctx, dev)
        self.generator = TriPlaneGenerator(cfg, device=dev)
        self.generator.load_state_dict(P)
        lp_cfg = ctx.config["tiny"]["lpips_vgg"] if ctx.tiny else perception.VGG16_CFG
        self.lpips = LPIPS(cfg=tuple(lp_cfg), device=dev,
                           compute_dtype=ctx.config["lpips"]["compute_dtype"])
        self.lpips.load_state_dict(lp)
        self.box_cx = BoxCXLoss(device=dev)
        self.box_cx.load_state_dict(box)
        self.names = list(dict(self.generator.named_parameters()))
        self.x0 = make_inputs(ctx, 0, dev)
        self.x0["ws"] = pivots(P, g, self.x0.pop("z"), dev)
        del P, lp, box
        self.readings = {"loss": [], "grad": None, "change": None}
        self._opt_steps = 0

    # -- the loop -----------------------------------------------------------
    def _coach_inputs(self, x):
        from spi_tpu_torch.training.coaches import CoachInputs

        return CoachInputs(x["target"], x["camera"], x["ws"], x["face_mask"], x["landmarks"])

    def _after_opt_step(self, opt, args, kwargs):
        """Reads the optimizer as it stands after the checked steps."""
        self._opt_steps += 1
        b = self.images_per_step
        params = opt.param_groups[0]["params"]
        with torch.no_grad():
            if self._opt_steps == 1:
                beta1 = opt.param_groups[0]["betas"][0]
                self.readings["grad"] = _lane_norms(
                    {n: opt.state[p]["exp_avg"] / (1 - beta1)
                     for n, p in zip(self.names, params) if "exp_avg" in opt.state.get(p, {})}, b)
            if self._opt_steps == self.check_steps:
                start = dict(self.generator.named_parameters())
                self.readings["change"] = _lane_norms(
                    {n: p - start[n][None] for n, p in zip(self.names, params)}, b)
                self._hook.remove()

    def run(self, on_step):
        from spi_tpu_torch.training.coaches import CoachSettings, tune_batch

        dev, wl = self.ctx.device, self.ctx.workload
        b = self.images_per_step
        settings = CoachSettings(num_steps=wl["steps"], **self.coach)
        self._hook = register_optimizer_step_post_hook(self._after_opt_step)
        loop = 0
        while True:
            if loop == 0:
                x = self.x0
                draws = [_Draws(self.g, self.coach, self.ctx.seed, i, self.check_steps, dev)
                         for i in range(b)]
            else:
                x = make_inputs(self.ctx, loop, dev)
                with torch.no_grad():
                    x["ws"] = self.generator.mapping(
                        x.pop("z"), ref_camera.canonical(0.0, dev).expand(b, 25))[:, None]
                draws = None
            rngs = [generator(self.ctx.seed, f"rng/{loop}/{i}", dev) for i in range(b)]

            def step_cb(it, lps, first=loop == 0):
                if first and it < self.check_steps:
                    self.readings["loss"].append(list(lps))
                on_step(it)

            tune_batch(self.generator, self.lpips, self._coach_inputs(x), settings,
                       noise=x["noise"], rngs=rngs, draws=draws, device=dev, on_step=step_cb,
                       box_cx=self.box_cx)
            loop += 1

    def slice_starts(self, it):
        """A traced slice starts with a regularizer step."""
        return (it + 1) % self.coach["rot_bs"] == 0

    def release(self):
        for name in ("generator", "lpips", "box_cx", "x0"):
            setattr(self, name, None)
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the yardstick ------------------------------------------------------
    def reference(self, lower=None):
        """The plain reference's readings on the same weights, inputs and
        draws, image by image; `lower`: the operand dtype of the control."""
        ctx, dev, g = self.ctx, self.ctx.device, self.g
        P, lp, box = weights(ctx, dev)
        x = make_inputs(ctx, 0, dev)
        ws = pivots(P, g, x["z"], dev)
        lp_cfg = ctx.config["tiny"]["lpips_vgg"] if ctx.tiny else perception.VGG16_CFG
        out = {"loss": [[None] * self.images_per_step for _ in range(self.check_steps)],
               "grad": [], "change": []}
        for i in range(self.images_per_step):
            xi = {"target": x["target"][i], "camera": x["camera"][i], "ws": ws[i],
                  "noise": {k: v[i] for k, v in x["noise"].items()},
                  "face_mask": x["face_mask"][i], "landmarks": x["landmarks"][i]}
            draws = [step_draws(g, self.coach, ctx.seed, i, t, dev) for t in range(self.check_steps)]
            with quant.operands(lower):
                r = steps.rotbbox(P, g, lp, box, xi, self.coach, draws, self.check_steps, tuple(lp_cfg))
            for t, v in enumerate(r["loss"]):
                out["loss"][t][i] = v
            out["grad"].append(r["grad"])
            out["change"].append(r["change"])
        return out

    def program_readings(self):
        r = self.readings
        b = self.images_per_step
        return {"loss": r["loss"],
                "grad": [{k: v[i] for k, v in (r["grad"] or {}).items()} for i in range(b)],
                "change": [{k: v[i] for k, v in (r["change"] or {}).items()} for i in range(b)]}

    # -- the counts ---------------------------------------------------------
    def _renders(self, it):
        """[(cameras, with SR, with backward)] of step `it`, per image: the
        target camera's; every `rot_bs`-th step the rotation and mirror
        terms' surrounding cameras (the mirror term as the cell's yaws turn
        it on), and the depth anchor's tuned and frozen depth renders."""
        c = self.coach
        k = c["rot_bs"]
        out = [(1, True, True)]
        if it % k == 0:
            out += [(k, True, True)] * ((c["rot_lambda"] > 0) + (c["mirror_rot_lambda"] > 0))
            if c["depth_lambda"] > 0:
                out += [(4, False, True), (4, False, False)]
        return out

    def render_passes(self, it):
        b, dt = self.images_per_step, self.dtype
        return [p for cams, _, grad in self._renders(it)
                for p in work.render_passes(self.g, cams * b, b, dt, grad)]

    def bias_act_calls(self, it):
        b, dt = self.images_per_step, self.dtype
        calls = work.synthesis(self.g, b, dt, True)
        for cams, sr, grad in self._renders(it):
            calls += work.render(self.g, cams * b, dt, grad, sr)
        return calls

    def image_step_flops(self):
        from benchmark.harness import load_module

        return load_module("flops", self.ctx.config["name"]).image_step(self.ctx.config,
                                                                         self.ctx.workload)


def _lane_norms(tensors, b):
    """{leaf: [norm of lane i]} of stacked (B, ...) tensors."""
    return {k: v.detach().double().reshape(b, -1).norm(dim=1).tolist() for k, v in tensors.items()}


def build(ctx):
    return Cell(ctx)
