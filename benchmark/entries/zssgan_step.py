"""CLIP-guided editing: the port's
`spi_tpu_torch.editing.zssgan.ZSSGANTrainer.step`, driven as
`spi_tpu_torch.cli.run_editing` drives it (one step, its loss read back as
a float), without the sample grids and checkpoints that loop writes.

Set-up makes the generator's and each CLIP model's weights on the device
from the seed and loads the same tensors into the port's modules, builds
the trainer (a frozen and a trainable twin) and its text-side state with a
stand-in tokenizer, and hands the first `check_steps` steps their z,
noise and renderer draws, so that the plain reference can follow them;
later steps draw from the trainer's generator, seeded from the run's seed.
A loop is the workload's step count; should it end inside the window, the
next seeded edit starts (a new trainer and its text state)."""

from __future__ import annotations

import gc

import torch

from benchmark.counts import eg3d as work
from benchmark.entries._port import triplane_config
from benchmark.harness import generator, sub_seed
from benchmark.reference import clip as ref_clip
from benchmark.reference import eg3d, quant, steps


def _clip_cfg(ctx, name):
    return ctx.config["tiny"]["clip"] if ctx.tiny else ctx.config["clip"][name]


def weights(ctx, dev):
    g = ctx.generator_cfg
    gen = eg3d.make_tensors(eg3d.generator_spec(g), generator(ctx.seed, "generator", dev), dev)
    clips = {name: eg3d.make_tensors(ref_clip.clip_spec(_clip_cfg(ctx, name)),
                                     generator(ctx.seed, f"clip/{name}", dev), dev)
             for name in ctx.config["clip_models"]}
    return gen, clips


def step_draws(g, batch, seed, step, dev):
    """Step `step`'s draws in the trainer's format."""
    gen = generator(seed, f"draws/{step}", dev)
    m = g["neural_rendering_resolution"] ** 2
    noise_shapes = [(name, shape) for name, shape, _ in eg3d.generator_spec(g)
                    if name.startswith("backbone.synthesis.") and name.endswith("noise_const")]

    def render():
        return {"noise": {name: torch.randn((batch, 1, *shape), generator=gen, device=dev)
                          for name, shape in noise_shapes},
                "stratified": torch.rand((batch, m, g["depth_resolution"], 1), generator=gen,
                                         device=dev),
                "exponential": torch.empty(batch * m, g["depth_resolution_importance"] + 1,
                                           device=dev).exponential_(generator=gen)}

    z = torch.randn((batch, g["z_dim"]), generator=gen, device=dev)
    return {"w": {"z": z}, "frozen": render(), "trainable": render()}


class Cell:
    def __init__(self, ctx):
        from spi_tpu_torch.editing.clip_loss import DirectionalCLIPLoss
        from spi_tpu_torch.models.perception.clip import CLIP, CLIPConfig
        from spi_tpu_torch.models.triplane import TriPlaneGenerator

        self.ctx, dev = ctx, ctx.device
        g, wl = ctx.generator_cfg, ctx.workload
        self.g, self.settings = g, dict(wl["editing"])
        self.images_per_step = self.settings["batch"]
        self.warmup, self.check_steps = wl["warmup_steps"], wl["check_steps"]
        self.slice_steps = wl["trace_steps"]
        cfg = triplane_config(g, ctx.config["compute_dtype"])
        P, clips = weights(ctx, dev)
        self.frozen = TriPlaneGenerator(cfg, device=dev)
        self.frozen.load_state_dict(P)
        self.losses, self.weights = {}, {}
        for name, w in zip(ctx.config["clip_models"], wl["clip_weights"]):
            model = CLIP(CLIPConfig(**_clip_cfg(ctx, name)), device=dev)
            model.load_state_dict(clips[name])
            self.losses[name] = DirectionalCLIPLoss(model, lambda_direction=self.settings[
                "lambda_direction"])
            self.weights[name] = w
        del P, clips
        self.tokenizer = ref_clip.CRCTokenizer(_clip_cfg(ctx, ctx.config["clip_models"][0])
                                               ["vocab_size"])
        self.readings = {"loss": [], "grad": None, "change": None}
        self.trainer = self._trainer(0)

    def _trainer(self, loop):
        from spi_tpu_torch.editing.zssgan import EditingSettings, ZSSGANTrainer

        s = self.settings
        settings = EditingSettings(
            source_class=s["source_class"], target_class=s["target_class"], lr=s["lr"],
            g_reg_every=s["g_reg_every"], batch=s["batch"], iterations=s["iterations"],
            truncation=s["truncation"], lambda_direction=s["lambda_direction"])
        trainer = ZSSGANTrainer(self.frozen, self.losses, self.weights, settings,
                                device=self.ctx.device,
                                seed=sub_seed(self.ctx.seed, f"trainer/{loop}"))
        trainer.build_states(self.tokenizer)
        return trainer

    def _read(self, trainer, step):
        """The optimizer's state after the first step, the leaves' change
        after the checked steps."""
        opt = trainer.optimizer
        names = [n for n, p in trainer.trainable.named_parameters() if p.requires_grad]
        params = opt.param_groups[0]["params"]
        with torch.no_grad():
            if step == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                self.readings["grad"] = [{
                    n: float(opt.state[p]["exp_avg"].double().norm()) / (1 - beta1)
                    for n, p in zip(names, params) if "exp_avg" in opt.state.get(p, {})}]
            if step == self.check_steps - 1:
                start = dict(self.frozen.named_parameters())
                self.readings["change"] = [{n: float((p - start[n]).double().norm())
                                            for n, p in zip(names, params)}]

    def run(self, on_step):
        dev, loop = self.ctx.device, 0
        while True:
            trainer = self.trainer if loop == 0 else self._trainer(loop)
            for it in range(self.settings["iterations"]):
                given = loop == 0 and it < self.check_steps
                draws = (step_draws(self.g, self.images_per_step, self.ctx.seed, it, dev)
                         if given else None)
                loss = float(trainer.step(draws))
                if given:
                    self.readings["loss"].append([loss])
                    self._read(trainer, it)
                on_step(it)
            loop += 1

    def slice_starts(self, it):
        return True

    def release(self):
        self.trainer = self.frozen = self.losses = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the yardstick ------------------------------------------------------
    def reference(self, lower=None):
        ctx, dev, g = self.ctx, self.ctx.device, self.g
        P, clips = weights(ctx, dev)
        s = self.settings
        directions = []
        with quant.operands(lower):
            for name, w in zip(ctx.config["clip_models"], ctx.workload["clip_weights"]):
                cfg = _clip_cfg(ctx, name)
                direction = ref_clip.text_direction(clips[name], cfg, self.tokenizer,
                                                    s["source_class"], s["target_class"])
                directions.append((clips[name], cfg, w, direction))
            mask = [k for k, _, _ in eg3d.generator_spec(g) if _trained(k)]
            draws = [step_draws(g, self.images_per_step, ctx.seed, t, dev)
                     for t in range(self.check_steps)]
            r = steps.editing(P, g, directions, mask, s, draws, self.check_steps)
        return {"loss": [[v] for v in r["loss"]], "grad": [r["grad"]], "change": [r["change"]]}

    def program_readings(self):
        return self.readings

    # -- the counts ---------------------------------------------------------
    def render_passes(self, it):
        b = self.images_per_step
        return (work.render_passes(self.g, b, b, "float32", False)
                + work.render_passes(self.g, b, b, "float32", True))

    def bias_act_calls(self, it):
        """The mapping; the frozen twin's render; the trainable twin's, whose
        gradient runs back through every layer to the trained convolutions
        and their affines (ToRGB's and the superresolution's affines do not
        train, and their inputs, the w codes, take no gradient)."""
        b, g = self.images_per_step, self.g
        return (work.mapping(g, b, False)
                + work.synthesis(g, b, "float32", False) + work.render(g, b, "float32", False)
                + work.synthesis(g, b, "float32", True, rgb_affine=False)
                + work.render(g, b, "float32", True, sr_affines=False))

    def image_step_flops(self):
        from benchmark.harness import load_module

        return load_module("flops", self.ctx.config["name"]).image_step(self.ctx.config,
                                                                         self.ctx.workload)


def _trained(name):
    """The leaves StyleGAN-NADA trains on EG3D: every synthesis conv0 / conv1
    subtree of the backbone (not ToRGB, the mapping, the decoder or the
    superresolution)."""
    parts = name.split(".")
    return len(parts) >= 4 and parts[:2] == ["backbone", "synthesis"] \
        and parts[3] in ("conv0", "conv1")


def build(ctx):
    return Cell(ctx)
