"""EG3D GAN training: losses, the training step, G_ema and the ADA
heuristic (counterpart of spi_tpu/training/gan.py; spec eg3d/training/
training_loop.py: phase updates with lazy regularization :198-214, the
gradient all-reduce :287-298, the G_ema lerp :305-316, ADA's p :322-326).

One step, in spi_tpu's order:
  1. D: G renders with random noise, without gradient; the generated and
     the real (image, image_raw) pairs go through the ADA pipe and the dual
     discriminator; the logistic D loss, plus every `r1_interval` steps the
     lazy R1 penalty on both real inputs, through the pipe: a second-order
     gradient (`torch.autograd.grad(..., create_graph=True)`), which runs
     the bias_act kernels' backward as the backward of their backward;
  2. Adam on D (beta1 0, the lazy-regularization lr and beta2 scaling);
  3. G: the non-saturating loss through the updated D, plus every
     `density_reg_interval` steps EG3D's density TV (sigma at uniform
     points against sigma at perturbed points, from planes with constant
     noise, as spi_tpu's `sample_mixed` call);
  4. Adam on G;
  5. G_ema <- G_ema * beta + G * (1 - beta), over G's trainable leaves
     (its parameters and constant noise maps); the other buffers copied.
A regularizer runs on `step % interval == 0`, a Python `if`.

Across processes (one a card under torchrun, `torch.distributed`
initialized), each process runs its own shard of the batch and the
gradients, with `rt`, are averaged over the processes before each Adam
step, and the metrics after it: spi_tpu's pmean over its mesh axis.

Every random number of a step (each render's noise maps and renderer
draws, the pipe's draws, density TV's points and offsets) comes from the
trainer's `torch.Generator`, or from the `draws` a caller hands `step`
(tests hand spi_tpu's).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from spi_tpu_torch.models.discriminator import DualDiscriminator, filtered_resizing
from spi_tpu_torch.models.rendering import RenderingOptions
from spi_tpu_torch.models.rendering.renderer import draw_randoms
from spi_tpu_torch.models.triplane import TriPlaneConfig, TriPlaneGenerator
from spi_tpu_torch.utils.device import module_device, resolve_device
from spi_tpu_torch.utils.params import to_device

DENSITY_POINTS = 1000  # density TV's points an image


def tiny_gan_config(**overrides) -> TriPlaneConfig:
    """The tiny generator of spi_tpu's GAN tests (tests/test_gan.py:20-32):
    128^2 output through the 2X superresolution, 16^2 neural render, 4 + 4
    depth samples."""
    defaults = dict(
        z_dim=16, c_dim=25, w_dim=16, img_resolution=128, backbone_resolution=32,
        neural_rendering_resolution=16,
        rendering=RenderingOptions(depth_resolution=4, depth_resolution_importance=4),
        sr_variant="SuperresolutionHybrid2X", channel_base=512, channel_max=32,
    )
    defaults.update(overrides)
    return TriPlaneConfig(**defaults)


# The tiny dual discriminator of the same tests (tests/test_gan.py:78-85).
TINY_DISCRIMINATOR = dict(img_resolution=128, channel_base=1024, channel_max=32)


@dataclasses.dataclass(frozen=True)
class GANConfig:
    batch_per_device: int = 4
    g_lr: float = 0.0025
    d_lr: float = 0.002
    beta2: float = 0.99
    r1_gamma: float = 1.0
    r1_interval: int = 16
    density_reg: float = 0.25
    density_reg_p_dist: float = 0.004  # EG3D config: perturbation distance
    density_reg_interval: int = 4
    ema_kimg: float = 10.0
    ada_target: float = 0.6
    ada_interval: int = 4
    ada_kimg: float = 500.0
    style_mixing_prob: float = 0.0

    def ema_beta(self, total_batch: int) -> float:
        # training_loop.py:305-310: beta = 0.5 ** (batch / max(ema_kimg * 1000, 1e-8))
        return 0.5 ** (total_batch / max(self.ema_kimg * 1000.0, 1e-8))

    def adam(self, which: str) -> dict:
        """torch.optim.Adam's arguments for 'g' or 'd': lr * mb, betas (0,
        beta2 ** mb), mb = interval / (interval + 1) of its regularizer."""
        interval = self.density_reg_interval if which == "g" else self.r1_interval
        mb = interval / (interval + 1)
        lr = self.g_lr if which == "g" else self.d_lr
        return {"lr": lr * mb, "betas": (0.0, self.beta2**mb), "eps": 1e-8}


def logistic_g_loss(gen_logits):
    """Non-saturating G loss: softplus(-D(G(z)))."""
    return F.softplus(-gen_logits).mean()


def logistic_d_loss(real_logits, gen_logits):
    """D loss: softplus(D(G(z))) + softplus(-D(real))."""
    return F.softplus(gen_logits).mean() + F.softplus(-real_logits).mean()


def _world() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _mean_over_processes(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor averaged over the processes: one all-reduce of their
    concatenation (training_loop.py:287-298's flat gradient)."""
    world = _world()
    if world == 1:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


class GANTrainer:
    """G, D, G_ema and their optimizers. generator: a TriPlaneGenerator;
    discriminator: a DualDiscriminator, both on `device` (None means the
    card; raises without a GPU). augment: an AugmentPipe applied to both
    real and generated pairs, or None."""

    def __init__(self, generator: TriPlaneGenerator, discriminator: DualDiscriminator,
                 config: GANConfig = GANConfig(), augment=None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        for name, m in (("generator", generator), ("discriminator", discriminator)):
            if module_device(m) != self.device:
                raise ValueError(f"the {name} is on {module_device(m)}, the trainer on "
                                 f"{self.device}")
        self.generator = generator
        self.discriminator = discriminator
        self.config = config
        self.augment = augment
        self.g_ema = copy.deepcopy(generator).eval().requires_grad_(False)
        # G's trainable leaves, by name: its parameters and, as in spi_tpu
        # (whose G is one tree that jax.grad and Adam see whole), its
        # constant noise maps, which density TV's constant-noise planes
        # reach. EG3D keeps those as buffers.
        self.g_leaves = dict(generator.named_parameters())
        for name, buf in generator.named_buffers():
            if name.endswith("noise_const"):
                self.g_leaves[name] = buf.requires_grad_(True)
        self.g_params = list(self.g_leaves.values())
        self.d_params = list(discriminator.parameters())
        self.g_opt = torch.optim.Adam(self.g_params, **config.adam("g"))
        self.d_opt = torch.optim.Adam(self.d_params, **config.adam("d"))
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self.step_count = 0

    # -- draws -------------------------------------------------------------
    def draw_render(self, n: int, generator) -> dict:
        """One render's draws: noise maps and the renderer's numbers."""
        cfg = self.generator.cfg
        return {"noise": self.generator.draw_noise(n, generator),
                **draw_randoms(cfg.rendering, n, cfg.neural_rendering_resolution ** 2,
                               self.device, generator)}

    def draw_augment(self, n: int, generator) -> dict | None:
        if self.augment is None:
            return None
        cfg = self.generator.cfg
        shapes = [(3, cfg.img_resolution, cfg.img_resolution),
                  (3, cfg.neural_rendering_resolution, cfg.neural_rendering_resolution)]
        return self.augment.draw(n, generator, self.device, shapes)

    def draw(self, n: int, generator=None) -> dict:
        """One step's draws for a batch of n: {'d': {'render', 'aug_gen',
        'aug_real'}, 'g': {'render', 'aug', 'density_uniform',
        'density_normal'}}, from `generator` (default the trainer's)."""
        gen = self.rng if generator is None else generator
        d = {"render": self.draw_render(n, gen), "aug_gen": self.draw_augment(n, gen),
             "aug_real": self.draw_augment(n, gen)}
        g = {"render": self.draw_render(n, gen), "aug": self.draw_augment(n, gen)}
        shape = (n, DENSITY_POINTS, 3)
        g["density_uniform"] = torch.rand(shape, generator=gen, device=self.device)
        g["density_normal"] = torch.randn(shape, generator=gen, device=self.device)
        return {"d": d, "g": g}

    # -- loss pieces ---------------------------------------------------------
    def _g_images(self, z, c, render_draws):
        ws = self.generator.mapping(z, c)
        out = self.generator.synthesis(ws, c, noise_mode="random", draws=render_draws)
        return out, ws

    def _augment_pair(self, image, image_raw, p, draws):
        """The pipe on both images with one set of draws (spi_tpu replays one
        key at both resolutions)."""
        if self.augment is None:
            return image, image_raw
        return self.augment.apply(image, p, draws), self.augment.apply(image_raw, p, draws)

    def _d(self, image, image_raw, c):
        return self.discriminator({"image": image, "image_raw": image_raw}, c)

    def d_loss(self, real, z, c, draws, step: int, aug_p: float = 0.0):
        """-> (loss, {'rt': E[sign D(real)], 'r1': the R1 term or None})."""
        cfg = self.config
        with torch.no_grad():
            out, _ = self._g_images(z, c, draws["render"])
        gen_logits = self._d(*self._augment_pair(out["image"], out["image_raw"], aug_p,
                                                 draws["aug_gen"]), c)
        do_r1 = cfg.r1_gamma > 0 and step % cfg.r1_interval == 0
        real = real.detach().requires_grad_(do_r1)
        real_raw = filtered_resizing(real.detach(), self.generator.cfg.neural_rendering_resolution)
        real_raw.requires_grad_(do_r1)
        # The pipe inside: R1 penalizes the gradient with respect to the raw
        # real images, through the (differentiable) pipe.
        real_logits = self._d(*self._augment_pair(real, real_raw, aug_p, draws["aug_real"]), c)
        loss = logistic_d_loss(real_logits, gen_logits)
        r1 = None
        if do_r1:
            grads = torch.autograd.grad(real_logits.sum(), (real, real_raw), create_graph=True)
            penalty = sum(g.square().sum(dim=(1, 2, 3)) for g in grads)
            r1 = penalty.mean() * (cfg.r1_gamma / 2) * cfg.r1_interval
            loss = loss + r1
        return loss, {"rt": torch.sign(real_logits.detach()).mean(), "r1": r1}

    def g_loss(self, z, c, draws, step: int, aug_p: float = 0.0):
        """-> (loss, {'fake_score': mean D(G(z)), 'density_tv': the term or
        None})."""
        cfg = self.config
        out, ws = self._g_images(z, c, draws["render"])
        logits = self._d(*self._augment_pair(out["image"], out["image_raw"], aug_p,
                                             draws["aug"]), c)
        loss = logistic_g_loss(logits)
        tv = None
        if cfg.density_reg > 0 and step % cfg.density_reg_interval == 0:
            # EG3D's 'l1' density regularization, with the lazy gain of its
            # interval; the planes with constant noise, once for both probes.
            g = self.generator
            pts = (draws["density_uniform"] - 0.5) * g.cfg.rendering.box_warp
            offset = draws["density_normal"] * cfg.density_reg_p_dist
            dirs = torch.zeros_like(pts)
            planes = g.planes_nhwc(ws, noise_mode="const")
            _, sigma_a = g.sample_mixed(ws, pts, dirs, planes=planes)
            _, sigma_b = g.sample_mixed(ws, pts + offset, dirs, planes=planes)
            tv = (sigma_a - sigma_b).abs().mean() * cfg.density_reg * cfg.density_reg_interval
            loss = loss + tv
        return loss, {"fake_score": logits.detach().mean(), "density_tv": tv}

    # -- the step --------------------------------------------------------------
    @staticmethod
    def _grads(loss, params):
        """d loss / d params, zeros for a parameter the loss does not reach
        (optax's Adam sees a zero gradient there, and so must torch's)."""
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    @staticmethod
    def _apply(opt, params, grads):
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()

    def step(self, real, z, c, aug_p: float = 0.0, draws: dict | None = None) -> dict:
        """One training step on this process's shard: real (N, 3, R, R) in
        [-1, 1], z (N, z_dim), c (N, c_dim). draws: as `draw` gives, else
        drawn from the trainer's generator. Returns {'loss_g', 'loss_d',
        'rt', 'fake_score'} (0-dim tensors, averaged over the processes).
        After it each parameter's `.grad` holds the gradient it was updated
        with."""
        cfg = self.config
        n = real.shape[0]
        d = self.draw(n) if draws is None else to_device(draws, self.device)
        step = self.step_count

        d_loss, d_aux = self.d_loss(real, z, c, d["d"], step, aug_p)
        *d_grads, rt = _mean_over_processes(self._grads(d_loss, self.d_params)
                                            + [d_aux["rt"]])
        self._apply(self.d_opt, self.d_params, d_grads)

        g_loss, g_aux = self.g_loss(z, c, d["g"], step, aug_p)
        g_grads = _mean_over_processes(self._grads(g_loss, self.g_params))
        self._apply(self.g_opt, self.g_params, g_grads)

        beta = cfg.ema_beta(cfg.batch_per_device * _world())
        with torch.no_grad():
            ema = self.g_ema.state_dict()
            for name, t in self.generator.state_dict().items():
                e = ema[name]
                e.copy_(e * beta + t * (1 - beta) if name in self.g_leaves else t)
        self.step_count += 1
        loss_g, loss_d, fake_score = _mean_over_processes(
            [g_loss.detach(), d_loss.detach(), g_aux["fake_score"]])
        return {"loss_g": loss_g, "loss_d": loss_d, "rt": rt, "fake_score": fake_score}


def adjust_ada_p(p: float, rt: float, config: GANConfig, total_batch: int) -> float:
    """ADA's probability update (training_loop.py:322-326): move p so as to
    keep E[sign(D(real))] at ada_target. In float32, as spi_tpu's."""
    f32 = np.float32
    adjust = (f32(np.sign(rt - config.ada_target)) * f32(total_batch * config.ada_interval)
              / f32(config.ada_kimg * 1000))
    return float(np.clip(f32(p) + adjust, f32(0.0), f32(1.0)))
