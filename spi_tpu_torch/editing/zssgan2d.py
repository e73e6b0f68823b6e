"""Twin-generator CLIP editing over a plain 2D StyleGAN2 (counterpart of
spi_tpu/editing/zssgan2d.py; spec ZSSGAN/model/ZSSGAN.py + ZSSGAN/train.py).

The same step as the EG3D trainer over `models/stylegan2.Generator`: no
camera, style mixing of two z codes at a random crossover layer with
probability `mixing_prob`, and the synthesis convolutions plus the
learned constant input as the trainable set.

`ZSSGANSG3Trainer` runs the same step over `models/stylegan3.SG3Generator`
(StyleGAN-NADA over an alias-free generator): no noise inputs and no
renderer, so a render has no draws; every synthesis layer but ToRGB
trains (its modulated convolution, bias and affine), while the input, the
mapping and the buffers (`magnitude_ema`, the input's `transform`,
`freqs`, `phases`, the FIR filters) stay as loaded: the twins render with
`update_emas=False`. Its CLIP losses resize a render bicubically, as
StyleGAN-NADA's CLIP preprocess does (`Resize(BICUBIC)` + `CenterCrop`):
at 1024^2 -> 224^2 a bilinear tap reads 2x2 pixels, a bicubic one 4x4.
"""

from __future__ import annotations

import dataclasses

import torch

from spi_tpu_torch.editing.zssgan import EditingSettings, TwinGeneratorTrainer, _select
from spi_tpu_torch.utils.stats import span


def conv_mask_2d(module) -> set[str]:
    """The flat keys of synthesis.b{res}.conv0 / conv1 and of
    synthesis.b4.const: the reference's default training set,
    get_all_layers()[1:3] + the convolutions (ZSSGAN.py
    get_training_layers), whose [1:3] covers the constant input."""
    return _select(module, lambda n: len(n) >= 3 and n[0] == "synthesis"
                   and (n[2] in ("conv0", "conv1") or n[-1] == "const"))


class ZSSGAN2DTrainer(TwinGeneratorTrainer):
    """frozen: a models/stylegan2.Generator. mixing_prob: train.py's
    --mixing."""

    def __init__(self, frozen, clip_losses, clip_weights,
                 settings: EditingSettings = EditingSettings(), trainable=None, device=None,
                 seed: int = 0, mixing_prob: float = 0.0):
        self.mixing_prob = mixing_prob
        super().__init__(frozen, clip_losses, clip_weights, settings, trainable, device, seed)

    def draw_w(self, n, generator, out=None):
        """{'z1', 'z2': (n, z_dim), 'mix': (n,) U[0, 1), 'cross': (n,) in
        [1, num_ws)}, in spi_tpu's order of keys."""
        dev, z_dim, out = self.device, self.frozen.mapping.z_dim, out or {}
        return {"z1": torch.randn((n, z_dim), generator=generator, device=dev, out=out.get("z1")),
                "z2": torch.randn((n, z_dim), generator=generator, device=dev, out=out.get("z2")),
                "mix": torch.rand((n,), generator=generator, device=dev, out=out.get("mix")),
                "cross": torch.randint(1, self.frozen.num_ws, (n,), generator=generator,
                                       device=dev, out=out.get("cross"))}

    @torch.no_grad()
    def sample_w(self, w_draws, truncation=None):
        """mixing_noise + mapping: with probability `mixing_prob` two z are
        mapped and crossed over at layer `cross`."""
        psi = self.settings.truncation if truncation is None else truncation
        z1 = w_draws["z1"]
        c = torch.zeros(z1.shape[0], 0, device=self.device)
        w1 = self.frozen.mapping(z1, c, truncation_psi=psi)
        if self.mixing_prob <= 0:
            return w1
        w2 = self.frozen.mapping(w_draws["z2"], c, truncation_psi=psi)
        layer = torch.arange(self.frozen.num_ws, device=self.device)[None, :, None]
        mixed = torch.where(layer < w_draws["cross"][:, None, None], w1, w2)
        use_mix = (w_draws["mix"] < self.mixing_prob)[:, None, None]
        return torch.where(use_mix, mixed, w1)

    def draw_render(self, n, generator, out=None):
        return {"noise": self.frozen.synthesis.draw_noise(n, generator, (out or {}).get("noise"))}

    def render(self, g, ws, render_draws):
        return g.synthesis(ws, noise_mode="random", noise=render_draws["noise"])

    def grad_mask(self, module):
        return conv_mask_2d(module)


def sg3_layer_mask(module) -> set[str]:
    """The parameter names of every SG3 synthesis layer but ToRGB
    (`synthesis.L{idx}_{size}_{channels}.{weight, bias, affine.*}`, idx <
    num_layers): not the input, the mapping or any buffer."""
    syn = module.synthesis
    return {f"synthesis.{name}.{k}" for name in syn.layer_names
            if not getattr(syn, name).is_torgb
            for k, _ in getattr(syn, name).named_parameters()}


class ZSSGANSG3Trainer(ZSSGAN2DTrainer):
    """frozen: a models/stylegan3.SG3Generator. The mapping and style mixing
    are the 2D trainer's (SG3 has StyleGAN2's mapping and `num_ws`); each
    of `clip_losses` is taken with `resize='bicubic'`."""

    def __init__(self, frozen, clip_losses, clip_weights, *args, **kwargs):
        clip_losses = {name: dataclasses.replace(loss, resize="bicubic")
                       for name, loss in clip_losses.items()}
        super().__init__(frozen, clip_losses, clip_weights, *args, **kwargs)

    def sample_w(self, w_draws, truncation=None):
        with span("spi.mapping"):
            return super().sample_w(w_draws, truncation)

    def draw_render(self, n, generator, out=None):
        return {}

    def render(self, g, ws, render_draws):
        return g.synthesis(ws, update_emas=False)

    def grad_mask(self, module):
        return sg3_layer_mask(module)
