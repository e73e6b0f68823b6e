"""Twin-generator CLIP editing over a plain 2D StyleGAN2 (counterpart of
spi_tpu/editing/zssgan2d.py; spec ZSSGAN/model/ZSSGAN.py + ZSSGAN/train.py).

The same step as the EG3D trainer over `models/stylegan2.Generator`: no
camera, style mixing of two z codes at a random crossover layer with
probability `mixing_prob`, and the synthesis convolutions plus the
learned constant input as the trainable set.
"""

from __future__ import annotations

import torch

from spi_tpu_torch.editing.zssgan import EditingSettings, TwinGeneratorTrainer, _select


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

    def draw_w(self, n, generator):
        """{'z1', 'z2': (n, z_dim), 'mix': (n,) U[0, 1), 'cross': (n,) in
        [1, num_ws)}, in spi_tpu's order of keys."""
        dev, z_dim = self.device, self.frozen.mapping.z_dim
        return {"z1": torch.randn((n, z_dim), generator=generator, device=dev),
                "z2": torch.randn((n, z_dim), generator=generator, device=dev),
                "mix": torch.rand((n,), generator=generator, device=dev),
                "cross": torch.randint(1, self.frozen.num_ws, (n,), generator=generator,
                                       device=dev)}

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

    def draw_render(self, n, generator):
        return {"noise": self.frozen.synthesis.draw_noise(n, generator)}

    def render(self, g, ws, render_draws):
        return g.synthesis(ws, noise_mode="random", noise=render_draws["noise"])

    def grad_mask(self, module):
        return conv_mask_2d(module)
