"""StyleCLIP latent mapper, text-conditioned w+ edits (counterpart of
spi_tpu/editing/styleclip_mapper.py; spec ZSSGAN/mapper/latent_mappers.py:
8-59, ZSSGAN/mapper/styleclip_mapper.py and the objective of
ZSSGAN/mapper/training/coach.py).

`Mapper`: PixelNorm once, then `depth` EqualLinear(dim, lr_mul 0.01)
layers with fused leaky ReLU. `LevelsMapper`: separate coarse (w 0:4),
medium (4:8) and fine (8:) mappers, each optional. `StyleCLIPCoach`
trains one with Adam so that G(w + 0.1 M(w)) matches a text prompt.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from spi_tpu_torch.models.stylegan2 import seeded_init
from spi_tpu_torch.utils.device import module_device, resolve_device


def _pixel_norm(x, eps: float = 1e-8):
    return x * (x.square().mean(dim=-1, keepdim=True) + eps).rsqrt()


class _EqualLinear(nn.Module):
    """Weights stored divided by lr_mul, applied at lr_mul / sqrt(dim)."""

    def __init__(self, dim, lr_mul, device=None):
        super().__init__()
        self.lr_mul = lr_mul
        self.weight = nn.Parameter(torch.empty(dim, dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=gen) / self.lr_mul)
            self.bias.zero_()

    def forward(self, x):
        scale = self.lr_mul / math.sqrt(self.weight.shape[1])
        x = x @ (self.weight.T * scale) + self.bias * self.lr_mul
        return F.leaky_relu(x, 0.2) * math.sqrt(2.0)


class Mapper(nn.Module):
    """PixelNorm at the input, then `depth` x EqualLinear(dim, lr_mul=0.01,
    activation='fused_lrelu') (latent_mappers.py:8-28); layers "0".."3"."""

    def __init__(self, dim=512, depth=4, lr_mul=0.01, device=None):
        super().__init__()
        for i in range(depth):
            self.add_module(str(i), _EqualLinear(dim, lr_mul, device))
        self.depth = depth

    def forward(self, x):
        x = _pixel_norm(x)
        for i in range(self.depth):
            x = getattr(self, str(i))(x)
        return x


_LEVELS = (("course_mapping", slice(0, 4)),  # sic: the upstream name
           ("medium_mapping", slice(4, 8)),
           ("fine_mapping", slice(8, None)))


class LevelsMapper(nn.Module):
    """Independent mappers over the coarse / medium / fine w+ slices
    (latent_mappers.py:31-59); a level not used gives a zero delta.

    device: None means the card (raises without a GPU)."""

    def __init__(self, dim=512, num_ws=14, use_coarse=True, use_medium=True, use_fine=True,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_ws = num_ws
        for (name, _), use in zip(_LEVELS, (use_coarse, use_medium, use_fine)):
            if use:
                self.add_module(name, Mapper(dim, device=dev))
        seeded_init(self, seed)

    def forward(self, w):
        """w: (N, num_ws, dim) -> the delta, of the same shape."""
        parts = []
        for name, sl in _LEVELS:
            part = w[:, sl]
            parts.append(getattr(self, name)(part) if hasattr(self, name)
                         else torch.zeros_like(part))
        return torch.cat(parts, dim=1)


@dataclasses.dataclass(frozen=True)
class StyleCLIPSettings:
    lr: float = 0.5
    edit_scale: float = 0.1  # styleclip_mapper.py: w + 0.1 * mapper(w)
    id_lambda: float = 0.1
    latent_l2_lambda: float = 0.8
    batch: int = 2


class StyleCLIPCoach:
    """Trains a LevelsMapper (Adam at `settings.lr`) so that
    G(w + edit_scale M(w)) matches a text prompt.

    device: None means the card (raises without a GPU); the mapper must
    be on it."""

    def __init__(self, mapper: LevelsMapper, settings: StyleCLIPSettings = StyleCLIPSettings(),
                 device=None):
        self.device = resolve_device(device)
        if module_device(mapper) != self.device:
            raise ValueError(f"the mapper is on {module_device(mapper)}, the coach on "
                             f"{self.device}")
        self.mapper = mapper
        self.settings = settings
        self.optimizer = torch.optim.Adam(mapper.parameters(), lr=settings.lr)

    def loss(self, render, clip_global_loss, target_tokens, ws, id_loss=None):
        """render(ws) -> image (the generator with its draws);
        clip_global_loss(img, tokens); id_loss(edited, original) or None.
        The objective: the CLIP loss, latent L2 (MSE of w_hat against w,
        coach.py:211) and, with id_lambda > 0, the ID term against a
        no-grad render of the original w."""
        s = self.settings
        delta = s.edit_scale * self.mapper(ws)
        img_edit = render(ws + delta)
        loss = clip_global_loss(img_edit, target_tokens)
        loss = loss + s.latent_l2_lambda * delta.square().mean()
        if id_loss is not None and s.id_lambda > 0:
            with torch.no_grad():
                img_orig = render(ws)
            loss = loss + s.id_lambda * id_loss(img_edit, img_orig)
        return loss

    def step(self, render, clip_global_loss, target_tokens, ws, id_loss=None):
        """One Adam step of the mapper; returns the loss."""
        loss = self.loss(render, clip_global_loss, target_tokens, ws.to(self.device), id_loss)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()
