"""Noise-buffer regularizer and renormalization (counterpart of
spi_tpu/criteria/noise_reg.py; spec spi w_projector.py:90-110)."""

from __future__ import annotations

import torch


def noise_regularization(noise: dict):
    """For each noise map: sum over a 2x average-pooled pyramid (down to
    8 px) of the squared mean of noise * roll(noise), along both axes."""
    reg = 0.0
    for v in noise.values():
        x = v[None, None]
        while True:
            reg = reg + (x * torch.roll(x, shifts=1, dims=3)).mean().square()
            reg = reg + (x * torch.roll(x, shifts=1, dims=2)).mean().square()
            if x.shape[2] <= 8:
                break
            n, c, h, w = x.shape
            x = x.reshape(n, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
    return reg


@torch.no_grad()
def normalize_noise(noise: dict) -> None:
    """Zero-mean unit-variance renormalization of each map, in place: over
    its last two axes, so that (B, H, W) maps of B images are renormalized
    image by image."""
    for v in noise.values():
        v.sub_(v.mean(dim=(-2, -1), keepdim=True))
        v.mul_(v.square().mean(dim=(-2, -1), keepdim=True).rsqrt())
