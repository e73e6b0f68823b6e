"""LPIPS perceptual distance, VGG16 backbone (counterpart of
spi_tpu/criteria/lpips.py; spec spi/criteria/lpips/lpips.py:32-71).

Inputs in [-1, 1], bilinear-resized to 256 when larger; LPIPS
shift/scale; VGG16 activations at relu1_2..relu5_3, unit-normalized
over channels; squared difference -> 1x1 'lin' head -> spatial mean ->
sum over layers, mean over the batch. Parameters: `net.features.*`
and `lin.0`..`lin.4`, as in the JAX pytree. `compute_dtype='bfloat16'`
runs the VGG on bfloat16 copies of its weights and input and widens its
features to float32 before they are normalized, as spi_tpu's LPIPS.
"""

from __future__ import annotations

import torch
from torch import nn

from spi_tpu_torch.models.perception.vgg import VGG16_CFG, VGGFeatures
from spi_tpu_torch.models.stylegan2 import seeded_init
from spi_tpu_torch.ops import resize_bilinear
from spi_tpu_torch.utils.device import resolve_device
from spi_tpu_torch.utils.params import cast_call
from spi_tpu_torch.utils.stats import span

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _normalize_activation(x, eps=1e-10):
    return x / (x.square().sum(dim=1, keepdim=True).sqrt() + eps)


class LPIPS(nn.Module):
    """LPIPS-VGG16. `cfg` / `target_layers` swap in a smaller VGG for
    tests. device: None means `cuda` (raises without a GPU)."""

    def __init__(self, max_size=256, cfg=VGG16_CFG, target_layers=(3, 8, 15, 22, 29),
                 device=None, seed: int = 1, compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                             f"got {compute_dtype!r}")
        dev = resolve_device(device)
        self.max_size = max_size
        self.compute_dtype = getattr(torch, compute_dtype)
        self.net = VGGFeatures(cfg=cfg, target_layers=target_layers, device=dev)
        self.lin = nn.ParameterList(
            [nn.Parameter(torch.empty(c, device=dev)) for c in self.net.out_channels()])
        self.register_buffer("shift", torch.tensor(_SHIFT, device=dev).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, device=dev).reshape(1, 3, 1, 1),
                             persistent=False)
        seeded_init(self.net, seed)
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in self.lin:  # |N(0, 1)| / C, as the JAX init
                p.copy_(torch.randn(p.shape, generator=gen).abs().to(dev) / p.shape[0])

    def features(self, x):
        """x in [-1, 1], (N, 3, H, W) -> list of unit-normalized activations."""
        with span("spi.lpips"):
            if x.shape[-1] > self.max_size:
                x = resize_bilinear(x, (self.max_size, self.max_size))
            x = (x - self.shift) / self.scale
            feats = cast_call(self.net, self.compute_dtype, x.to(self.compute_dtype))
            return [_normalize_activation(f.float()) for f in feats]

    def forward(self, x, y=None, mask=None, y_feats=None):
        """Distance summed over layers, averaged over the batch. mask:
        optional (N, 1, H, W) in [0, 1], area-pooled to each layer.
        y_feats: precomputed `features(y)`; then y is not read."""
        n = x.shape[0]
        fx = self.features(x)
        fy = y_feats if y_feats is not None else self.features(y)
        total = 0.0
        for f_x, f_y, lin in zip(fx, fy, self.lin):
            diff = (f_x - f_y).square()
            if mask is not None:
                diff = diff * _area_pool_to(mask, diff.shape[-1])
            per_pixel = torch.einsum("nchw,c->nhw", diff, lin)
            total = total + per_pixel.mean(dim=(1, 2)).sum()
        return total / n


def _area_pool_to(mask, size: int):
    n, c, h, w = mask.shape
    f = h // size
    return mask.reshape(n, c, size, f, size, f).mean(dim=(3, 5))
