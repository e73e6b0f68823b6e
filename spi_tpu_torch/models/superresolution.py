"""Superresolution networks (counterpart of spi_tpu/models/superresolution.py;
spec EG3D superresolution.py).

The FFHQ-512 checkpoint uses SuperresolutionHybrid8XDC (:264-290): two
synthesis blocks (32->256 @256, 256->128 @512) fed the last w repeated
3x. The other Hybrid variants start with a no-upsample block.
"""

from __future__ import annotations

from torch import nn

from spi_tpu_torch.models.stylegan2 import SynthesisBlock
from spi_tpu_torch.ops import resize_bilinear

# variant -> (input resolution, block0 width, block0 resolution, block0 up, block1 width)
_VARIANTS = {
    "SuperresolutionHybrid8XDC": (128, 256, 256, 2, 128),
    "SuperresolutionHybrid8X": (128, 128, 256, 2, 64),
    "SuperresolutionHybrid4X": (128, 128, 128, 1, 64),
    "SuperresolutionHybrid2X": (64, 128, 64, 1, 64),
}


class Superresolution(nn.Module):
    """Two-block SR network covering the Hybrid variants. `channel_max`
    clamps the block widths (None keeps the reference widths)."""

    def __init__(self, variant, img_resolution, channels=32, sr_antialias=True, w_dim=512,
                 channel_max=None, device=None):
        super().__init__()
        if variant not in _VARIANTS:
            raise ValueError(f"unknown superresolution variant {variant!r}")
        in_res, ch0, res0, up0, ch1 = _VARIANTS[variant]
        if img_resolution != 2 * res0:
            raise ValueError(f"{variant} outputs {2 * res0}^2, but img_resolution={img_resolution}")

        def clamp(ch):
            return ch if channel_max is None else min(ch, channel_max)

        self.variant = variant
        self.input_resolution = in_res
        self.sr_antialias = sr_antialias
        self.block0 = SynthesisBlock(channels, clamp(ch0), w_dim=w_dim, resolution=res0,
                                     img_channels=3, is_last=False, conv_clamp=None,
                                     up=up0, device=device)
        self.block1 = SynthesisBlock(clamp(ch0), clamp(ch1), w_dim=w_dim,
                                     resolution=img_resolution, img_channels=3, is_last=True,
                                     conv_clamp=None, up=2, device=device)

    def forward(self, rgb, x, ws, noise_mode="none"):
        """rgb: (N, 3, r, r); x: (N, C, r, r); ws: (N, L, w_dim)."""
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        if x.shape[-1] != self.input_resolution:
            size = (self.input_resolution, self.input_resolution)
            x = resize_bilinear(x, size, antialias=self.sr_antialias)
            rgb = resize_bilinear(rgb, size, antialias=self.sr_antialias)
        x, rgb = self.block0(x, rgb, ws, noise_mode=noise_mode)
        _, rgb = self.block1(x, rgb, ws, noise_mode=noise_mode)
        return rgb
