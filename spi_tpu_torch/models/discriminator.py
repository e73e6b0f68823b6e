"""StyleGAN2 discriminator and EG3D's dual discriminator (counterpart of
spi_tpu/models/discriminator.py; spec eg3d/training/networks_stylegan2.py:
557-795 and eg3d/training/dual_discriminator.py:21-200).

Resnet blocks from the image resolution down to 8, a minibatch-stddev
epilogue at 4^2, and a conditioning mapping network on the camera label
whose output projects the epilogue's features. The dual discriminator
sees the superresolved image concatenated with the raw neural render
resized (bilinear, antialiased) to the image's resolution: 6 channels.

Parameter names are spi_tpu's flattened keys (`b512.fromrgb.weight`,
`mapping.fc0.bias`, `b4.out.weight`, ...), so `utils/checkpoint.
load_flat_params` reads spi_tpu's discriminator tree as it is. Every layer
computes in float32 (spi_tpu drops the reference's fp16 resolutions too);
the activations go through `bias_act`, on the card its kernels, which
differentiate twice, as the lazy R1 penalty needs.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from spi_tpu_torch.models.stylegan2 import (
    FullyConnected,
    MappingNetwork,
    _normal,
    _resample_filter_buffer,
    seeded_init,
)
from spi_tpu_torch.ops import bias_act, gradfix, resize_bilinear
from spi_tpu_torch.ops.bias_act import activation_funcs
from spi_tpu_torch.utils.device import resolve_device


class ConvLayer(nn.Module):
    """Conv2dLayer (networks_stylegan2.py:135-190): a normalized-weight
    convolution with optional downsampling through the [1, 3, 3, 1] filter
    (the discriminator never upsamples), then bias, activation, gain and
    clamp."""

    def __init__(self, in_channels, out_channels, kernel_size, bias=True, activation="linear",
                 down=1, conv_clamp=None, device=None):
        super().__init__()
        self.in_channels = in_channels
        self.kernel_size = kernel_size
        self.activation = activation
        self.down = down
        self.conv_clamp = conv_clamp
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device)) if bias else None
        _resample_filter_buffer(self, device)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(_normal(self.weight.shape, gen, self.weight.device))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x, gain: float = 1.0):
        w = self.weight * (1 / math.sqrt(self.in_channels * self.kernel_size**2))
        # gradfix: lazy R1 differentiates every convolution twice.
        x = gradfix.conv2d_resample(x, w, f=self.resample_filter, down=self.down,
                                    padding=self.kernel_size // 2)
        act_gain = activation_funcs[self.activation].def_gain * gain
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=clamp)


class DiscriminatorBlock(nn.Module):
    """networks_stylegan2.py:557-645, resnet architecture; in_channels 0
    marks the first block, which reads the image through `fromrgb`."""

    def __init__(self, in_channels, tmp_channels, out_channels, img_channels,
                 activation="lrelu", conv_clamp=256.0, device=None):
        super().__init__()
        if in_channels == 0:
            self.fromrgb = ConvLayer(img_channels, tmp_channels, 1, activation=activation,
                                     conv_clamp=conv_clamp, device=device)
        self.conv0 = ConvLayer(tmp_channels, tmp_channels, 3, activation=activation,
                               conv_clamp=conv_clamp, device=device)
        self.conv1 = ConvLayer(tmp_channels, out_channels, 3, activation=activation, down=2,
                               conv_clamp=conv_clamp, device=device)
        self.skip = ConvLayer(tmp_channels, out_channels, 1, bias=False, down=2, device=device)

    def forward(self, x, img):
        if hasattr(self, "fromrgb"):
            y = self.fromrgb(img)
            x = x + y if x is not None else y
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv0(x)
        x = self.conv1(x, gain=math.sqrt(0.5))
        return y + x


def minibatch_stddev(x, group_size: int = 4, num_channels: int = 1):
    """MinibatchStdLayer (networks_stylegan2.py:648-676): the group is
    min(group_size, N), lowered until it divides N, of this process's batch
    (one process a card, as spi_tpu's per-device shard)."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    while n % g != 0:
        g -= 1
    f = num_channels
    y = x.reshape(g, n // g, f, c // f, h, w)
    y = y - y.mean(dim=0)
    y = (y.square().mean(dim=0) + 1e-8).sqrt()
    y = y.mean(dim=(2, 3, 4)).reshape(-1, f, 1, 1)
    return torch.cat([x, y.repeat(g, 1, h, w)], dim=1)


class DiscriminatorEpilogue(nn.Module):
    """networks_stylegan2.py:678-733."""

    def __init__(self, in_channels, cmap_dim, resolution=4, mbstd_group_size=4,
                 mbstd_num_channels=1, activation="lrelu", conv_clamp=256.0, device=None):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        self.conv = ConvLayer(in_channels + mbstd_num_channels, in_channels, 3,
                              activation=activation, conv_clamp=conv_clamp, device=device)
        self.fc = FullyConnected(in_channels * resolution**2, in_channels, activation=activation,
                                 device=device)
        self.out = FullyConnected(in_channels, 1 if cmap_dim == 0 else cmap_dim, device=device)

    def forward(self, x, cmap=None):
        if self.mbstd_num_channels > 0:
            x = minibatch_stddev(x, self.mbstd_group_size, self.mbstd_num_channels)
        x = self.conv(x)
        x = self.fc(x.reshape(x.shape[0], -1))
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) / math.sqrt(self.cmap_dim)
        return x


class Discriminator(nn.Module):
    """The single-image discriminator (networks_stylegan2.py:735-795,
    dual_discriminator.py:21-80). device: None means `cuda` (raises without
    a GPU); weights are drawn from `seed` as spi_tpu's init draws them
    (normal weights, zero biases)."""

    def __init__(self, c_dim, img_resolution, img_channels=3, channel_base=32768,
                 channel_max=512, conv_clamp=256.0, cmap_dim=None, disc_c_noise=0.0,
                 device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.c_dim = c_dim
        self.img_resolution = img_resolution
        self.disc_c_noise = disc_c_noise
        log2 = int(math.log2(img_resolution))
        self.block_resolutions = [2**i for i in range(log2, 2, -1)]

        def channels(res):
            return min(channel_base // res, channel_max)

        if c_dim == 0:
            cmap_dim = 0
        elif cmap_dim is None:
            cmap_dim = channels(4)
        for res in self.block_resolutions:
            self.add_module(f"b{res}", DiscriminatorBlock(
                channels(res) if res < img_resolution else 0, channels(res), channels(res // 2),
                img_channels, conv_clamp=conv_clamp, device=dev))
        if c_dim > 0:
            self.mapping = MappingNetwork(0, c_dim, cmap_dim, num_ws=None, w_avg_beta=None,
                                          device=dev)
        self.b4 = DiscriminatorEpilogue(channels(4), cmap_dim, conv_clamp=conv_clamp, device=dev)
        seeded_init(self, seed)

    def forward(self, img, c, generator=None):
        """img (N, img_channels, R, R), c (N, c_dim) -> logits (N, 1).
        With disc_c_noise > 0, the label noise is drawn from `generator`."""
        x = None
        for res in self.block_resolutions:
            x = getattr(self, f"b{res}")(x, img if x is None else None)
        cmap = None
        if self.c_dim > 0:
            cc = c
            if self.disc_c_noise > 0 and generator is not None:
                noise = torch.randn(c.shape, generator=generator, device=c.device)
                cc = c + noise * c.std(dim=0, unbiased=False) * self.disc_c_noise
            cmap = self.mapping(None, cc)
        return self.b4(x, cmap)


def filtered_resizing(image, size: int):
    """dual_discriminator.py:86-102, the default 'antialiased' mode."""
    return resize_bilinear(image, (size, size), antialias=True)


class DualDiscriminator(Discriminator):
    """EG3D's dual discriminator (dual_discriminator.py:107-200): the image
    concatenated with the raw render resized to it, 6 channels."""

    def __init__(self, c_dim, img_resolution, img_channels=6, **kwargs):
        super().__init__(c_dim, img_resolution, img_channels=img_channels, **kwargs)

    def forward(self, img: dict, c, generator=None):
        image_raw = filtered_resizing(img["image_raw"], img["image"].shape[-1])
        x = torch.cat([img["image"], image_raw], dim=1)
        return super().forward(x, c, generator=generator)
