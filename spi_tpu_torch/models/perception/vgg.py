"""VGG feature extractors, torchvision layout (counterpart of
spi_tpu/models/perception/vgg.py): VGG16 for LPIPS, VGG19 up to conv2_1
(torchvision index 5) for the BoxCX loss.

Parameters are named `features.{i}.weight` / `features.{i}.bias` after
the torchvision module index, as in the JAX package's pytree.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def module_list(cfg):
    """[(torchvision_index, kind, in_ch, out_ch)] for conv/relu/pool."""
    mods = []
    idx = 0
    in_ch = 3
    for v in cfg:
        if v == "M":
            mods.append((idx, "pool", in_ch, in_ch))
            idx += 1
        else:
            mods.append((idx, "conv", in_ch, v))
            mods.append((idx + 1, "relu", v, v))
            idx += 2
            in_ch = v
    return mods


class _Conv3x3(nn.Module):
    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))

    def reset_parameters(self, gen):
        # He-style init, a stand-in when pretrained weights are absent.
        cin = self.weight.shape[1]
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=gen).to(self.weight.device)
                              * math.sqrt(2.0 / (cin * 9)))
            self.bias.zero_()

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, padding=1)


class VGGFeatures(nn.Module):
    """torchvision-layout VGG `features`, returning the activations at
    `target_layers` (torchvision module indices)."""

    def __init__(self, cfg=VGG16_CFG, target_layers=(3, 8, 15, 22, 29), device=None):
        super().__init__()
        self.mods = module_list(cfg)
        self.target_layers = tuple(target_layers)
        self.features = nn.ModuleDict({
            str(idx): _Conv3x3(cin, cout, device=device)
            for idx, kind, cin, cout in self.mods if kind == "conv"
        })

    def out_channels(self) -> tuple[int, ...]:
        by_idx = {idx: cout for idx, _, _, cout in self.mods}
        return tuple(by_idx[i] for i in self.target_layers)

    def forward(self, x):
        outputs = []
        max_layer = max(self.target_layers)
        for idx, kind, _, _ in self.mods:
            if kind == "conv":
                x = self.features[str(idx)](x)
            elif kind == "relu":
                x = F.relu(x)
            else:
                x = F.max_pool2d(x, 2, 2)
            if idx in self.target_layers:
                outputs.append(x)
            if idx >= max_layer:
                break
        return outputs


# ImageNet normalization of torchvision-pretrained VGG (inputs in [0, 1]).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x01):
    """(N, 3, H, W) in [0, 1] -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x01.dtype, device=x01.device)
    std = torch.tensor(IMAGENET_STD, dtype=x01.dtype, device=x01.device)
    return (x01 - mean[None, :, None, None]) / std[None, :, None, None]
