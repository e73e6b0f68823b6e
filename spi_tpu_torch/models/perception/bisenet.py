"""BiSeNet face parser, 19 classes (counterpart of
spi_tpu/models/perception/bisenet.py; spec third_part/bisenet/bisenet.py +
resnet.py, SPI's variant).

A ResNet-18 context path (the spatial path is replaced by its 1/8
feature), attention refinement at 1/16 and 1/32, feature fusion, and the
main output head upsampled bilinearly (align_corners=True) to the input
size; the aux heads `conv_out16` / `conv_out32` hold weights but are not
run at inference. The parsing map is the argmax over the logits
(preprocess/extract_mask.py:35-62). Inference only: batch norms use their
running statistics (eps 1e-5). Parameter and buffer names are the torch
state_dict's (cp.resnet.conv1.weight, ...), which are spi_tpu's pytree
paths, so one `bisenet.npz` loads into both packages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spi_tpu_torch.models.perception.layers import BatchNorm, Conv2d
from spi_tpu_torch.models.stylegan2 import seeded_init
from spi_tpu_torch.utils.device import resolve_device

# extract_mask.py's normalisation: ImageNet statistics on [0, 1] input.
PARSING_MEAN = (0.485, 0.456, 0.406)
PARSING_STD = (0.229, 0.224, 0.225)


def _conv(cin, cout, k, stride=1, device=None):
    """A bias-free k x k convolution with 'same' padding and BiSeNet's
    fan-out init."""
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False, fan="out",
                  device=device)


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k, device=None):
        super().__init__()
        self.conv = _conv(cin, cout, k, device=device)
        self.bn = BatchNorm(cout, device)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1, device=None):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, device)
        self.bn1 = BatchNorm(cout, device)
        self.conv2 = _conv(cout, cout, 3, device=device)
        self.bn2 = BatchNorm(cout, device)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.ModuleDict({"0": _conv(cin, cout, 1, stride, device),
                                             "1": BatchNorm(cout, device)})

    def forward(self, x):
        r = F.relu(self.bn1(self.conv1(x)))
        r = self.bn2(self.conv2(r))
        if self.downsample is not None:
            x = self.downsample["1"](self.downsample["0"](x))
        return F.relu(x + r)


class ResNet18(nn.Module):
    """The context path's ResNet-18: features at 1/8, 1/16 and 1/32."""

    def __init__(self, device=None):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, device)
        self.bn1 = BatchNorm(64, device)
        for i, (cin, cout, stride) in enumerate(
                [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]):
            self.add_module(f"layer{i + 1}", nn.ModuleDict({
                "0": BasicBlock(cin, cout, stride, device), "1": BasicBlock(cout, cout, 1, device)}))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        feats = []
        for i in range(4):
            for block in getattr(self, f"layer{i + 1}").values():
                x = block(x)
            feats.append(x)
        return feats[1], feats[2], feats[3]


class AttentionRefinement(nn.Module):
    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout, 3, device)
        self.conv_atten = _conv(cout, cout, 1, device=device)
        self.bn_atten = BatchNorm(cout, device)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(self.conv_atten(feat.mean(dim=(2, 3), keepdim=True)))
        return feat * torch.sigmoid(atten)


class _Head(nn.Module):
    def __init__(self, cin, mid, n_classes, device=None):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid, 3, device)
        self.conv_out = _conv(mid, n_classes, 1, device=device)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """x (N, 3, H, W), ImageNet-normalised -> (N, n_classes, H, W) logits
    of the main head. device: None means `cuda` (raises without a GPU);
    weights are drawn from `seed` until a checkpoint is loaded."""

    def __init__(self, n_classes: int = 19, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cp = nn.ModuleDict({
            "resnet": ResNet18(dev),
            "arm16": AttentionRefinement(256, 128, dev),
            "arm32": AttentionRefinement(512, 128, dev),
            "conv_head32": ConvBNReLU(128, 128, 3, dev),
            "conv_head16": ConvBNReLU(128, 128, 3, dev),
            "conv_avg": ConvBNReLU(512, 128, 1, dev),
        })
        self.ffm = nn.ModuleDict({
            "convblk": ConvBNReLU(256, 256, 1, dev),
            "conv1": _conv(256, 64, 1, device=dev),
            "conv2": _conv(64, 256, 1, device=dev),
        })
        self.conv_out = _Head(256, 256, n_classes, dev)
        self.conv_out16 = _Head(128, 64, n_classes, dev)
        self.conv_out32 = _Head(128, 64, n_classes, dev)
        seeded_init(self, seed)
        self.eval()

    def forward(self, x):
        h, w = x.shape[2:]
        cp = self.cp
        feat8, feat16, feat32 = cp["resnet"](x)
        # The global context is 128 channels, broadcast over the 1/32 map
        # (the ARM's output width, not feat32's 512).
        avg = cp["conv_avg"](feat32.mean(dim=(2, 3), keepdim=True))
        feat32_up = F.interpolate(cp["arm32"](feat32) + avg, size=feat16.shape[2:],
                                  mode="nearest-exact")
        feat32_up = cp["conv_head32"](feat32_up)
        feat16_up = F.interpolate(cp["arm16"](feat16) + feat32_up, size=feat8.shape[2:],
                                  mode="nearest-exact")
        feat16_up = cp["conv_head16"](feat16_up)
        # feature fusion of the spatial (feat8) and context (feat16_up) paths
        feat = self.ffm["convblk"](torch.cat([feat8, feat16_up], dim=1))
        atten = F.relu(self.ffm["conv1"](feat.mean(dim=(2, 3), keepdim=True)))
        feat = feat * torch.sigmoid(self.ffm["conv2"](atten)) + feat
        return F.interpolate(self.conv_out(feat), size=(h, w), mode="bilinear",
                             align_corners=True)


@torch.no_grad()
def parse_logits(bisenet: BiSeNet, images01):
    """(N, 3, H, W) in [0, 1] -> (N, 19, H, W) logits, after extract_mask.py's
    ImageNet normalisation."""
    mean = torch.tensor(PARSING_MEAN, device=images01.device).reshape(1, 3, 1, 1)
    std = torch.tensor(PARSING_STD, device=images01.device).reshape(1, 3, 1, 1)
    return bisenet((images01 - mean) / std)


def parse_faces(bisenet: BiSeNet, images01):
    """(N, 3, H, W) in [0, 1] -> (N, H, W) int32 argmax parsing map
    (preprocess/extract_mask.py:35-62)."""
    return parse_logits(bisenet, images01).argmax(dim=1).to(torch.int32)
