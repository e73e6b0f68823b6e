"""3DMM coefficient regressor, Deep3DFaceRecon's ResNet-50 (counterpart of
spi_tpu/models/perception/face_recon.py; spec
third_part/Deep3DFaceRecon_pytorch/models/networks.py:69-105, the
ReconNetWrapper: a torchvision ResNet-50 without its fc, and seven 1x1
coefficient heads; models/bfm.py split_coeff).

SPI's preprocess reads only `angle` and `trans`
(preprocess/extract_camera.py:87-136); the whole 257-coefficient split is
given. Parameter and buffer names are the torch state_dict's
(backbone.conv1.weight, backbone.layer1.0.conv1.weight, ...,
final_layers.0.weight), which are spi_tpu's pytree paths, so one
`facerecon.npz` loads into both packages. Inference only: batch norms use
their running statistics (eps 1e-5).

Input: (N, 3, 224, 224) RGB in [0, 1] (facerecon_model.py feeds im / 255
without ImageNet normalisation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spi_tpu_torch.models.perception.layers import BatchNorm, Conv2d
from spi_tpu_torch.models.stylegan2 import seeded_init
from spi_tpu_torch.utils.device import resolve_device

# (name, dim) of the seven heads: concatenation order networks.py:85-93,
# split order bfm.py split_coeff.
COEFF_SPLIT = (
    ("id", 80),
    ("exp", 64),
    ("tex", 80),
    ("angle", 3),
    ("gamma", 27),
    ("trans_xy", 2),
    ("trans_z", 1),
)


class Bottleneck(nn.Module):
    """torchvision's ResNet Bottleneck: the stride on the 3x3 conv."""

    def __init__(self, cin, planes, stride=1, device=None):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False, device=device)
        self.bn1 = BatchNorm(planes, device)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False,
                            device=device)
        self.bn2 = BatchNorm(planes, device)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, device=device)
        self.bn3 = BatchNorm(planes * 4, device)
        self.downsample = None
        if stride != 1 or cin != planes * 4:
            self.downsample = nn.ModuleDict({
                "0": Conv2d(cin, planes * 4, 1, stride=stride, bias=False, device=device),
                "1": BatchNorm(planes * 4, device)})

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample["1"](self.downsample["0"](x))
        return F.relu(out + x)


class ResNet50Backbone(nn.Module):
    """torchvision resnet50 without the fc head: pooled (N, 2048)."""

    def __init__(self, stage_blocks=(3, 4, 6, 3), width=64, device=None):
        super().__init__()
        self.conv1 = Conv2d(3, width, 7, stride=2, padding=3, bias=False, device=device)
        self.bn1 = BatchNorm(width, device)
        cin = planes = width
        for si, n in enumerate(stage_blocks):
            blocks = nn.ModuleDict()
            for bi in range(n):
                stride = 2 if si > 0 and bi == 0 else 1
                blocks[str(bi)] = Bottleneck(cin, planes, stride, device)
                cin = planes * 4
            self.add_module(f"layer{si + 1}", blocks)
            planes *= 2
        self.num_stages = len(stage_blocks)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for si in range(self.num_stages):
            for block in getattr(self, f"layer{si + 1}").values():
                x = block(x)
        return x.mean(dim=(2, 3))


class FaceReconNet(nn.Module):
    """x (N, 3, 224, 224) in [0, 1] -> (N, 257) raw BFM coefficients.
    device: None means `cuda` (raises without a GPU). Until a checkpoint
    is loaded the backbone's weights are drawn from `seed` and the heads
    are zero, as the reference initialises them (networks.py:94-96)."""

    feature_dim = 2048

    def __init__(self, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.backbone = ResNet50Backbone(device=dev)
        self.final_layers = nn.ModuleDict({
            str(i): Conv2d(self.feature_dim, dim, 1, device=dev)
            for i, (_, dim) in enumerate(COEFF_SPLIT)})
        seeded_init(self.backbone, seed)
        with torch.no_grad():
            for head in self.final_layers.values():
                head.weight.zero_()
                head.bias.zero_()
        self.eval()

    def forward(self, x):
        feat = self.backbone(x)
        return torch.cat([feat @ head.weight.flatten(1).T + head.bias
                          for head in self.final_layers.values()], dim=1)

    @staticmethod
    def split_coeff(coeffs):
        """(N, 257) -> {id, exp, tex, angle, gamma, trans} (bfm.py
        split_coeff; trans = trans_xy ++ trans_z)."""
        out, i = {}, 0
        for name, dim in COEFF_SPLIT:
            out[name] = coeffs[:, i:i + dim]
            i += dim
        out["trans"] = torch.cat([out.pop("trans_xy"), out.pop("trans_z")], dim=1)
        return out
