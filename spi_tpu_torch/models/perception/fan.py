"""FAN 68-point face landmark network (counterpart of
spi_tpu/models/perception/fan.py; spec: the `face_alignment` package's
2DFAN4 that preprocess/extract_landmark.py:10 runs, the 4-stack Face
Alignment Network of Bulat & Tzimiropoulos 2017).

7x7/s2 stem -> ConvBlocks to 256 channels at 64x64 -> `num_modules`
depth-4 hourglass modules with intermediate supervision -> 68 heatmaps
at 64x64, decoded with the quarter-pixel offset rule. Inference only:
batch norms use their running statistics (eps 1e-5). Parameter and
buffer names are the released 2DFAN4 state_dict's (conv1, bn1, conv2..
conv4, m{i}.b1_{d} / b2_{d} / b2_plus_{d} / b3_{d}, top_m_{i},
conv_last{i}, bn_end{i}, l{i}, bl{i}, al{i}), which are spi_tpu's pytree
paths, so one `fan.npz` loads into both packages.

Face detection: the upstream package runs an SFD detector first; SPI
feeds portraits where the face fills the frame, so the crop is the whole
image unless a box is given. Input: (N, 3, 256, 256) RGB in [0, 1].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spi_tpu_torch.models.perception.layers import BatchNorm, Conv2d
from spi_tpu_torch.models.stylegan2 import seeded_init
from spi_tpu_torch.ops import resize_bilinear
from spi_tpu_torch.utils.device import resolve_device


class ConvBlock(nn.Module):
    """Three pre-activation 3x3 convolutions giving out/2 + out/4 + out/4
    channels, concatenated, plus a bn-relu-1x1 shortcut where the channel
    counts differ."""

    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.bn1 = BatchNorm(cin, device)
        self.conv1 = Conv2d(cin, cout // 2, 3, padding=1, bias=False, device=device)
        self.bn2 = BatchNorm(cout // 2, device)
        self.conv2 = Conv2d(cout // 2, cout // 4, 3, padding=1, bias=False, device=device)
        self.bn3 = BatchNorm(cout // 4, device)
        self.conv3 = Conv2d(cout // 4, cout // 4, 3, padding=1, bias=False, device=device)
        self.downsample = None
        if cin != cout:
            self.downsample = nn.ModuleDict({
                "0": BatchNorm(cin, device), "2": Conv2d(cin, cout, 1, bias=False, device=device)})

    def forward(self, x):
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        if self.downsample is not None:
            x = self.downsample["2"](F.relu(self.downsample["0"](x)))
        return torch.cat([out1, out2, out3], dim=1) + x


class HourGlass(nn.Module):
    def __init__(self, depth=4, features=256, device=None):
        super().__init__()
        self.depth = depth
        for level in range(depth, 0, -1):
            names = [f"b1_{level}", f"b2_{level}", f"b3_{level}"]
            if level == 1:
                names.append(f"b2_plus_{level}")
            for name in names:
                self.add_module(name, ConvBlock(features, features, device))

    def _forward(self, level, x):
        up1 = getattr(self, f"b1_{level}")(x)
        low1 = getattr(self, f"b2_{level}")(F.avg_pool2d(x, 2, 2))
        if level > 1:
            low2 = self._forward(level - 1, low1)
        else:
            low2 = getattr(self, f"b2_plus_{level}")(low1)
        low3 = getattr(self, f"b3_{level}")(low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._forward(self.depth, x)


class FAN(nn.Module):
    """x (N, 3, 256, 256) in [0, 1] -> the last module's (N, 68, 64, 64)
    heatmaps. device: None means `cuda` (raises without a GPU); weights
    are drawn from `seed` (He-normal convolutions, identity batch norms)
    until a checkpoint is loaded."""

    def __init__(self, num_modules: int = 4, num_landmarks: int = 68, device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.num_modules = num_modules
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, device=dev)
        self.bn1 = BatchNorm(64, dev)
        self.conv2 = ConvBlock(64, 128, dev)
        self.conv3 = ConvBlock(128, 128, dev)
        self.conv4 = ConvBlock(128, 256, dev)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(device=dev))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256, dev))
            self.add_module(f"conv_last{i}", Conv2d(256, 256, 1, device=dev))
            self.add_module(f"bn_end{i}", BatchNorm(256, dev))
            self.add_module(f"l{i}", Conv2d(256, num_landmarks, 1, device=dev))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", Conv2d(256, 256, 1, device=dev))
                self.add_module(f"al{i}", Conv2d(num_landmarks, 256, 1, device=dev))
        seeded_init(self, seed)
        self.eval()

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.avg_pool2d(self.conv2(x), 2, 2)
        previous = self.conv4(self.conv3(x))
        out = None
        for i in range(self.num_modules):
            ll = getattr(self, f"top_m_{i}")(getattr(self, f"m{i}")(previous))
            ll = F.relu(getattr(self, f"bn_end{i}")(getattr(self, f"conv_last{i}")(ll)))
            out = getattr(self, f"l{i}")(ll)
            if i < self.num_modules - 1:
                previous = previous + getattr(self, f"bl{i}")(ll) + getattr(self, f"al{i}")(out)
        return out


def decode_heatmaps(heatmaps):
    """(N, 68, H, W) -> (N, 68, 2) landmark xy in heatmap pixels: the
    argmax, moved a quarter pixel toward the larger neighbour on each axis
    where the peak is inside the map on both axes (face_alignment's
    utils.get_preds_fromhm)."""
    n, c, h, w = heatmaps.shape
    flat = heatmaps.reshape(n, c, h * w)
    idx = flat.argmax(dim=-1)
    ys, xs = idx // w, idx % w

    def at(dy, dx):
        yy = (ys + dy).clamp(0, h - 1)
        xx = (xs + dx).clamp(0, w - 1)
        return flat.gather(-1, (yy * w + xx)[..., None])[..., 0]

    dx = torch.sign(at(0, 1) - at(0, -1)) * 0.25
    dy = torch.sign(at(1, 0) - at(-1, 0)) * 0.25
    interior = (xs > 0) & (xs < w - 1) & (ys > 0) & (ys < h - 1)
    x = xs.float() + torch.where(interior, dx, 0.0)
    y = ys.float() + torch.where(interior, dy, 0.0)
    return torch.stack([x, y], dim=-1)


@torch.no_grad()
def landmarks_from_image(fan: FAN, image01, bbox=None):
    """image01: (N, 3, S, S) in [0, 1] (any square size; resized to 256).
    bbox: optional (N, 4) [x0, y0, x1, y1] in image pixels, else the whole
    frame. Returns (N, 68, 2) landmarks in image pixel coordinates."""
    _, _, hh, ww = image01.shape
    pts = decode_heatmaps(fan(resize_bilinear(image01, (256, 256))))  # on the 64x64 grid
    if bbox is None:
        scale = torch.tensor([ww / 64.0, hh / 64.0], dtype=torch.float32, device=pts.device)
        return pts * scale
    x0, y0, x1, y1 = bbox.unbind(-1)
    sx, sy = (x1 - x0) / 64.0, (y1 - y0) / 64.0
    return torch.stack([pts[..., 0] * sx[:, None] + x0[:, None],
                        pts[..., 1] * sy[:, None] + y0[:, None]], dim=-1)
