"""ArcFace IR-SE50 backbone for the ID metric (counterpart of
spi_tpu/models/perception/arcface.py; spec spi/criteria/id_loss/
model_irse.py + helpers.py, InsightFace IR-SE50).

Input conv 3 -> 64 + BN + PReLU; 24 bottleneck_IR_SE units in 4 stages
([3, 4, 14, 3] units, depths [64, 128, 256, 512], each stage entered at
stride 2); output BN -> flatten -> 512*7*7 FC -> BatchNorm1d -> L2 norm.
Inference only: batch norms use their stored statistics, dropout is the
identity. Parameter and buffer names are the torch state_dict's
(`input_layer.0.weight`, `body.{i}.res_layer.{j}...`,
`output_layer.3.weight`, ...), which are spi_tpu's pytree paths.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from spi_tpu_torch.utils.device import resolve_device

_STAGES = [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)]  # (in, depth, units)


def units():
    """[(in_channel, depth, stride)] of the body (helpers.get_blocks(50))."""
    out = []
    for in_ch, depth, n in _STAGES:
        out.append((in_ch, depth, 2))
        out.extend((depth, depth, 1) for _ in range(n - 1))
    return out


class _Weight(nn.Module):
    """A module holding one `weight` (conv kernels, PReLU slopes)."""

    def __init__(self, *shape, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape, device=device))


class _BatchNorm(nn.Module):
    """Batch norm in eval form over dim 1: affine weight and bias,
    running statistics as buffers."""

    def __init__(self, ch, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("running_mean", torch.zeros(ch, device=device))
        self.register_buffer("running_var", torch.ones(ch, device=device))

    def forward(self, x, eps=1e-5):
        inv = torch.rsqrt(self.running_var + eps)
        scale = self.weight * inv
        shift = self.bias - self.running_mean * scale
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * scale.reshape(shape) + shift.reshape(shape)


def _prelu(x, slope):
    return torch.where(x >= 0, x, slope.reshape(1, -1, 1, 1) * x)


class _Unit(nn.Module):
    def __init__(self, cin, depth, stride, device=None):
        super().__init__()
        self.stride = stride
        self.res_layer = nn.ModuleDict({
            "0": _BatchNorm(cin, device),
            "1": _Weight(depth, cin, 3, 3, device=device),
            "2": _Weight(depth, device=device),
            "3": _Weight(depth, depth, 3, 3, device=device),
            "4": _BatchNorm(depth, device),
            "5": nn.ModuleDict({"fc1": _Weight(depth // 16, depth, 1, 1, device=device),
                                "fc2": _Weight(depth, depth // 16, 1, 1, device=device)}),
        })
        if cin != depth:
            self.shortcut_layer = nn.ModuleDict({
                "0": _Weight(depth, cin, 1, 1, device=device), "1": _BatchNorm(depth, device)})
        else:
            self.shortcut_layer = None

    def forward(self, x):
        if self.shortcut_layer is None:  # MaxPool2d(1, stride): a strided subsample
            shortcut = x[:, :, ::self.stride, ::self.stride]
        else:
            shortcut = self.shortcut_layer["1"](
                F.conv2d(x, self.shortcut_layer["0"].weight, stride=self.stride))
        r = self.res_layer
        res = F.conv2d(r["0"](x), r["1"].weight, padding=1)
        res = _prelu(res, r["2"].weight)
        res = r["4"](F.conv2d(res, r["3"].weight, stride=self.stride, padding=1))
        se = F.conv2d(res.mean(dim=(2, 3), keepdim=True), r["5"]["fc1"].weight)
        se = F.conv2d(torch.relu(se), r["5"]["fc2"].weight)
        return res * torch.sigmoid(se) + shortcut


class IRSE50(nn.Module):
    """x (N, 3, 112, 112) in [-1, 1] -> L2-normalized (N, 512) embeddings.
    device: None means `cuda` (raises without a GPU)."""

    def __init__(self, embedding_size: int = 512, device=None, seed: int = 3):
        super().__init__()
        dev = resolve_device(device)
        self.input_layer = nn.ModuleDict({
            "0": _Weight(64, 3, 3, 3, device=dev), "1": _BatchNorm(64, dev),
            "2": _Weight(64, device=dev)})
        self.body = nn.ModuleDict({str(i): _Unit(cin, depth, stride, dev)
                                   for i, (cin, depth, stride) in enumerate(units())})
        self.output_layer = nn.ModuleDict({
            "0": _BatchNorm(512, dev), "3": nn.Linear(512 * 7 * 7, embedding_size, device=dev),
            "4": _BatchNorm(embedding_size, dev)})
        self.reset_parameters(torch.Generator().manual_seed(seed))

    def reset_parameters(self, gen):
        """He-normal convolutions, N(0, 0.01^2) FC, PReLU slopes 0.25 and
        identity batch norms, as spi_tpu's init (a stand-in when the
        pretrained weights are absent)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, _Weight) and m.weight.ndim == 1:  # PReLU slopes
                    m.weight.fill_(0.25)
                elif isinstance(m, _Weight):
                    fan = m.weight[0].numel()
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen).to(m.weight.device)
                                   * math.sqrt(2.0 / fan))
            fc = self.output_layer["3"]
            fc.weight.copy_(torch.randn(fc.weight.shape, generator=gen).to(fc.weight.device) * 0.01)
            fc.bias.zero_()

    def forward(self, x):
        p = self.input_layer
        x = _prelu(p["1"](F.conv2d(x, p["0"].weight, padding=1)), p["2"].weight)
        for unit in self.body.values():
            x = unit(x)
        o = self.output_layer
        x = o["0"](x).flatten(1)
        x = o["4"](o["3"](x))
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
