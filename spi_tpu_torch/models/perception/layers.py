"""Layers shared by the perception networks: an eval-form batch norm and a
convolution that draws its own seeded He-normal weights (the JAX
package's `init`), so that `seeded_init` can set a whole network."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Batch norm in eval form over dim 1: affine weight and bias,
    running statistics as buffers, eps 1e-5."""

    def __init__(self, ch, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))
        self.register_buffer("running_mean", torch.zeros(ch, device=device))
        self.register_buffer("running_var", torch.ones(ch, device=device))

    def forward(self, x, eps=1e-5):
        # One fused call (one launch on the card) in place of the six
        # elementwise steps of x * scale + shift.
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=eps)


class Conv2d(nn.Module):
    """`F.conv2d` with a (cout, cin, k, k) `weight`, an optional `bias`, a
    fixed stride and padding. `reset_parameters(gen)` draws He-normal
    weights over the fan-in (`fan='out'`: over cout * k * k, as spi_tpu's
    BiSeNet init) and zero biases."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True, fan="in", device=None):
        super().__init__()
        self.stride, self.padding, self.fan = stride, padding, fan
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None

    def reset_parameters(self, gen):
        cout, cin, k, _ = self.weight.shape
        fan = (cin if self.fan == "in" else cout) * k * k
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=gen).to(self.weight.device)
                              * math.sqrt(2.0 / fan))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.padding)
