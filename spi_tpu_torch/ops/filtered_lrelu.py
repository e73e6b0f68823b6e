"""Bias -> up-FIR -> leaky ReLU with gain and clamp -> down-FIR
(counterpart of spi_tpu/ops/filtered_lrelu.py; spec EG3D
torch_utils/ops/filtered_lrelu.py:58-155, `_filtered_lrelu_ref` at
:124-166), the StyleGAN3 alias-free nonlinearity.

spi_tpu composes it from XLA ops, not a Pallas kernel, so the port composes
it from its own pieces: both `bias_act` calls launch the CUDA bias_act
kernels on a card, and the FIRs are `upfirdn2d`'s depthwise convolutions.
The filters are float32 tensors (1D separable or 2D), or None for the
identity.
"""

from __future__ import annotations

import math

from spi_tpu_torch.ops.bias_act import bias_act
from spi_tpu_torch.ops.upfirdn2d import _parse_padding, filter_size, upfirdn2d


def filtered_lrelu(x, fu=None, fd=None, b=None, up: int = 1, down: int = 1, padding=0,
                   gain: float = math.sqrt(2.0), slope: float = 0.2,
                   clamp: float | None = None, flip_filter: bool = False):
    """x: (N, C, H, W); fu / fd: up / down FIR filters; b: (C,) bias.
    Returns (N, C, H', W') with
    H' = (H * up + py0 + py1 - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down."""
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    px0, px1, py0, py1 = _parse_padding(padding)
    fu_w, fu_h = filter_size(fu)
    fd_w, fd_h = filter_size(fd)

    n, c, in_h, in_w = x.shape
    out_w = (in_w * up + (px0 + px1) - (fu_w - 1) - (fd_w - 1) + (down - 1)) // down
    out_h = (in_h * up + (py0 + py1) - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down

    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up**2,
                  flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    x = upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
    if tuple(x.shape) != (n, c, out_h, out_w):
        raise ValueError(f"filtered_lrelu gave {tuple(x.shape)}, expected {(n, c, out_h, out_w)}")
    return x
