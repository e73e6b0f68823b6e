"""Pad -> zero-upsample -> FIR filter -> downsample for NCHW batches
(counterpart of spi_tpu/ops/upfirdn2d.py; spec EG3D upfirdn2d.py:120-213).

Expressed as one zero-upsample, one pad/crop and one depthwise strided
convolution, as EG3D's `_upfirdn2d_ref` does. Filters are small float32
tensors built by `setup_filter`; the gain and the flip are folded into the
filter in float32, and the result is cast to x's dtype, as spi_tpu does
(so a bfloat16 x is filtered by bfloat16 taps).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _parse_scaling(scaling) -> tuple[int, int]:
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling must be >= 1, got {scaling}")
    return int(sx), int(sy)


def _parse_padding(padding) -> tuple[int, int, int, int]:
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def filter_size(f) -> tuple[int, int]:
    """(width, height) of a 1D (separable) or 2D filter; None is 1x1."""
    if f is None:
        return 1, 1
    if f.ndim == 1:
        return int(f.shape[0]), int(f.shape[0])
    return int(f.shape[1]), int(f.shape[0])


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0, separable: bool | None = None,
                 device=None) -> torch.Tensor:
    """Prepare a 2D FIR filter for upfirdn2d (EG3D upfirdn2d.py:52-101)."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    if f.ndim not in (0, 1, 2) or f.size == 0:
        raise ValueError(f"bad filter shape {f.shape}")
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = np.flip(f, axis=tuple(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2))
    return torch.tensor(np.ascontiguousarray(f, dtype=np.float32), device=device)


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1.0):
    """Zero-upsample by `up` (up-1 zeros after each pixel), pad/crop by
    `padding` (x0, x1, y0, y1; negative crops), convolve with `f` (true
    convolution unless flip_filter), keep every `down`-th pixel.

    x: (N, C, H, W); f: 2D or 1D (outer product) filter tensor, or None.
    """
    if x.ndim != 4:
        raise ValueError(f"x must be NCHW, got shape {tuple(x.shape)}")
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    if f is None:
        f = torch.ones(1, 1, device=x.device)
    f = f.to(device=x.device, dtype=torch.float32)
    if f.ndim == 1:
        f = torch.outer(f, f)
    n, c, h, w = x.shape

    # Zero-upsample.
    x = x.reshape(n, c, h, 1, w, 1)
    x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
    x = x.reshape(n, c, h * upy, w * upx)
    # Pad, then crop where padding is negative.
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    x = x[:, :, max(-pady0, 0):x.shape[2] - max(-pady1, 0),
          max(-padx0, 0):x.shape[3] - max(-padx1, 0)]
    if x.shape[2] < f.shape[0] or x.shape[3] < f.shape[1]:
        raise ValueError("upsampled buffer smaller than filter")

    # FIR filter (depthwise) with the downsample as the stride.
    f = f * gain
    if not flip_filter:
        f = f.flip([0, 1])
    weight = f.to(x.dtype)[None, None].repeat(c, 1, 1, 1)
    return F.conv2d(x, weight, stride=(downy, downx), groups=c)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1.0):
    """Upsample with the given filter (EG3D upfirdn2d.py:317-341)."""
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = filter_size(f)
    p = [
        padx0 + (fw + upx - 1) // 2,
        padx1 + (fw - upx) // 2,
        pady0 + (fh + upy - 1) // 2,
        pady1 + (fh - upy) // 2,
    ]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1.0):
    """Downsample with the given filter (EG3D upfirdn2d.py:344-370)."""
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = filter_size(f)
    p = [
        padx0 + (fw - downx + 1) // 2,
        padx1 + (fw - downx) // 2,
        pady0 + (fh - downy + 1) // 2,
        pady1 + (fh - downy) // 2,
    ]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
