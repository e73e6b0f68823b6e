"""Image resizing (counterpart of spi_tpu/ops/resize.py)."""

from __future__ import annotations

import torch.nn.functional as F


def resize_bilinear(x, size: tuple[int, int], antialias: bool = False):
    """Bilinear resize of (N, C, H, W) to (N, C, *size), half-pixel centers
    (align_corners=False). Computed in float32 and returned in x's dtype:
    PyTorch's CPU antialiased resize takes no bfloat16, and the card's and
    the CPU's result should be one function."""
    y = F.interpolate(x.float(), size=tuple(size), mode="bilinear", align_corners=False,
                      antialias=antialias)
    return y.to(x.dtype)


def resize_area(x, size: tuple[int, int]):
    """Area (average-pool) downsample of (N, C, H, W) by integer factors."""
    n, c, h, w = x.shape
    oh, ow = size
    if h % oh or w % ow:
        raise ValueError(f"resize_area needs integer factors, got {(h, w)} -> {size}")
    fh, fw = h // oh, w // ow
    return x.reshape(n, c, oh, fh, ow, fw).mean(dim=(3, 5))
