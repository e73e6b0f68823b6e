"""Image tensor <-> file helpers (counterpart of spi_tpu/utils/image.py;
spec spi/utils/log_utils.py:7-53). Tensors are moved to the CPU here."""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image


def _numpy(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def tensor2im(x, vmin=-1.0, vmax=1.0) -> Image.Image:
    """(3, H, W) or (1, 3, H, W) in [vmin, vmax] -> 8-bit RGB image."""
    arr = _numpy(x)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip((arr.transpose(1, 2, 0) - vmin) / (vmax - vmin), 0.0, 1.0) * 255.0
    return Image.fromarray(arr.astype(np.uint8))


def tensor2depth(x) -> Image.Image:
    """(1, 1, H, W) depth -> grayscale image stretched to its range
    (log_utils.py:28-41)."""
    arr = _numpy(x)
    while arr.ndim > 2:
        arr = arr[0]
    lo, hi = float(arr.min()), float(arr.max())
    return Image.fromarray(((arr - lo) / max(hi - lo, 1e-8) * 255.0).astype(np.uint8))


def save_image(x, path: str, vmin=-1.0, vmax=1.0):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tensor2im(x, vmin=vmin, vmax=vmax).save(path)


def save_image_grid(batch, path: str, grid_rows: int | None = None, vmin=-1.0, vmax=1.0):
    """(N, 3, H, W) in [vmin, vmax] -> one tiled image, sqrt(N) rows
    (ZSSGAN/train.py:93)."""
    arr = _numpy(batch)
    n, c, h, w = arr.shape
    rows = grid_rows or max(1, int(n ** 0.5))
    cols = (n + rows - 1) // rows
    canvas = np.full((c, rows * h, cols * w), vmin, arr.dtype)
    for i in range(n):
        r, col = divmod(i, cols)
        canvas[:, r * h:(r + 1) * h, col * w:(col + 1) * w] = arr[i]
    save_image(canvas, path, vmin=vmin, vmax=vmax)
