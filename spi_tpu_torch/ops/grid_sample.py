"""Bilinear sampling from channels-last tables (counterpart of
spi_tpu/ops/grid_sample.py).

Zeros padding, align_corners=False: four corner gathers from a flat
(rows, C) table, with out-of-range corners weighted to zero. This is
the plain version of the triplane lookup (ops/plane_splat.py, whose
kernel follows its order of operations) and, as `grid_sample`, the
sampler of the depth warp (utils/rotate.py) and of the ADA pipe
(training/augment.py). spi_tpu runs both as XLA compositions, with no
TPU kernel behind them.
"""

from __future__ import annotations

import torch


def texel_coords(u, v, h: int, w: int):
    """[-1, 1] plane coordinates -> continuous texel coordinates
    (align_corners=False: -1 maps to -0.5 px, +1 to size - 0.5 px)."""
    fx = ((u + 1.0) * w - 1.0) * 0.5
    fy = ((v + 1.0) * h - 1.0) * 0.5
    return fx, fy


def bilinear_corners(fx, fy, h: int, w: int):
    """The four bilinear corners of each point: a list of
    (flat index clamped into range, weight zeroed where out of range)."""
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    tx = fx - x0f
    ty = fy - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    out = []
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            flat = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            out.append((flat, wx * wy * valid))
    return out


def sample_flat(table, coords, h: int, w: int):
    """table: (N, H*W, C); coords: (N, P, 2) xy in [-1, 1] -> (N, P, C)."""
    n, hw, c = table.shape
    fx, fy = texel_coords(coords[..., 0], coords[..., 1], h, w)
    rows = table.reshape(n * hw, c)
    base = (torch.arange(n, device=table.device) * hw)[:, None]
    out = None
    for flat, wgt in bilinear_corners(fx, fy, h, w):
        vals = rows.index_select(0, (flat + base).reshape(-1)).reshape(*flat.shape, c)
        term = vals * wgt[..., None]
        out = term if out is None else out + term
    return out


def grid_sample(input, grid):  # noqa: A002 - torch's argument name
    """`F.grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=False)` by the same corner gathers as spi_tpu's:
    input (N, C, H, W), grid (N, Ho, Wo, 2) of (x, y) in [-1, 1] ->
    (N, C, Ho, Wo)."""
    n, c, h, w = input.shape
    gn, ho, wo, two = grid.shape
    if two != 2 or gn != n:
        raise ValueError(f"grid {tuple(grid.shape)} does not fit input {tuple(input.shape)}")
    table = input.permute(0, 2, 3, 1).reshape(n, h * w, c)
    out = sample_flat(table, grid.reshape(n, ho * wo, 2), h, w)
    return out.reshape(n, ho, wo, c).permute(0, 3, 1, 2)
