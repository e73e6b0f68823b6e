"""ROI-align by bilinear gathers (counterpart of spi_tpu/ops/roi_align.py).

The BoxCX loss crops 80x80 mouth and eye regions with it
(spi/criteria/bbox_cx_loss.py:41-61, torchvision.ops.roi_align with
aligned=False). Like spi_tpu, and unlike torchvision, the sampling ratio
is fixed (2 sub-samples per bin side, not the adaptive ceil(bin size))
and sample points are clamped to the feature map's extent (border
replication, no zero for points outside it).
"""

from __future__ import annotations

import torch


def roi_align(features, boxes, output_size: int, sampling_ratio: int = 2):
    """features (N, C, H, W), one box per sample (N, 4) as (x1, y1, x2, y2)
    in pixel coordinates -> (N, C, output_size, output_size): each bin the
    mean of sampling_ratio^2 bilinear samples."""
    n, c, _, _ = features.shape
    s, o = sampling_ratio, output_size
    x1, y1, x2, y2 = boxes.unbind(1)
    bin_w = (x2 - x1) / o
    bin_h = (y2 - y1) / o
    # Bin i's samples at x1 + (i + (j + 0.5) / s) * bin_w (aligned=False).
    i = torch.arange(o, dtype=features.dtype, device=features.device)
    j = (torch.arange(s, dtype=features.dtype, device=features.device) + 0.5) / s
    offs = (i[:, None] + j[None, :]).reshape(-1)
    xs = x1[:, None] + offs[None, :] * bin_w[:, None]
    ys = y1[:, None] + offs[None, :] * bin_h[:, None]
    vals = _bilinear_pixels(features, xs, ys)
    return vals.reshape(n, c, o, s, o, s).mean(dim=(3, 5))


def _bilinear_pixels(features, xs, ys):
    """Sample (N, C, H, W) at the outer product of row coordinates ys and
    column coordinates xs, each (N, P), pixel centres at integers and
    clamped into the map -> (N, C, P, P)."""
    n, c, h, w = features.shape
    p = xs.shape[1]
    xs = xs.clamp(0.0, w - 1.0)
    ys = ys.clamp(0.0, h - 1.0)
    x0f, y0f = torch.floor(xs), torch.floor(ys)
    tx = (xs - x0f)[:, None, None, :]
    ty = (ys - y0f)[:, None, :, None]
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)

    def rows(yi):  # (N, C, H, W) -> (N, C, P, W)
        return torch.gather(features, 2, yi[:, None, :, None].expand(n, c, p, w))

    def cols(f, xi):  # (N, C, P, W) -> (N, C, P, P)
        return torch.gather(f, 3, xi[:, None, None, :].expand(n, c, p, p))

    f_y0, f_y1 = rows(y0), rows(y1)
    top = cols(f_y0, x0) * (1 - tx) + cols(f_y0, x1) * tx
    bot = cols(f_y1, x0) * (1 - tx) + cols(f_y1, x1) * tx
    return top * (1 - ty) + bot * ty
