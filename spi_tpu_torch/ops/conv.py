"""2D convolution with optional up/downsampling (counterpart of
spi_tpu/ops/conv.py; spec EG3D conv2d_resample.py:48-145).

The branch structure of `conv2d_resample`, which factors the
up/FIR/conv/down pipeline into the cheapest primitive sequence, is kept
as the spec; each convolution is `F.conv2d` / `F.conv_transpose2d`, each
FIR `upfirdn2d` (on a card the kernel of csrc/upfirdn2d.cu).
"""

from __future__ import annotations

import torch.nn.functional as F

from spi_tpu_torch.ops.upfirdn2d import _parse_padding, filter_size, upfirdn2d


def conv2d(x, w, stride=1, padding=0, groups=1, flip_weight=True):
    """F.conv2d; flip_weight=False flips the kernel (true convolution)."""
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        w = w.flip([2, 3])
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


def conv_transpose2d(x, w, stride=1, padding=0, groups=1, flip_weight=True):
    """F.conv_transpose2d with w in torch's (C, O // groups, kh, kw)
    layout; flip_weight=False flips the kernel first."""
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        w = w.flip([2, 3])
    return F.conv_transpose2d(x, w, stride=stride, padding=padding, groups=groups)


def _conv2d_wrapper(x, w, stride=1, padding=0, groups=1, transpose=False, flip_weight=True):
    """EG3D conv2d_resample.py:30-43."""
    op = conv_transpose2d if transpose else conv2d
    return op(x, w, stride=stride, padding=padding, groups=groups, flip_weight=flip_weight)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1,
                    flip_weight=True, flip_filter=False):
    """2D convolution with optional up/downsampling; padding is given
    once, with respect to the upsampled image.

    x: (N, C, H, W); w: (O, C // groups, kh, kw); f: FIR filter from
    setup_filter or None; up, down: integer factors.
    """
    if not (isinstance(up, int) and up >= 1 and isinstance(down, int) and down >= 1):
        raise ValueError(f"up and down must be ints >= 1, got {up}, {down}")
    out_channels, in_channels_per_group, kh, kw = (int(s) for s in w.shape)
    fw, fh = filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    # 1x1 kernel + downsampling only: downsample first, then convolve.
    if kw == 1 and kh == 1 and (down > 1 and up == 1):
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d_wrapper(x, w, groups=groups, flip_weight=flip_weight)

    # 1x1 kernel + upsampling only: convolve first, then upsample.
    if kw == 1 and kh == 1 and (up > 1 and down == 1):
        x = _conv2d_wrapper(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up**2,
                         flip_filter=flip_filter)

    # Downsampling only: strided convolution.
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d_wrapper(x, w, stride=down, groups=groups, flip_weight=flip_weight)

    # Upsampling (with optional downsampling): transposed strided conv.
    if up > 1:
        if groups == 1:
            wt = w.transpose(0, 1)
        else:
            wt = w.reshape(groups, out_channels // groups, in_channels_per_group, kh, kw)
            wt = wt.transpose(1, 2)
            wt = wt.reshape(groups * in_channels_per_group, out_channels // groups, kh, kw)
        px0 -= kw - 1
        px1 -= kw - up
        py0 -= kh - 1
        py1 -= kh - up
        pxt = max(min(-px0, -px1), 0)
        pyt = max(min(-py0, -py1), 0)
        x = _conv2d_wrapper(x, wt, stride=up, padding=(pyt, pxt), groups=groups,
                            transpose=True, flip_weight=(not flip_weight))
        x = upfirdn2d(x, f, padding=[px0 + pxt, px1 + pxt, py0 + pyt, py1 + pyt],
                      gain=up**2, flip_filter=flip_filter)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    # No resampling with symmetric non-negative padding: plain conv2d.
    if up == 1 and down == 1:
        if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
            return _conv2d_wrapper(x, w, padding=(py0, px0), groups=groups,
                                   flip_weight=flip_weight)

    # Generic fallback.
    x = upfirdn2d(x, (f if up > 1 else None), up=up, padding=[px0, px1, py0, py1],
                  gain=up**2, flip_filter=flip_filter)
    x = _conv2d_wrapper(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x

