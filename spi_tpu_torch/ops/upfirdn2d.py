"""Pad -> zero-upsample -> FIR filter -> downsample for NCHW batches
(counterpart of spi_tpu/ops/upfirdn2d.py; spec EG3D upfirdn2d.py:120-213).

`upfirdn2d` is the FIR of every resampling convolution (ops/conv.py, the
ToRGB skips of models/stylegan2.py) and of StyleGAN3's filtered_lrelu. On
a CUDA tensor it is an autograd Function over the hand-written kernel of
`csrc/upfirdn2d.cu`, which zero-upsamples, pads or crops, filters and
downsamples in one pass, in float32 and bfloat16; on a CPU tensor it runs
`upfirdn2d_plain`, EG3D's `_upfirdn2d_ref` composition: one zero-upsample,
one pad/crop and one depthwise strided convolution. There is no switch and
no fallback between the two. Filters are small tensors built by
`setup_filter`; the gain and the flip are folded into the filter in
float32, and the result is cast to x's dtype, as spi_tpu does (so a
bfloat16 x is filtered by bfloat16 taps); the kernel sums the products in
float32 and rounds once, as the plain version's convolution does.

The backward is the same Function on the adjoint problem, as StyleGAN2-ADA's
`_upfirdn2d_cuda`: the cotangent filtered with the opposite flip, up and
down swapped, the padding derived from the shapes. It saves the filter and
the shapes only, so every order of gradient is the kernel again. Under
torch.func.vmap the Function's rule folds the image axis into N: one
launch for the batch, with one filter for every image.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spi_tpu_torch.ops import _lib


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


def upfirdn2d_plain(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1.0):
    """The plain PyTorch version: zero-upsample by `up` (up-1 zeros after
    each pixel), pad/crop by `padding` (x0, x1, y0, y1; negative crops),
    convolve with `f` (true convolution unless flip_filter), keep every
    `down`-th pixel.

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


# What the kernel takes (csrc/upfirdn2d.cu kMaxTaps, kMaxFactor): filter
# taps a side, and the up and down factors.
MAX_TAPS = 32
MAX_FACTOR = 8
# The launch count of the kernel by the dtype of x.
_COUNTS = {torch.float32: "upfirdn2d", torch.bfloat16: "upfirdn2d_bf16"}


def _out_size(n, up, pad0, pad1, taps, down):
    """Length of one output axis; the plain version's error where the
    upsampled, padded axis is shorter than the filter."""
    padded = n * up + pad0 + pad1
    if padded < taps:
        raise ValueError("upsampled buffer smaller than filter")
    return (padded - taps) // down + 1


def upfirdn2d_cuda(x, f, up=(1, 1), down=(1, 1), padding=(0, 0, 0, 0), flip_filter=False,
                   gain=1.0):
    """Launch the kernel: `upfirdn2d_plain`'s function in one pass. x:
    (N, C, H, W) contiguous, float32 or bfloat16; f: None, or a 1-D or 2-D
    contiguous float32 or bfloat16 filter of at most MAX_TAPS a side on
    x's device; up and down (x, y) factors in [1, MAX_FACTOR]; padding
    (x0, x1, y0, y1). Raises on anything else."""
    if x.ndim != 4:
        raise ValueError(f"x must be NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _COUNTS:
        raise ValueError(f"the upfirdn2d kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    fw, fh = filter_size(f)
    if f is not None:
        if f.ndim not in (1, 2) or f.dtype not in _COUNTS or not f.is_contiguous():
            raise ValueError(f"the filter must be a contiguous 1-D or 2-D float32 or bfloat16 "
                             f"tensor, got {tuple(f.shape)} {f.dtype}")
        if f.device != x.device:
            raise ValueError(f"the filter is on {f.device}, x on {x.device}")
    if max(fw, fh) > MAX_TAPS:
        raise ValueError(f"the upfirdn2d kernel takes at most {MAX_TAPS} taps a side, "
                         f"got a {fh}x{fw} filter")
    (upx, upy), (downx, downy) = up, down
    if not all(1 <= k <= MAX_FACTOR for k in (upx, upy, downx, downy)):
        raise ValueError(f"the upfirdn2d kernel takes up and down factors in [1, {MAX_FACTOR}], "
                         f"got up {up}, down {down}")
    padx0, padx1, pady0, pady1 = padding
    n, c, h, w = x.shape
    if h * w >= 2**31 or n * c >= 2**31:
        raise ValueError(f"the upfirdn2d kernel takes < 2^31 planes and pixels a plane, got "
                         f"{tuple(x.shape)}")
    out_w = _out_size(w, upx, padx0, padx1, fw, downx)
    out_h = _out_size(h, upy, pady0, pady1, fh, downy)
    _lib.require(x, "x", dtype=x.dtype, align=x.dtype.itemsize)
    y = torch.empty(n, c, out_h, out_w, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    name = _COUNTS[x.dtype]
    err = getattr(_lib.lib(), f"spi_{name}")(
        x.data_ptr(), y.data_ptr(), None if f is None else f.data_ptr(),
        int(f is not None and f.dtype == torch.bfloat16), 0 if f is None else f.ndim, fw, fh,
        n * c, h, w, out_h, out_w, upx, upy, downx, downy, padx0, pady0, int(flip_filter),
        gain, _lib.stream_handle(x.device),
    )
    _lib.check(err, name)
    _lib.launch_counts[name] += 1
    return y


class _Upfirdn2d(torch.autograd.Function):
    """upfirdn2d as a differentiable function of x: the kernel on a CUDA
    tensor, `upfirdn2d_plain` on a CPU one. The filter takes no gradient.
    up, down: (x, y) factors; padding: (x0, x1, y0, y1)."""

    @staticmethod
    def forward(x, f, up, down, padding, flip_filter, gain):
        if not x.is_cuda:
            return upfirdn2d_plain(x, f, up, down, padding, flip_filter, gain)
        return upfirdn2d_cuda(x.contiguous(), None if f is None else f.contiguous(), up, down,
                              padding, flip_filter, gain)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, f, *cfg = inputs
        ctx.save_for_backward(f)
        ctx.cfg = tuple(cfg)
        ctx.in_hw = tuple(x.shape[2:])

    @staticmethod
    def backward(ctx, dy):
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        (f,) = ctx.saved_tensors
        (upx, upy), (downx, downy), (px0, px1, py0, py1), flip_filter, gain = ctx.cfg
        ih, iw = ctx.in_hw
        oh, ow = dy.shape[2:]
        fw, fh = filter_size(f)
        # The adjoint: the cotangent upsampled by `down`, filtered with the
        # opposite flip, downsampled by `up`, under the padding that gives
        # back x's shape (StyleGAN2-ADA's Upfirdn2dCuda.backward).
        p = (fw - px0 - 1, iw * upx - ow * downx + px0 - upx + 1,
             fh - py0 - 1, ih * upy - oh * downy + py0 - upy + 1)
        dx = _Upfirdn2d.apply(dy, f, (downx, downy), (upx, upy), p, not flip_filter, gain)
        return dx, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, f, up, down, padding, flip_filter, gain):
        """Under torch.func.vmap, one launch for the B images: the image axis
        folds into N. The filter must be the same for every image."""
        x_dim, f_dim = in_dims[:2]
        if f_dim is not None or x_dim is None:
            raise ValueError("upfirdn2d under vmap takes batched images and one filter for all")
        x = x.movedim(x_dim, 0)
        b, n = x.shape[:2]
        y = _Upfirdn2d.apply(x.reshape(b * n, *x.shape[2:]), f, up, down, padding,
                             flip_filter, gain)
        return y.reshape(b, n, *y.shape[1:]), 0


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1.0):
    """Zero-upsample by `up` (up-1 zeros after each pixel), pad/crop by
    `padding` (x0, x1, y0, y1; negative crops), convolve with `f` (true
    convolution unless flip_filter), keep every `down`-th pixel.

    x: (N, C, H, W); f: 2D or 1D (outer product) filter tensor, or None.
    A CUDA tensor goes through the kernel (float32 and bfloat16; other
    dtypes raise), a CPU tensor through `upfirdn2d_plain`.
    """
    if not x.is_cuda:
        return upfirdn2d_plain(x, f, up, down, padding, flip_filter, gain)
    if f is not None and f.requires_grad:
        raise ValueError("the upfirdn2d kernel takes no gradient of the filter")
    return _Upfirdn2d.apply(x, f, _parse_scaling(up), _parse_scaling(down),
                            _parse_padding(padding), bool(flip_filter), float(gain))


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
