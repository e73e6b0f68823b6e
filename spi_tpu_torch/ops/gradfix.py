"""Convolutions whose gradients of every order are convolutions again (EG3D's
torch_utils/ops/conv2d_gradfix.py).

The GAN's lazy R1 penalty differentiates the discriminator twice.
PyTorch's built-in double backward of a convolution
(`_convolution_double_backward`) runs a grouped convolution, such as the
depthwise FIR filter of every resampling layer, as one convolution per
channel, which made an R1 step many times as long as a plain one. Here
the backward of a convolution is two autograd Functions of its own, the
input's gradient and the weight's, each one `torch.ops.aten.
convolution_backward` call (PyTorch's own first-order kernels: the
depthwise ones for a depthwise filter), and each one's backward is the
forward convolution or the other gradient again, on the same
configuration. spi_tpu needs none of this: XLA differentiates its
convolutions to any order.

This is plain PyTorch: cuDNN's and PyTorch's convolution kernels, no
kernel of this repository. Only the discriminator runs through it
(`conv2d_resample` here, its layers' resampling convolution): the
generator's convolutions, differentiated once, and under torch.func.vmap
on the batched path, keep `ops/conv.py`'s, which run faster there.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spi_tpu_torch.ops.upfirdn2d import filter_size


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv(x, w, stride=1, padding=0, groups=1):
    """F.conv2d differentiable to any order through convolutions."""
    cfg = (_pair(stride), _pair(padding), int(groups))
    return _Conv.apply(x, w, cfg)


def conv2d_resample(x, w, f=None, down=1, padding=0):
    """`ops/conv.conv2d_resample` without upsampling, as the discriminator's
    layers call it (flip_weight, the FIR filter `f` unflipped), with every
    convolution through `conv`: its down > 1 branches' padding arithmetic,
    and `upfirdn2d`'s pad and depthwise FIR filter written out."""
    if down == 1:
        return conv(x, w, 1, padding)
    fw, fh = filter_size(f)
    pad = [padding + (fw - down + 1) // 2, padding + (fw - down) // 2,
           padding + (fh - down + 1) // 2, padding + (fh - down) // 2]
    if w.shape[2] == w.shape[3] == 1:  # 1x1 kernel: downsample first, then convolve
        return conv(_fir(x, f, pad, down), w)
    return conv(_fir(x, f, pad, 1), w, down)


def _fir(x, f, pad, down):
    """upfirdn2d(x, f, down=down, padding=pad) for up = 1 and pad >= 0."""
    f = f.to(dtype=torch.float32)
    if f.ndim == 1:
        f = torch.outer(f, f)
    c = x.shape[1]
    weight = f.flip([0, 1]).to(x.dtype)[None, None].repeat(c, 1, 1, 1)
    return conv(F.pad(x, pad), weight, down, 0, c)


def _forward(x, w, cfg):
    stride, padding, groups = cfg
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


def _backward(gy, x, w, cfg, mask):
    """One of the convolution's first-order gradients (mask: input, weight)."""
    stride, padding, groups = cfg
    return torch.ops.aten.convolution_backward(
        gy, x, w, None, stride, padding, (1, 1), False, (0, 0), groups, [*mask, False])


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(x, w, cfg):
        return _forward(x, w, cfg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, cfg = inputs
        ctx.save_for_backward(x, w)
        ctx.cfg = cfg

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = _ConvInputGrad.apply(gy, x, w, ctx.cfg) if ctx.needs_input_grad[0] else None
        gw = _ConvWeightGrad.apply(gy, x, w, ctx.cfg) if ctx.needs_input_grad[1] else None
        return gx, gw, None


class _ConvInputGrad(torch.autograd.Function):
    """The input's gradient, linear in (gy, w); x gives only its shape."""

    @staticmethod
    def forward(gy, x, w, cfg):
        return _backward(gy, x, w, cfg, (True, False))[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        gy, x, w, cfg = inputs
        ctx.save_for_backward(gy, x, w)
        ctx.cfg = cfg

    @staticmethod
    def backward(ctx, ggx):
        gy, x, w = ctx.saved_tensors
        d_gy = _Conv.apply(ggx, w, ctx.cfg) if ctx.needs_input_grad[0] else None
        d_w = _ConvWeightGrad.apply(gy, ggx, w, ctx.cfg) if ctx.needs_input_grad[2] else None
        return d_gy, None, d_w, None


class _ConvWeightGrad(torch.autograd.Function):
    """The weight's gradient, linear in (gy, x); w gives only its shape."""

    @staticmethod
    def forward(gy, x, w, cfg):
        return _backward(gy, x, w, cfg, (False, True))[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        gy, x, w = inputs[:3]
        ctx.save_for_backward(gy, x, w)
        ctx.cfg = inputs[3]

    @staticmethod
    def backward(ctx, ggw):
        gy, x, w = ctx.saved_tensors
        d_gy = _Conv.apply(x, ggw, ctx.cfg) if ctx.needs_input_grad[0] else None
        d_x = _ConvInputGrad.apply(gy, x, ggw, ctx.cfg) if ctx.needs_input_grad[1] else None
        return d_gy, d_x, None, None
