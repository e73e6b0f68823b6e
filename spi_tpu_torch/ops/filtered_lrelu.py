"""Bias -> up-FIR -> leaky ReLU with gain and clamp -> down-FIR
(counterpart of spi_tpu/ops/filtered_lrelu.py; spec EG3D
torch_utils/ops/filtered_lrelu.py:58-155, `_filtered_lrelu_ref` at
:124-166), the StyleGAN3 alias-free nonlinearity.

spi_tpu composes it from XLA ops. The port routes each call by what it
can observe:
- on a CUDA tensor that the fused kernel takes (float32; up 1, 2 or 4
  with a 1-D up filter of 6 * up taps, none at up 1; down 1 or 2 with a
  1-D down filter of 6 * down taps, none at down 1: every layer of
  StyleGAN3-T), `_FilteredLReLUCuda` over `csrc/filtered_lrelu.cu`: one
  forward kernel computes the whole op per output tile with the upsampled
  map in shared memory, and, where a gradient is needed, writes 2 bits of
  each upsampled value (`pack_signs`); the backward kernel reads only those
  and the output's gradient, and a second kernel sums the bias gradient;
- anything else (2-D radial filters, other dtypes, factors or taps past
  the kernel's), and every CPU tensor, takes `filtered_lrelu_composed`:
  two `bias_act` and two `upfirdn2d` calls, the kernels of each on a card,
  their plain versions on the CPU.
`filtered_lrelu_fwd_plain` / `filtered_lrelu_bwd_plain` are the fused
kernels' plain versions (forward with packed signs; backward from them).
The filters are float32 tensors (1D separable or 2D), or None for the
identity. Each call is one `spi.filtered_lrelu` span.
"""

from __future__ import annotations

import math

import torch

from spi_tpu_torch.ops import _lib
from spi_tpu_torch.ops.bias_act import bias_act
from spi_tpu_torch.ops.upfirdn2d import _parse_padding, filter_size, upfirdn2d, upfirdn2d_plain
from spi_tpu_torch.utils.stats import span

# What the fused kernel takes (csrc/filtered_lrelu.cu kFilterTaps): real
# taps of each filter a phase, and the factors: filter taps by factor, 1
# meaning no filter.
FILTER_TAPS = 6
UP_TAPS = {1: 1, 2: 2 * FILTER_TAPS, 4: 4 * FILTER_TAPS}
DOWN_TAPS = {1: 1, 2: 2 * FILTER_TAPS}


def _sizes(in_h, in_w, fu_hw, fd_hw, up, down, padding):
    """(up_h, up_w, out_h, out_w): the upsampled, filtered map and the
    output. fu_hw / fd_hw: (width, height) of each filter."""
    px0, px1, py0, py1 = padding
    up_w = in_w * up + px0 + px1 - (fu_hw[0] - 1)
    up_h = in_h * up + py0 + py1 - (fu_hw[1] - 1)
    return up_h, up_w, (up_h - fd_hw[1]) // down + 1, (up_w - fd_hw[0]) // down + 1


def filtered_lrelu_composed(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter):
    """The op as two bias_act and two upfirdn2d calls (EG3D's
    `_filtered_lrelu_ref`); padding (x0, x1, y0, y1)."""
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=list(padding), gain=up**2, flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)


def _shifts(device):
    """The bit offsets (0, 2, 4, 6) of a byte's four values, made on the
    device (no copy from the host)."""
    return torch.arange(0, 8, 2, dtype=torch.uint8, device=device)


def pack_signs(neg, clamped):
    """Two bits of each upsampled value, four neighbours along x a byte:
    value 4g + j of a row in bits 2j ("not u >= 0", so lrelu' is the
    slope) and 2j + 1 ("not |v| < clamp": clamped, the gradient is 0).
    neg, clamped: bool (..., H, W) -> uint8 (..., H, ceil(W / 4)), the
    bits past W 0."""
    w = neg.shape[-1]
    code = neg.to(torch.uint8) | (clamped.to(torch.uint8) << 1)
    code = torch.nn.functional.pad(code, (0, -w % 4)).unflatten(-1, (-1, 4))
    return (code << _shifts(code.device)).sum(-1, dtype=torch.uint8)


def unpack_signs(signs, w):
    """(neg, clamped) bool (..., H, w) of `pack_signs`' bytes."""
    code = ((signs[..., None] >> _shifts(signs.device)) & 3).flatten(-2)[..., :w]
    return (code & 1).bool(), (code & 2).bool()


def filtered_lrelu_fwd_plain(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter):
    """The fused forward kernel's plain version: (y, signs), signs as
    `pack_signs` of the upsampled pre-activation u = upfirdn2d(x + b, fu)
    (N, C, up_h, ceil(up_w / 4)). The sign and clamp tests are those of
    csrc/bias_act.cu: lrelu'(u) = 1 where u >= 0, clamped where
    not |lrelu(u) * gain| < clamp."""
    if b is not None:
        x = x + b.to(x.dtype)[None, :, None, None]
    u = upfirdn2d_plain(x, fu, up=up, padding=padding, gain=up**2, flip_filter=flip_filter)
    neg = ~(u >= 0)
    v = torch.where(neg, u * slope, u) * gain
    if clamp is None:
        clamped = torch.zeros_like(neg)
    else:
        clamped = ~(v.abs() < clamp)
        v = v.clamp(-clamp, clamp)
    y = upfirdn2d_plain(v, fd, down=down, flip_filter=flip_filter)
    return y, pack_signs(neg, clamped)


def filtered_lrelu_bwd_plain(dy, signs, fu, fd, in_hw, up, down, padding, gain, slope,
                             flip_filter, need_db=True):
    """The fused backward kernels' plain version: (dx, db) from the
    output's gradient and the forward's signs alone. dv, the gradient of
    the activated map, is dy through the down-FIR's adjoint; du = dv *
    slope (where the sign bit is set) * gain, 0 where clamped; dx is du
    through the up-FIR's adjoint, db its sum over each channel (None
    unless need_db)."""
    (ih, iw), (oh, ow) = in_hw, dy.shape[2:]
    px0, px1, py0, py1 = padding
    fuw, fuh = filter_size(fu)
    fdw, fdh = filter_size(fd)
    up_h, up_w, _, _ = _sizes(ih, iw, (fuw, fuh), (fdw, fdh), up, down, padding)
    # Each FIR's adjoint, as _Upfirdn2d.backward: up and down swapped, the
    # opposite flip, the padding that gives back the forward's input.
    dv = upfirdn2d_plain(dy, fd, up=down, padding=(fdw - 1, up_w - ow * down, fdh - 1,
                                                    up_h - oh * down), flip_filter=not flip_filter)
    neg, clamped = unpack_signs(signs, up_w)
    du = torch.where(clamped, 0.0, torch.where(neg, dv * slope, dv) * gain).to(dv.dtype)
    dx = upfirdn2d_plain(du, fu, down=up, padding=(fuw - px0 - 1, iw * up - up_w + px0 - up + 1,
                                                    fuh - py0 - 1, ih * up - up_h + py0 - up + 1),
                         flip_filter=not flip_filter, gain=up**2)
    return dx, (dx.sum(dim=(0, 2, 3)) if need_db else None)


def fused_refusal(x, fu, fd, b, up, down):
    """Why the fused kernel does not take this call (a message), or None
    where it does; the device is left to the caller. It takes float32 NCHW
    x, up in UP_TAPS with a 1-D float32 up filter of that many taps (none
    at up 1), down in DOWN_TAPS likewise, and a float32 (C,) bias or
    none."""
    if x.ndim != 4 or x.dtype != torch.float32:
        return f"the filtered_lrelu kernel takes float32 NCHW, got {x.dtype} {tuple(x.shape)}"
    for name, f, factor, forms in (("up", fu, up, UP_TAPS), ("down", fd, down, DOWN_TAPS)):
        if f is not None and (f.ndim != 1 or f.dtype != torch.float32):
            return (f"the filtered_lrelu kernel takes 1-D float32 filters, got a "
                    f"{tuple(f.shape)} {f.dtype} {name} filter")
        taps = 1 if f is None else int(f.shape[0])
        if forms.get(factor) != taps:
            return (f"the filtered_lrelu kernel takes {name} factor and taps in "
                    f"{sorted(forms.items())} (1 tap: no filter), got {factor} and {taps}")
    if b is not None and (b.ndim != 1 or b.dtype != torch.float32 or b.shape[0] != x.shape[1]):
        return (f"the filtered_lrelu kernel takes a float32 (C,) bias, got {tuple(b.shape)} "
                f"{b.dtype}")
    return None


def _require_filter(f, name, x):
    if f is not None:
        _lib.require(f, name, device=x.device, ndim=1)


def _ptr(t):
    return None if t is None else t.data_ptr()


def filtered_lrelu_fwd_cuda(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter,
                            write_signs):
    """Launch the forward kernel: (y, signs), signs a uint8 (N, C, up_h,
    ceil(up_w / 4)) tensor where write_signs, else None. Raises on what
    the kernel does not take."""
    refusal = fused_refusal(x, fu, fd, b, up, down)
    if refusal:
        raise ValueError(refusal)
    n, c, h, w = x.shape
    up_h, up_w, out_h, out_w = _sizes(h, w, filter_size(fu), filter_size(fd), up, down, padding)
    if out_h < 1 or out_w < 1:
        raise ValueError("upsampled buffer smaller than filter")
    if h * w >= 2**31 or up_h * up_w >= 2**31 or n * c >= 2**31:
        raise ValueError(f"the filtered_lrelu kernel takes < 2^31 planes and values a plane, got "
                         f"{tuple(x.shape)} upsampled to {up_h}x{up_w}")
    _lib.require(x, "x")
    _require_filter(fu, "fu", x)
    _require_filter(fd, "fd", x)
    if b is not None:
        _lib.require(b, "b", device=x.device, ndim=1)
    y = torch.empty(n, c, out_h, out_w, device=x.device)
    signs = (torch.empty(n, c, up_h, (up_w + 3) // 4, dtype=torch.uint8, device=x.device)
             if write_signs else None)
    if y.numel() == 0:
        return y, signs
    err = _lib.lib().spi_filtered_lrelu_fwd(
        x.data_ptr(), _ptr(b), _ptr(fu), _ptr(fd), y.data_ptr(), _ptr(signs), n * c, c, h, w, up_h,
        up_w, out_h, out_w, up, down, padding[0], padding[2], int(flip_filter), gain, slope,
        -1.0 if clamp is None else clamp, _lib.stream_handle(x.device))
    _lib.check(err, "filtered_lrelu_fwd")
    _lib.launch_counts["filtered_lrelu_fwd"] += 1
    return y, signs


def filtered_lrelu_bwd_cuda(dy, signs, fu, fd, in_hw, up, down, padding, gain, slope, flip_filter,
                            need_db):
    """Launch the backward kernel, and where need_db the bias gradient's:
    (dx, db or None) from the output gradient dy and the forward's signs."""
    n, c, out_h, out_w = dy.shape
    h, w = in_hw
    up_h, up_w, oh, ow = _sizes(h, w, filter_size(fu), filter_size(fd), up, down, padding)
    if (oh, ow) != (out_h, out_w) or tuple(signs.shape) != (n, c, up_h, (up_w + 3) // 4):
        raise ValueError(f"dy {tuple(dy.shape)} and signs {tuple(signs.shape)} do not fit an "
                         f"input of {in_hw} upsampled to {up_h}x{up_w}")
    _lib.require(dy, "dy")
    _lib.require(signs, "signs", dtype=torch.uint8, device=dy.device, align=1)
    _require_filter(fu, "fu", dy)
    _require_filter(fd, "fd", dy)
    lib = _lib.lib()
    tiles = lib.spi_filtered_lrelu_bwd_tiles(up, down, h, w)
    if tiles < 0 or n * c * tiles >= 2**31:
        raise ValueError(f"the filtered_lrelu kernel takes < 2^31 tiles, got {n * c} planes of "
                         f"{h}x{w}")
    dx = torch.empty(n, c, h, w, device=dy.device)
    part = torch.empty(n * c * tiles, device=dy.device) if need_db else None
    db = torch.empty(c, device=dy.device) if need_db else None
    if dx.numel() == 0:
        return dx, None if db is None else db.zero_()
    stream = _lib.stream_handle(dy.device)
    err = lib.spi_filtered_lrelu_bwd(
        dy.data_ptr(), signs.data_ptr(), _ptr(fu), _ptr(fd), dx.data_ptr(), _ptr(part), n * c, h,
        w, up_h, up_w, out_h, out_w, up, down, padding[0], padding[2], int(flip_filter), gain,
        slope, stream)
    _lib.check(err, "filtered_lrelu_bwd")
    _lib.launch_counts["filtered_lrelu_bwd"] += 1
    if need_db:
        err = lib.spi_filtered_lrelu_bias_grad(part.data_ptr(), db.data_ptr(), n, c, tiles, stream)
        _lib.check(err, "filtered_lrelu_bias_grad")
        _lib.launch_counts["filtered_lrelu_bias_grad"] += 1
    return dx, db


class _FilteredLReLUCuda(torch.autograd.Function):
    """The fused kernels as a differentiable function of x and b. It saves
    the packed signs and the filters, never x or the upsampled map. The
    filters take no gradient."""

    @staticmethod
    def forward(ctx, x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter,
                write_signs):
        y, signs = filtered_lrelu_fwd_cuda(x, fu, fd, b, up, down, padding, gain, slope, clamp,
                                           flip_filter, write_signs)
        ctx.save_for_backward(signs, fu, fd)
        ctx.cfg = (tuple(x.shape[2:]), up, down, padding, gain, slope, flip_filter)
        return y

    @staticmethod
    def backward(ctx, dy):
        signs, fu, fd = ctx.saved_tensors
        if signs is None:
            raise RuntimeError("filtered_lrelu saved no signs: its forward ran with no gradient "
                               "needed")
        dx, db = _FilteredLReLUCudaGrad.apply(dy.contiguous(), signs, fu, fd, *ctx.cfg,
                                              ctx.needs_input_grad[3])
        return (dx if ctx.needs_input_grad[0] else None), None, None, db, *(None,) * 8


class _FilteredLReLUCudaGrad(torch.autograd.Function):
    """The backward kernels, as a function of dy whose own backward raises:
    the signs hold no second derivative (no path of the port takes one
    through StyleGAN3; the GAN's R1 runs through EG3D)."""

    @staticmethod
    def forward(ctx, dy, signs, fu, fd, in_hw, up, down, padding, gain, slope, flip_filter,
                need_db):
        return filtered_lrelu_bwd_cuda(dy, signs, fu, fd, in_hw, up, down, padding, gain, slope,
                                       flip_filter, need_db)

    @staticmethod
    def backward(ctx, *_):
        raise RuntimeError("the filtered_lrelu CUDA kernels take no second derivative")


def filtered_lrelu(x, fu=None, fd=None, b=None, up: int = 1, down: int = 1, padding=0,
                   gain: float = math.sqrt(2.0), slope: float = 0.2,
                   clamp: float | None = None, flip_filter: bool = False):
    """x: (N, C, H, W); fu / fd: up / down FIR filters; b: (C,) bias.
    Returns (N, C, H', W') with
    H' = (H * up + py0 + py1 - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down."""
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    padding = _parse_padding(padding)
    n, c, in_h, in_w = x.shape
    _, _, out_h, out_w = _sizes(in_h, in_w, filter_size(fu), filter_size(fd), up, down, padding)

    with span("spi.filtered_lrelu"):
        if x.is_cuda and fused_refusal(x, fu, fd, b, up, down) is None:
            if any(f is not None and f.requires_grad for f in (fu, fd)):
                raise ValueError("the filtered_lrelu kernel takes no gradient of the filters")
            write_signs = torch.is_grad_enabled() and (
                x.requires_grad or (b is not None and b.requires_grad))
            x = _FilteredLReLUCuda.apply(
                x.contiguous(), *(None if t is None else t.contiguous() for t in (fu, fd, b)),
                int(up), int(down), padding, float(gain), float(slope),
                None if clamp is None else float(clamp), bool(flip_filter), write_signs)
        else:
            x = filtered_lrelu_composed(x, fu, fd, b, up, down, padding, gain, slope, clamp,
                                        flip_filter)
    if tuple(x.shape) != (n, c, out_h, out_w):
        raise ValueError(f"filtered_lrelu gave {tuple(x.shape)}, expected {(n, c, out_h, out_w)}")
    return x
