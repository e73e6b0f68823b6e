"""Fused bias + activation + gain + clamp (counterpart of
spi_tpu/ops/bias_act.py and spi_tpu/ops/bias_act_pallas.py).

`bias_act` is the op every StyleGAN2, SR, mapping and decoder layer
calls. On a CUDA tensor it launches the hand-written kernel of
`csrc/bias_act.cu` (forward and backward, wrapped in an autograd
Function), as EG3D's `impl='cuda'` did; on a CPU tensor it runs the
plain elementwise chain `bias_act_plain` under PyTorch's autograd.
There is no switch and no fallback between the two.

float32 and bfloat16 are taken, with the Pallas kernels' rounding: x + b
is added in the input's dtype, everything after it is computed in
float32, and the result is rounded once to the input's dtype.
`bias_act_grad_plain` is the plain version of the backward kernel (dx by
the kernel's rule), against which the kernel is checked.

The kernel is first-order only (its backward is a kernel, not
differentiable again), which is all inversion needs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from spi_tpu_torch.ops import _lib


@dataclasses.dataclass(frozen=True)
class _ActSpec:
    func: Callable
    def_alpha: float
    def_gain: float
    cuda_id: int
    # d act / d x from the input x and the activation y, as the kernels'
    # act_grad: spi_tpu/ops/bias_act_pallas.py `_act_grad`, but at x = 0
    # the value of jax.grad of spi_tpu's default impl='xla' path.
    grad: Callable


_SELU_LAMBDA, _SELU_ALPHA = 1.0507009873554805, 1.6732632423543772


def _step(x, below):
    return torch.where(x >= 0, 1.0, below).to(x.dtype)


def _swish_grad(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


# Activation table of spi_tpu/ops/bias_act.py (EG3D bias_act.py:23-33),
# with each activation's id in csrc/bias_act.cu.
activation_funcs: dict[str, _ActSpec] = {
    "linear": _ActSpec(lambda x, alpha: x, 0.0, 1.0, 0, lambda x, y, alpha: torch.ones_like(x)),
    # relu'(0) = 0 and selu'(0) = lambda alpha, as jax.grad of impl='xla'
    # (the Pallas kernel takes the x >= 0 branch there).
    "relu": _ActSpec(lambda x, alpha: F.relu(x), 0.0, math.sqrt(2), 1,
                     lambda x, y, alpha: (x > 0).to(x.dtype)),
    # As jax.nn.leaky_relu: the x >= 0 branch at 0, so lrelu'(0) = 1 like
    # both spi_tpu impls and the kernel (F.leaky_relu's gradient there is alpha).
    "lrelu": _ActSpec(lambda x, alpha: torch.where(x >= 0, x, x * alpha), 0.2, math.sqrt(2), 2,
                      lambda x, y, alpha: _step(x, alpha)),
    "tanh": _ActSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0, 3, lambda x, y, alpha: 1.0 - y * y),
    "sigmoid": _ActSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0, 4,
                        lambda x, y, alpha: y * (1.0 - y)),
    "elu": _ActSpec(lambda x, alpha: F.elu(x), 0.0, 1.0, 5,
                    lambda x, y, alpha: torch.where(x >= 0, 1.0, y + 1.0)),
    "selu": _ActSpec(lambda x, alpha: F.selu(x), 0.0, 1.0, 6,
                     lambda x, y, alpha: torch.where(x > 0, _SELU_LAMBDA,
                                                     y + _SELU_LAMBDA * _SELU_ALPHA)),
    "softplus": _ActSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0, 7,
                         lambda x, y, alpha: torch.sigmoid(x)),
    "swish": _ActSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2), 8,
                      lambda x, y, alpha: _swish_grad(x)),
}

# The dtypes the kernels take, and the launch count of each kernel by dtype.
_COUNTS = {torch.float32: ("bias_act_fwd", "bias_act_bwd"),
           torch.bfloat16: ("bias_act_fwd_bf16", "bias_act_bwd_bf16")}


def _resolve(act, alpha, gain, clamp):
    if clamp is not None and clamp < 0:
        raise ValueError(f"clamp must be None or >= 0, got {clamp}")
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    clamp = float(clamp) if clamp is not None else None
    return spec, alpha, gain, clamp


def _add_bias(x, b, dim):
    """x + b along `dim`, in x's dtype, widened to float32."""
    if b is not None:
        if b.ndim != 1 or b.shape[0] != x.shape[dim]:
            raise ValueError(f"bias of shape {tuple(b.shape)} does not match dim {dim} "
                             f"of {tuple(x.shape)}")
        x = x + b.to(x.dtype).reshape([-1 if i == dim else 1 for i in range(x.ndim)])
    return x.float()


def bias_act_plain(x, b=None, dim=1, act="linear", alpha=None, gain=None, clamp=None):
    """The plain PyTorch version: the elementwise chain of
    spi_tpu/ops/bias_act.py:67-83, with the Pallas kernel's rounding
    (x + b in x's dtype, the rest in float32, one rounding to x's dtype at
    the end; for float32 inputs no rounding at all)."""
    spec, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    y = spec.func(_add_bias(x, b, dim), alpha)
    if gain != 1:
        y = y * gain
    if clamp is not None:
        y = y.clamp(-clamp, clamp)
    return y.to(x.dtype)


def bias_act_grad_plain(g, x, b=None, dim=1, act="linear", alpha=None, gain=None, clamp=None):
    """The plain version of the backward kernel: dx = g * act'(x + b) *
    gain in float32, 0 where the forward clamped (|act(x + b) * gain| >=
    clamp), rounded once to x's dtype (spi_tpu/ops/bias_act_pallas.py
    `_bwd_kernel`). At x + b = 0, act' is that of jax.grad of spi_tpu's
    default impl='xla' path, which the models run: relu'(0) = 0 and
    selu'(0) = lambda alpha, where the Pallas kernel gives 1 and lambda;
    lrelu'(0) = elu'(0) = 1 in both."""
    spec, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    xb = _add_bias(x, b, dim)
    y = spec.func(xb, alpha)
    d = g.float() * spec.grad(xb, y, alpha) * gain
    if clamp is not None:
        yg = y * gain
        d = torch.where((yg > -clamp) & (yg < clamp), d, 0.0)
    return d.to(x.dtype)


def _shape_2d(x, dim):
    c = x.shape[dim]
    trail = math.prod(x.shape[dim + 1:])
    return c, trail


def _kernel_dtype(x):
    if x.dtype not in _COUNTS:
        raise ValueError(f"the bias_act kernels take float32 or bfloat16, got {x.dtype}")
    return x.dtype


def bias_act_fwd_cuda(x, b, dim, act_id, alpha, gain, clamp):
    """Launch the forward kernel: y = clamp(act(x + b) * gain). x and b of
    one dtype, float32 or bfloat16. `clamp` None disables clamping."""
    dt = _kernel_dtype(x)
    _lib.require(x, "x", dtype=dt, align=dt.itemsize)
    _lib.require(b, "b", dtype=dt, device=x.device, ndim=1, align=dt.itemsize)
    c, trail = _shape_2d(x, dim)
    if b.shape[0] != c:
        raise ValueError(f"bias has {b.shape[0]} entries, dim {dim} has {c}")
    if x.numel() >= 2**31:
        raise ValueError(f"bias_act kernel takes < 2^31 elements, got {x.numel()}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    name = _COUNTS[dt][0]
    err = getattr(_lib.lib(), f"spi_{name}")(
        x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), c, trail, act_id,
        alpha, gain, -1.0 if clamp is None else clamp, _lib.stream_handle(x.device),
    )
    _lib.check(err, name)
    _lib.launch_counts[name] += 1
    return y


def bias_act_bwd_cuda(g, x, b, dim, act_id, alpha, gain, clamp):
    """Launch the backward kernel: dx = g * act'(x + b) * gain, zero where
    the forward clamped. g, x and b of one dtype, float32 or bfloat16."""
    dt = _kernel_dtype(x)
    _lib.require(g, "grad", dtype=dt, device=x.device, align=dt.itemsize)
    _lib.require(x, "x", dtype=dt, align=dt.itemsize)
    _lib.require(b, "b", dtype=dt, device=x.device, ndim=1, align=dt.itemsize)
    if g.shape != x.shape:
        raise ValueError(f"grad shape {tuple(g.shape)} != x shape {tuple(x.shape)}")
    c, trail = _shape_2d(x, dim)
    if x.numel() >= 2**31:
        raise ValueError(f"bias_act kernel takes < 2^31 elements, got {x.numel()}")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    name = _COUNTS[dt][1]
    err = getattr(_lib.lib(), f"spi_{name}")(
        g.data_ptr(), x.data_ptr(), b.data_ptr(), dx.data_ptr(), x.numel(), c,
        trail, act_id, alpha, gain, -1.0 if clamp is None else clamp,
        _lib.stream_handle(x.device),
    )
    _lib.check(err, name)
    _lib.launch_counts[name] += 1
    return dx


class _BiasActCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, b, dim, act_id, alpha, gain, clamp):
        ctx.save_for_backward(x, b)
        ctx.cfg = (dim, act_id, alpha, gain, clamp)
        return bias_act_fwd_cuda(x, b, dim, act_id, alpha, gain, clamp)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        dim = ctx.cfg[0]
        dx = bias_act_bwd_cuda(g.contiguous(), x, b, *ctx.cfg)
        db = None
        if ctx.needs_input_grad[1]:
            c, trail = _shape_2d(x, dim)
            db = dx.reshape(-1, c, trail).sum(dim=(0, 2))
        return (dx if ctx.needs_input_grad[0] else None), db, None, None, None, None, None


def bias_act(x, b=None, dim=1, act="linear", alpha=None, gain=None, clamp=None):
    """Add bias along `dim`, apply the activation, scale by gain, clamp to
    [-clamp, clamp] (clamp=None disables it). Matches EG3D's
    `_bias_act_ref` and spi_tpu's `bias_act`.

    A CUDA tensor goes through the kernel; a CPU tensor through
    `bias_act_plain`. The card takes float32 and bfloat16 (b is cast to
    x's dtype, as spi_tpu's Pallas path does); other dtypes raise.
    """
    if not x.is_cuda:
        return bias_act_plain(x, b, dim=dim, act=act, alpha=alpha, gain=gain, clamp=clamp)
    spec, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    if not 0 <= dim < x.ndim:
        raise ValueError(f"dim {dim} out of range for shape {tuple(x.shape)}")
    dt = _kernel_dtype(x)
    b = torch.zeros(x.shape[dim], dtype=dt, device=x.device) if b is None else b.to(dt)
    return _BiasActCuda.apply(x.contiguous(), b.contiguous(), dim, spec.cuda_id,
                              alpha, gain, clamp)
