"""Fused bias + activation + gain + clamp (counterpart of
spi_tpu/ops/bias_act.py and spi_tpu/ops/bias_act_pallas.py).

`bias_act` is the op every StyleGAN2, SR, mapping and decoder layer
calls. On a CUDA tensor it launches the hand-written kernel of
`csrc/bias_act.cu` (forward and backward, wrapped in an autograd
Function), as EG3D's `impl='cuda'` did; on a CPU tensor it runs the
plain elementwise chain `bias_act_plain` under PyTorch's autograd.
There is no switch and no fallback between the two.

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


# Activation table of spi_tpu/ops/bias_act.py (EG3D bias_act.py:23-33),
# with each activation's id in csrc/bias_act.cu.
activation_funcs: dict[str, _ActSpec] = {
    "linear": _ActSpec(lambda x, alpha: x, 0.0, 1.0, 0),
    "relu": _ActSpec(lambda x, alpha: F.relu(x), 0.0, math.sqrt(2), 1),
    # As jax.nn.leaky_relu: the x >= 0 branch at 0, so lrelu'(0) = 1 like
    # both spi_tpu impls and the kernel (F.leaky_relu's gradient there is alpha).
    "lrelu": _ActSpec(lambda x, alpha: torch.where(x >= 0, x, x * alpha), 0.2, math.sqrt(2), 2),
    "tanh": _ActSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0, 3),
    "sigmoid": _ActSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0, 4),
    "elu": _ActSpec(lambda x, alpha: F.elu(x), 0.0, 1.0, 5),
    "selu": _ActSpec(lambda x, alpha: F.selu(x), 0.0, 1.0, 6),
    "softplus": _ActSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0, 7),
    "swish": _ActSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2), 8),
}


def _resolve(act, alpha, gain, clamp):
    if clamp is not None and clamp < 0:
        raise ValueError(f"clamp must be None or >= 0, got {clamp}")
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    clamp = float(clamp) if clamp is not None else None
    return spec, alpha, gain, clamp


def bias_act_plain(x, b=None, dim=1, act="linear", alpha=None, gain=None, clamp=None):
    """The plain PyTorch version: the elementwise chain of
    spi_tpu/ops/bias_act.py:67-83."""
    spec, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    if b is not None:
        if b.ndim != 1 or b.shape[0] != x.shape[dim]:
            raise ValueError(f"bias of shape {tuple(b.shape)} does not match dim {dim} of {tuple(x.shape)}")
        x = x + b.reshape([-1 if i == dim else 1 for i in range(x.ndim)])
    x = spec.func(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


def _shape_2d(x, dim):
    c = x.shape[dim]
    trail = math.prod(x.shape[dim + 1:])
    return c, trail


def bias_act_fwd_cuda(x, b, dim, act_id, alpha, gain, clamp):
    """Launch the forward kernel: y = clamp(act(x + b) * gain). `clamp`
    None disables clamping."""
    _lib.require(x, "x")
    _lib.require(b, "b", device=x.device, ndim=1)
    c, trail = _shape_2d(x, dim)
    if b.shape[0] != c:
        raise ValueError(f"bias has {b.shape[0]} entries, dim {dim} has {c}")
    if x.numel() >= 2**31:
        raise ValueError(f"bias_act kernel takes < 2^31 elements, got {x.numel()}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    err = _lib.lib().spi_bias_act_fwd(
        x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), c, trail, act_id,
        alpha, gain, -1.0 if clamp is None else clamp, _lib.stream_handle(x.device),
    )
    _lib.check(err, "bias_act_fwd")
    _lib.launch_counts["bias_act_fwd"] += 1
    return y


def bias_act_bwd_cuda(g, x, b, dim, act_id, alpha, gain, clamp):
    """Launch the backward kernel: dx = g * act'(x + b) * gain, zero where
    the forward clamped."""
    _lib.require(g, "grad", device=x.device)
    _lib.require(x, "x")
    _lib.require(b, "b", device=x.device, ndim=1)
    if g.shape != x.shape:
        raise ValueError(f"grad shape {tuple(g.shape)} != x shape {tuple(x.shape)}")
    c, trail = _shape_2d(x, dim)
    if x.numel() >= 2**31:
        raise ValueError(f"bias_act kernel takes < 2^31 elements, got {x.numel()}")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    err = _lib.lib().spi_bias_act_bwd(
        g.data_ptr(), x.data_ptr(), b.data_ptr(), dx.data_ptr(), x.numel(), c,
        trail, act_id, alpha, gain, -1.0 if clamp is None else clamp,
        _lib.stream_handle(x.device),
    )
    _lib.check(err, "bias_act_bwd")
    _lib.launch_counts["bias_act_bwd"] += 1
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
    `bias_act_plain`. Only float32 is taken on the card.
    """
    if not x.is_cuda:
        return bias_act_plain(x, b, dim=dim, act=act, alpha=alpha, gain=gain, clamp=clamp)
    spec, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    if not 0 <= dim < x.ndim:
        raise ValueError(f"dim {dim} out of range for shape {tuple(x.shape)}")
    if b is None:
        b = torch.zeros(x.shape[dim], dtype=x.dtype, device=x.device)
    return _BiasActCuda.apply(x.contiguous(), b.contiguous(), dim, spec.cuda_id,
                              alpha, gain, clamp)
