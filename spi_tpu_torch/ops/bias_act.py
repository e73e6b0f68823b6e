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

The kernels differentiate twice, as EG3D's (`BiasActCudaGrad`): the
backward is an autograd Function of its own (`_BiasActCudaGrad`), whose
backward launches the backward kernel again for the cotangent of g (dx
is linear in g) and, where act'' is not identically 0 (tanh, sigmoid,
elu, selu, softplus, swish), the second-order kernel for x and b
(`bias_act_grad2_plain` is its plain version; float32 only). The GAN's
lazy R1 penalty is such a second-order gradient. A third order raises.

Under torch.func.vmap (several images a step, parallel/mesh.py) the
autograd Function's vmap rule launches the kernel once for the batch, as
spi_tpu's `jax.vmap` of the layer does: a shared bias folds the image axis
into the rows; a bias of each image's own (stage 2 tunes per-image
weights) takes the kernels' batched-bias form, a (B, C) bias over B
images. The plain chain needs no rule.
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
    # d^2 act / d x^2 from x and y, where it is not identically 0: at x = 0
    # the value of jax.grad(jax.grad(...)) of spi_tpu's impl='xla' path.
    grad2: Callable | None = None


_SELU_LAMBDA, _SELU_ALPHA = 1.0507009873554805, 1.6732632423543772


def _step(x, below):
    return torch.where(x >= 0, 1.0, below).to(x.dtype)


def _expm1_below(x):
    """expm1(x) where x <= 0, else 0: jax.nn.elu's `safe_x`, so that the
    branch not taken never overflows into a NaN gradient."""
    return torch.expm1(torch.where(x > 0, 0.0, x))


def _elu(x):
    # jax.nn.elu's form, whose first and second derivatives at 0 are the
    # expm1 branch's (F.elu's second derivative there is 0).
    return torch.where(x > 0, x, _expm1_below(x))


def _swish_grad(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _swish_grad2(x):
    s = torch.sigmoid(x)
    return s * (1.0 - s) * (2.0 + x * (1.0 - 2.0 * s))


def _softplus_grad2(x):
    s = torch.sigmoid(x)
    return s * (1.0 - s)


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
    "tanh": _ActSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0, 3, lambda x, y, alpha: 1.0 - y * y,
                     lambda x, y: -2.0 * y * (1.0 - y * y)),
    "sigmoid": _ActSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0, 4,
                        lambda x, y, alpha: y * (1.0 - y),
                        lambda x, y: y * (1.0 - y) * (1.0 - 2.0 * y)),
    # elu and selu are where(x > 0, x, expm1(x)) here as in jax.nn: at 0
    # their second derivative is the expm1 branch's.
    "elu": _ActSpec(lambda x, alpha: _elu(x), 0.0, 1.0, 5,
                    lambda x, y, alpha: torch.where(x >= 0, 1.0, y + 1.0),
                    lambda x, y: torch.where(x > 0, 0.0, y + 1.0)),
    "selu": _ActSpec(lambda x, alpha: _SELU_LAMBDA * torch.where(
        x > 0, x, _SELU_ALPHA * _expm1_below(x)), 0.0, 1.0, 6,
                     lambda x, y, alpha: torch.where(x > 0, _SELU_LAMBDA,
                                                     y + _SELU_LAMBDA * _SELU_ALPHA),
                     lambda x, y: torch.where(x > 0, 0.0, y + _SELU_LAMBDA * _SELU_ALPHA)),
    "softplus": _ActSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0, 7,
                         lambda x, y, alpha: torch.sigmoid(x), lambda x, y: _softplus_grad2(x)),
    "swish": _ActSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2), 8,
                      lambda x, y, alpha: _swish_grad(x), lambda x, y: _swish_grad2(x)),
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


def bias_act_grad2_plain(gg, g, x, b=None, dim=1, act="linear", alpha=None, gain=None,
                        clamp=None):
    """The plain version of the second-order kernel, float32: the derivative
    of the backward kernel's dx with respect to x, applied to the cotangent
    gg of dx: gg * g * act''(x + b) * gain, 0 where the forward clamped; 0
    for linear, relu and lrelu. At x + b = 0, act'' is that of
    jax.grad(jax.grad(...)) of spi_tpu's impl='xla' path."""
    spec, alpha, gain, clamp = _resolve(act, alpha, gain, clamp)
    xb = _add_bias(x, b, dim)
    if spec.grad2 is None:
        return torch.zeros_like(xb)
    y = spec.func(xb, alpha)
    d = gg.float() * g.float() * spec.grad2(xb, y) * gain
    if clamp is not None:
        yg = y * gain
        d = torch.where((yg > -clamp) & (yg < clamp), d, 0.0)
    return d


def _shape_2d(x, dim):
    c = x.shape[dim]
    trail = math.prod(x.shape[dim + 1:])
    return c, trail


def _kernel_dtype(x):
    if x.dtype not in _COUNTS:
        raise ValueError(f"the bias_act kernels take float32 or bfloat16, got {x.dtype}")
    return x.dtype


def _kernel_shapes(x, b, dim):
    """(C, trail, elements a bias row serves) of a kernel call. A 1-D bias
    (C,) serves all of x; a batched bias (B, C), one row an image, serves
    x's B leading slices, one each."""
    c, trail = _shape_2d(x, dim)
    if b.shape[-1] != c or (b.ndim == 2 and (dim == 0 or x.shape[0] != b.shape[0])):
        raise ValueError(f"bias of shape {tuple(b.shape)} does not fit dim {dim} of "
                         f"{tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"bias_act kernel takes < 2^31 elements, got {x.numel()}")
    return c, trail, x.numel() // b.shape[0] if b.ndim == 2 else x.numel()


def _require_bias(b, dt, device):
    _lib.require(b, "b", dtype=dt, device=device, align=dt.itemsize)
    if b.ndim not in (1, 2):
        raise ValueError(f"b must be (C,) or batched (B, C), got shape {tuple(b.shape)}")


def bias_act_fwd_cuda(x, b, dim, act_id, alpha, gain, clamp):
    """Launch the forward kernel: y = clamp(act(x + b) * gain). x and b of
    one dtype, float32 or bfloat16. `clamp` None disables clamping. b is
    (C,), or (B, C) for B images stacked on x's first axis, each with its
    own bias (the batched-bias form, one launch for the B images)."""
    dt = _kernel_dtype(x)
    _lib.require(x, "x", dtype=dt, align=dt.itemsize)
    _require_bias(b, dt, x.device)
    c, trail, img_elems = _kernel_shapes(x, b, dim)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    name = _COUNTS[dt][0]
    err = getattr(_lib.lib(), f"spi_{name}")(
        x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), c, trail, img_elems, act_id,
        alpha, gain, -1.0 if clamp is None else clamp, _lib.stream_handle(x.device),
    )
    _lib.check(err, name)
    _lib.launch_counts[name] += 1
    return y


def bias_act_bwd_cuda(g, x, b, dim, act_id, alpha, gain, clamp):
    """Launch the backward kernel: dx = g * act'(x + b) * gain, zero where
    the forward clamped. g, x and b of one dtype, float32 or bfloat16; b
    as in `bias_act_fwd_cuda`."""
    dt = _kernel_dtype(x)
    _lib.require(g, "grad", dtype=dt, device=x.device, align=dt.itemsize)
    _lib.require(x, "x", dtype=dt, align=dt.itemsize)
    _require_bias(b, dt, x.device)
    if g.shape != x.shape:
        raise ValueError(f"grad shape {tuple(g.shape)} != x shape {tuple(x.shape)}")
    c, trail, img_elems = _kernel_shapes(x, b, dim)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    name = _COUNTS[dt][1]
    err = getattr(_lib.lib(), f"spi_{name}")(
        g.data_ptr(), x.data_ptr(), b.data_ptr(), dx.data_ptr(), x.numel(), c,
        trail, img_elems, act_id, alpha, gain, -1.0 if clamp is None else clamp,
        _lib.stream_handle(x.device),
    )
    _lib.check(err, name)
    _lib.launch_counts[name] += 1
    return dx


def bias_act_grad2_cuda(gg, g, x, b, dim, act_id, alpha, gain, clamp):
    """Launch the second-order kernel: gg * g * act''(x + b) * gain, zero
    where the forward clamped. float32 only (no path needs a bfloat16
    second order); b as in `bias_act_fwd_cuda`."""
    if x.dtype != torch.float32:
        raise ValueError(f"the second-order bias_act kernel takes float32, got {x.dtype}")
    for t, name in ((gg, "grad of dx"), (g, "grad")):
        _lib.require(t, name, device=x.device)
        if t.shape != x.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != x shape {tuple(x.shape)}")
    _lib.require(x, "x")
    _require_bias(b, torch.float32, x.device)
    c, trail, img_elems = _kernel_shapes(x, b, dim)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _lib.lib().spi_bias_act_grad2(
        gg.data_ptr(), g.data_ptr(), x.data_ptr(), b.data_ptr(), out.data_ptr(), x.numel(), c,
        trail, img_elems, act_id, alpha, gain, -1.0 if clamp is None else clamp,
        _lib.stream_handle(x.device),
    )
    _lib.check(err, "bias_act_grad2")
    _lib.launch_counts["bias_act_grad2"] += 1
    return out


# The activations whose second derivative is not identically 0, by kernel id.
_SECOND_ORDER_IDS = frozenset(s.cuda_id for s in activation_funcs.values() if s.grad2)


def _bias_grad(d, x, b, dim):
    """db from an elementwise gradient d of x: summed per channel, over all
    of x for a (C,) bias and over each image's rows for a (B, C) one."""
    c, trail = _shape_2d(x, dim)
    db = d.reshape(b.shape[0] if b.ndim == 2 else 1, -1, c, trail).sum(dim=(1, 3))
    return db if b.ndim == 2 else db[0]


def _vmap_args(info, in_dims, tensors, b):
    """Batch-first, contiguous `tensors` (expanded where unbatched) and the
    bias: (B, C) where it is batched, else as it is."""
    n = info.batch_size
    out = [t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
           for t, d in zip(tensors, in_dims)]
    if in_dims[len(tensors)] is not None:
        b = b.movedim(in_dims[len(tensors)], 0)
    return [t.contiguous() for t in out], b.contiguous()


class _BiasActCuda(torch.autograd.Function):
    @staticmethod
    def forward(x, b, dim, act_id, alpha, gain, clamp):
        return bias_act_fwd_cuda(x, b, dim, act_id, alpha, gain, clamp)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, b, *cfg = inputs
        ctx.save_for_backward(x, b)
        ctx.cfg = tuple(cfg)

    @staticmethod
    def backward(ctx, g):
        x, b = ctx.saved_tensors
        dx = _BiasActCudaGrad.apply(g.contiguous(), x, b, *ctx.cfg)
        db = _bias_grad(dx, x, b, ctx.cfg[0]) if ctx.needs_input_grad[1] else None
        return (dx if ctx.needs_input_grad[0] else None), db, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, b, dim, act_id, alpha, gain, clamp):
        """Under torch.func.vmap, one launch for the B images: with a shared
        bias, B folds into x's outer rows; with a batched bias (each image's
        own, as in a vmapped stage-2 step) the batched-bias form takes the
        (B, C) bias."""
        (x,), b = _vmap_args(info, in_dims, (x,), b)
        return _BiasActCuda.apply(x, b, dim + 1, act_id, alpha, gain, clamp), 0


class _BiasActCudaGrad(torch.autograd.Function):
    """The backward kernel as a differentiable function of (g, x, b): dx =
    g * act'(x + b) * gain (EG3D's BiasActCudaGrad). Its own backward is
    the backward kernel again for g, and the second-order kernel for x and
    b where act'' is not identically 0; elsewhere their gradient is 0."""

    @staticmethod
    def forward(g, x, b, dim, act_id, alpha, gain, clamp):
        return bias_act_bwd_cuda(g, x, b, dim, act_id, alpha, gain, clamp)

    @staticmethod
    def setup_context(ctx, inputs, output):
        g, x, b, *cfg = inputs
        ctx.save_for_backward(g, x, b)
        ctx.cfg = tuple(cfg)

    @staticmethod
    def backward(ctx, gg):
        g, x, b = ctx.saved_tensors
        gg = gg.contiguous()
        need_g, need_x, need_b = ctx.needs_input_grad[:3]
        d_g = _BiasActCudaGrad.apply(gg, x, b, *ctx.cfg) if need_g else None
        d_x = d_b = None
        if (need_x or need_b) and ctx.cfg[1] in _SECOND_ORDER_IDS:
            d_x = _BiasActCudaGrad2.apply(gg, g, x, b, *ctx.cfg)
            d_b = _bias_grad(d_x, x, b, ctx.cfg[0]) if need_b else None
        return d_g, (d_x if need_x else None), d_b, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, g, x, b, dim, act_id, alpha, gain, clamp):
        """One launch for the B images, as `_BiasActCuda.vmap`."""
        (g, x), b = _vmap_args(info, in_dims, (g, x), b)
        return _BiasActCudaGrad.apply(g, x, b, dim + 1, act_id, alpha, gain, clamp), 0


class _BiasActCudaGrad2(torch.autograd.Function):
    """The second-order kernel (float32). Not differentiable again."""

    @staticmethod
    def forward(gg, g, x, b, dim, act_id, alpha, gain, clamp):
        return bias_act_grad2_cuda(gg, g, x, b, dim, act_id, alpha, gain, clamp)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, _):
        raise RuntimeError("the bias_act kernels differentiate twice, not three times")

    @staticmethod
    def vmap(info, in_dims, gg, g, x, b, dim, act_id, alpha, gain, clamp):
        (gg, g, x), b = _vmap_args(info, in_dims, (gg, g, x), b)
        return _BiasActCudaGrad2.apply(gg, g, x, b, dim + 1, act_id, alpha, gain, clamp), 0


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
