"""The reference's products: every convolution and matrix product of the
reference goes through these helpers, which compute in float32 (TF32 is
off, `full_float32`) and, inside `operands(dtype)`, first round both
operands to `dtype`, and the gradient that comes back to each operand
too: bfloat16; or float8, e4m3 forward and e5m2 backward, each tensor
with its own scale (the usual float8 training recipe). That is the
control of `correct`: the reference computed in the precision below the
one the configuration states, with float32 accumulation, as a
lower-precision kernel would."""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_OPERAND = contextvars.ContextVar("operand_dtype", default=None)
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # largest finite


def full_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def operands(dtype):
    """Round the operands of every product to `dtype` (None: float32)."""
    token = _OPERAND.set(dtype)
    try:
        yield
    finally:
        _OPERAND.reset(token)


def _round(t, dt):
    if dt in FP8_MAX:
        scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX[dt]
        return (t / scale).to(dt).to(t.dtype) * scale
    return t.to(dt).to(t.dtype)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dt):
        ctx.dt = torch.float8_e5m2 if dt == torch.float8_e4m3fn else dt
        return _round(t, dt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dt), None


def q(t):
    """`t` rounded to the operand precision in force, back in its dtype; its
    gradient rounded likewise."""
    dt = _OPERAND.get()
    return t if dt is None else _Round.apply(t, dt)


def conv2d(x, w, bias=None, stride=1, padding=0, groups=1):
    return F.conv2d(q(x), q(w), bias, stride=stride, padding=padding, groups=groups)


def conv_transpose2d(x, w, stride=1, padding=0, groups=1):
    return F.conv_transpose2d(q(x), q(w), stride=stride, padding=padding, groups=groups)


def linear(x, w, bias=None):
    return F.linear(q(x), q(w), bias)


def matmul(a, b):
    return q(a) @ q(b)
