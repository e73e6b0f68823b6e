"""The least time of each hand-written kernel's work, from the logical
shapes of the operation (never from a kernel's launch arguments or
counters), so that a kernel that does the same work another way is read
against the same count.

Rule: the larger of bytes over the HBM rate and operations over the
dtype's peak, counting each input read once and each output written once.
Peaks are NVIDIA's data-sheet values for one H100 SXM at 700 W."""

from __future__ import annotations

import dataclasses

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores, no tensor cores
BF16_FLOPS = 989e12  # dense tensor cores
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def bound_s(nbytes: float, flops: float, peak: float = F32_FLOPS) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


@dataclasses.dataclass(frozen=True)
class RenderPass:
    """One sampling pass of the triplane renderer: `points` world points
    read from `tables` plane sets of 3 x `hw` texels x `channels`, planes
    stored in `plane_dtype`; `backward`: whether the pass's splat runs."""

    points: int
    tables: int
    hw: int
    channels: int
    plane_dtype: str
    backward: bool


def lookup_bytes(p: RenderPass) -> float:
    """Planes once, coordinates (float32 xyz), features out (3 planes x C
    float32 a point)."""
    return (p.tables * 3 * p.hw * p.channels * DTYPE_BYTES[p.plane_dtype]
            + p.points * 3 * 4 + p.points * 3 * p.channels * 4)


def splat_bytes(p: RenderPass) -> float:
    """Coordinates and the (3, points, C) float32 cotangent in, the float32
    plane-gradient tables out."""
    return p.points * 3 * 4 + p.points * 3 * p.channels * 4 + p.tables * 3 * p.hw * p.channels * 4


def bilinear_flops(p: RenderPass) -> float:
    """4 corners x C multiply-adds a point and plane."""
    return p.points * 3 * 4 * p.channels * 2


def lookup_s(p: RenderPass) -> float:
    return bound_s(lookup_bytes(p), bilinear_flops(p))


def splat_s(p: RenderPass) -> float:
    return bound_s(splat_bytes(p), bilinear_flops(p))


@dataclasses.dataclass(frozen=True)
class BiasAct:
    """One bias + activation over `elements` values of `channels` biases in
    `dtype`; `backward`: whether its gradient kernel runs too."""

    elements: int
    channels: int
    dtype: str
    backward: bool


def bias_act_fwd_s(c: BiasAct) -> float:
    """x and b in, y out."""
    b = DTYPE_BYTES[c.dtype]
    return bound_s(2 * c.elements * b + c.channels * b, 4 * c.elements)


def bias_act_bwd_s(c: BiasAct) -> float:
    """g, x and b in, dx out."""
    b = DTYPE_BYTES[c.dtype]
    return bound_s(3 * c.elements * b + c.channels * b, 4 * c.elements)
