"""Ray/box math (counterpart of spi_tpu/models/rendering/math_utils.py;
spec EG3D math_utils.py)."""

from __future__ import annotations

import torch


def normalize_vecs(v):
    """math_utils.py:33-37 (plain norm division)."""
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def get_ray_limits_box(rays_o, rays_d, box_side_length):
    """Slab-test intersection of rays with the centered cube
    (math_utils.py:46-98). rays_o, rays_d: (..., 3) -> (tmin, tmax), each
    (..., 1); rays that miss get (-1, -2)."""
    half = box_side_length / 2
    invdir = 1.0 / rays_d
    t_lo = (-half - rays_o) * invdir
    t_hi = (half - rays_o) * invdir
    tmin = torch.minimum(t_lo, t_hi).amax(dim=-1)
    tmax = torch.maximum(t_lo, t_hi).amin(dim=-1)
    is_valid = tmin <= tmax
    tmin = torch.where(is_valid, tmin, torch.full_like(tmin, -1.0))
    tmax = torch.where(is_valid, tmax, torch.full_like(tmax, -2.0))
    return tmin[..., None], tmax[..., None]


def linspace_batched(start, stop, num: int):
    """[num, *start.shape] evenly spaced, inclusive (math_utils.py:101-118)."""
    steps = torch.arange(num, dtype=torch.float32, device=start.device) / (num - 1)
    steps = steps.reshape((num,) + (1,) * start.ndim)
    return start[None] + steps * (stop - start)[None]
