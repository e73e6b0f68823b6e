"""EG3D / SPI cameras as 25-vectors: flattened 4x4 cam2world and 3x3
normalized intrinsics (eg3d/camera_utils.py, spi/utils/camera_utils.py)."""

from __future__ import annotations

import math

import torch

RADIUS = 2.7
LOOKAT = (0.0, 0.0, 0.2)
PITCH = -0.2
FOCAL = 4.2647


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def pack(cam2world, intrinsics):
    n = cam2world.shape[0]
    return torch.cat([cam2world.reshape(n, 16), intrinsics.expand(n, 3, 3).reshape(n, 9)], 1)


def unpack(camera):
    return camera[:, :16].reshape(-1, 4, 4), camera[:, 16:25].reshape(-1, 3, 3)


def _intrinsics(device):
    return torch.tensor([[FOCAL, 0, 0.5], [0, FOCAL, 0.5], [0, 0, 1]], device=device)


def lookat(h, v):
    """Cameras at azimuth h and polar v (each (N, 1)) looking at LOOKAT."""
    v = v.clamp(1e-5, math.pi - 1e-5)
    phi = torch.arccos(1 - 2 * (v / math.pi))
    origin = torch.cat([RADIUS * torch.sin(phi) * torch.cos(math.pi - h),
                        RADIUS * torch.cos(phi),
                        RADIUS * torch.sin(phi) * torch.sin(math.pi - h)], dim=-1)
    fwd = _unit(torch.tensor(LOOKAT, device=h.device) - origin)
    up = torch.tensor([0.0, 1.0, 0.0], device=h.device).expand_as(fwd)
    right = -_unit(torch.linalg.cross(up, fwd, dim=-1))
    up = _unit(torch.linalg.cross(fwd, right, dim=-1))
    n = fwd.shape[0]
    m = torch.eye(4, device=h.device).repeat(n, 1, 1)
    m[:, :3, :3] = torch.stack([right, up, fwd], dim=-1)
    m[:, :3, 3] = origin
    return pack(m, _intrinsics(h.device))


def canonical(yaw, device):
    """The frontal FFHQ camera turned by `yaw` (a float)."""
    h = torch.full((1, 1), math.pi / 2 + yaw, device=device)
    return lookat(h, torch.full((1, 1), math.pi / 2 + PITCH, device=device))


def sample_camera(u_yaw, u_pitch, yaw_range, pitch_range):
    """One-sided jitter from the canonical view; uniforms (N, 1)."""
    return lookat(u_yaw * yaw_range + math.pi / 2, u_pitch * pitch_range + math.pi / 2 + PITCH)


def _rotation(yaw, pitch):
    cy, sy, cp, sp = torch.cos(yaw), torch.sin(yaw), torch.cos(pitch), torch.sin(pitch)
    z, o = torch.zeros_like(cy), torch.ones_like(cy)
    ym = torch.stack([torch.stack(r, -1) for r in ((cy, z, sy), (z, o, z), (-sy, z, cy))], -2)
    pm = torch.stack([torch.stack(r, -1) for r in ((o, z, z), (z, cp, -sp), (z, sp, cp))], -2)
    return ym @ pm


def surrounding(camera, u_yaw, u_pitch, yaw_range, pitch_range):
    """Copies of `camera` (1, 25) turned by world rotations of uniform yaw and
    pitch in [-range, range); uniforms (K,)."""
    rot = _rotation((u_yaw * 2 - 1) * yaw_range, (u_pitch * 2 - 1) * pitch_range)
    ext, intr = unpack(camera.expand(u_yaw.shape[0], 25))
    return pack(torch.cat([rot @ ext[:, :3], ext[:, 3:]], dim=1), intr)


def mirror(camera):
    ext, intr = unpack(camera)
    signs = torch.tensor([[1, -1, -1, -1], [-1, 1, 1, 1], [-1, 1, 1, 1], [1, 1, 1, 1]],
                         dtype=ext.dtype, device=ext.device)
    return pack(ext * signs, intr)


def mirror_weight(camera):
    """SPI's yaw weight of the mirror term: 0 where |yaw| < 0.2."""
    r = unpack(camera)[0][:, :3, :3]
    pitch = torch.arctan(-r[:, 1, 2] / r[:, 2, 2])
    yaw = torch.arctan(r[:, 0, 2] * torch.cos(pitch) / r[:, 2, 2]).abs()
    g = torch.exp(-0.5 * yaw.square() / 0.29 ** 2) / (0.29 * math.sqrt(2 * math.pi))
    return torch.where(yaw < 0.2, torch.zeros_like(yaw), (1.0 - g / 2.7) / 2.0)
