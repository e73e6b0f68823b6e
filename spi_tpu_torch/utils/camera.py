"""Camera construction (counterpart of spi_tpu/utils/camera.py).

Cameras are 25-vectors: flattened 4x4 cam2world + flattened 3x3
normalized intrinsics (OpenCV convention).
"""

from __future__ import annotations

import math

import torch

# Canonical FFHQ-EG3D viewing geometry (spi/utils/camera_utils.py:233-240).
CANONICAL_RADIUS = 2.7
CANONICAL_LOOKAT = (0.0, 0.0, 0.2)
CANONICAL_PITCH = -0.2
CANONICAL_FOCAL = 4.2647


def normalize_vecs(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def create_cam2world_matrix(forward_vector, origin):
    """y-up, no-roll cam2world from forward direction + position
    (eg3d/camera_utils.py:118-139)."""
    forward_vector = normalize_vecs(forward_vector)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=forward_vector.dtype,
                      device=forward_vector.device).expand_as(forward_vector)
    right = -normalize_vecs(torch.linalg.cross(up, forward_vector, dim=-1))
    up = normalize_vecs(torch.linalg.cross(forward_vector, right, dim=-1))
    n = forward_vector.shape[0]
    eye = torch.eye(4, dtype=forward_vector.dtype, device=forward_vector.device)
    rotation = eye.repeat(n, 1, 1)
    rotation[:, :3, :3] = torch.stack([right, up, forward_vector], dim=-1)
    translation = eye.repeat(n, 1, 1)
    translation[:, :3, 3] = origin
    return translation @ rotation


def _spherical_origin(h, v, radius):
    """Azimuth/polar angles -> camera origin (eg3d/camera_utils.py:44-53)."""
    v = v.clamp(1e-5, math.pi - 1e-5)
    phi = torch.arccos(1 - 2 * (v / math.pi))
    ox = radius * torch.sin(phi) * torch.cos(math.pi - h)
    oz = radius * torch.sin(phi) * torch.sin(math.pi - h)
    oy = radius * torch.cos(phi)
    return torch.cat([ox, oy, oz], dim=-1)


def lookat_pose(h, v, lookat_position, radius: float = CANONICAL_RADIUS):
    """cam2world for cameras at spherical (h, v), each (N, 1), looking at a
    point (eg3d/camera_utils.py:58-96)."""
    origins = _spherical_origin(h, v, radius)
    lookat = torch.tensor(lookat_position, dtype=origins.dtype, device=origins.device)
    return create_cam2world_matrix(normalize_vecs(lookat - origins), origins)


def default_intrinsics(device=None):
    return torch.tensor([[CANONICAL_FOCAL, 0, 0.5], [0, CANONICAL_FOCAL, 0.5], [0, 0, 1]],
                        dtype=torch.float32, device=device)


def pack_camera(cam2world, intrinsics):
    """(N, 4, 4) + (3, 3) | (N, 3, 3) -> (N, 25)."""
    n = cam2world.shape[0]
    if intrinsics.ndim == 2:
        intrinsics = intrinsics[None].expand(n, 3, 3)
    return torch.cat([cam2world.reshape(n, 16), intrinsics.reshape(n, 9)], dim=1)


def canonical_camera(yaw: float = 0.0, pitch: float = 0.0, batch_size: int = 1, device=None):
    """Frontal FFHQ camera (spi/utils/camera_utils.py:233-240)."""
    h = torch.full((batch_size, 1), math.pi / 2 + yaw, dtype=torch.float32, device=device)
    v = torch.full((batch_size, 1), math.pi / 2 + CANONICAL_PITCH + pitch,
                   dtype=torch.float32, device=device)
    return pack_camera(lookat_pose(h, v, CANONICAL_LOOKAT), default_intrinsics(device))
