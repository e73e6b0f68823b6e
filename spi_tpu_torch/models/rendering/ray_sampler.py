"""Camera rays from cam2world + intrinsics (counterpart of
spi_tpu/models/rendering/ray_sampler.py; spec EG3D ray_sampler.py:24-63)."""

from __future__ import annotations

import torch


def sample_rays(cam2world, intrinsics, resolution: int):
    """Per-pixel ray origins and unit directions, each (N, R*R, 3), in
    row-major pixel order (x fastest). cam2world: (N, 4, 4); intrinsics:
    (N, 3, 3) normalized by image size."""
    n = cam2world.shape[0]
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]

    coords = (torch.arange(resolution, dtype=torch.float32, device=cam2world.device)
              + 0.5) / resolution
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    x_cam = xx.reshape(1, -1).expand(n, -1)
    y_cam = yy.reshape(1, -1).expand(n, -1)
    z_cam = torch.ones_like(x_cam)

    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam

    cam_rel = torch.stack([x_lift, y_lift, z_cam, torch.ones_like(z_cam)], dim=-1)
    world_rel = torch.einsum("nij,npj->npi", cam2world, cam_rel)[..., :3]

    cam_locs = cam2world[:, :3, 3]
    ray_dirs = world_rel - cam_locs[:, None, :]
    ray_dirs = ray_dirs / torch.linalg.norm(ray_dirs, dim=-1, keepdim=True)
    ray_origins = cam_locs[:, None, :].expand(ray_dirs.shape)
    return ray_origins, ray_dirs
