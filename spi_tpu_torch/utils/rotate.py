"""Depth-guided reprojection warp, "rotate" (counterpart of
spi_tpu/utils/rotate.py; spec spi/utils/rotate.py).

Unproject the target view's depth to world points, project them into
the source view, keep the pixels whose source depth agrees within `eps`
(the occlusion test) and sample the source image there. The RotBbox
coach warps the target photo into nearby views with it, under no_grad,
as pseudo multi-view supervision (rot_bbox_cx_coach.py:88-131).
"""

from __future__ import annotations

import torch

from spi_tpu_torch.ops import resize_bilinear
from spi_tpu_torch.ops.grid_sample import grid_sample
from spi_tpu_torch.utils.camera import unpack_camera
from spi_tpu_torch.utils.stats import span


def _intrinsics(intrinsics):
    """(fx, fy, cx, cy, skew), each (N, 1)."""
    return tuple(intrinsics[:, i, j][:, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2), (0, 1)))


def unproject(depth_map, cam2world, intrinsics, resolution: int):
    """Depth (N, R, R) or (N, R*R) -> homogeneous world points (N, R*R, 4)
    at the pixel centres (rotate.py:5-29)."""
    n = cam2world.shape[0]
    fx, fy, cx, cy, sk = _intrinsics(intrinsics)
    coords = (torch.arange(resolution, dtype=depth_map.dtype, device=depth_map.device)
              + 0.5) / resolution
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    x_cam = xx.reshape(1, -1).expand(n, -1)
    y_cam = yy.reshape(1, -1).expand(n, -1)
    z_cam = depth_map.reshape(n, -1)
    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    cam_rel = torch.stack([x_lift, y_lift, z_cam, torch.ones_like(z_cam)], dim=-1)
    return torch.einsum("nij,npj->npi", cam2world, cam_rel)


def project(world_points, cam2world, intrinsics):
    """World points (N, P, 4) -> uv in [0, 1] (N, P, 2) and camera-space
    depth (N, P) (rotate.py:32-52)."""
    fx, fy, cx, cy, sk = _intrinsics(intrinsics)
    with span("spi.sync"):  # torch.linalg.inv reads its error code back
        world2cam = torch.linalg.inv(cam2world)
    cam_rel = torch.einsum("nij,npj->npi", world2cam, world_points)
    x_lift, y_lift, z_cam = cam_rel[..., 0], cam_rel[..., 1], cam_rel[..., 2]
    y_uv = y_lift / z_cam * fy + cy
    x_uv = x_lift / z_cam * fx + sk * y_uv / fy - cy * sk / fy + cx
    return torch.stack([x_uv, y_uv], dim=-1), z_cam


def _warp(depth1, ex1, in1, img2, depth2, ex2, in2, img2_mask=None, eps=6e-2):
    """Target depth (N, R, R) in view 1, source image (N, C, R, R) and
    depth (N, R, R) in view 2 -> warped image (N, C, R, R) and validity
    mask (N, 1, R, R) (rotate.py:56-89)."""
    n, h, w = depth1.shape
    uv, z = project(unproject(depth1, ex1, in1, resolution=h), ex2, in2)
    grid = uv.reshape(n, h, w, 2) * 2.0 - 1.0
    in_bounds = ((grid[..., 0] >= -1) & (grid[..., 0] <= 1)
                 & (grid[..., 1] >= -1) & (grid[..., 1] <= 1)).to(img2.dtype)
    sampled_depth2 = grid_sample(depth2.reshape(n, 1, h, w), grid).reshape(n, h, w)
    depth_mask = ((sampled_depth2 - z.reshape(n, h, w)).abs() < eps).to(img2.dtype)
    depth_mask = (depth_mask * in_bounds)[:, None]
    new_rgb = grid_sample(img2, grid) * depth_mask
    if img2_mask is not None:
        new_mask = grid_sample(img2_mask.reshape(n, 1, h, w), grid)
        new_rgb = new_rgb * new_mask
        depth_mask = depth_mask * new_mask
    return new_rgb, depth_mask


def rotate(target_camera, target_depth, src_image, src_camera, src_depth, src_mask=None,
           eps: float = 5e-2, depth_resolution: int = 128):
    """Warp the source image (N, C, R, R) seen by `src_camera` (N, 25) into
    `target_camera` (N, 25) (rotate.py:92-116). target_depth, src_depth:
    (N, 1, d, d) neural depths at d = `depth_resolution`, resized
    bilinearly to R. Returns (warped image, mask)."""
    n = src_image.shape[0]
    resolution = src_image.shape[-1]
    tex, tin = unpack_camera(target_camera)
    gex, gin = unpack_camera(src_camera)

    def fit_depth(d):
        d = d.reshape(n, 1, depth_resolution, depth_resolution)
        if depth_resolution != resolution:
            d = resize_bilinear(d, (resolution, resolution))
        return d.reshape(n, resolution, resolution)

    return _warp(fit_depth(target_depth), tex, tin, src_image, fit_depth(src_depth), gex, gin,
                 img2_mask=src_mask, eps=eps)


def rotate_with_confidence(target_camera, target_depth, src_image, src_camera, src_depth,
                           src_mask, confidence_eps: float = 0.1, depth_resolution: int = 128):
    """Cycle-consistency confidence masking (rotate.py:119-151): warp there
    and back, keep the pixels that come back within `confidence_eps`.
    Returns (warp, warp back, confidence, warped confidence, warped
    confidence x warp)."""
    warp_img, warp_mask = rotate(target_camera, target_depth, src_image, src_camera, src_depth,
                                 src_mask=src_mask, depth_resolution=depth_resolution)
    warp_img_rt, _ = rotate(src_camera, src_depth, warp_img, target_camera, target_depth,
                            src_mask=warp_mask, depth_resolution=depth_resolution)
    diff = (src_image - warp_img_rt).abs()
    confidence = (diff.sum(dim=1, keepdim=True) < confidence_eps).to(src_image.dtype)
    warp_confidence, _ = rotate(target_camera, target_depth, confidence, src_camera, src_depth,
                                src_mask=src_mask, depth_resolution=depth_resolution)
    return warp_img, warp_img_rt, confidence, warp_confidence, warp_confidence * warp_img
