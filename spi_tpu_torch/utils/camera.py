"""Camera construction, sampling, mirroring and yaw weights (counterpart
of spi_tpu/utils/camera.py).

Cameras are 25-vectors: flattened 4x4 cam2world + flattened 3x3
normalized intrinsics (OpenCV convention).

The samplers take their uniforms either injected (`uniforms`, so that a
test can hand them spi_tpu's draws) or drawn from a `torch.Generator`.
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
    # Built by concatenation, not written into an identity in place, so
    # that it runs under torch.func.vmap with per-image cameras.
    zero = torch.zeros(n, 1, 3, dtype=forward_vector.dtype, device=forward_vector.device)
    eye = torch.eye(4, dtype=forward_vector.dtype, device=forward_vector.device)
    last_row = eye[3:].expand(n, 1, 4)
    rotation = torch.cat([torch.cat([torch.stack([right, up, forward_vector], dim=-1),
                                     zero.transpose(1, 2)], dim=2), last_row], dim=1)
    translation = torch.cat([torch.cat([eye[:3, :3].expand(n, 3, 3), origin[:, :, None]], dim=2),
                             last_row], dim=1)
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


def fov_to_intrinsics(fov_degrees: float, device=None):
    """(3, 3) normalized intrinsics from a field of view in degrees
    (eg3d/camera_utils.py:140-149)."""
    focal = 1.0 / (math.tan(fov_degrees * 3.14159 / 360) * 1.414)
    return torch.tensor([[focal, 0, 0.5], [0, focal, 0.5], [0, 0, 1]], dtype=torch.float32,
                        device=device)


def default_intrinsics(device=None):
    return torch.tensor([[CANONICAL_FOCAL, 0, 0.5], [0, CANONICAL_FOCAL, 0.5], [0, 0, 1]],
                        dtype=torch.float32, device=device)


def pack_camera(cam2world, intrinsics):
    """(N, 4, 4) + (3, 3) | (N, 3, 3) -> (N, 25)."""
    n = cam2world.shape[0]
    if intrinsics.ndim == 2:
        intrinsics = intrinsics[None].expand(n, 3, 3)
    return torch.cat([cam2world.reshape(n, 16), intrinsics.reshape(n, 9)], dim=1)


def unpack_camera(camera):
    """(N, 25) -> cam2world (N, 4, 4), intrinsics (N, 3, 3)."""
    return camera[:, :16].reshape(-1, 4, 4), camera[:, 16:25].reshape(-1, 3, 3)


def canonical_camera(yaw: float = 0.0, pitch: float = 0.0, batch_size: int = 1, device=None):
    """Frontal FFHQ camera (spi/utils/camera_utils.py:233-240)."""
    h = torch.full((batch_size, 1), math.pi / 2 + yaw, dtype=torch.float32, device=device)
    v = torch.full((batch_size, 1), math.pi / 2 + CANONICAL_PITCH + pitch,
                   dtype=torch.float32, device=device)
    return pack_camera(lookat_pose(h, v, CANONICAL_LOOKAT), default_intrinsics(device))


def draw_uniforms(shape, device=None, generator=None):
    """A camera sampler's (yaw, pitch) U[0, 1) draws, each of `shape`, in
    the order the samplers draw them."""
    return [torch.rand(shape, generator=generator, device=device) for _ in range(2)]


def _uniforms(uniforms, shape, device, generator):
    """The sampler's (yaw, pitch) U[0, 1) draws: `uniforms` as given, or two
    draws of `shape` from `generator`."""
    if uniforms is not None:
        return [u.to(device) for u in uniforms]
    return draw_uniforms(shape, device, generator)


def sample_camera(batch_size: int = 1, yaw_range: float = 0.35, pitch_range: float = 0.25,
                  uniforms=None, generator=None, device=None):
    """Lookat cameras jittered uniformly in yaw over [0, yaw_range) and in
    pitch over [0, pitch_range) from the canonical view, one-sided as in
    spi/utils/camera_utils.py:159-166. uniforms: (u_yaw, u_pitch), each
    (batch_size, 1) in [0, 1); else drawn from `generator`."""
    u_h, u_v = _uniforms(uniforms, (batch_size, 1), device, generator)
    h = u_h * yaw_range + math.pi / 2
    v = u_v * pitch_range + math.pi / 2 + CANONICAL_PITCH
    return pack_camera(lookat_pose(h, v, CANONICAL_LOOKAT), default_intrinsics(h.device))


def angle_to_rotation(yaw, pitch, roll):
    """Euler angles (each (B,)) -> (B, 3, 3) rotation Y(yaw) @ X(pitch) @
    Z(roll) (spi/utils/camera_utils.py:169-193)."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    ymat = mat([(cy, zero, sy), (zero, one, zero), (-sy, zero, cy)])
    pmat = mat([(one, zero, zero), (zero, cp, -sp), (zero, sp, cp)])
    rmat = mat([(cr, -sr, zero), (sr, cr, zero), (zero, zero, one)])
    return ymat @ pmat @ rmat


def sample_surrounding_camera(middle_camera, batch_size: int = 1, yaw_range: float = 0.1,
                              pitch_range: float = 0.1, uniforms=None, generator=None):
    """`batch_size` copies of `middle_camera` (1, 25) whose extrinsics are
    turned by world rotations of uniform yaw in [-yaw_range, yaw_range)
    and pitch in [-pitch_range, pitch_range) (spi/utils/camera_utils.py:
    196-211). uniforms: (u_yaw, u_pitch), each (batch_size,) in [0, 1);
    else drawn from `generator`."""
    u_y, u_p = _uniforms(uniforms, (batch_size,), middle_camera.device, generator)
    y = (u_y * 2 - 1) * yaw_range
    p = (u_p * 2 - 1) * pitch_range
    rot = angle_to_rotation(y, p, torch.zeros_like(y))
    ext, intr = unpack_camera(middle_camera.expand(batch_size, middle_camera.shape[-1]))
    ext = torch.cat([rot @ ext[:, :3], ext[:, 3:]], dim=1)
    return pack_camera(ext, intr)


def flip_yaw(pose):
    """Mirror a cam2world about the x = 0 plane
    (spi/utils/camera_utils.py:336-343)."""
    signs = torch.tensor([[1, -1, -1, -1], [-1, 1, 1, 1], [-1, 1, 1, 1], [1, 1, 1, 1]],
                         dtype=pose.dtype, device=pose.device)
    return pose * signs


def mirror_camera(camera):
    """Camera of the horizontally flipped image
    (spi/utils/camera_utils.py:346-350)."""
    pose, intrinsics = unpack_camera(camera)
    return pack_camera(flip_yaw(pose), intrinsics)


def rotation_to_angle(matrix):
    """(..., 3, 3) -> (yaw, pitch, roll) (spi/utils/camera_utils.py:353-364)."""
    r11, r12, r13 = matrix[..., 0, 0], matrix[..., 0, 1], matrix[..., 0, 2]
    r23, r33 = matrix[..., 1, 2], matrix[..., 2, 2]
    pitch = torch.arctan(-r23 / r33)
    yaw = torch.arctan(r13 * torch.cos(pitch) / r33)
    roll = torch.arctan(-r12 / r11)
    return yaw, pitch, roll


_GAUSS_CONST = math.sqrt(2 * math.pi)


def _gauss(x, mean=0.0, std=0.25):
    return torch.exp(-0.5 * (x - mean).square() / (std * std)) / (std * _GAUSS_CONST)


def camera_yaw(camera):
    ext, _ = unpack_camera(camera)
    yaw, _, _ = rotation_to_angle(ext[:, :3, :3])
    return yaw


def cal_camera_weight(camera):
    """Yaw-dependent mirror-loss weight (spi/utils/camera_utils.py:387-401):
    0 for near-frontal cameras (|yaw| < 0.2), rising toward profile views."""
    yaw = camera_yaw(camera).abs()
    w = (1.0 - _gauss(yaw, std=0.29) / 2.7) / 2.0
    return torch.where(yaw < 0.2, torch.zeros_like(w), w)


def cal_camera_gauss_weight(camera):
    """Gaussian yaw weight, the adaptive yaw range of stage 2
    (spi/utils/camera_utils.py:368-383)."""
    return _gauss(camera_yaw(camera), std=0.4) / 2.6


def check_front(camera, eps: float = 0.1):
    """True for near-frontal cameras (spi/utils/camera_utils.py:425-429)."""
    r = unpack_camera(camera)[0][:, :3, :3]
    sy = torch.sqrt(r[:, 0, 0] ** 2 + r[:, 1, 0] ** 2)
    return torch.arctan2(-r[:, 2, 0], sy).abs() < eps
