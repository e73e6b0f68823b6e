"""Alignment and camera-label math on the host, numpy and PIL (a copy of
spi_tpu/preprocess/camera_math.py, which gives bitwise the same results).

Specs:
- POS 5-point least-squares alignment + crop: preprocess/extract_3dmm.py:16-103
- 3DMM pose -> EG3D camera: preprocess/extract_camera.py:14-47 (Euler),
  :87-136 (cal_camera: trans z-10, scale 0.27 + offsets, focal 2985.29,
  axis flip diag(1,-1,-1))
- label normalization: preprocess/process_camera.py:9-58 (radius -> 2.7,
  K -> 2985.29/700, principal point 0.5)
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def extract_5p(lm: np.ndarray) -> np.ndarray:
    """68-pt -> 5-pt landmarks (extract_3dmm.py:41-46)."""
    idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    lm5p = np.stack(
        [
            lm[idx[0]],
            np.mean(lm[idx[[1, 2]]], 0),
            np.mean(lm[idx[[3, 4]]], 0),
            lm[idx[5]],
            lm[idx[6]],
        ],
        axis=0,
    )
    return lm5p[[1, 2, 0, 3, 4]]


def pos(xp: np.ndarray, x: np.ndarray):
    """Least-squares 2D-3D similarity alignment (extract_3dmm.py:17-38).

    xp: (2, 5) image landmarks; x: (3, 5) canonical 3D landmarks.
    Returns (t (2,1), s).
    """
    npts = xp.shape[1]
    a = np.zeros([2 * npts, 8])
    a[0 : 2 * npts - 1 : 2, 0:3] = x.T
    a[0 : 2 * npts - 1 : 2, 3] = 1
    a[1 : 2 * npts : 2, 4:7] = x.T
    a[1 : 2 * npts : 2, 7] = 1
    b = xp.T.reshape([2 * npts, 1])
    k, _, _, _ = np.linalg.lstsq(a, b, rcond=None)
    r1, r2 = k[0:3], k[4:7]
    s = (np.linalg.norm(r1) + np.linalg.norm(r2)) / 2
    t = np.stack([k[3], k[7]], axis=0)
    return t, s


def resize_n_crop_img(img: Image.Image, lm: np.ndarray, t, s, target_size=1024.0):
    """(extract_3dmm.py:49-68)."""
    w0, h0 = img.size
    w = (w0 * s).astype(np.int32)
    h = (h0 * s).astype(np.int32)
    left = (w / 2 - target_size / 2 + float((t[0] - w0 / 2) * s)).astype(np.int32)
    right = left + target_size
    up = (h / 2 - target_size / 2 + float((h0 / 2 - t[1]) * s)).astype(np.int32)
    below = up + target_size
    img = img.resize((int(w), int(h)), resample=Image.LANCZOS)
    img = img.crop((int(left), int(up), int(right), int(below)))

    lm = np.stack([lm[:, 0] - t[0] + w0 / 2, lm[:, 1] - t[1] + h0 / 2], axis=1) * s
    lm = lm - np.array([[w / 2 - target_size / 2, h / 2 - target_size / 2]])
    return img, lm


def align_img(img: Image.Image, lm: np.ndarray, lm3d_std: np.ndarray,
              target_size=1024.0, rescale_factor=466.285):
    """5-point alignment + 1024 crop + 224 thumb (extract_3dmm.py:71-103).

    Returns (trans_params, img_224, lm_224, img_1024).
    """
    w0, h0 = img.size
    lm5p = extract_5p(lm) if lm.shape[0] != 5 else lm
    t, s = pos(lm5p.T, lm3d_std.T)
    s = rescale_factor / s
    img_new, lm_new = resize_n_crop_img(img, lm, t, s, target_size=target_size)
    trans_params = np.array([w0, h0, s, float(t[0]), float(t[1])])
    lm_new = lm_new * (224 / 1024.0)
    img_low = img_new.resize((224, 224), resample=Image.LANCZOS)
    return trans_params, img_low, lm_new, img_new


def crop_for_eg3d(img: Image.Image, lm: np.ndarray, lm3d_std: np.ndarray,
                  rescale_factor=300, center_crop_size=700, output_size=512):
    """The SPI crop (extract_camera.py:72-85): align at rescale 300, center
    crop 700, resize to 512."""
    _, _, _, im_high = align_img(img, lm, lm3d_std, rescale_factor=rescale_factor)
    left = int(im_high.size[0] / 2 - center_crop_size / 2)
    upper = int(im_high.size[1] / 2 - center_crop_size / 2)
    im_cropped = im_high.crop(
        (left, upper, left + center_crop_size, upper + center_crop_size)
    )
    return im_cropped.resize((output_size, output_size), resample=Image.LANCZOS)


def compute_rotation(angles: np.ndarray) -> np.ndarray:
    """Euler (x, y, z) -> world rotation (extract_camera.py:14-47):
    transpose of Rz @ Ry @ Rx."""
    x, y, z = angles
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    rot_x = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    rot_y = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rot_z = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rot_z @ rot_y @ rot_x).T


def cal_camera(angle: np.ndarray, trans: np.ndarray) -> dict:
    """3DMM angle/trans coeffs -> camera pose + intrinsics
    (extract_camera.py:87-136)."""
    angle = np.asarray(angle, np.float64).reshape(3)
    trans = np.asarray(trans, np.float64).reshape(3).copy()

    rot = compute_rotation(angle)
    trans[2] += -10
    c = -rot @ trans
    pose = np.eye(4)
    pose[:3, :3] = rot

    c = c * 0.27  # match tripleganger scale
    c[1] += 0.006
    c[2] += 0.161
    pose[:3, 3] = c

    focal = 2985.29
    k = np.eye(3)
    k[0, 0] = focal
    k[1, 1] = focal
    k[0, 2] = 1024 / 2.0
    k[1, 2] = 1024 / 2.0

    flip = np.diag([1.0, -1.0, -1.0])
    pose[:3, :3] = pose[:3, :3] @ flip
    return {
        "pose": pose,
        "intrinsics": k,
        "angle": (angle * np.array([1, -1, 1])).tolist(),
    }


def fix_intrinsics(intrinsics: np.ndarray) -> np.ndarray:
    """Normalize K by the 700-crop (process_camera.py:9-21)."""
    k = np.array(intrinsics, np.float64).copy()
    if k.shape != (3, 3):
        raise ValueError(f"intrinsics must be 3x3, got {k.shape}")
    k[0, 0] = 2985.29 / 700
    k[1, 1] = 2985.29 / 700
    k[0, 2] = 0.5
    k[1, 2] = 0.5
    return k


def fix_pose_orig(pose: np.ndarray) -> np.ndarray:
    """Renormalize camera distance to radius 2.7 (process_camera.py:31-36)."""
    pose = np.array(pose, np.float64).copy()
    radius = np.linalg.norm(pose[:3, 3])
    pose[:3, 3] = pose[:3, 3] / radius * 2.7
    return pose


def flip_yaw(pose: np.ndarray) -> np.ndarray:
    """(process_camera.py:38-45)."""
    flipped = np.array(pose).copy()
    flipped[0, 1] *= -1
    flipped[0, 2] *= -1
    flipped[1, 0] *= -1
    flipped[2, 0] *= -1
    flipped[0, 3] *= -1
    return flipped


def process_camera(pose, intrinsics) -> np.ndarray:
    """-> 25-dim EG3D label (process_camera.py:48-58)."""
    pose = fix_pose_orig(pose)
    intrinsics = fix_intrinsics(intrinsics)
    return np.concatenate([np.asarray(pose).reshape(-1),
                           np.asarray(intrinsics).reshape(-1)]).astype(np.float32)


def mirror_label(label: np.ndarray) -> np.ndarray:
    """Camera label of the horizontally flipped image
    (extract_camera.py:158-186 cal_mirror_c)."""
    pose = label[:16].reshape(4, 4)
    return np.concatenate(
        [flip_yaw(pose).reshape(-1), label[16:25]]
    ).astype(np.float32)


# Canonical 5-point 3D landmarks of the BFM face model, transformed the
# way load_lm3d does (third_part/.../util/load_mats.py): used for POS
# alignment. These are data constants of the standard BFM 'similarity
# transform' file, reproduced so alignment runs without the BFM download.
LM3D_STD = np.array(
    [
        [-0.31148657, 0.09036078, 0.13377953],
        [0.30979887, 0.08972035, 0.13179526],
        [0.0032535, -0.24617933, 0.55244243],
        [-0.25216928, -0.5813392, 0.22405732],
        [0.2484662, -0.5812824, 0.22235769],
    ],
    dtype=np.float32,
)
