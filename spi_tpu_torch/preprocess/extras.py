"""Standalone preprocess utilities on the host (a copy of
spi_tpu/preprocess/extras.py).

Specs: preprocess/mirror_padding.py:17-38 (reflect-pad + distance-
blurred border), preprocess/video2frames.py:6-52 (frame dump at 512
with optional mirrored doubling), preprocess/
transform_into_goae_data_format.py:14-40 (GOAE label.json export).
"""

from __future__ import annotations

import json
import os

import numpy as np
from PIL import Image


def mirror_padding(img: Image.Image, pad: int = 250, blur_sigma: float = 5.0):
    """Reflect-pad `pad` px on each side and blur the pad band
    (mirror_padding.py:22-38 exactly): with d = distance from the outer
    edge in pad units, the blur weight is clip(3*(1 - d) + 1, 0, 1) —
    full blur over the ENTIRE pad band (weight 1 for d <= 1, including
    right at the image border) feathering to 0 at d = 4/3, i.e. ~pad/3
    INTO the valid image; gaussian sigma 5."""
    try:
        from scipy.ndimage import gaussian_filter
    except ImportError as e:
        raise ImportError("mirror_padding needs scipy (the scipy package)") from e

    arr = np.asarray(img.convert("RGB"), np.float32)
    padded = np.pad(arr, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
    h, w, _ = padded.shape
    y, x = np.mgrid[:h, :w].astype(np.float32)
    mask = 1.0 - np.minimum(
        np.minimum(x / pad, y / pad),
        np.minimum((w - 1 - x) / pad, (h - 1 - y) / pad),
    )
    blurred = gaussian_filter(padded, [blur_sigma, blur_sigma, 0])
    weight = np.clip(mask * 3.0 + 1.0, 0.0, 1.0)[..., None]
    out = padded + (blurred - padded) * weight
    return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


def video2frames(
    video_path: str,
    output_dir: str,
    size: int = 512,
    every: int = 1,
    mirror: bool = False,
    limit: int | None = None,
):
    """Dump video frames as jpgs at `size` (video2frames.py:6-52).
    With mirror=True each frame is also saved horizontally flipped. Needs
    OpenCV (the cv2 package), which nothing installs."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("video2frames needs OpenCV (the cv2 package)") from e

    os.makedirs(output_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = saved = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % every == 0:
            frame = cv2.resize(frame, (size, size))
            cv2.imwrite(os.path.join(output_dir, f"{saved:06d}.jpg"), frame)
            if mirror:
                cv2.imwrite(
                    os.path.join(output_dir, f"{saved:06d}_m.jpg"), frame[:, ::-1]
                )
            saved += 1
            if limit is not None and saved >= limit:
                break
        i += 1
    cap.release()
    return saved


def export_goae_format(spi_root: str, goae_root: str):
    """Repackage the SPI crop/ + c/ layout into the GOAE dataset format
    (transform_into_goae_data_format.py:14-40): images flat in one dir +
    label.json mapping filename -> 25-dim label list."""
    import shutil

    os.makedirs(goae_root, exist_ok=True)
    labels = []
    crop_root = os.path.join(spi_root, "crop")
    c_root = os.path.join(spi_root, "c")
    for name in sorted(os.listdir(crop_root)):
        img_path = os.path.join(crop_root, name, "target.jpg")
        c_path = os.path.join(c_root, name, "target.npy")
        if not (os.path.exists(img_path) and os.path.exists(c_path)):
            continue
        out_name = f"{name}.jpg"
        shutil.copy(img_path, os.path.join(goae_root, out_name))
        label = np.load(c_path).reshape(-1).tolist()
        labels.append([out_name, label])
    with open(os.path.join(goae_root, "label.json"), "w") as f:
        json.dump({"labels": labels}, f)
    return len(labels)
