"""Preprocess orchestration: image -> crop / camera / landmarks / mask
(counterpart of spi_tpu/preprocess/pipeline.py; spec
preprocess/run_total.py:23-88, the per-image loop writing the input/ c/
crop/ lm/ mask/ tree; extract_camera.py:51-156, CameraExtractor;
extract_landmark.py:25-36, landmarks at 256 scale; extract_mask.py:35-62,
the BiSeNet argmax).

The three networks are modules on one device, run at batch 1 under
`torch.no_grad()`; the camera algebra is numpy
(spi_tpu_torch.preprocess.camera_math). Outputs are jpg and npy files.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import numpy as np
import torch
from PIL import Image

from spi_tpu_torch.models.perception.bisenet import BiSeNet, parse_faces
from spi_tpu_torch.models.perception.face_recon import FaceReconNet
from spi_tpu_torch.models.perception.fan import FAN, landmarks_from_image
from spi_tpu_torch.preprocess import camera_math as cm
from spi_tpu_torch.utils.device import module_device, resolve_device


@dataclasses.dataclass
class PreprocessModels:
    """The perception networks, on one device; `bisenet` may be None to
    skip the parsing masks."""

    fan: FAN | None = None
    face_recon: FaceReconNet | None = None
    bisenet: BiSeNet | None = None

    @classmethod
    def random_init(cls, device=None, seed: int = 0):
        """Seeded random weights, for runs without the checkpoints. device:
        None means `cuda` (raises without a GPU)."""
        dev = resolve_device(device)
        return cls(fan=FAN(device=dev, seed=seed),
                   face_recon=FaceReconNet(device=dev, seed=seed + 1),
                   bisenet=BiSeNet(device=dev, seed=seed + 2))


def _to01(img: Image.Image, module) -> torch.Tensor:
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    return torch.from_numpy(arr.transpose(2, 0, 1)[None].copy()).to(module_device(module))


def get_landmarks(models: PreprocessModels, img: Image.Image) -> np.ndarray:
    """68 x 2 landmarks in image pixel coordinates (extract_landmark.py:14-22)."""
    return landmarks_from_image(models.fan, _to01(img, models.fan))[0].cpu().numpy()


@torch.no_grad()
def get_3dmm_pose(models: PreprocessModels, img224: Image.Image):
    """Aligned 224^2 image -> (angle (3,), trans (3,)) (extract_3dmm.py:154-222,
    the pose outputs SPI reads)."""
    net = models.face_recon
    split = net.split_coeff(net(_to01(img224, net)))
    return split["angle"][0].cpu().numpy(), split["trans"][0].cpu().numpy()


def get_parsing(models: PreprocessModels, img512: Image.Image) -> np.ndarray:
    """512^2 crop -> (512, 512) int64 parsing map (extract_mask.py:35-62)."""
    out = parse_faces(models.bisenet, _to01(img512, models.bisenet))
    return out[0].cpu().numpy().astype(np.int64)


@dataclasses.dataclass
class CameraExtractor:
    """extract_camera.py:51-156: landmarks -> 3DMM pose -> crop + 25-dim
    camera label."""

    models: PreprocessModels

    def extract(self, img: Image.Image):
        """-> (crop512 PIL, label (25,), mirror label (25,), raw landmarks)."""
        lm = get_landmarks(self.models, img)
        # the reference flips landmark y to the math convention before the
        # alignment (extract_landmark.py:19-21: lm[:,1] = H - 1 - lm[:,1])
        lm_flip = lm.copy()
        lm_flip[:, 1] = img.size[1] - 1 - lm_flip[:, 1]

        # aligned to 224 for the 3DMM net (extract_3dmm.py:163-178)
        _, img224, _, _ = cm.align_img(img, lm_flip, cm.LM3D_STD)
        angle, trans = get_3dmm_pose(self.models, img224)

        crop = cm.crop_for_eg3d(img, lm_flip, cm.LM3D_STD)
        cam = cm.cal_camera(angle, trans)
        label = cm.process_camera(cam["pose"], cam["intrinsics"])
        return crop, label, cm.mirror_label(label), lm


def run_total(input_dir: str, output_dir: str, models: PreprocessModels,
              names: list[str] | None = None, mirror: bool = False, verbose: bool = True):
    """The per-image preprocess loop (run_total.py:23-88), writing the
    input/ c/ crop/ lm/ mask/ subtrees. A failing image is recorded and
    the loop goes on, as the reference's (:87-88). Returns (the names
    done, [(name, repr of the exception)] of those that failed)."""
    subdirs = {k: os.path.join(output_dir, k) for k in ("input", "c", "crop", "lm", "mask")}
    for d in subdirs.values():
        os.makedirs(d, exist_ok=True)

    extractor = CameraExtractor(models)
    files = sorted(f for f in os.listdir(input_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if names is not None:
        files = [f for f in files if os.path.splitext(f)[0] in names]

    results, failures = [], []
    for fname in files:
        name = os.path.splitext(fname)[0]
        try:
            src = os.path.join(input_dir, fname)
            img = Image.open(src).convert("RGB")
            shutil.copy(src, os.path.join(subdirs["input"], fname))

            crop, label, label_m, _ = extractor.extract(img)
            for d in ("c", "crop", "lm", "mask"):
                os.makedirs(os.path.join(subdirs[d], name), exist_ok=True)
            crop.save(os.path.join(subdirs["crop"], name, "target.jpg"))
            np.save(os.path.join(subdirs["c"], name, "target.npy"), label)
            if mirror:
                crop.transpose(Image.FLIP_LEFT_RIGHT).save(
                    os.path.join(subdirs["crop"], name, "target_m.jpg"))
                np.save(os.path.join(subdirs["c"], name, "target_m.npy"), label_m)

            # landmarks on the crop at 256 scale (extract_landmark.py:25-36)
            lm_crop = get_landmarks(models, crop)
            np.save(os.path.join(subdirs["lm"], name, "target.npy"), lm_crop / 2.0)

            if models.bisenet is not None:
                np.save(os.path.join(subdirs["mask"], name, "target.npy"),
                        get_parsing(models, crop))

            results.append(name)
            if verbose:
                print(f"preprocessed {name}")
        except Exception as e:  # noqa: BLE001 -- one bad face never stops the run (run_total.py:87)
            failures.append((name, repr(e)))
            if verbose:
                print(f"FAILED {name}: {e!r}")
    return results, failures
