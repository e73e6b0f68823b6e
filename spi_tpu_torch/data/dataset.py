"""Per-identity inversion dataset (a copy of spi_tpu/data/dataset.py's
PTIDataset; spec spi/data/images_dataset.py:102-226). Directory tree:

    <root>/crop/<name>/target.<mode>   512^2 face crop
    <root>/c/<name>/target.npy         25-dim camera label
    <root>/mask/<name>/target.npy|.pt  face-parsing argmax map
    <root>/lm/<name>/target.npy        68x2 landmarks (256 scale)

with resume filtering against existing outputs (:139-147), `i/N`
worklist blocks (:149-158), select_range and filter_index. Host-side
only: numpy arrays out.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
from PIL import Image


@dataclasses.dataclass
class InversionSample:
    name: str
    image: np.ndarray  # (1, 3, size, size) float32 in [-1, 1]
    camera: np.ndarray  # (1, 25) float32
    mask: np.ndarray | None = None  # (1, 1, size, size) float32 raw parsing ids
    landmarks: np.ndarray | None = None  # (1, 68, 2) float32


def load_image(path: str, size: int = 512) -> np.ndarray:
    img = Image.open(path).convert("RGB").resize((size, size))
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr.transpose(2, 0, 1)[None] * 2.0 - 1.0


def _load_mask(path_base: str, size: int = 512) -> np.ndarray | None:
    npy, pt = path_base + ".npy", path_base + ".pt"
    if os.path.exists(npy):
        mask = np.load(npy)
    elif os.path.exists(pt):
        import torch  # reference-produced .pt masks

        mask = torch.load(pt, map_location="cpu").numpy()
    else:
        return None
    mask = np.asarray(mask, dtype=np.float32)
    while mask.ndim < 4:
        mask = mask[None]
    mask = mask[:, :1]
    if mask.shape[-1] != size:  # nearest neighbour: parsing ids are categorical
        idx = (np.arange(size) * (mask.shape[-1] / size)).astype(np.int64)
        mask = mask[:, :, idx][:, :, :, idx]
    return mask


class PTIDataset:
    def __init__(self, source_root: str, c_root: str | None = None,
                 mask_root: str | None = None, lm_root: str | None = None,
                 target_name: str = "target", mode: str = "jpg",
                 dataset_block: str | None = None, output_root: str | None = None,
                 select_range: int | None = None, filter_index: list[str] | None = None,
                 size: int = 512):
        self.source_root = source_root
        self.c_root = c_root
        self.mask_root = mask_root
        self.lm_root = lm_root
        self.target_name = target_name
        self.mode = mode
        # Images and masks are resized to `size`, so that a scaled-down
        # generator (run_inversion --tiny) can read full-size data.
        self.size = size

        paths = sorted(glob.glob(f"{source_root}/*/"))
        if select_range is not None:
            paths = paths[:select_range]
        if output_root is not None:
            existing = {os.path.splitext(os.path.basename(p))[0]
                        for p in glob.glob(f"{output_root}/*.jpg")}
            paths = [p for p in paths if os.path.basename(os.path.dirname(p)) not in existing]
        if dataset_block is not None:
            index, total = (int(v) for v in dataset_block.split("/"))
            block = len(paths) // total + 1
            paths = paths[(index - 1) * block: index * block]
        if filter_index is not None:
            paths = [os.path.join(source_root, f"{ff}/") for ff in filter_index]
        self.source_paths = paths

    def __len__(self) -> int:
        return len(self.source_paths)

    def __getitem__(self, index: int) -> InversionSample:
        path = self.source_paths[index]
        name = os.path.basename(os.path.dirname(path))
        fname = self.target_name
        image = load_image(os.path.join(path, f"{fname}.{self.mode}"), size=self.size)
        camera = np.load(os.path.join(self.c_root, name, fname + ".npy")).astype(
            np.float32).reshape(1, 25)
        mask = None
        if self.mask_root is not None:
            mask = _load_mask(os.path.join(self.mask_root, name, fname), self.size)
        lm = None
        if self.lm_root is not None:
            lm_path = os.path.join(self.lm_root, name, fname + ".npy")
            if os.path.exists(lm_path):
                lm = np.load(lm_path).astype(np.float32).reshape(1, -1, 2)
        return InversionSample(name=name, image=image, camera=camera, mask=mask, landmarks=lm)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


FACE_ATTRIBUTES = (1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13)


def face_mask_from_parsing(mask: np.ndarray) -> np.ndarray:
    """19-class parsing map -> binary face mask (spi/utils/mask_utils.py:4-24)."""
    out = np.zeros_like(mask, dtype=np.float32)
    for att in FACE_ATTRIBUTES:
        out += mask == att
    return out


def foreground_mask_from_parsing(mask: np.ndarray) -> np.ndarray:
    """Non-background mask (rot_bbox_cx_coach.py:37)."""
    return 1.0 - (mask == 0).astype(np.float32)
