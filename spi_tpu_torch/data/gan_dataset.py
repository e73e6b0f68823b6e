"""GAN training dataset: labeled image folders / zips and infinite
rank-sharded sampling (a copy of spi_tpu/data/gan_dataset.py; spec
eg3d/training/dataset.py:28-244 and eg3d/torch_utils/misc.py:113-144).

ImageFolderDataset reads a directory tree or a zip of images, with a
dataset.json {"labels": [[fname, label], ...]}: images as uint8 CHW,
labels float32, and an xflip that mirrors the 25-dim camera labels.
`infinite_indices` is EG3D's InfiniteSampler (seeded shuffle,
rank / num_replicas striding, sliding-window reshuffle). Host-side only:
numpy arrays out.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Iterator

import numpy as np
from PIL import Image

from spi_tpu_torch.preprocess.camera_math import mirror_label


class ImageFolderDataset:
    """Images from a directory tree or a zip, with optional labels."""

    def __init__(
        self,
        path: str,
        resolution: int | None = None,
        use_labels: bool = True,
        max_size: int | None = None,
        xflip: bool = False,
    ):
        self.path = path
        self.resolution = resolution
        self.use_labels = use_labels
        self._zip = None
        if path.endswith(".zip"):
            self._zip = zipfile.ZipFile(path)
            names = self._zip.namelist()
        else:
            names = []
            for root, _, files in os.walk(path):
                for f in files:
                    names.append(os.path.relpath(os.path.join(root, f), path))
        self._image_names = sorted(
            n for n in names if n.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        self._labels = self._load_labels(names)
        self._xflip = xflip
        # max_size truncates the RAW image list BEFORE xflip doubling
        # (eg3d/training/dataset.py:45-49): with max_size applied after,
        # flip indices >= max_size would silently drop the flipped
        # variants of part of the dataset.
        if max_size is not None and len(self._image_names) > max_size:
            self._image_names = self._image_names[:max_size]
        self._size = len(self._image_names) * (2 if xflip else 1)

    def _open(self, name: str):
        if self._zip is not None:
            return self._zip.open(name)
        return open(os.path.join(self.path, name), "rb")

    def _load_labels(self, names) -> dict[str, np.ndarray] | None:
        if not self.use_labels or "dataset.json" not in names:
            return None
        with self._open("dataset.json") as f:
            data = json.load(f)
        labels = data.get("labels")
        if labels is None:
            return None
        return {fname: np.asarray(label, np.float32) for fname, label in labels}

    def __len__(self) -> int:
        return self._size

    @property
    def label_dim(self) -> int:
        if self._labels is None:
            return 0
        return next(iter(self._labels.values())).shape[0]

    def __getitem__(self, idx: int):
        base = len(self._image_names)
        flip = idx >= base
        name = self._image_names[idx % base]
        with self._open(name) as f:
            img = Image.open(f).convert("RGB")
        if self.resolution is not None:
            img = img.resize((self.resolution, self.resolution), Image.LANCZOS)
        arr = np.asarray(img, np.uint8).transpose(2, 0, 1)  # CHW
        if flip:
            arr = arr[:, :, ::-1]
        label = np.zeros((0,), np.float32)
        if self._labels is not None:
            label = self._labels.get(name, np.zeros(self.label_dim, np.float32)).copy()
            if flip and label.shape[0] == 25:
                label = mirror_label(label)
        return arr, label


def infinite_indices(
    n: int, rank: int = 0, num_replicas: int = 1,
    shuffle: bool = True, seed: int = 0, window_size: float = 0.5,
) -> Iterator[int]:
    """InfiniteSampler (misc.py:113-144): endless rank-strided indices
    with windowed reshuffling."""
    assert n > 0 and 0 <= rank < num_replicas
    order = np.arange(n)
    rnd = None
    window = 0
    if shuffle:
        rnd = np.random.RandomState(seed)
        rnd.shuffle(order)
        window = int(np.rint(order.size * window_size))
    idx = 0
    while True:
        i = idx % order.size
        if idx % num_replicas == rank:
            yield int(order[i])
        if window >= 2:
            j = (i - rnd.randint(window)) % order.size
            order[i], order[j] = order[j], order[i]
        idx += 1


def batch_iterator(
    dataset: ImageFolderDataset, batch_size: int,
    rank: int = 0, num_replicas: int = 1, seed: int = 0,
):
    """-> iterator of (images float32 [-1,1] (B,3,H,W), labels (B,L))."""
    it = infinite_indices(len(dataset), rank=rank, num_replicas=num_replicas, seed=seed)
    while True:
        imgs, labels = [], []
        for _ in range(batch_size):
            img, label = dataset[next(it)]
            imgs.append(img)
            labels.append(label)
        x = np.stack(imgs).astype(np.float32) / 127.5 - 1.0
        yield x, np.stack(labels)
