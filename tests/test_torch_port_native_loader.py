"""spi_tpu_torch/data/native_loader.py, the port's copy of spi_tpu's
ctypes binding of native/libspi_io.so: tests/test_native_loader.py's cases
on the port's module (the same skip where the library is not available),
and the port's decodes and prefetch batches against spi_tpu's on the same
bytes and files, bitwise."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from spi_tpu.data import native_loader as J
from spi_tpu_torch.data import native_loader as P
from spi_tpu_torch.ops import resize_bilinear
from torch_threads import few_torch_threads  # noqa: F401


@pytest.fixture(autouse=True)
def _library():
    if not P.available():
        pytest.skip("native lib not built")


def _png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _jpg_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


def _images(tmp_path, n, size, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = tmp_path / f"{i}.png"
        Image.fromarray(rng.integers(0, 255, (size, size, 3), np.uint8)).save(p)
        paths.append(str(p))
    return paths


class TestDecode:
    def test_png_roundtrip_matches_pil(self):
        arr = np.random.default_rng(0).integers(0, 255, (32, 32, 3), np.uint8)
        out = P.decode_image(_png_bytes(arr), 32)
        assert out is not None and out.shape == (3, 32, 32) and out.dtype == np.float32
        ref = arr.astype(np.float32).transpose(2, 0, 1) / 127.5 - 1.0
        np.testing.assert_allclose(out, ref, atol=1e-6)

    def test_jpeg_decode_close_to_pil(self):
        arr = np.random.default_rng(1).integers(0, 255, (64, 64, 3), np.uint8)
        data = _jpg_bytes(arr)
        out = P.decode_image(data, 64)
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32)
        assert out is not None
        assert np.abs(out - (ref.transpose(2, 0, 1) / 127.5 - 1.0)).mean() < 0.02

    def test_resize_bilinear_matches_port(self):
        arr = np.zeros((64, 64, 3), np.uint8)
        arr[:32] = 200
        out = P.decode_image(_png_bytes(arr), 32)
        x = torch.from_numpy(arr).float().permute(2, 0, 1)[None] / 127.5 - 1.0
        np.testing.assert_allclose(out, resize_bilinear(x, (32, 32))[0].numpy(), atol=1e-3)

    def test_garbage_returns_none(self):
        assert P.decode_image(b"not an image", 16) is None

    @pytest.mark.parametrize("kind,size,out_size", [
        ("png", 32, 32), ("png", 48, 20), ("jpeg", 64, 64), ("jpeg", 40, 56),
    ])
    def test_decode_equals_spi_tpu(self, kind, size, out_size):
        arr = np.random.default_rng(size).integers(0, 255, (size, size, 3), np.uint8)
        data = _png_bytes(arr) if kind == "png" else _jpg_bytes(arr)
        got, want = P.decode_image(data, out_size), J.decode_image(data, out_size)
        assert got.dtype == want.dtype and got.shape == want.shape == (3, out_size, out_size)
        np.testing.assert_array_equal(got, want)


class TestLoader:
    def test_prefetch_batches(self, tmp_path):
        loader = P.NativeLoader(_images(tmp_path, 6, 16, 2), out_size=16, batch=4, n_threads=2,
                                shuffle=False)
        imgs, idx = loader.next()
        assert imgs.shape == (4, 3, 16, 16)
        assert (idx >= 0).all()
        assert imgs.min() >= -1.0 and imgs.max() <= 1.0
        for _ in range(3):
            imgs, idx = loader.next()
        loader.close()

    def test_batches_equal_spi_tpu(self, tmp_path):
        """Both loaders over the same files, shuffled from one seed, one
        thread each: the same indices and images, batch by batch."""
        paths = _images(tmp_path, 7, 24, 3)
        kw = dict(out_size=20, batch=3, n_threads=1, seed=11, shuffle=True)
        port, ref = P.NativeLoader(paths, **kw), J.NativeLoader(paths, **kw)
        try:
            for _ in range(4):
                (gi, gx), (wi, wx) = port.next()[::-1], ref.next()[::-1]
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gx, wx)
        finally:
            port.close()
            ref.close()

    def test_bad_file_marked_negative(self, tmp_path):
        good = tmp_path / "a.png"
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(good)
        bad = tmp_path / "b.png"
        bad.write_bytes(b"broken")
        loader = P.NativeLoader([str(good), str(bad)], out_size=8, batch=2, n_threads=1,
                                shuffle=False)
        imgs, idx = loader.next()
        assert (idx < 0).sum() == 1
        bad_slot = int(np.where(idx < 0)[0][0])
        assert idx[bad_slot] == -1 - 1
        np.testing.assert_array_equal(imgs[bad_slot], 0.0)
        loader.close()
