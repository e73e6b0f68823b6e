"""ctypes binding for the native C++ image pipeline (native/spi_io.cpp), a
copy of spi_tpu/data/native_loader.py that the port keeps as its own.

Threaded JPEG/PNG decode -> bilinear resize -> float32 CHW [-1,1] with a
bounded prefetch queue, on the host. It loads the repository's
native/libspi_io.so (built by `make -C native` where it is missing);
`load_library` returns None, and `decode_image` None, when the library is
unavailable, as spi_tpu's do. Neither package has a caller for it yet.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_LIB_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_library(build_if_missing: bool = True):
    """Load (and lazily build) native/libspi_io.so; None if unavailable."""
    global _LIB, _LIB_TRIED
    # Short-circuit on ANY prior attempt: a failed build must not
    # re-spawn `make` (120 s timeout) on every subsequent image load.
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    native_dir = os.path.join(_repo_root(), "native")
    so_path = os.path.join(native_dir, "libspi_io.so")
    if not os.path.exists(so_path) and build_if_missing:
        try:
            subprocess.run(
                ["make", "-C", native_dir], check=True,
                capture_output=True, timeout=120,
            )
        except Exception:
            _LIB_TRIED = True
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        # Latch only if a build was possible: a build_if_missing=False
        # probe should not block a later build-enabled call.
        if build_if_missing:
            _LIB_TRIED = True
        return None

    lib.spi_decode_image.restype = ctypes.c_int
    lib.spi_decode_image.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.spi_loader_create.restype = ctypes.c_void_p
    lib.spi_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.spi_loader_next.restype = ctypes.c_int
    lib.spi_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.spi_loader_destroy.restype = None
    lib.spi_loader_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    _LIB_TRIED = True
    return _LIB


def available() -> bool:
    return load_library() is not None


def decode_image(data: bytes, out_size: int) -> np.ndarray | None:
    """bytes -> (3, S, S) float32 in [-1,1]; None on decode failure."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty((3, out_size, out_size), np.float32)
    rc = lib.spi_decode_image(
        data, len(data), out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out if rc == 0 else None


class NativeLoader:
    """Prefetching batch loader over a list of image paths.

    Yields (images (B,3,S,S) float32 [-1,1], indices (B,) int64).
    A negative index -1-i marks path i as undecodable (zero-filled
    image) — per-image failure capture, like the reference preprocess
    loop (preprocess/run_total.py:87-88)."""

    def __init__(
        self, paths: list[str], out_size: int, batch: int,
        n_threads: int = 4, seed: int = 0, shuffle: bool = True,
        max_queue: int = 4,
    ):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native loader unavailable (build native/)")
        self._lib = lib
        self.batch = batch
        self.out_size = out_size
        joined = "\n".join(paths).encode()
        self._handle = lib.spi_loader_create(
            joined, len(paths), out_size, batch, n_threads,
            seed, int(shuffle), max_queue,
        )
        if not self._handle:
            raise RuntimeError("spi_loader_create failed")

    def next(self):
        imgs = np.empty((self.batch, 3, self.out_size, self.out_size), np.float32)
        idx = np.empty((self.batch,), np.int64)
        rc = self._lib.spi_loader_next(
            self._handle,
            imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc != 0:
            raise StopIteration
        return imgs, idx

    def __iter__(self):
        while True:
            yield self.next()

    def close(self):
        if self._handle:
            self._lib.spi_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
