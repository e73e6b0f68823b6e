"""Build, load and count the port's CUDA kernels.

All sources under `spi_tpu_torch/csrc/` compile with `nvcc` for
`sm_90a` into ONE shared library with a plain C interface, loaded with
`ctypes`. Each source compiles to an object in its own `nvcc` process,
all started together, and one more `nvcc` links them. The library goes
to `build/` at the root of the checkout, named by a hash of the sources
and flags, so a changed source is rebuilt and an unchanged one reused.
The build happens at the first kernel launch, never at import: the CPU
tests import every module on a machine without `nvcc`.

`launch_counts` holds one plain integer per kernel; each wrapper adds
one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
]

KERNELS = ("plane_splat", "plane_sample", "plane_sample_bf16", "bias_act_fwd", "bias_act_bwd",
           "bias_act_grad2", "bias_act_fwd_bf16", "bias_act_bwd_bf16", "win_scatter",
           "row_gather", "row_scatter_add", "upfirdn2d", "upfirdn2d_bf16", "filtered_lrelu_fwd",
           "filtered_lrelu_bwd", "filtered_lrelu_bias_grad")
launch_counts: dict[str, int] = {k: 0 for k in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: every function returns cudaGetLastError() after its launch
# (spi_filtered_lrelu_bwd_tiles, which launches nothing, a count).
_SIGNATURES = {
    "spi_plane_splat": [_P, _P, _P, *[_I] * 11, _F, _P],
    "spi_plane_sample": [_P, _P, _P, *[_I] * 5, _F, _P],
    "spi_plane_sample_bf16": [_P, _P, _P, *[_I] * 5, _F, _P],
    "spi_bias_act_fwd": [_P, _P, _P, *[_I] * 5, _F, _F, _F, _P],
    "spi_bias_act_bwd": [_P, _P, _P, _P, *[_I] * 5, _F, _F, _F, _P],
    "spi_bias_act_grad2": [_P, _P, _P, _P, _P, *[_I] * 5, _F, _F, _F, _P],
    "spi_bias_act_fwd_bf16": [_P, _P, _P, *[_I] * 5, _F, _F, _F, _P],
    "spi_bias_act_bwd_bf16": [_P, _P, _P, _P, *[_I] * 5, _F, _F, _F, _P],
    "spi_win_scatter": [_P, _P, _P, _P, *[_I] * 10, _P],
    "spi_row_gather": [_P, _P, _P, _I, _I, _I, _P],
    "spi_row_scatter_add": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
    "spi_row_scatter_add_atomic": [_P, _P, _P, _I, _I, _I, _P],
    "spi_upfirdn2d": [_P, _P, _P, *[_I] * 16, _F, _P],
    "spi_upfirdn2d_bf16": [_P, _P, _P, *[_I] * 16, _F, _P],
    "spi_filtered_lrelu_fwd": [*[_P] * 6, *[_I] * 13, _F, _F, _F, _P],
    "spi_filtered_lrelu_bwd": [*[_P] * 6, *[_I] * 12, _F, _F, _P],
    "spi_filtered_lrelu_bwd_tiles": [_I] * 4,
    "spi_filtered_lrelu_bias_grad": [_P, _P, _I, _I, _I, _P],
}

_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libspi_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            objs.append(str(obj))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if verbose or proc.returncode:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}")
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, out)  # atomic: a concurrent build never sees half a file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(device: torch.device) -> int:
    """The raw handle of the current stream on `device`, read on every call
    (never cached, so a change of stream is followed) without building a
    `torch.cuda.Stream` object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def require(t: torch.Tensor, name: str, *, dtype=torch.float32, device=None,
            ndim: int | None = None, align: int = 4) -> None:
    """Raise unless `t` is a contiguous CUDA tensor the kernels take. The
    usual case is one combined test; the reasons are sorted out only when
    it fails."""
    if (t.is_cuda and t.dtype is dtype and t.is_contiguous()
            and (ndim is None or t.ndim == ndim) and t.data_ptr() % align == 0
            and (device is None or t.get_device() == device.index)):
        return
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
