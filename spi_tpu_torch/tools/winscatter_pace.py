"""What sets the win_scatter kernel's pace: its time a block by phase, and
its float4 reductions alone.

    python -m spi_tpu_torch.tools.winscatter_pace

Builds `csrc/win_scatter.cu` with -DWIN_SCATTER_MARKS into a library of
its own (apart from the kernel library; it counts no launches). In that
build thread 0 of every block reads the global timer (%globaltimer, ns)
after each barrier that ends a phase, and a second kernel issues the
kernel's reductions alone. Runs both at the probe's shapes (384 tiles of
2048 points, C = 32, K1 64x64 and 64x32 windows and K2 256x48 strips,
f32 and bf16) and reports, per shape:

- the marked kernel's device-only time (its result held against
  `win_scatter_plain`), the span from the first block's start to the last
  block's end, and each phase's mean time a block: staging issue and
  zeroing, binning, the scan, placement and the run order, waits for
  staged cotangents, and the sums with their reductions. The marks add a
  barrier after placement and after each pass.
- the reductions alone, device-only: for each nonzero bin that
  `win_scatter_bins` finds, the float4 reductions onto the same table
  cells, with values made in registers (only the bins' 4-byte cells are
  read), at 1, 4 and 8 neighbouring lanes a cell. The kernel itself takes
  4 lanes a cell in f32 (two passes of 16 channels) and 8 in bf16.

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess

import torch

from spi_tpu_torch.ops import _lib
from spi_tpu_torch.ops.win_scatter import win_scatter_bins, win_scatter_plain
from spi_tpu_torch.tools.probe_winscatter import H, N_TILES, TILE_P, W, WINDOWS, make_inputs
from spi_tpu_torch.tools.timing import device_ms

PHASES = ("issue and zero", "bin", "scan", "place and order", "wait", "sums")
LANES = (1, 4, 8)
TOL = 1e-5  # the marked kernel against its plain version, relative to max |plain|


def build() -> ctypes.CDLL:
    """The marked build of win_scatter.cu, compiled on first use."""
    src = _lib.CSRC / "win_scatter.cu"
    flags = [*_lib.NVCC_FLAGS, "-DWIN_SCATTER_MARKS"]
    h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes()).hexdigest()[:16]
    so = _lib.BUILD_DIR / f"libwin_scatter_marks_{h}.so"
    if not so.exists():
        _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_lib._nvcc(), *flags, "-shared", str(src), "-o", str(so)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the marked build:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.spi_win_scatter.argtypes = _lib._SIGNATURES["spi_win_scatter"]
    lib.spi_win_scatter_marks.argtypes = [ctypes.c_void_p]
    lib.spi_win_scatter_reductions.argtypes = [ctypes.c_void_p, *[ctypes.c_int] * 3,
                                               ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.spi_win_scatter, lib.spi_win_scatter_marks, lib.spi_win_scatter_reductions):
        fn.restype = ctypes.c_int
    return lib


def run(device="cuda") -> dict:
    """{shape: {'device_ms', 'span_us', 'block_us', PHASES...: mean us a
    block, 'reductions', 'alone_ms': {lanes: ms}}} on a CUDA device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"winscatter_pace needs a CUDA device, got {dev}")
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    marks = torch.zeros(N_TILES, 8, dtype=torch.int64, device=dev)
    _lib.check(lib.spi_win_scatter_marks(marks.data_ptr()), "win_scatter marks")
    res = {}
    for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for name, win_h, win_w, spread in WINDOWS:
            offsets, fyx, gft = make_inputs(N_TILES, win_h, win_w, spread if win_h != H else H - 2,
                                            spread, dtype, device=dev, seed=4)
            c = gft.shape[1]
            out = torch.empty(H, W * c, device=dev)

            def marked():
                _lib.check(lib.spi_win_scatter(
                    offsets.data_ptr(), fyx.data_ptr(), gft.data_ptr(), out.data_ptr(), N_TILES,
                    fyx.shape[1], TILE_P, c, win_h, win_w, H, W, int(win_h != H),
                    int(dtype == torch.bfloat16), stream), "win_scatter (marked)")

            ms = device_ms(marked, device=dev)
            marked()
            want = win_scatter_plain(offsets, fyx, gft, win_h, win_w, H, W)
            err = float((out - want).abs().max() / want.abs().max())
            if not err <= TOL:
                raise AssertionError(f"marked win_scatter {name} {dt} disagrees: {err:.3e}")
            m = marks.cpu().double()
            block = m[:, 1:7].sum(1)
            cells = win_scatter_bins(offsets, fyx, gft, win_h, win_w, H, W)[0].int()
            alone = {}
            for lanes in LANES:
                def reductions(lanes=lanes):
                    _lib.check(lib.spi_win_scatter_reductions(
                        cells.data_ptr(), cells.numel(), c, lanes, out.data_ptr(), stream),
                        "win_scatter reductions")
                alone[lanes] = device_ms(reductions, device=dev)
            res[f"{name} {dt}"] = {
                "device_ms": ms, "span_us": float((m[:, 0] + block).max() - m[:, 0].min()) / 1e3,
                "block_us": float(block.mean()) / 1e3,
                **{ph: float(v) / 1e3 for ph, v in zip(PHASES, m[:, 1:7].mean(0))},
                "reductions": cells.numel() * (c // 4), "alone_ms": alone}
    return res


def report(res):
    for shape, r in res.items():
        print(f"{shape:16s} device-only {r['device_ms']:.4f} ms, span {r['span_us']:.1f} us, "
              f"block {r['block_us']:.2f} us: "
              + ", ".join(f"{ph} {r[ph]:.2f}" for ph in PHASES), flush=True)
        print(f"{'':16s} {r['reductions']} reductions alone: "
              + ", ".join(f"{k} lanes a cell {v:.4f} ms" for k, v in r["alone_ms"].items()),
              flush=True)


def main():
    report(run())


if __name__ == "__main__":
    main()
