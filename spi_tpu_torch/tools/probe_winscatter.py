"""Windowed bilinear splat probe (counterpart of tools/probe_winscatter_r5.py).

    python -m spi_tpu_torch.tools.probe_winscatter

Holds the `win_scatter` kernel against its plain version on a K1 window
(64x64, row and column offsets) and a K2 strip (256x48, column offset
only), then times kernel and plain version on one 786k-point plane pass
(384 tiles of 16x16 rays x 8 samples) in bfloat16 for the probe's three
window shapes, with CUDA events in place of the TPU's scan-slope timer.
"""

from __future__ import annotations

import torch

from spi_tpu_torch.ops.win_scatter import win_scatter, win_scatter_plain
from spi_tpu_torch.tools.timing import device_name, time_ms
from spi_tpu_torch.utils.device import resolve_device

H = W = 256
C = 32
TILE_P = 2048  # 16x16 rays x 8 samples
N_TILES = 384  # one 786k-point plane pass
# (name, win_h, win_w, spread of the points inside the window)
WINDOWS = (("K1 64x64", 64, 64, 56), ("K1 64x32", 64, 32, 24), ("K2 256x48", H, 48, 40))


def make_inputs(n_tiles: int, win_h: int, win_w: int, spread_h: float, spread_w: float,
                dtype=torch.float32, tile_p: int = TILE_P, device=None, seed: int = 0,
                out_h: int = H, out_w: int = W, c: int = C):
    """offsets (T, 2) int32 (multiples of 8, the window inside the table),
    fyx (T, 8, P) float32 with uniform window-relative rows / columns in
    [0, spread), gft (T, C, P) standard normal in `dtype`
    (tools/probe_winscatter_r5.py `make_inputs`)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randint(hi):
        return torch.randint(0, hi, (n_tiles,), generator=gen, device=device) * 8

    oy = torch.zeros(n_tiles, dtype=torch.long, device=device) if win_h == out_h \
        else randint((out_h - win_h) // 8 + 1)
    offsets = torch.stack([oy, randint((out_w - win_w) // 8 + 1)], dim=1).int()
    fyx = torch.zeros(n_tiles, 8, tile_p, device=device)
    fyx[:, 0] = torch.rand(n_tiles, tile_p, generator=gen, device=device) * spread_h
    fyx[:, 1] = torch.rand(n_tiles, tile_p, generator=gen, device=device) * spread_w
    gft = torch.randn(n_tiles, c, tile_p, generator=gen, device=device).to(dtype)
    return offsets, fyx, gft


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def run(device=None, n_tiles: int = N_TILES, tile_p: int = TILE_P, check_tiles: int = 4,
        iters: int = 20, warmup: int = 3) -> dict:
    """Check, then time; returns {'device', 'check': {case: error relative
    to max |plain|}, 'times': {window: {kernel_ms, plain_ms, ns_per_row}}}.
    On a CPU device both sides are the plain version, timed on the host."""
    dev = resolve_device(device)
    out = {"device": device_name(dev), "check": {}, "times": {}}
    for name, win_h, win_w, spread_h, spread_w in (
        ("K1 64x64 f32", 64, 64, 56, 56), ("K2 256x48 f32", H, 48, H - 2, 40),
        ("K1 64x64 bf16", 64, 64, 56, 56),
    ):
        dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
        args = make_inputs(check_tiles, win_h, win_w, spread_h, spread_w, dtype,
                           tile_p=min(512, tile_p), device=dev, seed=3)
        geom = dict(win_h=win_h, win_w=win_w, out_h=H, out_w=W)
        got = win_scatter(*args, **geom)
        want = win_scatter_plain(*args, *geom.values())
        out["check"][name] = _rel_err(got, want)
    for name, win_h, win_w, spread in WINDOWS:
        args = make_inputs(n_tiles, win_h, win_w, spread if win_h != H else H - 2, spread,
                           torch.bfloat16, tile_p=tile_p, device=dev, seed=1)
        geom = dict(win_h=win_h, win_w=win_w, out_h=H, out_w=W)
        ms = time_ms(lambda: win_scatter(*args, **geom), iters, warmup, dev)
        plain = time_ms(lambda: win_scatter_plain(*args, *geom.values()),
                        max(1, iters // 4), min(warmup, 1), dev)
        out["times"][f"{name} bf16"] = {"kernel_ms": ms, "plain_ms": plain,
                                        "ns_per_row": ms / (n_tiles * tile_p) * 1e6}
    return out


def report(res):
    print(f"device: {res['device']}")
    for name, err in res["check"].items():
        print(f"{name}: kernel vs plain, max abs err relative to max |plain| {err:.2e}")
    for name, t in res["times"].items():
        print(f"{name:20s} kernel {t['kernel_ms']:9.4f} ms  plain {t['plain_ms']:9.4f} ms  "
              f"-> {t['ns_per_row']:.3f} ns/row")


def main():
    report(run())


if __name__ == "__main__":
    main()
