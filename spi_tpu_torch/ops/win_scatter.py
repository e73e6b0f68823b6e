"""Windowed bilinear splat (counterpart of the round-5 probe
tools/probe_winscatter_r5.py `win_scatter`).

Tile t's points, at window-relative coordinates fyx[t, 0, :] (rows) and
fyx[t, 1, :] (columns), add their C-channel cotangents gft[t, :, p] into
a (win_h, win_w, C) window with the hat weight relu(1 - |i - f|) per
axis; corners outside the window are dropped, so a dead point (-10)
adds nothing. The window is added into the (out_h, out_w * C) float32
table at (offsets[t, 0], offsets[t, 1] * C); when win_h == out_h the row
offset is ignored (the probe's K2 strips). Window cells that would land
outside the table are dropped.

The clipping is the window's, not the plane's: the probe's numpy
`reference` clips only at the plane, so it differs where a footprint
leaves its window.

On a CUDA tensor `win_scatter` launches the kernel of
`csrc/win_scatter.cu`; on a CPU tensor it runs `win_scatter_plain`,
four masked `index_add_` calls. bfloat16 cotangents round as the Pallas
kernel does: the hat weights and hx * g to bfloat16, the sum in float32.
`win_scatter_binned` restates the kernel's algorithm in plain PyTorch and
counts the float4 reductions the kernel issues.
"""

from __future__ import annotations

import math

import torch

from spi_tpu_torch.ops import _lib

POINT_CHUNK = 2048  # points the kernel bins at a time (kPoints in csrc/win_scatter.cu)
MAX_CELLS = 15872   # window cells the kernel takes (kMaxCells)


def _round_bf16(x):
    return x.to(torch.bfloat16).float()


def _hat(i, f):
    return (1.0 - (i - f).abs()).clamp_min(0.0)


def _check(offsets, fyx, gft, win_h, win_w, out_h, out_w):
    t, rows, p = fyx.shape
    if rows < 2 or gft.ndim != 3 or gft.shape[0] != t or gft.shape[2] != p:
        raise ValueError(f"fyx {tuple(fyx.shape)} and gft {tuple(gft.shape)} do not match")
    if tuple(offsets.shape) != (t, 2):
        raise ValueError(f"offsets must be ({t}, 2), got {tuple(offsets.shape)}")
    if gft.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gft must be float32 or bfloat16, got {gft.dtype}")
    if not (0 < win_h <= out_h and 0 < win_w <= out_w):
        raise ValueError(f"window {win_h}x{win_w} does not fit a {out_h}x{out_w} table")


def win_scatter_plain(offsets, fyx, gft, win_h: int, win_w: int, out_h: int, out_w: int):
    """The plain PyTorch version: 4-corner expansion with window masks and
    `index_add_` into the float32 table -> (out_h, out_w * C)."""
    _check(offsets, fyx, gft, win_h, win_w, out_h, out_w)
    c = gft.shape[1]
    bf16 = gft.dtype == torch.bfloat16
    fy, fx = fyx[:, 0].float(), fyx[:, 1].float()  # (T, P)
    y0, x0 = fy.floor(), fx.floor()
    oy = offsets[:, 0:1] if win_h != out_h else torch.zeros_like(offsets[:, 0:1])
    ox = offsets[:, 1:2]
    g = gft.float()  # (T, C, P)
    out = torch.zeros(out_h * out_w, c, dtype=torch.float32, device=gft.device)
    for y in (y0, y0 + 1):
        hy = _hat(y, fy)
        if bf16:
            hy = _round_bf16(hy)
        for x in (x0, x0 + 1):
            hx = _hat(x, fx)
            if bf16:
                v = hy[:, None] * _round_bf16(_round_bf16(hx)[:, None] * g)
            else:
                v = hy[:, None] * (hx[:, None] * g)
            gy, gx = oy + y, ox + x
            keep = ((y >= 0) & (y < win_h) & (x >= 0) & (x < win_w)
                    & (gy >= 0) & (gy < out_h) & (gx >= 0) & (gx < out_w))
            flat = torch.where(keep, gy * out_w + gx, 0).long()
            v = torch.where(keep[:, None], v, 0.0)
            out.index_add_(0, flat.reshape(-1), v.permute(0, 2, 1).reshape(-1, c))
    return out.reshape(out_h, out_w * c)


def win_scatter_bins(offsets, fyx, gft, win_h: int, win_w: int, out_h: int, out_w: int):
    """The bins of the kernel's algorithm, in plain PyTorch: each corner
    inside its window and the table, with a nonzero hat weight on both axes
    (the kernel skips the others), binned by (tile, chunk of POINT_CHUNK
    points, table cell), and one float32 sum per nonzero bin. Returns each
    bin's table cell (row of the (out_h * out_w, C) table) and its (C,) sum.
    The corners are expanded here on their own, all four at once, apart
    from `win_scatter_plain`, which stays the independent reference."""
    _check(offsets, fyx, gft, win_h, win_w, out_h, out_w)
    t, _, p = fyx.shape
    cells = out_h * out_w
    dev = gft.device
    fy, fx = fyx[:, 0].float(), fyx[:, 1].float()  # (T, P)
    corner = torch.arange(4, device=dev)[:, None, None]
    y = fy.floor() + corner // 2  # (4, T, P): corners (0, 0), (0, 1), (1, 0), (1, 1)
    x = fx.floor() + corner % 2
    hy = (1.0 - (y - fy).abs()).clamp_min(0.0)
    hx = (1.0 - (x - fx).abs()).clamp_min(0.0)
    ty = y + (offsets[:, 0, None] if win_h != out_h else 0)  # table row and column
    tx = x + offsets[:, 1, None]
    live = ((y >= 0) & (y < win_h) & (x >= 0) & (x < win_w) & (ty >= 0) & (ty < out_h)
            & (tx >= 0) & (tx < out_w) & (hy > 0) & (hx > 0))
    q, tile, point = live.nonzero(as_tuple=True)
    g = gft[tile, :, point].float()  # (N, C): each live corner's cotangents
    wy, wx = hy[q, tile, point, None], hx[q, tile, point, None]
    if gft.dtype == torch.bfloat16:  # hy_bf16 * bf16(bf16(hx) * g), as the MXU rounds
        wy = wy.to(torch.bfloat16).float()
        v = wy * (wx.to(torch.bfloat16).float() * g).to(torch.bfloat16).float()
    else:
        v = wy * (wx * g)
    chunk = tile * math.ceil(p / POINT_CHUNK) + point // POINT_CHUNK
    key = chunk * cells + ty[q, tile, point].long() * out_w + tx[q, tile, point].long()
    uniq, inv = torch.unique(key, return_inverse=True)
    sums = torch.zeros(uniq.numel(), gft.shape[1], dtype=torch.float32, device=dev)
    sums.index_add_(0, inv, v)
    return uniq % cells, sums


def win_scatter_binned(offsets, fyx, gft, win_h: int, win_w: int, out_h: int, out_w: int):
    """The kernel's algorithm in plain PyTorch: each bin's sum
    (`win_scatter_bins`) added into the table. Returns the same table as
    `win_scatter_plain` and the number of float4 reductions the kernel
    issues: nonzero bins x C / 4."""
    cells, sums = win_scatter_bins(offsets, fyx, gft, win_h, win_w, out_h, out_w)
    c = gft.shape[1]
    out = torch.zeros(out_h * out_w, c, dtype=torch.float32, device=gft.device)
    out.index_add_(0, cells, sums)
    return out.reshape(out_h, out_w * c), cells.numel() * (c // 4)


def win_scatter_cuda(offsets, fyx, gft, win_h: int, win_w: int, out_h: int, out_w: int):
    """Launch the kernel: same function as `win_scatter_plain`.

    offsets (T, 2) int32; fyx (T, R >= 2, P) float32; gft (T, C, P)
    float32 or bfloat16, C a multiple of 4; all contiguous on one CUDA
    device; a window of at most MAX_CELLS cells.
    """
    _check(offsets, fyx, gft, win_h, win_w, out_h, out_w)
    _lib.require(offsets, "offsets", dtype=torch.int32, ndim=2)
    _lib.require(fyx, "fyx", device=offsets.device, ndim=3)
    _lib.require(gft, "gft", dtype=gft.dtype, device=offsets.device, ndim=3)
    t, rows, p = fyx.shape
    c = gft.shape[1]
    if c % 4:
        raise ValueError(f"win_scatter kernel takes C a multiple of 4, got {c}")
    if t * rows * p >= 2**31 or t * c * p >= 2**31 or out_h * out_w * c >= 2**31:
        raise ValueError("win_scatter kernel takes fewer than 2^31 elements per tensor")
    if win_h * win_w > MAX_CELLS:
        raise ValueError(f"win_scatter kernel takes at most {MAX_CELLS} window cells, "
                         f"got {win_h}x{win_w}")
    out = torch.empty(out_h, out_w * c, dtype=torch.float32, device=gft.device)
    err = _lib.lib().spi_win_scatter(
        offsets.data_ptr(), fyx.data_ptr(), gft.data_ptr(), out.data_ptr(), t, rows, p, c,
        win_h, win_w, out_h, out_w, int(win_h != out_h), int(gft.dtype == torch.bfloat16),
        _lib.stream_handle(gft.device),
    )
    _lib.check(err, "win_scatter")
    _lib.launch_counts["win_scatter"] += 1
    return out


def win_scatter(offsets, fyx, gft, *, win_h: int, win_w: int, out_h: int, out_w: int):
    """Windowed bilinear splat -> (out_h, out_w * C) float32. A CUDA tensor
    goes through the kernel, a CPU tensor through `win_scatter_plain`."""
    fn = win_scatter_cuda if gft.is_cuda else win_scatter_plain
    return fn(offsets, fyx, gft, win_h, win_w, out_h, out_w)
