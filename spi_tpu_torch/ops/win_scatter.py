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
"""

from __future__ import annotations

import torch

from spi_tpu_torch.ops import _lib


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


def win_scatter_cuda(offsets, fyx, gft, win_h: int, win_w: int, out_h: int, out_w: int):
    """Launch the kernel: same function as `win_scatter_plain`.

    offsets (T, 2) int32; fyx (T, R >= 2, P) float32; gft (T, C, P)
    float32 or bfloat16, C a multiple of 4; all contiguous on one CUDA
    device.
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
    if win_h * win_w * 4 * 4 > 232448:
        raise ValueError(f"a {win_h}x{win_w} window of 4 channels does not fit shared memory")
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
