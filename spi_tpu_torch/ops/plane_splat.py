"""Triplane sampling with a splat-kernel backward (counterpart of
spi_tpu/ops/plane_splat.py and renderer._sample_planes_windowed).

`sample_planes` is an autograd Function around the triplane lookup. Its
forward is the plain 4-corner gather (ops/grid_sample.py). Its backward
is the splat: each point's cotangent added with bilinear weights into
the three plane-gradient tables. On a CUDA tensor the backward launches
the kernel of `csrc/plane_splat.cu`; on a CPU tensor it runs
`splat_plain`, four `index_add_` calls. There is no switch and no
fallback between the two.

The TPU version tiled points by ray, reduced each tile into a VMEM
window on the MXU and fell back to an XLA scatter when a window
overflowed. The CUDA kernel is exact for any point layout, so every
render pass (coarse, fine, multi-camera) uses it, with no window, no
overflow fallback and no tile reordering.

The coordinates get no gradient: `sample_planes` raises if they need
one, rather than returning a silent zero as spi_tpu's windowed path did
(no render of the inversion path differentiates its sample points:
coarse depths come from the camera, importance depths are detached).
"""

from __future__ import annotations

import math

import torch

from spi_tpu_torch.ops import _lib
from spi_tpu_torch.ops.grid_sample import bilinear_corners, sample_flat, texel_coords


def project_onto_planes(coordinates):
    """(N, M, 3) -> (N, 3, M, 2): plane 0 reads (x, y), plane 1 (x, z),
    plane 2 (z, x) (EG3D renderer.py:23-53)."""
    x, y, z = coordinates.unbind(-1)
    return torch.stack([
        torch.stack([x, y], dim=-1),
        torch.stack([x, z], dim=-1),
        torch.stack([z, x], dim=-1),
    ], dim=1)


def _plane_texels(coordinates, box_warp: float, h: int, w: int):
    """(N, M, 3) world points -> per-plane texel coords (fx, fy), each (N*3, M)."""
    n, m, _ = coordinates.shape
    grids = project_onto_planes(coordinates * (2.0 / box_warp)).reshape(n * 3, m, 2)
    return texel_coords(grids[..., 0], grids[..., 1], h, w)


def splat_plain(coordinates, g, box_warp: float, h: int, w: int):
    """The plain PyTorch version: (N, M, 3) world points and (N, 3, M, C)
    cotangents -> (N, 3, H*W, C) plane gradient, accumulated in float32
    (float64 for float64 inputs), by a 4-corner `index_add_`.
    Out-of-range corners carry weight zero and add nothing."""
    n, m, _ = coordinates.shape
    c = g.shape[-1]
    acc = torch.promote_types(g.dtype, torch.float32)
    fx, fy = _plane_texels(coordinates.to(acc), box_warp, h, w)
    base = (torch.arange(n * 3, device=g.device) * (h * w))[:, None]
    gf = g.reshape(n * 3 * m, c).to(acc)
    out = torch.zeros(n * 3 * h * w, c, dtype=acc, device=g.device)
    for flat, wgt in bilinear_corners(fx, fy, h, w):
        out.index_add_(0, (flat + base).reshape(-1), gf * wgt.reshape(-1, 1))
    return out.reshape(n, 3, h * w, c)


def splat_cuda(coordinates, g, box_warp: float, h: int, w: int):
    """Launch the splat kernel: same function as `splat_plain`.

    coordinates: (N, M, 3) float32; g: (N, 3, M, C) float32 with C a
    multiple of 4; both contiguous on one CUDA device.
    """
    _lib.require(coordinates, "coordinates", ndim=3)
    _lib.require(g, "cotangent", device=coordinates.device, ndim=4, align=16)
    n, m, three = coordinates.shape
    if three != 3 or g.shape[:3] != (n, 3, m):
        raise ValueError(f"shapes do not match: coordinates {tuple(coordinates.shape)}, "
                         f"cotangent {tuple(g.shape)}")
    c = g.shape[3]
    if c % 4:
        raise ValueError(f"splat kernel takes C a multiple of 4, got {c}")
    if n * 3 * m * (c // 4) >= 2**31 or n * 3 * h * w * c >= 2**31:
        raise ValueError("splat kernel takes fewer than 2^31 work items and table entries")
    out = torch.empty(n, 3, h * w, c, dtype=torch.float32, device=g.device)
    err = _lib.lib().spi_plane_splat(
        coordinates.data_ptr(), g.data_ptr(), out.data_ptr(), n, m, h, w, c,
        2.0 / box_warp, _lib.stream_handle(g.device),
    )
    _lib.check(err, "plane_splat")
    _lib.launch_counts["plane_splat"] += 1
    return out


class _SamplePlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, planes, coordinates, box_warp):
        if ctx.needs_input_grad[1]:
            raise RuntimeError(
                "sample_planes computes no gradient for the sample coordinates; "
                "detach them (the renderer's coarse and importance depths carry none)"
            )
        n, n_planes, hw, c = planes.shape
        h = w = math.isqrt(hw)
        if n_planes != 3 or h * w != hw or coordinates.shape[0] != n:
            raise ValueError(f"planes {tuple(planes.shape)} / coordinates "
                             f"{tuple(coordinates.shape)} do not match")
        m = coordinates.shape[1]
        grids = project_onto_planes(coordinates * (2.0 / box_warp))
        out = sample_flat(planes.reshape(n * 3, hw, c), grids.reshape(n * 3, m, 2), h, w)
        ctx.save_for_backward(coordinates)
        ctx.geom = (box_warp, h, w, planes.dtype)
        return out.reshape(n, 3, m, c)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (coordinates,) = ctx.saved_tensors
        box_warp, h, w, dtype = ctx.geom
        if g.is_cuda:
            d = splat_cuda(coordinates.contiguous(), g.contiguous(), box_warp, h, w)
        else:
            d = splat_plain(coordinates, g, box_warp, h, w)
        return d.to(dtype), None, None


def sample_planes(planes, coordinates, box_warp: float):
    """Bilinear-sample (N, 3, H*W, C) channels-last planes at (N, M, 3)
    world points -> (N, 3, M, C). The backward is the splat."""
    return _SamplePlanes.apply(planes, coordinates, box_warp)
