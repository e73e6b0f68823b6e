"""Triplane sampling: a lookup kernel forward and a splat-kernel backward
(counterpart of spi_tpu/ops/plane_splat.py and
renderer._sample_planes_windowed).

`sample_planes` is an autograd Function around the triplane lookup. Its
forward is the 3-plane bilinear sample: on a CUDA tensor the kernel of
`csrc/plane_sample.cu` (float32 or bfloat16 planes, float32 features), on
a CPU tensor `sample_planes_plain`, the 4-corner gather of
ops/grid_sample.py. Its backward is the splat: each point's cotangent
added with bilinear weights into the three plane-gradient tables, on a
CUDA tensor by the kernel of `csrc/plane_splat.cu`, on a CPU tensor by
`splat_plain`, four `index_add_` calls. The splat is an autograd Function
too (`_Splat`), whose backward is the lookup again, so the planes are
differentiable to any order (a Hessian-vector product launches the splat
and the lookup). Both kernels share their texel math
(`csrc/plane_texels.cuh`). There is no switch and no fallback: a CUDA
input that a kernel does not take raises.

spi_tpu ran the forward as an XLA composition and the backward as a
Pallas kernel that tiled points by ray, reduced each tile into a VMEM
window on the MXU and fell back to an XLA scatter when a window
overflowed. The CUDA splat also works per ray tile, but groups each
tile's corners by texel and issues one global reduction per distinct
texel, so it is exact for any point layout: every render pass (coarse, fine,
multi-camera) uses it, with no window and no overflow fallback. The ray
geometry (`RayGeom`, as spi_tpu's renderer passes it) only decides which
points share a tile; without it a tile is a run of consecutive points.
`tile_points` and `splat_tiled` restate the kernel's tiling and its
per-tile reduction in plain PyTorch, for the CPU tests and for counting
the reductions a pass issues.

Under torch.func.vmap (several images a step) the Function's vmap rule
folds the image axis into the tables, so the lookup and the splat each
launch once for the batch. The lookup takes its inputs contiguous; where
a caller hands it strided ones, the forward copies them and counts the
copy in `contiguous_copies`.

The coordinates get no gradient: `sample_planes` raises if they need
one, rather than returning a silent zero as spi_tpu's windowed path did
(no render of the inversion path differentiates its sample points:
coarse depths come from the camera, importance depths are detached).
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class RayGeom:
    """Ray-bundle structure of one render pass (spi_tpu's RayGeom): points
    are ordered index = ((view * rays_h + vy) * rays_w + vx) * n_samples + s.
    `fine` marks importance-sampled depths."""

    n_views: int
    rays_h: int
    rays_w: int
    n_samples: int
    fine: bool = False

    @property
    def n_points(self) -> int:
        return self.n_views * self.rays_h * self.rays_w * self.n_samples


# Most points one block of the splat kernel owns (csrc/plane_splat.cu
# instantiates 256 and 512).
TILE_POINTS = 256
# Ray tiles (rays down, rays across, samples) of a coarse and of a fine
# pass, the fastest of those tools/splat_tiles.py times at full width:
# tall tiles share the most texels, since a ray's neighbours below it fall
# on the same texels of planes 1 and 2.
RAY_TILE = (16, 4, 4)
RAY_TILE_FINE = (16, 2, 8)


def kernel_tiling(geom: RayGeom | None, n: int, m: int, tile=None):
    """The kernel's view of the points of `n` tables of `m` points:
    (views per table, rays_h, rays_w, samples) and the tile (tv, tu, ts).
    Without a geometry every table is one row of `m` rays of one sample,
    tiled in runs of TILE_POINTS consecutive points."""
    if geom is None:
        return (1, 1, m, 1), tile or (1, TILE_POINTS, 1)
    if geom.n_points != n * m or geom.n_views % n:
        raise ValueError(f"ray geometry {geom} does not describe {n} tables of {m} points")
    tv, tu, ts = tile or (RAY_TILE_FINE if geom.fine else RAY_TILE)
    tile = (min(tv, geom.rays_h), min(tu, geom.rays_w), min(ts, geom.n_samples))
    return (geom.n_views // n, geom.rays_h, geom.rays_w, geom.n_samples), tile


def tile_points(n: int, m: int, layout, tile, device=None):
    """(tiles, tv * tu * ts) index of each tile's points into the (n * m)
    points, -1 where a ragged tile is masked: tiles ordered (table, view,
    tile row, tile column, sample group) and points (ray row, ray column,
    sample) within a tile, as the kernel numbers its blocks and points."""
    views, rays_h, rays_w, samples = layout
    tv, tu, ts = tile
    nh, nw, ns = -(-rays_h // tv), -(-rays_w // tu), -(-samples // ts)
    t = torch.arange(n * views * nh * nw * ns, device=device)[:, None]
    tb, view = t // (views * nh * nw * ns), t // (nh * nw * ns) % views
    ty, tx, tg = t // (nw * ns) % nh, t // ns % nw, t % ns
    loc = torch.arange(tv * tu * ts, device=device)[None]
    ry = ty * tv + loc // (tu * ts)
    rx = tx * tu + loc // ts % tu
    sp = tg * ts + loc % ts
    point = tb * m + ((view * rays_h + ry) * rays_w + rx) * samples + sp
    return torch.where((ry < rays_h) & (rx < rays_w) & (sp < samples), point, -1)


def splat_tiled(coordinates, g, box_warp: float, h: int, w: int, geom: RayGeom | None = None,
                tile=None):
    """The kernel's algorithm in plain PyTorch: for each (tile, plane), the
    in-plane corners' (tile, texel) keys, one sum of weight x cotangent per
    distinct key, and one add of each sum into the table. Returns the same
    plane gradient as `splat_plain` and the number of distinct (tile,
    plane, texel) keys: the kernel issues that many reductions per
    4-channel group."""
    n, m, _ = coordinates.shape
    c = g.shape[-1]
    layout, tile = kernel_tiling(geom, n, m, tile)
    pts = tile_points(n, m, layout, tile, device=g.device)
    live = pts >= 0
    tile_id = torch.arange(pts.shape[0], device=g.device)[:, None].expand_as(pts)[live]
    q = pts[live]
    tb, loc = q // m, q % m
    tile_table = torch.arange(pts.shape[0], device=g.device) // (pts.shape[0] // n)
    acc = torch.promote_types(g.dtype, torch.float32)
    fx, fy = _plane_texels(coordinates.to(acc), box_warp, h, w)
    gf = g.to(acc)
    out = torch.zeros(n * 3 * h * w, c, dtype=acc, device=g.device)
    n_keys = 0
    for p in range(3):
        px, py = fx[tb * 3 + p, loc], fy[tb * 3 + p, loc]
        x0, y0 = torch.floor(px), torch.floor(py)
        gp = gf[tb, p, loc]
        keys, rows, wts = [], [], []
        for (flat, wgt), (dx, dy) in zip(bilinear_corners(px, py, h, w),
                                         ((0, 0), (1, 0), (0, 1), (1, 1))):
            keep = (x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h)
            keys.append((tile_id * (h * w) + flat)[keep])
            rows.append(gp[keep])
            wts.append(wgt[keep])
        uniq, inv = torch.unique(torch.cat(keys), return_inverse=True)
        n_keys += uniq.numel()
        sums = torch.zeros(uniq.numel(), c, dtype=acc, device=g.device)
        sums.index_add_(0, inv, torch.cat(rows) * torch.cat(wts)[:, None])
        dest = (tile_table[uniq // (h * w)] * 3 + p) * (h * w) + uniq % (h * w)
        out.index_add_(0, dest, sums)
    return out.reshape(n, 3, h * w, c), n_keys


def splat_cuda(coordinates, g, box_warp: float, h: int, w: int, geom: RayGeom | None = None,
               tile=None):
    """Launch the splat kernel: same function as `splat_plain`.

    coordinates: (N, M, 3) float32; g: (N, 3, M, C) float32 with C a
    multiple of 4; both contiguous on one CUDA device. `geom` describes
    the N * M points (see `kernel_tiling`); `tile` overrides RAY_TILE / RAY_TILE_FINE.
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
    if n * 3 * m * c >= 2**31 or n * 3 * h * w * c >= 2**31:
        raise ValueError("splat kernel takes fewer than 2^31 cotangent and table entries")
    (views, rays_h, rays_w, samples), (tv, tu, ts) = kernel_tiling(geom, n, m, tile)
    if tv * tu * ts > 512:
        raise ValueError(f"splat kernel takes at most 512 points a tile, got {(tv, tu, ts)}")
    if h * w > 2**20:
        raise ValueError(f"splat kernel takes tables of at most 2^20 texels, got {h}x{w}")
    out = torch.empty(n, 3, h * w, c, dtype=torch.float32, device=g.device)
    err = _lib.lib().spi_plane_splat(
        coordinates.data_ptr(), g.data_ptr(), out.data_ptr(), n, views, rays_h, rays_w,
        samples, tv, tu, ts, h, w, c, 2.0 / box_warp, _lib.stream_handle(g.device),
    )
    _lib.check(err, "plane_splat")
    _lib.launch_counts["plane_splat"] += 1
    return out


def sample_planes_plain(planes, coordinates, box_warp: float):
    """The plain PyTorch version of the lookup: (N, 3, H*W, C) planes at
    (N, M, 3) world points -> (N, 3, M, C), by the 4-corner gather of
    `sample_flat` (float32 features from bfloat16 planes)."""
    n, _, hw, c = planes.shape
    h = w = math.isqrt(hw)
    m = coordinates.shape[1]
    grids = project_onto_planes(coordinates * (2.0 / box_warp))
    out = sample_flat(planes.reshape(n * 3, hw, c), grids.reshape(n * 3, m, 2), h, w)
    return out.reshape(n, 3, m, c)


# The lookup kernel's form for each planes dtype, and the channels that
# one thread of it reads from a corner row (16 bytes).
SAMPLE_KERNELS = {torch.float32: ("plane_sample", 4), torch.bfloat16: ("plane_sample_bf16", 8)}


def sample_planes_cuda(planes, coordinates, box_warp: float):
    """Launch the lookup kernel: the same function as `sample_planes_plain`,
    bitwise.

    planes: (N, 3, H*W, C) float32 with C a multiple of 4, or bfloat16 with
    C a multiple of 8, H = W; coordinates: (N, M, 3) float32; both
    contiguous on one CUDA device. Returns (N, 3, M, C) float32.
    """
    if planes.dtype not in SAMPLE_KERNELS:
        raise ValueError(f"lookup kernel takes float32 or bfloat16 planes, got {planes.dtype}")
    name, per_thread = SAMPLE_KERNELS[planes.dtype]
    if planes.ndim != 4 or coordinates.ndim != 3:
        raise ValueError(f"shapes do not match: planes {tuple(planes.shape)}, "
                         f"coordinates {tuple(coordinates.shape)}")
    n, n_planes, hw, c = planes.shape
    h = math.isqrt(hw)
    m = coordinates.shape[1]
    if n_planes != 3 or h * h != hw or tuple(coordinates.shape) != (n, m, 3):
        raise ValueError(f"shapes do not match: planes {tuple(planes.shape)}, "
                         f"coordinates {tuple(coordinates.shape)}")
    if c % per_thread:
        raise ValueError(f"lookup kernel takes C a multiple of {per_thread} for "
                         f"{planes.dtype} planes, got {c}")
    if n * 3 * m * c >= 2**31 or n * 3 * hw * c >= 2**31:
        raise ValueError("lookup kernel takes fewer than 2^31 output and plane entries")
    _lib.require(planes, "planes", dtype=planes.dtype, align=16)
    _lib.require(coordinates, "coordinates", device=planes.device)
    out = torch.empty(n, 3, m, c, dtype=torch.float32, device=planes.device)
    err = getattr(_lib.lib(), "spi_" + name)(
        planes.data_ptr(), coordinates.data_ptr(), out.data_ptr(), n, m, h, h, c,
        2.0 / box_warp, _lib.stream_handle(planes.device),
    )
    _lib.check(err, name)
    _lib.launch_counts[name] += 1
    return out


# Copies the forward made of strided inputs before the lookup kernel
# (by argument); the render passes hand it contiguous ones.
contiguous_copies = {"planes": 0, "coordinates": 0}


def _contiguous(t, name):
    if t.is_contiguous():
        return t
    contiguous_copies[name] += 1
    return t.contiguous()


class _SamplePlanes(torch.autograd.Function):
    @staticmethod
    def forward(planes, coordinates, box_warp, geom):
        n, n_planes, hw, _ = planes.shape
        h = w = math.isqrt(hw)
        if n_planes != 3 or h * w != hw or coordinates.shape[0] != n:
            raise ValueError(f"planes {tuple(planes.shape)} / coordinates "
                             f"{tuple(coordinates.shape)} do not match")
        kernel_tiling(geom, n, coordinates.shape[1])  # raises on a geometry that does not fit
        if planes.is_cuda:
            return sample_planes_cuda(_contiguous(planes, "planes"),
                                      _contiguous(coordinates, "coordinates"), box_warp)
        return sample_planes_plain(planes, coordinates, box_warp)

    @staticmethod
    def setup_context(ctx, inputs, output):
        planes, coordinates, box_warp, geom = inputs
        if ctx.needs_input_grad[1]:
            raise RuntimeError(
                "sample_planes computes no gradient for the sample coordinates; "
                "detach them (the renderer's coarse and importance depths carry none)"
            )
        h = math.isqrt(planes.shape[2])
        ctx.save_for_backward(coordinates)
        ctx.geom = (box_warp, h, h, planes.dtype, geom)

    @staticmethod
    def backward(ctx, g):
        (coordinates,) = ctx.saved_tensors
        box_warp, h, w, dtype, geom = ctx.geom
        d = _Splat.apply(coordinates, g, box_warp, h, w, geom)
        return d.to(dtype), None, None, None

    @staticmethod
    def vmap(info, in_dims, planes, coordinates, box_warp, geom):
        """Under torch.func.vmap: B images' (N, 3, H*W, C) planes and (N, M, 3)
        points fold into B * N tables of one call, so the forward lookup and
        the backward splat launch once for the whole batch. The ray geometry
        counts B times the views; a side that is not batched is expanded."""
        b = info.batch_size
        planes = _batch_first(planes, in_dims[0], b)
        coordinates = _batch_first(coordinates, in_dims[1], b)
        n = planes.shape[1]
        if geom is not None:
            geom = dataclasses.replace(geom, n_views=geom.n_views * b)
        out = _SamplePlanes.apply(planes.reshape(b * n, *planes.shape[2:]),
                                  coordinates.reshape(b * n, *coordinates.shape[2:]),
                                  box_warp, geom)
        return out.reshape(b, n, *out.shape[1:]), 0


class _Splat(torch.autograd.Function):
    """The splat as a function of the cotangent: (N, M, 3) points and
    (N, 3, M, C) cotangents -> (N, 3, H*W, C) float32 plane gradient, by
    `splat_cuda` on a CUDA tensor and `splat_plain` on a CPU tensor. It is
    linear in the cotangent and the adjoint of the lookup, so its backward
    is the lookup (`sample_planes`) of the incoming plane-shaped gradient
    at the same points: the planes are differentiable to any order on the
    two kernels."""

    @staticmethod
    def forward(coordinates, g, box_warp, h, w, geom):
        if g.is_cuda:
            return splat_cuda(coordinates.contiguous(), g.contiguous(), box_warp, h, w, geom)
        return splat_plain(coordinates, g, box_warp, h, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        coordinates, g, box_warp, h, w, geom = inputs
        if ctx.needs_input_grad[0]:
            raise RuntimeError("the splat computes no gradient for the sample coordinates")
        ctx.save_for_backward(coordinates)
        ctx.geom = (box_warp, g.dtype, geom)

    @staticmethod
    def backward(ctx, gg):
        (coordinates,) = ctx.saved_tensors
        box_warp, dtype, geom = ctx.geom
        dg = sample_planes(gg, coordinates, box_warp, geom).to(dtype)
        return None, dg, None, None, None, None


def _batch_first(x, dim, b):
    """A vmapped argument with its image axis first: moved there, or
    expanded to `b` images where the argument is shared."""
    if dim is None:
        return x.expand(b, *x.shape)
    return x.movedim(dim, 0)


def sample_planes(planes, coordinates, box_warp: float, geom: RayGeom | None = None):
    """Bilinear-sample (N, 3, H*W, C) channels-last planes at (N, M, 3)
    world points -> (N, 3, M, C) float32 (float64 for float64 inputs on the
    CPU). The forward is the lookup kernel, the backward the splat; `geom`,
    the ray geometry of the N * M points, only decides the splat's tiles."""
    return _SamplePlanes.apply(planes, coordinates, box_warp, geom)
