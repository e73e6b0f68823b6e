"""3D shape export: density grid -> marching tetrahedra -> PLY (counterpart
of spi_tpu/utils/shape.py; spec eg3d/shape_utils.py:40-100 and the
density loop of spi/utils/video_utils.py:142-205).

Device part: the densities of a cube grid, probed through
`TriPlaneGenerator.sample_mixed` in chunks of `max_batch` points from
planes computed once (spi_tpu recomputes them in every chunk; they depend
on ws alone). Host part: marching tetrahedra and an ASCII PLY writer in
numpy, copies of spi_tpu's that give identical output.
"""

from __future__ import annotations

import numpy as np
import torch

from spi_tpu_torch.utils.device import module_device


@torch.no_grad()
def sample_density_grid(generator, ws, resolution: int = 128, box_warp: float = 1.0,
                        max_batch: int = 1 << 16) -> np.ndarray:
    """Probe sigma on a cube grid centred at the origin with side
    `box_warp` (the EG3D rendering box). Returns (R, R, R) float32."""
    dev = module_device(generator)
    ws = ws.to(dev)
    half = box_warp / 2
    axis = np.linspace(-half, half, resolution, dtype=np.float32)
    grid = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), axis=-1)
    pts = torch.from_numpy(grid.reshape(-1, 3)).to(dev)
    planes = generator.planes_nhwc(ws, noise_mode="const")
    sigmas = []
    for i in range(0, pts.shape[0], max_batch):
        chunk = pts[i:i + max_batch][None]
        _, sigma = generator.sample_mixed(ws, chunk, torch.zeros_like(chunk), planes=planes)
        sigmas.append(sigma[0, :, 0].float())
    return torch.cat(sigmas).cpu().numpy().reshape(resolution, resolution, resolution)


# Each cube splits into 6 tetrahedra sharing the main diagonal (0,7).
# Corner order: bit 0 = x, bit 1 = y, bit 2 = z of the unit cube.
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]]
)
_CORNER = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    np.float32,
)
# For each of the 16 inside/outside sign patterns of a tetrahedron's 4
# vertices: the crossed edges (pairs of local vertex ids) forming 0, 1
# or 2 triangles. Standard marching-tetrahedra case table.
_TET_TRIS = {
    0b0001: [[(0, 1), (0, 2), (0, 3)]],
    0b0010: [[(1, 0), (1, 3), (1, 2)]],
    0b0100: [[(2, 0), (2, 1), (2, 3)]],
    0b1000: [[(3, 0), (3, 2), (3, 1)]],
    0b0011: [[(0, 2), (1, 2), (0, 3)], [(1, 2), (1, 3), (0, 3)]],
    0b0101: [[(0, 1), (2, 1), (0, 3)], [(2, 1), (2, 3), (0, 3)]],
    0b1001: [[(0, 1), (0, 2), (3, 1)], [(0, 2), (3, 2), (3, 1)]],
    0b0110: [[(1, 0), (2, 0), (1, 3)], [(2, 0), (2, 3), (1, 3)]],
    0b1010: [[(1, 0), (3, 0), (1, 2)], [(3, 0), (3, 2), (1, 2)]],
    0b1100: [[(2, 0), (3, 0), (2, 1)], [(3, 0), (3, 1), (2, 1)]],
}
for _pat in list(_TET_TRIS):
    # complementary pattern: same edges, reversed winding
    _TET_TRIS[0b1111 ^ _pat] = [[tri[0], tri[2], tri[1]] for tri in _TET_TRIS[_pat]]


def marching_tetrahedra(volume: np.ndarray, level: float):
    """Isosurface of a (X, Y, Z) scalar grid by marching tetrahedra, with
    skimage.measure.marching_cubes's output contract: vertices in grid
    index coordinates (float32) and faces (int64). Vectorised over cells:
    the loops run over the 6 tetrahedra and 16 sign patterns."""
    rx, ry, rz = volume.shape
    base = np.stack(
        np.meshgrid(np.arange(rx - 1), np.arange(ry - 1), np.arange(rz - 1), indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)  # (C, 3) cell origins
    corner_vals = np.stack(
        [volume[base[:, 0] + int(c[0]), base[:, 1] + int(c[1]), base[:, 2] + int(c[2])]
         for c in _CORNER],
        axis=1,
    )  # (C, 8)
    inside = corner_vals > level

    verts_out = []
    for tet in _TETS:
        tv = corner_vals[:, tet]  # (C, 4)
        ti = inside[:, tet]
        pattern = ti[:, 0] * 1 + ti[:, 1] * 2 + ti[:, 2] * 4 + ti[:, 3] * 8
        tet_pos = base[:, None, :] + _CORNER[tet][None]  # (C, 4, 3)
        for pat, tris in _TET_TRIS.items():
            sel = np.nonzero(pattern == pat)[0]
            if sel.size == 0:
                continue
            v = tv[sel]
            p = tet_pos[sel]
            for tri in tris:
                tri_pts = []
                for a, b in tri:
                    va, vb = v[:, a], v[:, b]
                    t = (level - va) / np.where(vb - va == 0, 1e-12, vb - va)
                    t = np.clip(t, 0.0, 1.0)[:, None]
                    tri_pts.append(p[:, a] * (1 - t) + p[:, b] * t)
                verts_out.append(np.stack(tri_pts, axis=1))  # (S, 3, 3)

    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    flat = np.concatenate(verts_out, axis=0).reshape(-1, 3)
    # one vertex for each position shared by several triangles
    keys = np.round(flat * 1e5).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3), np.float32)
    verts[inv] = flat
    return verts, inv.reshape(-1, 3)


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    """ASCII PLY of vertices and triangles (shape_utils.py:40-100's output,
    without plyfile)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def mesh_from_grid(sigmas: np.ndarray, level: float = 10.0, box_warp: float = 1.0):
    """The isosurface of a density grid from `sample_density_grid` as
    (verts in world coordinates, faces). `level=10` is EG3D's isosurface
    for the FFHQ checkpoints, moved inside the grid's range when the
    densities do not cross it."""
    lo, hi = float(sigmas.min()), float(sigmas.max())
    level = min(max(level, lo + 1e-4), hi - 1e-4) if hi > lo else lo
    verts, faces = marching_tetrahedra(sigmas, level=level)
    verts = verts / (sigmas.shape[0] - 1) * box_warp - box_warp / 2  # grid index -> world
    return verts, faces


def extract_shape(generator, ws, path: str | None = None, resolution: int = 128,
                  level: float = 10.0, box_warp: float = 1.0, max_batch: int = 1 << 16):
    """Density grid -> marching tetrahedra mesh (verts, faces) in world
    coordinates; writes a PLY when `path` is given."""
    sigmas = sample_density_grid(generator, ws, resolution=resolution, box_warp=box_warp,
                                 max_batch=max_batch)
    verts, faces = mesh_from_grid(sigmas, level, box_warp)
    if path is not None:
        write_ply(path, verts, faces)
    return verts, faces
