"""The triplane lookup (`sample_planes`' forward) against spi_tpu, on the CPU.

On CPU tensors the forward runs `sample_planes_plain`, the 4-corner
gather, and never reaches the kernel library; on the card the same
Function launches `csrc/plane_sample.cu`, which chip_smoke.py holds
bitwise to `sample_planes_plain`. Here the plain version is held to
spi_tpu's `sample_from_planes` (jitted, its XLA forward) at the
tolerances of the port's other lookup tests: float32 planes within 1e-5
(test_torch_port_ops.py), bfloat16 planes within 1e-6 of the largest
entry (the same f32 products of exactly widened bf16 rows, as in
test_torch_port_bf16_ops.py). The points lie exactly on texel centres and
edges, on the box's faces and outside it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.models.rendering import renderer as JR
from spi_tpu_torch.ops import _lib
from spi_tpu_torch.ops import plane_splat as ps
from spi_tpu_torch.ops.grid_sample import sample_flat
from spi_tpu_torch.utils.params import vmap_strict
from torch_threads import few_torch_threads  # noqa: F401

BOX_WARP = 1.0


def _planes(n, res, c, dtype, seed):
    t = torch.from_numpy(np.random.RandomState(seed).randn(n, 3, res * res, c).astype(np.float32))
    return t.to(dtype)


def _points(n, res, seed, box_warp=BOX_WARP):
    """(n, M, 3) world points: texel centres and edges of a res^2 plane on
    every axis, points on the box's faces (|x| = box_warp / 2), points
    outside it, and random points inside."""
    rs = np.random.RandomState(seed)
    i = np.arange(res + 1)
    on_grid = np.concatenate([(2 * i[:-1] + 1) / res - 1, 2 * i / res - 1])  # centres, edges
    half = box_warp / 2
    sets = []
    for _ in range(n):
        a, b, c = (rs.permutation(on_grid) for _ in range(3))
        k = min(len(a), len(b), len(c))
        grid_pts = np.stack([a[:k], b[:k], c[:k]], -1) * half
        faces = rs.uniform(-half, half, (24, 3))
        faces[np.arange(24), np.arange(24) % 3] = np.where(np.arange(24) % 2, half, -half)
        outside = rs.uniform(-1.6, 1.6, (24, 3)) * box_warp
        outside[:12, 0] = np.where(np.arange(12) % 2, 0.75, -0.75) * box_warp
        inside = rs.uniform(-half, half, (40, 3))
        sets.append(np.concatenate([grid_pts, faces, outside, inside]))
    return np.stack(sets).astype(np.float32)


def _jax_lookup(planes, coords, box_warp=BOX_WARP):
    jplanes = jnp.asarray(planes.float().numpy())
    if planes.dtype == torch.bfloat16:
        jplanes = jplanes.astype(jnp.bfloat16)
    fn = jax.jit(lambda p, x: JR.sample_from_planes(p, x, box_warp))
    return np.asarray(fn(jplanes, jnp.asarray(coords)))


def _todays_forward(planes, coordinates, box_warp):
    """The body of `_SamplePlanes.forward` before the lookup kernel."""
    n, _, hw, c = planes.shape
    h = w = int(round(hw ** 0.5))
    m = coordinates.shape[1]
    grids = ps.project_onto_planes(coordinates * (2.0 / box_warp))
    out = sample_flat(planes.reshape(n * 3, hw, c), grids.reshape(n * 3, m, 2), h, w)
    return out.reshape(n, 3, m, c)


@pytest.fixture
def no_library(monkeypatch):
    """Fails a test that reaches the kernel library; launch counts at 0."""
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_lib, "lib", refuse)
    _lib.reset_launch_counts()
    yield
    assert not any(_lib.launch_counts.values()), _lib.launch_counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_lookup_launches_nothing(no_library, dtype):
    """Forward and backward of `sample_planes` on CPU tensors: the plain
    versions, no launch, no library."""
    planes = _planes(2, 16, 8, dtype, seed=1).requires_grad_(True)
    coords = torch.from_numpy(_points(2, 16, seed=2))
    out = ps.sample_planes(planes, coords, BOX_WARP)
    assert out.dtype == torch.float32 and out.shape == (2, 3, coords.shape[1], 8)
    out.sum().backward()
    assert planes.grad.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("res,c", [(16, 8), (32, 32)])
def test_lookup_matches_spi_tpu(no_library, res, c, dtype):
    planes = _planes(2, res, c, dtype, seed=res + c)
    coords = _points(2, res, seed=res * c)
    got = ps.sample_planes(planes, torch.from_numpy(coords), BOX_WARP)
    want = _jax_lookup(planes, coords)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    # Zeros padding: a point more than a texel beyond the box in x, which
    # all three planes read, samples nothing.
    far = np.abs(coords[..., 0]) > 0.5 * BOX_WARP + 1.0 / res
    assert far.all(axis=0).any()
    assert not got.numpy()[:, :, far.all(axis=0)].any()


def test_lookup_matches_spi_tpu_other_box_warp(no_library):
    """box_warp 2: the world points scale by 1, the texel math alone."""
    planes = _planes(1, 16, 8, torch.float32, seed=3)
    coords = _points(1, 16, seed=4, box_warp=2.0)
    got = ps.sample_planes(planes, torch.from_numpy(coords), 2.0)
    np.testing.assert_allclose(got.numpy(), _jax_lookup(planes, coords, 2.0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_plain_is_todays_forward(no_library, dtype):
    """`sample_planes_plain`, and the Function's forward on the CPU, equal
    the forward as it was before the kernel, bitwise."""
    planes = _planes(2, 32, 32, dtype, seed=5)
    coords = torch.from_numpy(_points(2, 32, seed=6)).to(
        torch.float64 if dtype == torch.float64 else torch.float32)
    want = _todays_forward(planes, coords, BOX_WARP)
    assert torch.equal(ps.sample_planes_plain(planes, coords, BOX_WARP), want)
    assert torch.equal(ps.sample_planes(planes, coords, BOX_WARP), want)


def test_generator_planes_reach_the_lookup_contiguous():
    """`planes_nhwc` hands the lookup channels-last planes in memory, so
    that the kernel's forward copies nothing, alone and under vmap."""
    from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config

    g = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=0)
    ws = torch.zeros(2, g.num_ws, g.w_dim)
    with torch.no_grad():
        assert g.planes_nhwc(ws).is_contiguous()
        assert vmap_strict(g.planes_nhwc)(ws[:, None]).is_contiguous()


def test_vmapped_lookup_equals_a_loop(no_library):
    """Under vmap the batch folds into the tables of one call: equal,
    bitwise, to one call per image."""
    planes = _planes(3, 16, 8, torch.float32, seed=7).reshape(3, 1, 3, 256, 8)
    coords = torch.from_numpy(_points(3, 16, seed=8)).reshape(3, 1, -1, 3)
    out = vmap_strict(lambda p, x: ps.sample_planes(p, x, BOX_WARP))(planes, coords)
    loop = torch.stack([ps.sample_planes_plain(planes[i], coords[i], BOX_WARP) for i in range(3)])
    assert torch.equal(out, loop)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"),
    ("float64", "float32 or bfloat16"),
    ("c_not_multiple_of_4", "multiple of 4"),
    ("bf16_c_not_multiple_of_8", "multiple of 8"),
    ("points_not_xyz", "do not match"),
    ("point_sets_not_tables", "do not match"),
    ("planes_not_square", "do not match"),
])
def test_cuda_wrapper_raises(no_library, case, match):
    """`sample_planes_cuda` launches the kernel or raises: it never
    computes on what the kernel does not take, CPU tensors included."""
    planes = torch.zeros(2, 3, 64, 8)
    coords = torch.zeros(2, 10, 3)
    if case == "float64":
        planes = planes.double()
    elif case == "c_not_multiple_of_4":
        planes = torch.zeros(2, 3, 64, 6)
    elif case == "bf16_c_not_multiple_of_8":
        planes = torch.zeros(2, 3, 64, 4, dtype=torch.bfloat16)
    elif case == "points_not_xyz":
        coords = torch.zeros(2, 10, 2)
    elif case == "point_sets_not_tables":
        coords = torch.zeros(3, 10, 3)
    elif case == "planes_not_square":
        planes = torch.zeros(2, 3, 60, 8)
    with pytest.raises(ValueError, match=match):
        ps.sample_planes_cuda(planes, coords, BOX_WARP)
