"""The plain versions of the port's probe kernels against the bodies of
spi_tpu's Pallas probes, on the CPU, and the probe tools at a tiny size.

- row_gather_plain against `jnp.take_along_axis` (tools/profile_gather.py
  `gather_kernel`), row_scatter_add_plain against `.at[].add`
  (tools/probe_scatter_r5.py `pallas_rmw_probe`): bitwise for the gather,
  1e-6 of the largest entry for the scatter-add (sums in another order).
- win_scatter_plain against tools/probe_winscatter_r5.win_scatter run in
  interpret mode, on K1 windows and K2 strips, with footprints leaving
  the window, a dead point and integer coordinates: 1e-5 of the largest
  entry in float32 and in bfloat16, since the plain version rounds the
  hat weights and hx * g to bfloat16 where the Pallas kernel does and
  only the order of the float32 sums differs (1.3e-7 at most on these
  inputs).
- win_scatter_binned (the kernel's algorithm: bins by window cell, one
  sum a bin) against win_scatter_plain and the Pallas probe on K1, K2, a
  crowded window, a dead tile and windows overhanging the table, with its
  count of float4 reductions against the nonzero bins counted in numpy.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spi_tpu_torch.ops import gather_scatter as gs
from spi_tpu_torch.ops import win_scatter as ws
from spi_tpu_torch.tools import (
    probe_scatter,
    probe_winscatter,
    profile_gather,
    splat_tiles,
    timing,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))
import probe_winscatter_r5 as jwin  # noqa: E402  (imports bench_util from tools/)
from torch_threads import few_torch_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


class TestRowGather:
    @pytest.mark.parametrize("broadcast", [True, False])
    def test_matches_take_along_axis(self, broadcast):
        rs = np.random.RandomState(0)
        tab = rs.randn(64, 8).astype(np.float32)
        if broadcast:  # the probe's shape: one row index per output row
            idx = np.broadcast_to(rs.randint(0, 64, (100, 1)), (100, 8)).astype(np.int32)
        else:
            idx = rs.randint(0, 64, (100, 8)).astype(np.int32)
        want = jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx), axis=0)
        got = gs.row_gather(_t(tab), _t(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_per_element_indices_at_32_columns(self):
        """The probe's width with an index per element, none broadcast: the
        form in which the kernel makes four scalar loads."""
        rs = np.random.RandomState(2)
        tab = rs.randn(300, 32).astype(np.float32)
        idx = rs.randint(0, 300, (257, 32)).astype(np.int32)
        assert (idx != idx[:, :1]).any(axis=1).all()
        want = jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx), axis=0)
        got = gs.row_gather_plain(_t(tab), _t(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_cuda_wrapper_rejects_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            gs.row_gather_cuda(torch.zeros(4, 8), torch.zeros(2, 8, dtype=torch.int32))


class TestRowScatterAdd:
    @pytest.mark.parametrize("shape", [(500, 1), (500,)])
    def test_matches_at_add(self, shape):
        rs = np.random.RandomState(1)
        rows = rs.randint(0, 40, shape).astype(np.int32)
        upd = rs.randn(500, 8).astype(np.float32)
        want = jnp.zeros((40, 8), jnp.float32).at[jnp.asarray(rows).reshape(-1)].add(upd)
        got = gs.row_scatter_add(_t(rows), _t(upd), 40)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))

    def test_rows_past_the_table_are_dropped(self):
        rows = np.array([0, 40, 3, 99, 3], np.int32)
        upd = np.arange(20, dtype=np.float32).reshape(5, 4)
        want = jnp.zeros((40, 4), jnp.float32).at[jnp.asarray(rows)].add(upd)
        got = gs.row_scatter_add(_t(rows), _t(upd), 40)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_cuda_wrapper_rejects_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            gs.row_scatter_add_cuda(torch.zeros(3, dtype=torch.int32), torch.zeros(3, 8), 4)


def _win_inputs(k1, dtype):
    """2 tiles x 256 points (C = 8) into a 48 x 48 table: points spread past
    the window's edges on both sides, the first point of each tile dead
    (-10), every fifth on integer coordinates."""
    rs = np.random.RandomState(5 if k1 else 6)
    t, p, c, out = 2, 256, 8, 48
    win_h, win_w = (16, 16) if k1 else (out, 16)
    offsets = np.array([[8, 16], [24, 0]] if k1 else [[16, 8], [0, 32]], np.int32)
    fyx = np.zeros((t, 8, p), np.float32)
    fyx[:, 0] = rs.uniform(-1.5, win_h + 0.5, (t, p))
    fyx[:, 1] = rs.uniform(-1.5, win_w + 0.5, (t, p))
    fyx[:, :2, ::5] = np.round(fyx[:, :2, ::5])
    fyx[:, :2, 0] = -10.0
    gft = rs.randn(t, c, p).astype(np.float32)
    if dtype == "bf16":
        gft = np.asarray(jnp.asarray(gft, jnp.bfloat16))
    return offsets, fyx, gft, dict(win_h=win_h, win_w=win_w, out_h=out, out_w=out, c=c)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k1", [True, False], ids=["K1", "K2"])
def test_win_scatter_matches_pallas(k1, dtype):
    offsets, fyx, gft, geom = _win_inputs(k1, dtype)
    c = geom.pop("c")
    want = np.asarray(jwin.win_scatter(jnp.asarray(offsets), jnp.asarray(fyx), jnp.asarray(gft),
                                       c=c, ps=128, interpret=True, **geom))
    tg = _t(gft) if dtype == "f32" else torch.from_numpy(gft.astype(np.float32)).bfloat16()
    got = ws.win_scatter(_t(offsets), _t(fyx), tg, **geom).numpy()
    assert got.shape == want.shape == (geom["out_h"], geom["out_w"] * c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    # Every window's footprint escapes it: the table holds only window cells.
    tab = got.reshape(geom["out_h"], geom["out_w"], c)
    covered = np.zeros(tab.shape[:2], bool)
    for oy, ox in offsets:
        oy = oy if k1 else 0
        covered[oy:oy + geom["win_h"], ox:ox + geom["win_w"]] = True
    assert not tab[~covered].any() and tab[covered].any()


def _binned_case(case, dtype):
    """`_win_inputs`' K1 and K2 inputs, and three K1 variants: `crowded`
    (every point of both tiles within a 4 x 4 patch of cells, some 64
    corners a cell, as 64x32 windows crowd them), `dead` (the first tile's
    points all dead) and `overhang` (windows that leave the table past its
    last row and column, and before its first)."""
    offsets, fyx, gft, geom = _win_inputs(case != "K2", dtype)
    if case == "crowded":
        rs = np.random.RandomState(7)
        fyx[:, :2] = rs.uniform(5.0, 7.9, fyx[:, :2].shape)
    elif case == "dead":
        fyx[0, :2] = -10.0
    elif case == "overhang":
        offsets = np.array([[40, 40], [-8, -12]], np.int32)
    return offsets, fyx, gft, geom


def _nonzero_bins(offsets, fyx, geom):
    """Distinct (tile, window cell) pairs that a corner of nonzero hat
    weight reaches inside both the window and the table, counted in numpy."""
    bins = set()
    for t in range(fyx.shape[0]):
        oy = offsets[t, 0] if geom["win_h"] != geom["out_h"] else 0
        for fy, fx in zip(fyx[t, 0], fyx[t, 1]):
            for y in (np.floor(fy), np.floor(fy) + 1):
                for x in (np.floor(fx), np.floor(fx) + 1):
                    inside = (0 <= y < geom["win_h"] and 0 <= x < geom["win_w"]
                              and 0 <= oy + y < geom["out_h"]
                              and 0 <= offsets[t, 1] + x < geom["out_w"])
                    weight = (np.float32(1) - np.abs(np.float32(y) - fy) > 0
                              and np.float32(1) - np.abs(np.float32(x) - fx) > 0)
                    if inside and weight:
                        bins.add((t, int(y), int(x)))
    return len(bins)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["K1", "K2", "crowded", "dead", "overhang"])
def test_win_scatter_binned(case, dtype):
    """The kernel's algorithm restated (bins by cell, one sum a bin) gives
    the plain version's table and, where every window lies in the table,
    the Pallas probe's (interpret mode), each within 1e-5 of the largest
    entry; it counts one float4 reduction per nonzero (tile, cell) and
    4-channel group."""
    offsets, fyx, gft, geom = _binned_case(case, dtype)
    c = geom.pop("c")
    tg = _t(gft) if dtype == "f32" else torch.from_numpy(gft.astype(np.float32)).bfloat16()
    args = (_t(offsets), _t(fyx), tg, *geom.values())
    got, reductions = ws.win_scatter_binned(*args)
    plain = ws.win_scatter_plain(*args).numpy()
    scale = float(np.abs(plain).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), plain, rtol=0, atol=1e-5 * scale)
    if case != "overhang":  # the probe takes windows inside the table only
        want = np.asarray(jwin.win_scatter(jnp.asarray(offsets), jnp.asarray(fyx),
                                           jnp.asarray(gft), c=c, ps=128, interpret=True,
                                           **geom))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    assert reductions == _nonzero_bins(offsets, fyx, geom) * (c // 4)
    if case == "dead":  # the dead tile's window holds only the live tile's adds
        assert reductions == _nonzero_bins(offsets[1:], fyx[1:], geom) * (c // 4)


def test_win_scatter_binned_chunks():
    """Tiles longer than the kernel's chunk (POINT_CHUNK points) are binned
    a chunk at a time, each chunk reducing on its own: the plain version's
    table, and one reduction per nonzero bin of each chunk."""
    rs = np.random.RandomState(8)
    t, p, c = 2, ws.POINT_CHUNK + 452, 4
    geom = dict(win_h=16, win_w=16, out_h=48, out_w=48)
    offsets = np.array([[8, 16], [30, 0]], np.int32)
    fyx = rs.uniform(-1.5, 16.5, (t, 2, p)).astype(np.float32)
    gft = rs.randn(t, c, p).astype(np.float32)
    args = (_t(offsets), _t(fyx), _t(gft), *geom.values())
    got, reductions = ws.win_scatter_binned(*args)
    plain = ws.win_scatter_plain(*args).numpy()
    np.testing.assert_allclose(got.numpy(), plain, rtol=0, atol=1e-5 * float(np.abs(plain).max()))
    chunks = (fyx[:, :, :ws.POINT_CHUNK], fyx[:, :, ws.POINT_CHUNK:])
    assert reductions == sum(_nonzero_bins(offsets, f, geom) for f in chunks) * (c // 4)
    assert reductions > _nonzero_bins(offsets, fyx, geom) * (c // 4)


@pytest.mark.parametrize("python_name,cuda_name", [("POINT_CHUNK", "kPoints"),
                                                   ("MAX_CELLS", "kMaxCells")])
def test_win_scatter_constants_match_the_kernel(python_name, cuda_name):
    """The chunk and the window limit the wrapper and `win_scatter_bins`
    assume are the kernel's own."""
    import re

    src = (ws._lib.CSRC / "win_scatter.cu").read_text()
    found = re.findall(rf"constexpr int {cuda_name} = (\d+);", src)
    assert found == [str(getattr(ws, python_name))]


def test_win_scatter_cuda_rejects_cpu_tensors():
    offsets, fyx, gft, geom = _win_inputs(True, "f32")
    geom.pop("c")
    with pytest.raises(ValueError, match="CUDA"):
        ws.win_scatter_cuda(_t(offsets), _t(fyx), _t(gft), *geom.values())


@pytest.mark.parametrize("tool", ["probe_winscatter", "profile_gather", "probe_scatter"])
def test_tool_runs_on_cpu(tool):
    """Each probe tool's run() end to end at a tiny size on the CPU, where
    its kernel rows take the plain versions (agreeing exactly)."""
    if tool == "probe_winscatter":
        res = probe_winscatter.run("cpu", n_tiles=2, tile_p=256, check_tiles=2, iters=1,
                                   warmup=0)
        assert set(res["times"]) == {f"{name} bf16" for name, *_ in probe_winscatter.WINDOWS}
        assert all(v == 0 for v in res["check"].values())
    elif tool == "profile_gather":
        res = profile_gather.run("cpu", n_points=4096, iters=1, warmup=0)
        assert all(v == 0 for v in res["check"].values())
    else:
        res = probe_scatter.run("cpu", n_rows=4096, res=16, n_samples=8, iters=1, warmup=0)
        assert len(res["check"]) == 4 and all(v == 0 for v in res["check"].values())
        assert len(res["dup_stats"]) == 3
        assert all(s["unique"] <= s["total"] == 16 * 16 * 8 for s in res["dup_stats"])
    assert res["device"] == "cpu"
    assert all(np.isfinite(v) and v >= 0 for v in res["times"].values()
               if not isinstance(v, dict))


@pytest.mark.parametrize("timer", ["device_ms", "enqueue_us"])
def test_device_timers_raise_on_cpu(timer):
    """Device-only timing has no host-clock fallback."""
    calls = []
    with pytest.raises(ValueError, match="CUDA device"):
        getattr(timing, timer)(lambda: calls.append(1), device="cpu")
    assert not calls


def test_splat_tiles_points_on_cpu():
    """The splat_tiles tool's passes at a tiny size: the coarse pass's
    points, the fine and two-camera points a render hands
    sample_from_planes, and the RotBbox regularizers' four-camera coarse,
    four-camera fine and TV points, each with the ray geometry that
    describes them (none for TV)."""
    from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
    from spi_tpu_torch.ops.plane_splat import RayGeom
    from spi_tpu_torch.utils import camera as cam

    coarse = splat_tiles.coarse_pass_points("cpu", res=8, samples=6)
    assert coarse.shape == (1, 8 * 8 * 6, 3) and bool(torch.isfinite(coarse).all())
    g = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=0)
    passes = splat_tiles.render_points("cpu", (g, None, None, cam.canonical_camera()))
    res, s = g.cfg.neural_rendering_resolution, g.cfg.rendering.depth_resolution
    fine, fine_geom = passes["fine"]
    two, two_geom = passes["two-camera"]
    assert fine_geom == RayGeom(1, res, res, g.cfg.rendering.depth_resolution_importance, True)
    assert two_geom == RayGeom(2, res, res, s, False)
    assert fine.shape == (1, fine_geom.n_points, 3) and two.shape == (1, two_geom.n_points, 3)
    extra = splat_tiles.rotbbox_points("cpu", (g, None, None, cam.canonical_camera()))
    four, four_geom = extra["four-camera"]
    tv, tv_geom = extra["tv"]
    assert four_geom == RayGeom(4, res, res, s, False) and four.shape == (1, four_geom.n_points, 3)
    four_fine, four_fine_geom = extra["four-camera fine"]
    imp = g.cfg.rendering.depth_resolution_importance
    assert four_fine_geom == RayGeom(4, res, res, imp, True)
    assert four_fine.shape == (1, four_fine_geom.n_points, 3)
    assert tv_geom is None and tv.shape == (1, 2000, 3)
