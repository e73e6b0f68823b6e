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
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spi_tpu_torch.ops import gather_scatter as gs
from spi_tpu_torch.ops import win_scatter as ws
from spi_tpu_torch.tools import probe_scatter, probe_winscatter, profile_gather

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))
import probe_winscatter_r5 as jwin  # noqa: E402  (imports bench_util from tools/)


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
