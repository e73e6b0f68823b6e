"""The row scatter-add kernel's algorithm, and three faults of the port
against spi_tpu repaired, on the CPU.

- `row_scatter_add_binned` (the kernel's algorithm restated in plain
  PyTorch: count, scan, place, the sort within a table slice, run sums,
  heavy buckets split into parts and long runs into pieces) against
  `row_scatter_add_plain` and `jnp.zeros(...).at[rows].add(upd)`, within
  1e-6 of the largest entry (the same float32 sums in another order), on
  random, wrapped negative, all-dead, empty, one-hot-row and clustered
  (`probe_scatter.realistic_texels`) rows, at C = 4, 8 and 132 and a table
  that is not a whole number of slices; its count of parts and pieces
  against one made in numpy.
- The slice, split and chunk constants of the wrapper against the kernel's,
  and the rule that picks the kernel's route.
- `row_scatter_add` wraps rows in [-R, 0) as `.at[].add` does;
  `row_gather` wraps indices in [-R, 0) and gives NaN out of range, as
  `jnp.take_along_axis` does.
- A Hessian-vector product through `sample_planes` against
  `jax.jvp(jax.grad(...))` of spi_tpu's `sample_from_planes` (float32,
  1e-5 of the largest entry), and a float64 `gradgradcheck` of the splat.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.models.rendering import renderer as JR
from spi_tpu_torch.ops import _lib
from spi_tpu_torch.ops import gather_scatter as gs
from spi_tpu_torch.ops import plane_splat as ps
from spi_tpu_torch.tools import probe_scatter
from torch_threads import few_torch_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def no_library(monkeypatch):
    """Fails a test that reaches the kernel library; launch counts at 0."""
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_lib, "lib", refuse)
    _lib.reset_launch_counts()
    yield
    assert not any(_lib.launch_counts.values()), _lib.launch_counts


def _scatter_case(case):
    """(rows (P,) int32, updates (P, C) float32, n_out) for each case."""
    rs = np.random.RandomState(list(CASES).index(case))
    n_out, p, c = 1000, 3000, 8  # 1000 rows: 15 slices and 40 rows
    if case == "random":
        rows = rs.randint(0, n_out, p)
    elif case == "negative":
        rows = rs.randint(-n_out - 60, n_out + 60, p)
    elif case == "dead":
        rows = np.where(rs.rand(p) < 0.5, rs.randint(n_out, 3 * n_out, p),
                        rs.randint(-3 * n_out, -n_out, p))
    elif case == "empty":
        rows = np.zeros(0, np.int64)
        p = 0
    elif case == "hot":  # one row takes every update: three parts of the split
        p, c = 2 * gs.BUCKET_SPLIT + 1808, 4
        rows = np.full(p, -963)  # row 37, wrapped
    elif case == "long run":  # one row's run longer than RUN_SPLIT in an unsplit bucket
        rows = rs.randint(0, n_out, p)
        rows[rs.permutation(p)[:200]] = 5
    elif case == "clustered":  # plane 1's texels of a coarse pass at 64^2 rays x 48 samples
        rows = probe_scatter.realistic_texels("cpu", n_samples=48, res=64)[1].reshape(-1)
        n_out, p = probe_scatter.H * probe_scatter.W, rows.size
    elif case == "C=4":
        c = 4
        rows = rs.randint(-n_out, n_out, p)
    elif case == "C=132":
        c = 132
        rows = rs.randint(-n_out, n_out + 10, p)
    elif case == "ragged table":
        n_out = 5 * gs.SLICE_ROWS + 7
        rows = rs.randint(-n_out, n_out, p)
    upd = rs.randn(p, c).astype(np.float32)
    return rows.astype(np.int32), upd, n_out


CASES = ("random", "negative", "dead", "empty", "hot", "long run", "clustered", "C=4", "C=132",
         "ragged table")


def _expected_stats(rows, n_out, c):
    """Parts and pieces of the kernel's algorithm counted in numpy, with the
    entries of a bucket in update order (as `row_scatter_add_binned`
    places them)."""
    r = np.where(rows < 0, rows + n_out, rows)
    r = r[(r >= 0) & (r < n_out)]
    buckets = -(-n_out // gs.SLICE_ROWS)
    parts = pieces = 0
    for b in range(buckets):
        mine = r[r // gs.SLICE_ROWS == b]
        split = mine.size > gs.BUCKET_SPLIT
        chunks = [mine[i:i + gs.BUCKET_SPLIT] for i in range(0, mine.size, gs.BUCKET_SPLIT)]
        parts += max(1, len(chunks))
        for chunk in chunks:
            for n in np.unique(chunk, return_counts=True)[1]:
                if split or n > gs.RUN_SPLIT:
                    pieces += -(-n // gs.RUN_SPLIT)
    return {"parts": parts, "pieces": pieces, "reductions": pieces * (c // 4)}


@pytest.mark.parametrize("case", CASES)
def test_row_scatter_add_binned(no_library, case):
    """The kernel's algorithm restated gives the plain version's table and
    `.at[].add`'s, within 1e-6 of the largest entry, and the parts and
    pieces counted in numpy."""
    rows, upd, n_out = _scatter_case(case)
    got, stats = gs.row_scatter_add_binned(_t(rows), _t(upd), n_out)
    plain = gs.row_scatter_add_plain(_t(rows), _t(upd), n_out).numpy()
    want = np.asarray(jnp.zeros((n_out, upd.shape[1]), jnp.float32).at[jnp.asarray(rows)]
                      .add(jnp.asarray(upd)))
    assert got.shape == plain.shape == want.shape == (n_out, upd.shape[1])
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-6 * scale)
    assert stats == _expected_stats(rows, n_out, upd.shape[1])
    if case in ("dead", "empty"):
        assert scale == 0.0 and stats["pieces"] == 0
    if case == "hot":  # 4096 + 4096 + 1808 entries: every run in pieces of RUN_SPLIT
        assert stats["parts"] == -(-n_out // gs.SLICE_ROWS) + 2
        assert stats["pieces"] == 2 * gs.BUCKET_SPLIT // gs.RUN_SPLIT + 29
    if case == "long run":  # the hot row's run alone is split
        assert stats["pieces"] == -(-int((rows == 5).sum()) // gs.RUN_SPLIT)
    if case == "clustered":  # some buckets are split, some runs long
        assert stats["parts"] > -(-n_out // gs.SLICE_ROWS) and stats["pieces"] > 0


@pytest.mark.parametrize("python_name,cuda_name", [
    ("SLICE_ROWS", "kSliceRows"), ("BUCKET_SPLIT", "kBucketSplit"), ("RUN_SPLIT", "kRunSplit"),
    ("CHUNK", "kChunk"), ("MAX_BUCKETS", "kMaxBuckets")])
def test_row_scatter_add_constants_match_the_kernel(python_name, cuda_name):
    """The slice, split and chunk sizes `row_scatter_add_binned` and the
    wrapper's scratch assume are the kernel's own."""
    src = (_lib.CSRC / "row_scatter_add.cu").read_text()
    found = re.findall(rf"constexpr int {cuda_name} = (\d+);", src)
    assert found == [str(getattr(gs, python_name))]


def test_row_scatter_add_cuda_rejects_a_table_too_tall(monkeypatch):
    """More rows than the kernel's bucket histogram holds raises before any
    launch (checked on a stand-in CUDA test of the inputs)."""
    monkeypatch.setattr(_lib, "require", lambda *a, **k: None)
    with pytest.raises(ValueError, match="table rows"):
        gs.row_scatter_add_cuda(torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4),
                                gs.MAX_ROWS + 1)


@pytest.mark.parametrize("c,n_out,route", [
    (32, 65536, "atomic"), (4, 65536, "atomic"), (128, 65536, "binned"), (36, 65536, "binned"),
    (32, 2**20, "binned")])
def test_scatter_route(c, n_out, route):
    """Rows of at most ATOMIC_MAX_C channels into a table of at most half
    the L2 (50 MB here) take the atomic route, everything else the binned
    one: the probe's 786,432 x 32 into 65,536 rows (8 MB) is atomic, its
    128-channel shapes and a 128 MB table are binned."""
    assert gs.scatter_route(c, n_out, 50 * 2**20) == route


@pytest.mark.parametrize("shape", [(6,), (6, 1)])
def test_negative_rows_wrap_as_at_add(no_library, shape):
    """Rows in [-R, 0) wrap to row + R and the rest out of range are dropped:
    -40 adds into row 0 and -1 into row 39; -41 and 40 add nothing."""
    rows = np.array([0, -1, 3, -40, -41, 40], np.int32).reshape(shape)
    upd = np.arange(1, 7, dtype=np.float32)[:, None] * np.ones((1, 4), np.float32)
    want = np.asarray(jnp.zeros((40, 4), jnp.float32).at[jnp.asarray(rows).reshape(-1)].add(upd))
    got = gs.row_scatter_add(_t(rows), _t(upd), 40).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 5.0 and got[39, 0] == 2.0


def test_negative_rows_wrap_at_random(no_library):
    rs = np.random.RandomState(3)
    rows = rs.randint(-90, 90, 700).astype(np.int32)
    upd = rs.randn(700, 12).astype(np.float32)
    want = np.asarray(jnp.zeros((64, 12), jnp.float32).at[jnp.asarray(rows)].add(upd))
    got = gs.row_scatter_add(_t(rows), _t(upd), 64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("broadcast", [True, False])
def test_row_gather_wraps_and_fills_as_take_along_axis(no_library, broadcast):
    """Indices in [-R, 0) wrap; -R - 1, R and beyond give NaN; the plain
    version does not raise."""
    rs = np.random.RandomState(4)
    tab = rs.randn(64, 8).astype(np.float32)
    special = np.array([0, -1, 63, 64, -64, -65, 1000, -1000], np.int32)
    if broadcast:
        col = np.concatenate([special, rs.randint(-70, 70, 40)]).astype(np.int32)
        idx = np.broadcast_to(col[:, None], (col.size, 8)).astype(np.int32)
    else:
        idx = rs.randint(-70, 70, (48, 8)).astype(np.int32)
        idx[:8, 0] = special
    want = np.asarray(jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx), axis=0))
    got = gs.row_gather(_t(tab), _t(idx)).numpy()
    np.testing.assert_array_equal(got, want)  # NaN where want has NaN
    assert np.isnan(want).any() and not np.isnan(want[idx == -1]).any()


def _hvp_inputs(seed=0, res=16, c=4, m=50):
    rs = np.random.RandomState(seed)
    planes = rs.randn(1, 3, res * res, c).astype(np.float32)
    coords = rs.uniform(-0.55, 0.55, (1, m, 3)).astype(np.float32)  # some outside the box
    v = rs.randn(*planes.shape).astype(np.float32)
    return planes, coords, v


def test_hessian_vector_product_matches_spi_tpu(no_library):
    """H v of sum(sample_planes(p, x) ** 2) with respect to the planes, by
    a double backward through the lookup's Function (the splat, then the
    splat's own backward, the lookup), against jax.jvp(jax.grad(...)) of
    spi_tpu's sample_from_planes, within 1e-5 of the largest entry."""
    planes, coords, v = _hvp_inputs()

    def f(p):
        return jnp.sum(JR.sample_from_planes(p, jnp.asarray(coords), 1.0) ** 2)

    want = np.asarray(jax.jvp(jax.grad(f), (jnp.asarray(planes),), (jnp.asarray(v),))[1])
    p = _t(planes).requires_grad_(True)
    (g,) = torch.autograd.grad(ps.sample_planes(p, _t(coords), 1.0).square().sum(), p,
                               create_graph=True)
    (hvp,) = torch.autograd.grad((g * _t(v)).sum(), p)
    scale = float(np.abs(want).max())
    assert scale > 1.0
    np.testing.assert_allclose(hvp.numpy(), want, rtol=0, atol=1e-5 * scale)


def test_splat_gradgradcheck(no_library):
    """The splat as a function of the cotangent, in float64: its backward
    (the lookup) and that backward's own derivative (the splat) against
    finite differences."""
    rs = np.random.RandomState(1)
    coords = torch.from_numpy(rs.uniform(-0.55, 0.55, (1, 12, 3)))
    g = torch.from_numpy(rs.randn(1, 3, 12, 4)).requires_grad_(True)

    def splat(cot):
        return ps._Splat.apply(coords, cot, 1.0, 6, 6, None)

    assert splat(g).dtype == torch.float64
    assert torch.autograd.gradcheck(splat, (g,))
    assert torch.autograd.gradgradcheck(splat, (g,))
