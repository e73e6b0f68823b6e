"""spi_tpu_torch ops against spi_tpu, on the CPU.

The port runs with CPU tensors, so every kernel wrapper takes its plain
PyTorch version; the JAX side runs as spi_tpu's own tests run it
(`impl='xla'`, and the Pallas kernels in interpret mode). Inputs are
made with numpy from a seed and handed to both sides.

Tolerances: both sides compute in float32. Elementwise ops agree to a
few ulp (different transcendental approximations): 1e-5. Convolutions
and scatter-adds sum in another order: 1e-4 / 1e-5 absolute on O(1)
values, as spi_tpu's own torch-parity tests allow.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu import ops as jops
from spi_tpu.models.rendering import renderer as JR
from spi_tpu.ops import plane_splat as jsplat
from spi_tpu.ops.bias_act import activation_funcs as j_activation_funcs
from spi_tpu_torch import ops
from spi_tpu_torch.ops import plane_splat as psplat
from spi_tpu_torch.ops.bias_act import activation_funcs, bias_act_plain
from spi_tpu_torch.models.rendering import renderer as PR
from torch_threads import few_torch_threads  # noqa: F401

ACTS = sorted(activation_funcs)
BINOMIAL = [1.0, 3.0, 3.0, 1.0]


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def test_activation_table_matches_jax():
    assert set(activation_funcs) == set(j_activation_funcs)
    for k, spec in activation_funcs.items():
        assert spec.def_alpha == j_activation_funcs[k].def_alpha
        assert spec.def_gain == j_activation_funcs[k].def_gain


class TestBiasAct:
    """bias_act's plain version (what the port runs on the CPU) against
    spi_tpu's XLA chain and its Pallas kernel, values and gradients, as
    tests/test_ops.py holds the Pallas kernel against the XLA chain."""

    @pytest.fixture(scope="class")
    def data(self):
        return (_rand(2, 16, 8, 8, seed=1, scale=3.0), _rand(16, seed=2),
                _rand(2, 16, 8, 8, seed=3))

    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    @pytest.mark.parametrize("act", ACTS)
    def test_values_and_grads(self, data, act, impl):
        x, b, ct = data
        from spi_tpu.ops.bias_act import bias_act as jbias_act

        def jloss(x, b):
            y = jbias_act(x, b, act=act, gain=1.7, clamp=2.5, impl=impl)
            return jnp.sum(y * ct), y

        (_, jy), (jgx, jgb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), jnp.asarray(b))
        tx, tb = _t(x, True), _t(b, True)
        ty = ops.bias_act(tx, tb, act=act, gain=1.7, clamp=2.5)
        (ty * _t(ct)).sum().backward()
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_lrelu_grad_at_zero(self, impl):
        """At x + b exactly 0, lrelu' is 1 (the x >= 0 branch), as in both
        spi_tpu impls and the CUDA kernel: the gradient there is the gain."""
        from spi_tpu.ops.bias_act import bias_act as jbias_act

        x = np.array([[-1.5, 0.0, 2.0, -3.0, 0.0, 1.0, -1.0, 4.0],
                      [1.0, -0.5, 0.25, 3.0, -2.0, 0.0, 1.0, -4.0]], np.float32)
        b = np.array([1.5, 0.5, -0.25, 3.0, 2.0, -1.0, 1.0, 4.0], np.float32)
        at_zero = (x + b) == 0
        assert at_zero.sum() == 8

        def jloss(x, b):
            return jnp.sum(jbias_act(x, b, act="lrelu", impl=impl))

        jgx, jgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
        tx, tb = _t(x, True), _t(b, True)
        ops.bias_act(tx, tb, act="lrelu").sum().backward()
        np.testing.assert_allclose(tx.grad.numpy()[at_zero], np.sqrt(2), rtol=1e-6)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-6)
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), rtol=1e-6)

    @pytest.mark.parametrize("act", ["linear", "lrelu"])
    def test_fc_layout_trail_one(self, act):
        # (rows, C) with the bias on the last axis: the FC / decoder call.
        x, b = _rand(37, 24, seed=4, scale=2.0), _rand(24, seed=5)
        want = jops.bias_act(jnp.asarray(x), jnp.asarray(b), act=act)
        got = ops.bias_act(_t(x), _t(b), act=act)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_no_bias_other_dim(self):
        x = _rand(3, 5, 16, seed=6)
        want = jops.bias_act(jnp.asarray(x), None, dim=2, act="lrelu", impl="pallas")
        got = bias_act_plain(_t(x), None, dim=2, act="lrelu")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_cuda_wrapper_rejects_cpu_tensors(self):
        from spi_tpu_torch.ops.bias_act import bias_act_fwd_cuda

        with pytest.raises(ValueError, match="CUDA"):
            bias_act_fwd_cuda(torch.zeros(2, 3), torch.zeros(3), 1, 0, 0.0, 1.0, None)


class TestUpfirdn2d:
    @pytest.mark.parametrize("up,down,pad", [
        (1, 1, (1, 1, 1, 1)),
        (2, 1, (2, 1, 2, 1)),
        (1, 2, (1, 1, 1, 1)),
        (2, 2, (2, 2, 2, 2)),
        (1, 1, (-1, 2, 0, -1)),
        (4, 1, (3, 2, 3, 2)),
    ])
    def test_parity(self, up, down, pad):
        x = _rand(2, 3, 16, 16, seed=up * 10 + down)
        want = jops.upfirdn2d(jnp.asarray(x), jops.setup_filter(BINOMIAL), up=up, down=down,
                              padding=pad)
        got = ops.upfirdn2d(_t(x), ops.setup_filter(BINOMIAL), up=up, down=down, padding=pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_identity_gain_and_flip(self):
        x = _rand(1, 2, 8, 8, seed=3)
        np.testing.assert_allclose(ops.upfirdn2d(_t(x), None).numpy(), x, atol=1e-6)
        f = np.array([[0.25, 0.5], [0.125, 0.125]], np.float32)
        want = jops.upfirdn2d(jnp.asarray(x), f, padding=(1, 0, 1, 0), flip_filter=True, gain=2.0)
        got = ops.upfirdn2d(_t(x), _t(f), padding=(1, 0, 1, 0), flip_filter=True, gain=2.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_setup_filter_and_upsample2d(self):
        np.testing.assert_allclose(ops.setup_filter(BINOMIAL).numpy(),
                                   jops.setup_filter(BINOMIAL), rtol=1e-7)
        x = _rand(1, 3, 8, 8, seed=7)
        want = jops.upsample2d(jnp.asarray(x), jops.setup_filter(BINOMIAL))
        got = ops.upsample2d(_t(x), ops.setup_filter(BINOMIAL))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


class TestConv:
    @pytest.mark.parametrize("stride,padding,groups", [(1, 1, 1), (2, 1, 1), (1, 0, 2)])
    def test_conv2d(self, stride, padding, groups):
        x, w = _rand(2, 4, 12, 12, seed=1), _rand(6, 4 // groups, 3, 3, seed=2)
        for flip in (True, False):
            want = jops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, padding=padding,
                               groups=groups, flip_weight=flip)
            got = ops.conv2d(_t(x), _t(w), stride=stride, padding=padding, groups=groups,
                             flip_weight=flip)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("stride,padding,groups", [(2, 0, 1), (2, 1, 1), (2, 1, 2)])
    def test_conv_transpose2d(self, stride, padding, groups):
        x, w = _rand(2, 4, 9, 9, seed=3), _rand(4, 6 // groups, 3, 3, seed=4)
        for flip in (True, False):
            want = jops.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                         padding=padding, groups=groups, flip_weight=flip)
            got = ops.conv_transpose2d(_t(x), _t(w), stride=stride, padding=padding,
                                       groups=groups, flip_weight=flip)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("kw,up,down,flip", [
        (3, 1, 1, True), (3, 2, 1, False), (3, 1, 2, True), (1, 2, 1, True),
        (1, 1, 2, True), (3, 2, 2, False),
    ])
    def test_conv2d_resample(self, kw, up, down, flip):
        x, w = _rand(1, 8, 8, 8, seed=5), _rand(16, 8, kw, kw, seed=6)
        want = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=jops.setup_filter(BINOMIAL),
                                    up=up, down=down, padding=kw // 2, flip_weight=flip)
        got = ops.conv2d_resample(_t(x), _t(w), f=ops.setup_filter(BINOMIAL), up=up, down=down,
                                  padding=kw // 2, flip_weight=flip)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


class TestResize:
    def test_area(self):
        x = _rand(1, 3, 16, 16, seed=30)
        np.testing.assert_allclose(ops.resize_area(_t(x), (8, 8)).numpy(),
                                   np.asarray(jops.resize_area(jnp.asarray(x), (8, 8))),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("src,dst,antialias", [(8, 16, False), (16, 64, True)])
    def test_bilinear_upscale(self, src, dst, antialias):
        x = _rand(1, 3, src, src, seed=31)
        want = jops.resize_bilinear(jnp.asarray(x), (dst, dst), antialias=antialias)
        got = ops.resize_bilinear(_t(x), (dst, dst), antialias=antialias)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    def test_bilinear_downscale_antialias(self):
        # jax.image.resize and torch's antialias filter differ slightly at
        # the borders; spi_tpu's own torch test allows 1e-3.
        x = _rand(1, 3, 32, 32, seed=32)
        want = jops.resize_bilinear(jnp.asarray(x), (16, 16), antialias=True)
        got = ops.resize_bilinear(_t(x), (16, 16), antialias=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# Triplane sampling and the splat, with the geometry of tests/test_plane_splat.py

H = W = 256
C = 8


def _geom(fine=False):
    return jsplat.RayGeom(n_views=1, rays_h=16, rays_w=16, n_samples=12, fine=fine)


def _tile_coherent_coords(key, geom, spread):
    tv, tu, ts = geom.tile_dims()
    n_groups = geom.n_samples // ts
    k1, k2 = jax.random.split(key)
    centers = jax.random.uniform(k1, (n_groups, 3), minval=-0.35, maxval=0.35)
    pts = jax.random.uniform(k2, (geom.rays_h * geom.rays_w, n_groups, ts, 3),
                             minval=-spread, maxval=spread) + centers[None, :, None, :]
    return np.asarray(pts.reshape(1, geom.n_points, 3))


def _coords(case):
    geom = _geom(case == "fine")
    if case == "overflow":  # spread over the whole box: every window overflows
        return np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (1, geom.n_points, 3),
                                             minval=-0.49, maxval=0.49))
    if case == "border":  # grid edge and points outside the box
        c = _tile_coherent_coords(jax.random.PRNGKey(3), geom, 0.02).copy()
        c[0, :200] = [0.499, 0.0, 0.0]
        c[0, 200:400] = [0.75, 0.75, 0.75]
        return c
    return _tile_coherent_coords(jax.random.PRNGKey(1), geom, 0.05)


@pytest.fixture(scope="module")
def planes():
    return _rand(1, 3, H * W, C, seed=40)


@pytest.fixture(scope="module")
def cotangent():
    return _rand(1, 3, _geom().n_points, C, seed=41)


SPLAT_CASES = ["coarse", "fine", "overflow", "border"]


@pytest.mark.parametrize("case", SPLAT_CASES)
def test_splat_plain_matches_splat_xla(case, cotangent):
    """splat_plain == spi_tpu's exact 4-corner scatter `_splat_xla`, plane
    by plane (texel coords from the same projection)."""
    coords = _coords(case)
    got = psplat.splat_plain(_t(coords), _t(cotangent), 1.0, H, W).numpy()
    grids = np.asarray(JR.project_onto_planes(jnp.asarray(coords) * 2.0))[0]
    for p in range(3):
        fx = ((grids[p, :, 0] + 1.0) * W - 1.0) * 0.5
        fy = ((grids[p, :, 1] + 1.0) * H - 1.0) * 0.5
        want = jsplat._splat_xla(jnp.asarray(fy), jnp.asarray(fx), jnp.asarray(cotangent[0, p]),
                                 H, W)
        np.testing.assert_allclose(got[0, p], np.asarray(want), rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_plane_grad(case, impl):
    """spi_tpu's plane gradient of sum(sample_from_planes(...) * cotangent)
    with the ray geometry passed: `impl='windowed'` runs the Pallas splat in
    interpret mode (with its overflow fallback), 'xla' the autodiff scatter."""
    coords = _coords(case)
    ct = _rand(1, 3, _geom().n_points, C, seed=41)

    def loss(p):
        out = JR.sample_from_planes(p, jnp.asarray(coords), 1.0, geom=_geom(case == "fine"),
                                    impl=impl)
        return jnp.sum(out * ct)
    return np.asarray(jax.grad(loss)(jnp.asarray(_rand(1, 3, H * W, C, seed=40))))


def _port_plane_grad(planes, coords, cotangent, geom=None):
    tp = _t(planes, True)
    out = PR.sample_from_planes(tp, _t(coords), 1.0, geom)
    (out * _t(cotangent)).sum().backward()
    return tp.grad.numpy()


@pytest.mark.parametrize("case", SPLAT_CASES)
def test_sample_planes_grad_matches_windowed_splat(case, planes, cotangent):
    """The port's plane gradient == spi_tpu's `splat_planes` Pallas kernel
    (interpret mode, with its overflow fallback) and spi_tpu's XLA
    autodiff, for coarse, fine, overflowing and border/outside points."""
    got = _port_plane_grad(planes, _coords(case), cotangent)
    np.testing.assert_allclose(got, _jax_plane_grad(case, "windowed"), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _jax_plane_grad(case, "xla"), rtol=1e-4, atol=1e-5)


def _port_geom(geom):
    return psplat.RayGeom(geom.n_views, geom.rays_h, geom.rays_w, geom.n_samples, geom.fine)


@pytest.mark.parametrize("case", SPLAT_CASES)
def test_sample_planes_grad_with_ray_geometry(case, planes, cotangent):
    """With the ray geometry passed, as spi_tpu's renderer passes it, the
    port's plane gradient still matches spi_tpu's `sample_from_planes(...,
    geom=RayGeom)`, windowed and XLA."""
    got = _port_plane_grad(planes, _coords(case), cotangent, _port_geom(_geom(case == "fine")))
    np.testing.assert_allclose(got, _jax_plane_grad(case, "windowed"), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, _jax_plane_grad(case, "xla"), rtol=1e-4, atol=1e-5)


# Two views of 20 x 16 rays x 6 samples on one set of planes: 20 rays and
# 6 samples are not multiples of the kernel's 16 x 4 x 4 tiles.
RAGGED = dict(n_views=2, rays_h=20, rays_w=16, n_samples=6)


def _ragged_inputs():
    n = RAGGED["rays_h"] * RAGGED["rays_w"] * RAGGED["n_samples"]
    rs = np.random.RandomState(47)
    coords = rs.uniform(-0.45, 0.45, (2, n, 3)).astype(np.float32)
    coords[1, :40] = [0.75, 0.0, 0.0]  # outside planes 0 and 1, on plane 2's edge
    return coords, _rand(2, 3, n, C, seed=48)


def test_two_view_ragged_batch_with_ray_geometry(planes):
    """A two-camera batch on one set of planes, with a ray geometry whose
    tiles are ragged, against spi_tpu with the same geometry (its windowed
    path takes the XLA scatter for a batch)."""
    coords, ct = _ragged_inputs()

    def jgrad(impl):
        def loss(p):
            out = JR.sample_from_planes(p, jnp.asarray(coords), 1.0,
                                        geom=jsplat.RayGeom(**RAGGED), impl=impl)
            return jnp.sum(out * ct)
        return np.asarray(jax.grad(loss)(jnp.asarray(planes)))

    got = _port_plane_grad(planes, coords, ct, psplat.RayGeom(**RAGGED))
    for impl in ("windowed", "xla"):
        np.testing.assert_allclose(got, jgrad(impl), rtol=1e-4, atol=1e-5)


def _tiled_cases():
    coords, ct = _ragged_inputs()
    yield "ragged two-view", coords.reshape(1, -1, 3), ct.transpose(1, 0, 2, 3).reshape(
        1, 3, -1, C), psplat.RayGeom(**RAGGED)
    for case in SPLAT_CASES:
        yield case, _coords(case), _rand(1, 3, _geom().n_points, C, seed=41), _port_geom(
            _geom(case == "fine"))
    yield "no geometry", _coords("coarse"), _rand(1, 3, _geom().n_points, C, seed=41), None


@pytest.mark.parametrize("case", ["ragged two-view", *SPLAT_CASES, "no geometry"])
def test_splat_tiled_matches_splat_plain(case):
    """The kernel's tiling and per-tile grouping, restated in plain PyTorch
    (`tile_points`, `splat_tiled`), give `splat_plain`'s gradient: every
    point lies in exactly one tile, and one sum per distinct (tile, texel)
    added into the table is the 4-corner scatter. The count of distinct
    keys is what the kernel issues per channel group."""
    _, coords, ct, geom = next(c for c in _tiled_cases() if c[0] == case)
    n, m, _ = coords.shape
    pts = psplat.tile_points(n, m, *psplat.kernel_tiling(geom, n, m))
    live = pts[pts >= 0]
    assert np.array_equal(np.sort(live.numpy()), np.arange(n * m))
    got, keys = psplat.splat_tiled(_t(coords), _t(ct), 1.0, H, W, geom)
    want = psplat.splat_plain(_t(coords), _t(ct), 1.0, H, W)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert 0 < keys <= 3 * 4 * n * m


def test_ray_geometry_must_describe_the_points(planes):
    with pytest.raises(ValueError, match="geometry"):
        PR.sample_from_planes(_t(planes), _t(_coords("coarse")), 1.0,
                              psplat.RayGeom(1, 16, 16, 11))


def test_renderer_passes_ray_geometry():
    """A render hands sample_from_planes the geometry of each pass: the
    scanline width from the resolution, the samples of the pass, and
    whether it is the importance pass."""
    from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
    from spi_tpu_torch.utils import camera as cam

    g = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=0)
    seen = []
    orig = PR.sample_from_planes

    def spy(planes, coordinates, box_warp, geom=None):
        seen.append((tuple(coordinates.shape), geom))
        return orig(planes, coordinates, box_warp, geom)

    PR.sample_from_planes = spy
    try:
        with torch.no_grad():
            ws = torch.zeros(1, g.num_ws, g.w_dim)
            g.synthesis(ws, cam.canonical_camera(), generator=torch.Generator().manual_seed(0))
    finally:
        PR.sample_from_planes = orig
    res = g.cfg.neural_rendering_resolution
    s, i = g.cfg.rendering.depth_resolution, g.cfg.rendering.depth_resolution_importance
    assert seen == [((1, res * res * s, 3), psplat.RayGeom(1, res, res, s, False)),
                    ((1, res * res * i, 3), psplat.RayGeom(1, res, res, i, True))]


def test_sample_planes_forward_matches(planes):
    coords = _coords("border")
    want = JR.sample_from_planes(jnp.asarray(planes), jnp.asarray(coords), 1.0)
    got = PR.sample_from_planes(_t(planes), _t(coords), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_shared_planes_camera_batch():
    """(1, 3, HW, C) planes sampled for 3 point sets: forward and plane
    gradient match spi_tpu's batch merge (box_warp 2)."""
    tables = _rand(1, 3, 16 * 16, 4, seed=42)
    coords = np.random.RandomState(43).uniform(-1.2, 1.2, (3, 50, 3)).astype(np.float32)
    ct = _rand(3, 3, 50, 4, seed=44)

    def jloss(p):
        out = JR.sample_from_planes(p, jnp.asarray(coords), 2.0)
        return jnp.sum(out * ct), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(tables))
    tp = _t(tables, True)
    out = PR.sample_from_planes(tp, _t(coords), 2.0)
    (out * _t(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_coordinate_gradient_raises():
    tables = _t(_rand(1, 3, 8 * 8, 4, seed=45), True)
    coords = _t(_rand(1, 10, 3, seed=46) * 0.3, True)
    with pytest.raises(RuntimeError, match="coordinates"):
        PR.sample_from_planes(tables, coords, 1.0)


def test_splat_cuda_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        psplat.splat_cuda(torch.zeros(1, 4, 3), torch.zeros(1, 3, 4, 8), 1.0, 8, 8)
