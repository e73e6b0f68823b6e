"""spi_tpu_torch generator stack against spi_tpu, on the CPU, at
tiny_test_config.

Weights enter the port only through the flat npz that spi_tpu's
`save_pytree` writes. Random draws (stratified jitter, importance
exponentials) are derived with jax.random from the same key splits as
spi_tpu's renderer and handed to the port as tensors.

Tolerances: float32 on both sides; convolutions, matmuls and the sorted
composite sum in other orders. Values: 1e-5..1e-4 absolute on O(1)
outputs. Gradients: 2e-3 relative to the largest entry. The backward
through ~30 layers, the renderer and the superresolution is
ill-conditioned in float32 at this config: spi_tpu's own eager and jit
gradients of the same function differ by up to 8.7e-4 relative (w and
every noise map), and a float64 run of the port agrees with the jit
gradients to 6e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.models import triplane as JT
from spi_tpu.models.rendering import math_utils as jmath
from spi_tpu.models.rendering import ray_marcher as JM
from spi_tpu.models.rendering import renderer as JR
from spi_tpu.models.rendering.ray_sampler import sample_rays as j_sample_rays
from spi_tpu.utils import camera as jcam
from spi_tpu.utils.checkpoint import flatten_pytree, save_pytree
from spi_tpu.utils.params import extract_noise as j_extract_noise
from spi_tpu.utils.params import replace_noise as j_replace_noise
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.models.rendering import math_utils as pmath
from spi_tpu_torch.models.rendering import ray_marcher as PM
from spi_tpu_torch.models.rendering import renderer as PR
from spi_tpu_torch.models.rendering.ray_sampler import sample_rays as p_sample_rays
from spi_tpu_torch.utils import camera as pcam
from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz
from spi_tpu_torch.utils.params import extract_noise, replace_noise
from torch_threads import few_torch_threads  # noqa: F401


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close_rel(got, want, tol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3e} relative to max |want| > {tol}"


def render_draws(rng, m, s, n_imp):
    """The renderer's draws as spi_tpu's single-camera synthesis makes
    them from `rng` (triplane.py:221, :260, renderer.py:421)."""
    rng_rest, _ = jax.random.split(rng)
    rng_render, _ = jax.random.split(rng_rest)
    rc, rf, _ = jax.random.split(rng_render, 3)
    return {
        "stratified": torch.from_numpy(np.array(jax.random.uniform(rc, (1, m, s, 1)))),
        "exponential": torch.from_numpy(np.array(jax.random.exponential(rf, (m, n_imp + 1)))),
    }


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX generator, JAX params, port generator, flat params): a JAX init
    with nonzero noise strengths (so noise maps get a gradient), saved
    with save_pytree and loaded into the port."""
    jg = JT.tiny_test_config()
    params = jg.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, 0.1) if "noise_strength" in jax.tree_util.keystr(p) else v,
        params)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_pytree(path, params)
    flat = load_npz(path)
    pg = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=123)
    load_flat_params(pg, flat)
    return jg, params, pg, flat


class TestLoadFlatParams:
    def test_roundtrip_every_key(self, pair):
        _, params, pg, flat = pair
        want = flatten_pytree(params)
        assert set(flat) == set(want)
        state = pg.state_dict()
        assert set(state) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
        assert any(k.endswith("noise_const") for k in state)
        assert "decoder.net.0.weight" in state and "backbone.mapping.w_avg" in state

    def test_mismatch_raises(self, pair):
        _, _, _, flat = pair
        pg = TriPlaneGenerator(tiny_test_config(), device="cpu")
        missing = dict(flat)
        missing.pop("decoder.net.2.bias")
        with pytest.raises(ValueError, match="missing"):
            load_flat_params(pg, missing)
        with pytest.raises(ValueError, match="unexpected"):
            load_flat_params(pg, {**flat, "decoder.net.4.weight": np.zeros(3, np.float32)})
        bad = dict(flat)
        bad["decoder.net.0.bias"] = np.zeros(5, np.float32)
        with pytest.raises(ValueError, match="shape"):
            load_flat_params(pg, bad)


class TestNetworks:
    def test_mapping(self, pair):
        jg, params, pg, _ = pair
        z, c = _rand(3, jg.z_dim, seed=1), _rand(3, 25, seed=2)
        for psi in (1.0, 0.7):
            want = jg.mapping(params, jnp.asarray(z), jnp.asarray(c), truncation_psi=psi)
            got = pg.mapping(_t(z), _t(c), truncation_psi=psi)
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    def test_planes(self, pair):
        jg, params, pg, _ = pair
        ws = _rand(2, jg.num_ws, jg.w_dim, seed=3, scale=0.5)
        want = jg._planes_nhwc(params, jnp.asarray(ws))
        got = pg.planes_nhwc(_t(ws))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


class TestRendering:
    def test_camera_and_rays(self):
        want = np.asarray(jcam.canonical_camera(yaw=0.3, batch_size=2))
        got = pcam.canonical_camera(yaw=0.3, batch_size=2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        c = _t(want)
        jo, jd = j_sample_rays(jnp.asarray(want[:, :16]).reshape(-1, 4, 4),
                               jnp.asarray(want[:, 16:]).reshape(-1, 3, 3), 8)
        po, pd = p_sample_rays(c[:, :16].reshape(-1, 4, 4), c[:, 16:].reshape(-1, 3, 3), 8)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)

    def test_ray_limits_box(self):
        o = np.concatenate([_rand(1, 20, 3, seed=4) * 2.0], axis=0)
        d = _rand(1, 20, 3, seed=5)
        jt = jmath.get_ray_limits_box(jnp.asarray(o), jnp.asarray(d), 1.0)
        pt = pmath.get_ray_limits_box(_t(o), _t(d), 1.0)
        for a, b in zip(pt, jt):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("bounds", ["fixed", "per_ray", "disparity"])
    def test_sample_stratified(self, bounds):
        ro = _t(_rand(2, 5, 3, seed=6))
        key = jax.random.PRNGKey(8)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (2, 5, 7, 1))))
        if bounds == "per_ray":
            start = np.abs(_rand(2, 5, 1, seed=9)) + 1.0
            end = start + 1.5
            want = JR.sample_stratified(key, jnp.asarray(ro.numpy()), jnp.asarray(start),
                                        jnp.asarray(end), 7)
            got = PR.sample_stratified(ro, _t(start), _t(end), 7, uniform=u)
        else:
            disp = bounds == "disparity"
            want = JR.sample_stratified(key, jnp.asarray(ro.numpy()), 2.25, 3.3, 7, disp)
            got = PR.sample_stratified(ro, 2.25, 3.3, 7, disp, uniform=u)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("det", [False, True])
    def test_sample_pdf(self, det):
        key = jax.random.PRNGKey(10)
        bins = np.sort(np.random.RandomState(11).uniform(2, 3, (64, 14)), axis=-1).astype(np.float32)
        weights = np.random.RandomState(12).uniform(0, 1, (64, 12)).astype(np.float32)
        weights[:8, 3] = 50.0  # peaked rows
        want = JR.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights), 9, det=det)
        e = torch.from_numpy(np.array(jax.random.exponential(key, (64, 10))))
        got = PR.sample_pdf(_t(bins), _t(weights), 9, det=det, exponential=e)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_sample_importance(self):
        key = jax.random.PRNGKey(13)
        z = np.sort(np.random.RandomState(14).uniform(2, 3, (1, 30, 8, 1)), axis=2).astype(np.float32)
        w = np.random.RandomState(15).uniform(0, 1, (1, 30, 7, 1)).astype(np.float32)
        want = JR.sample_importance(key, jnp.asarray(z), jnp.asarray(w), 6)
        e = torch.from_numpy(np.array(jax.random.exponential(key, (30, 7))))
        got = PR.sample_importance(_t(z), _t(w), 6, exponential=e)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("white_back", [False, True])
    def test_march_rays_merge_values_and_grads(self, white_back):
        """The port's sort-based merge == spi_tpu's rank merge, with the
        gradients of colors and densities."""
        rs = np.random.RandomState(16)
        d1 = np.sort(rs.uniform(2, 3, (2, 16, 6, 1)), axis=2).astype(np.float32)
        d2 = np.sort(rs.uniform(2, 3, (2, 16, 5, 1)), axis=2).astype(np.float32)
        d2[:, :, 0] = d1[:, :, 2]  # ties: group 1 first
        d2 = np.sort(d2, axis=2)
        c1, c2 = _rand(2, 16, 6, 4, seed=17), _rand(2, 16, 5, 4, seed=18)
        s1, s2 = _rand(2, 16, 6, 1, seed=19), _rand(2, 16, 5, 1, seed=20)
        ct = _rand(2, 16, 4, seed=21)

        def jloss(c1, s1, c2, s2):
            rgb, depth, w = JM.march_rays_merge(c1, s1, jnp.asarray(d1), c2, s2, jnp.asarray(d2),
                                                white_back=white_back)
            return jnp.sum(rgb * ct), (rgb, depth, w)

        (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            *map(jnp.asarray, (c1, s1, c2, s2)))
        tin = [_t(a, True) for a in (c1, s1, c2, s2)]
        pout = PM.march_rays_merge(tin[0], tin[1], _t(d1), tin[2], tin[3], _t(d2),
                                   white_back=white_back)
        (pout[0] * _t(ct)).sum().backward()
        for a, b in zip(pout, jout):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        for a, b in zip(tin, jgrads):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)

    def test_march_rays(self):
        d = np.sort(np.random.RandomState(22).uniform(2, 3, (1, 8, 10, 1)), axis=2).astype(np.float32)
        c, s = _rand(1, 8, 10, 3, seed=23), _rand(1, 8, 10, 1, seed=24)
        want = JM.march_rays(jnp.asarray(c), jnp.asarray(s), jnp.asarray(d))
        got = PM.march_rays(_t(c), _t(s), _t(d))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


class TestSynthesis:
    """The whole synthesis forward and the w / noise gradients."""

    @pytest.fixture(scope="class")
    def results(self, pair):
        jg, params, pg, _ = pair
        ws = _rand(1, jg.num_ws, jg.w_dim, seed=30, scale=0.5)
        cam = np.asarray(jcam.canonical_camera(yaw=0.2))
        r1, r2 = _rand(1, 3, 128, 128, seed=31), _rand(1, 3, 16, 16, seed=32)
        rng = jax.random.PRNGKey(5)
        noise = {k: np.asarray(v) for k, v in j_extract_noise(params).items()}

        def jloss(ws, noise):
            out = jg.synthesis(j_replace_noise(params, noise), rng, ws, jnp.asarray(cam))
            return jnp.sum(out["image"] * r1) + jnp.sum(out["image_raw"] * r2), out

        (_, jout), (jgw, jgn) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
            jnp.asarray(ws), {k: jnp.asarray(v) for k, v in noise.items()})

        rend = jg.rendering
        draws = render_draws(rng, jg.neural_rendering_resolution ** 2, rend.depth_resolution,
                             rend.depth_resolution_importance)
        tws = _t(ws, True)
        tnoise = {k: _t(v, True) for k, v in noise.items()}
        with replace_noise(pg, tnoise):
            pout = pg.synthesis(tws, _t(cam), draws=draws)
        ((pout["image"] * _t(r1)).sum() + (pout["image_raw"] * _t(r2)).sum()).backward()
        return jout, jgw, jgn, pout, tws, tnoise

    @pytest.mark.parametrize("key", ["image", "image_raw", "image_depth"])
    def test_forward(self, results, key):
        jout, _, _, pout, _, _ = results
        assert tuple(pout[key].shape) == tuple(jout[key].shape)
        np.testing.assert_allclose(pout[key].detach().numpy(), np.asarray(jout[key]),
                                   rtol=1e-4, atol=1e-4)

    def test_grad_ws(self, results):
        _, jgw, _, _, tws, _ = results
        _close_rel(tws.grad.numpy(), jgw, 2e-3)

    def test_grad_noise(self, results):
        _, _, jgn, _, _, tnoise = results
        for k, v in tnoise.items():
            if k.startswith("superresolution"):
                # sr_noise_mode='none': no synthesis gradient on either side.
                assert v.grad is None and not np.asarray(jgn[k]).any()
                continue
            _close_rel(v.grad.numpy(), jgn[k], 2e-3)

    def test_generator_buffers_restored(self, pair, results):
        _, params, pg, _ = pair
        for k, v in extract_noise(pg).items():
            assert not v.requires_grad
            np.testing.assert_array_equal(v.numpy(), np.asarray(j_extract_noise(params)[k]))


def test_shared_planes_camera_batch(pair):
    """synthesis_from_planes with (1, ...) planes and 2 cameras equals two
    single-camera renders with the same draws (the batch merge)."""
    jg, params, pg, _ = pair
    ws = _t(_rand(1, jg.num_ws, jg.w_dim, seed=40, scale=0.5))
    cams = pcam.canonical_camera(batch_size=2)
    cams[1, 3] += 0.02
    m = jg.neural_rendering_resolution ** 2
    gen = torch.Generator().manual_seed(0)
    u = torch.rand(2, m, 4, 1, generator=gen)
    e = torch.empty(2 * m, 5).exponential_(generator=gen)
    with torch.no_grad():
        planes = pg.planes_nhwc(ws)
        both = pg.synthesis_from_planes(planes, ws, cams,
                                        draws={"stratified": u, "exponential": e})
        for i in range(2):
            one = pg.synthesis_from_planes(
                planes, ws, cams[i:i + 1],
                draws={"stratified": u[i:i + 1], "exponential": e[i * m:(i + 1) * m]})
            for k in ("image", "image_raw", "image_depth"):
                np.testing.assert_allclose(both[k][i:i + 1].numpy(), one[k].numpy(),
                                           rtol=1e-5, atol=1e-5)


def test_config_fields_match_jax():
    """The port's TriPlaneConfig carries the JAX dataclass's architecture."""
    from spi_tpu_torch.models.triplane import ffhq512_128_config

    for jcfg, pcfg in ((JT.ffhq512_128_config(), ffhq512_128_config()),
                       (JT.tiny_test_config(), tiny_test_config())):
        for f in dataclasses.fields(pcfg):
            if f.name == "rendering":
                for rf in dataclasses.fields(pcfg.rendering):
                    assert getattr(pcfg.rendering, rf.name) == getattr(jcfg.rendering, rf.name)
            else:
                assert getattr(pcfg, f.name) == getattr(jcfg, f.name), f.name
