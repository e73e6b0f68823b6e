"""spi_tpu_torch's perception, regularizers and stage-1 'sg' projector
against spi_tpu, on the CPU.

LPIPS runs on a small VGG (`cfg`) so that the CPU tests stay quick; the
weights of both sides come from one JAX init, carried over with
`load_flat_params`. The 2-step projection hands the port spi_tpu's own
random draws (noise init, w noise, render jitter), derived with
jax.random from the key splits of spi_tpu's projector.

Tolerances: float32 on both sides. Features and distances: 1e-5
relative (convolutions sum in another order). The projection: 2e-3
relative to the largest entry, since its gradients are held to that
much by tests/test_torch_port_generator.py and two Adam steps pass them
on.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.criteria import noise_reg as jnoise
from spi_tpu.criteria.lpips import LPIPS as JLPIPS
from spi_tpu.models import triplane as JT
from spi_tpu.training import projectors as JP
from spi_tpu.utils import camera as jcam
from spi_tpu.utils.checkpoint import flatten_pytree
from spi_tpu.utils.params import extract_noise as j_extract_noise
from spi_tpu.utils.params import init_noise_like as j_init_noise_like
from spi_tpu_torch.criteria import noise_reg as pnoise
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.training import projectors as PP
from spi_tpu_torch.utils.checkpoint import load_flat_params
from spi_tpu_torch.utils.params import extract_noise, init_noise_like
from torch_threads import few_torch_threads  # noqa: F401

SMALL_VGG = dict(cfg=(8, "M", 16, "M", 16), target_layers=(1, 4, 7))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_rel(got, want, tol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3e} relative to max |want| > {tol}"


@pytest.fixture(scope="module")
def lpips_pair():
    jl = JLPIPS(remat=False, **SMALL_VGG)
    jparams = jl.init(jax.random.PRNGKey(7))
    pl = LPIPS(device="cpu", **SMALL_VGG)
    load_flat_params(pl, flatten_pytree(jparams))
    return jl, jparams, pl


@pytest.fixture(scope="module")
def gen_pair():
    """tiny_test_config with nonzero noise strengths, so that the noise
    maps get a gradient."""
    jg = JT.tiny_test_config()
    params = jg.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, 0.1) if "noise_strength" in jax.tree_util.keystr(p) else v,
        params)
    pg = TriPlaneGenerator(tiny_test_config(), device="cpu")
    load_flat_params(pg, flatten_pytree(params))
    return jg, params, pg


class TestLPIPS:
    @pytest.mark.parametrize("size", [32, 64])
    def test_features(self, lpips_pair, size):
        jl, jparams, pl = lpips_pair
        x = np.tanh(_rand(2, 3, size, size, seed=size))
        want = jl.features(jparams, jnp.asarray(x))
        got = pl.features(_t(x))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)

    def test_resized_distance_and_mask(self, lpips_pair):
        """A 64^2 pair through max_size=32 (the bilinear resize), with and
        without a mask; and the 'sg' feature distance."""
        jl, jparams, _ = lpips_pair
        jl = JLPIPS(max_size=32, remat=False, **SMALL_VGG)
        pl = LPIPS(max_size=32, device="cpu", **SMALL_VGG)
        load_flat_params(pl, flatten_pytree(jparams))
        x, y = np.tanh(_rand(2, 3, 64, 64, seed=1)), np.tanh(_rand(2, 3, 64, 64, seed=2))
        mask = (np.random.RandomState(3).uniform(size=(2, 1, 32, 32)) > 0.5).astype(np.float32)
        for m in (None, mask):
            want = jl(jparams, jnp.asarray(x), jnp.asarray(y),
                      mask=None if m is None else jnp.asarray(m))
            got = pl(_t(x), _t(y), mask=None if m is None else _t(m))
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        want = JP.vgg_feature_distance(jl, jparams, jnp.asarray(x), jnp.asarray(y))
        got = PP.vgg_feature_distance(pl, _t(x), pl.features(_t(y)))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


class TestNoiseReg:
    @pytest.fixture(scope="class")
    def noise(self):
        return {f"n{r}": _rand(r, r, seed=r) for r in (4, 8, 32)}

    def test_regularization_and_grad(self, noise):
        want, jgrad = jax.value_and_grad(jnoise.noise_regularization)(
            {k: jnp.asarray(v) for k, v in noise.items()})
        tn = {k: _t(v).requires_grad_(True) for k, v in noise.items()}
        got = pnoise.noise_regularization(tn)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        for k, v in tn.items():
            np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrad[k]), rtol=1e-4, atol=1e-7)

    def test_normalize_in_place(self, noise):
        want = jnoise.normalize_noise({k: jnp.asarray(v) for k, v in noise.items()})
        tn = {k: _t(v).clone() for k, v in noise.items()}
        pnoise.normalize_noise(tn)
        for k in noise:
            np.testing.assert_allclose(tn[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)


class TestProjectorPieces:
    @pytest.mark.parametrize("step", [0, 1, 12, 60, 99])
    def test_schedules(self, step):
        # spi_tpu computes the schedules in float32, the port in Python floats.
        s = JP.ProjectorSettings(num_steps=100)
        ps = PP.ProjectorSettings(num_steps=100)
        np.testing.assert_allclose(PP._lr_schedule(step, ps), float(JP._lr_schedule(step, s)),
                                   rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(PP._w_noise_scale(step, 0.7, ps),
                                   float(JP._w_noise_scale(step, 0.7, s)), rtol=1e-5, atol=1e-12)

    def test_settings_match_jax(self):
        assert PP.ProjectorSettings() == PP.ProjectorSettings(
            **{f: getattr(JP.ProjectorSettings(), f) for f in PP.ProjectorSettings.__dataclass_fields__})

    def test_w_stats(self, gen_pair):
        jg, params, pg = gen_pair
        cam = jcam.canonical_camera()
        jw, jstd = JP.compute_w_stats(jg, params, cam, 64)
        pw, pstd = PP.compute_w_stats(pg, _t(cam), 64)
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pstd, jstd, rtol=1e-5)

    def test_init_noise_like(self, gen_pair):
        _, params, pg = gen_pair
        gen = torch.Generator().manual_seed(0)
        got = init_noise_like(pg, gen)
        want = j_extract_noise(params)
        assert list(got) == sorted(want)
        for k, v in got.items():
            assert v.shape == want[k].shape and v.dtype == torch.float32
        again = init_noise_like(pg, torch.Generator().manual_seed(0))
        assert all(torch.equal(got[k], again[k]) for k in got)
        assert set(extract_noise(pg)) == set(want)


def test_project_sg_two_steps(gen_pair, lpips_pair):
    """Two 'sg' steps with spi_tpu's draws: the optimised w and noise maps
    and the per-step distances."""
    jg, params, pg = gen_pair
    jl, jparams, pl = lpips_pair
    settings = JP.ProjectorSettings(mode="sg", num_steps=2, w_avg_samples=32)
    psettings = PP.ProjectorSettings(mode="sg", num_steps=2, w_avg_samples=32)
    cam = np.asarray(jcam.canonical_camera(yaw=0.1))
    target = np.tanh(_rand(1, 3, 128, 128, seed=50))
    rng = jax.random.PRNGKey(9)

    jw, jnoise_out, jdists = JP.project(jg, params, jl, jparams, jnp.asarray(target),
                                        jnp.asarray(cam), rng, settings)

    # spi_tpu's draws (projectors.py:142-143, :196-205; triplane.py:221,
    # :260; renderer.py:421).
    rng_noise_init, rng_steps = jax.random.split(rng)
    noise0 = j_init_noise_like(rng_noise_init, params)
    m = jg.neural_rendering_resolution ** 2
    rend = jg.rendering
    w_noise, render = [], []
    for step in range(settings.num_steps):
        step_rng = jax.random.fold_in(rng_steps, step)
        w_noise.append(np.asarray(jax.random.normal(step_rng, (1, 1, jg.w_dim))))
        rng_rest, _ = jax.random.split(jax.random.fold_in(step_rng, 1))
        rng_render, _ = jax.random.split(rng_rest)
        rc, rf, _ = jax.random.split(rng_render, 3)
        render.append({
            "stratified": _t(jax.random.uniform(rc, (1, m, rend.depth_resolution, 1))),
            "exponential": _t(jax.random.exponential(
                rf, (m, rend.depth_resolution_importance + 1))),
        })
    draws = {"noise0": {k: _t(v) for k, v in noise0.items()},
             "w_noise": _t(np.stack(w_noise)), "render": render}
    before = {k: v.clone() for k, v in extract_noise(pg).items()}
    pw, pnoise_out, pdists = PP.project(pg, pl, _t(target), _t(cam), psettings, draws=draws,
                                        device="cpu")

    np.testing.assert_allclose(pdists.numpy(), np.asarray(jdists), rtol=1e-4)
    assert tuple(pw.shape) == (1, jg.num_ws, jg.w_dim)
    _close_rel(pw.numpy(), jw, 2e-3)
    assert set(pnoise_out) == set(jnoise_out)
    for k, v in pnoise_out.items():
        _close_rel(v.numpy(), jnoise_out[k], 2e-3)
    for k, v in extract_noise(pg).items():  # the generator's buffers are untouched
        assert torch.equal(v, before[k])
