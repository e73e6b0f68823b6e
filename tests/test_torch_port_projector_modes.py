"""spi_tpu_torch's 'sgw+' and 'mir' projector modes against spi_tpu, on
the CPU.

Both sides get one set of weights (a JAX init carried over with
`load_flat_params`) and spi_tpu's own random draws (noise init, w noise,
render jitter), rebuilt with jax.random from the key splits of spi_tpu's
projector, as tests/test_torch_port_projector.py does for 'sg'.

Tolerances: float32 on both sides. Distances: 1e-4 relative. w+ and
noise maps after two steps: 2e-3 of the largest entry, as for 'sg'.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.criteria.lpips import LPIPS as JLPIPS
from spi_tpu.models import triplane as JT
from spi_tpu.training import projectors as JP
from spi_tpu.utils import camera as jcam
from spi_tpu.utils.checkpoint import flatten_pytree
from spi_tpu.utils.params import init_noise_like as j_init_noise_like
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.training import projectors as PP
from spi_tpu_torch.utils.checkpoint import load_flat_params
from spi_tpu_torch.utils.params import extract_noise
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
def jgen():
    """tiny_test_config with nonzero noise strengths, so that the noise
    maps get a gradient."""
    jg = JT.tiny_test_config()
    params = jg.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, 0.1) if "noise_strength" in jax.tree_util.keystr(p) else v,
        params)
    return jg, params


def _port_gen(params):
    pg = TriPlaneGenerator(tiny_test_config(), device="cpu")
    load_flat_params(pg, flatten_pytree(params))
    return pg


def _render_draws(jg, render_rng, n_cams=1):
    """The renderer's draws for one synthesis_from_planes call with key
    `render_rng` (triplane.py:260; renderer.py:421)."""
    rng_render, _ = jax.random.split(render_rng)
    rc, rf, _ = jax.random.split(rng_render, 3)
    m = jg.neural_rendering_resolution ** 2
    rend = jg.rendering
    return {
        "stratified": _t(jax.random.uniform(rc, (n_cams, m, rend.depth_resolution, 1))),
        "exponential": _t(jax.random.exponential(
            rf, (n_cams * m, rend.depth_resolution_importance + 1))),
    }


@pytest.mark.parametrize("mode", ["sgw+", "mir"])
def test_project_two_steps(jgen, lpips_pair, mode):
    """Two steps with spi_tpu's draws: the optimised w+ and noise maps and
    the per-step distances. 'mir' looks from a yawed camera, so that the
    mirror term has a nonzero weight."""
    jg, params = jgen
    pg = _port_gen(params)
    jl, jparams, pl = lpips_pair
    settings = JP.ProjectorSettings(mode=mode, num_steps=2, w_avg_samples=32)
    psettings = PP.ProjectorSettings(mode=mode, num_steps=2, w_avg_samples=32)
    cam = np.asarray(jcam.canonical_camera(yaw=0.4 if mode == "mir" else 0.1))
    target = np.tanh(_rand(1, 3, 128, 128, seed=51))
    rng = jax.random.PRNGKey(11)

    jw, jnoise_out, jdists = JP.project(jg, params, jl, jparams, jnp.asarray(target),
                                        jnp.asarray(cam), rng, settings)

    # spi_tpu's draws (projectors.py:142-143, :196-219; triplane.py:221, :260).
    rng_noise_init, rng_steps = jax.random.split(rng)
    n_cams = 2 if mode == "mir" else 1
    w_noise, render = [], []
    for step in range(settings.num_steps):
        step_rng = jax.random.fold_in(rng_steps, step)
        w_noise.append(np.asarray(jax.random.normal(step_rng, (1, jg.num_ws, jg.w_dim))))
        render_rng = jax.random.fold_in(step_rng, 1)
        if mode != "mir":  # synthesis() splits once more before synthesis_from_planes
            render_rng, _ = jax.random.split(render_rng)
        render.append(_render_draws(jg, render_rng, n_cams))
    noise0 = j_init_noise_like(rng_noise_init, params)
    draws = {"noise0": {k: _t(v) for k, v in noise0.items()},
             "w_noise": _t(np.stack(w_noise)), "render": render}
    before = {k: v.clone() for k, v in extract_noise(pg).items()}
    pw, pnoise_out, pdists = PP.project(pg, pl, _t(target), _t(cam), psettings, draws=draws,
                                        device="cpu")

    np.testing.assert_allclose(pdists.numpy(), np.asarray(jdists), rtol=1e-4)
    assert tuple(pw.shape) == tuple(jw.shape) == (1, jg.num_ws, jg.w_dim)
    _close_rel(pw.numpy(), jw, 2e-3)
    assert set(pnoise_out) == set(jnoise_out)
    for k, v in pnoise_out.items():
        _close_rel(v.numpy(), jnoise_out[k], 2e-3)
    for k, v in extract_noise(pg).items():  # the generator's buffers are untouched
        assert torch.equal(v, before[k])
    assert all(p.grad is None for p in pg.parameters())  # no weight gradients in stage 1
