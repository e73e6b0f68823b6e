"""spi_tpu_torch's camera mirroring and recon-only stage-2 tuning against
spi_tpu, on the CPU (the 'sgw+' and 'mir' projector modes are in
tests/test_torch_port_projector_modes.py).

Both sides get one set of weights (a JAX init carried over with
`load_flat_params`) and spi_tpu's own random draws, rebuilt with
jax.random from the key splits of spi_tpu's coach, as
tests/test_torch_port_projector.py does for 'sg'.

Tolerances: float32 on both sides. Camera functions: 1e-6 (the same
formulas). LPIPS values: 1e-4 relative. Tuned weights: Adam's first
steps move each weight by about lr times the sign of its gradient, so a
weight whose gradient is at float32 noise level in one framework may
move another way in the other; the test holds the weight change to
0.05 lr on all but 0.01% of the weights and to 2 lr everywhere (after
two steps on these inputs: 8.6e-6 of 584,786 weights beyond 0.05 lr,
at most 0.76 lr).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.criteria.lpips import LPIPS as JLPIPS
from spi_tpu.models import triplane as JT
from spi_tpu.training import coaches as JC
from spi_tpu.utils import camera as jcam
from spi_tpu.utils.checkpoint import flatten_pytree
from spi_tpu.utils.params import extract_noise as j_extract_noise
from spi_tpu.utils.params import replace_noise as j_replace_noise
from spi_tpu.utils.params import trainable_mask
from spi_tpu_torch.criteria.l2_loss import l2_loss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.training import coaches as PC
from spi_tpu_torch.utils import camera as pcam
from spi_tpu_torch.utils.checkpoint import load_flat_params
from spi_tpu_torch.utils.params import trainable_parameters
from torch_threads import few_torch_threads  # noqa: F401

SMALL_VGG = dict(cfg=(8, "M", 16, "M", 16), target_layers=(1, 4, 7))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


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
    """A fresh port generator with spi_tpu's weights (tuning changes it in place)."""
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


class TestCamera:
    @pytest.mark.parametrize("yaw,pitch", [(0.0, 0.0), (0.1, -0.05), (-0.35, 0.1), (0.6, 0.2),
                                           (-0.9, -0.15)])
    def test_mirror_and_weight(self, yaw, pitch):
        jc = jcam.canonical_camera(yaw=yaw, pitch=pitch, batch_size=2)
        pc = _t(jc)
        np.testing.assert_array_equal(pcam.mirror_camera(pc).numpy(),
                                      np.asarray(jcam.mirror_camera(jc)))
        pose = pcam.unpack_camera(pc)[0]
        np.testing.assert_array_equal(pcam.flip_yaw(pose).numpy(),
                                      np.asarray(jcam.flip_yaw(jcam.unpack_camera(jc)[0])))
        for got, want in zip(pcam.rotation_to_angle(pose[:, :3, :3]),
                             jcam.rotation_to_angle(jcam.unpack_camera(jc)[0][:, :3, :3])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pcam.camera_yaw(pc).numpy(), np.asarray(jcam.camera_yaw(jc)),
                                   rtol=1e-6, atol=1e-6)
        for c in (pc, pcam.mirror_camera(pc)):
            np.testing.assert_allclose(pcam.cal_camera_weight(c).numpy(),
                                       np.asarray(jcam.cal_camera_weight(jnp.asarray(c.numpy()))),
                                       rtol=1e-6, atol=1e-7)
        x = _t(np.linspace(-1, 1, 9, dtype=np.float32))
        np.testing.assert_allclose(pcam._gauss(x, std=0.29).numpy(),
                                   np.asarray(jcam._gauss(jnp.asarray(x.numpy()), std=0.29)),
                                   rtol=1e-6)

    def test_yawed_camera_weight_is_positive(self):
        assert float(pcam.cal_camera_weight(pcam.canonical_camera(yaw=0.4))[0]) > 0
        assert float(pcam.cal_camera_weight(pcam.canonical_camera())[0]) == 0


def test_l2_loss():
    a, b = _rand(2, 3, 8, 8, seed=1), _rand(2, 3, 8, 8, seed=2)
    from spi_tpu.criteria.l2_loss import l2_loss as jl2

    np.testing.assert_allclose(l2_loss(_t(a), _t(b)).item(), float(jl2(a, b)), rtol=1e-6)


def test_trainable_parameters_match_mask(jgen):
    _, params = jgen
    pg = _port_gen(params)
    flat_mask = flatten_pytree(trainable_mask(params))
    assert set(trainable_parameters(pg)) == {k for k, v in flat_mask.items() if v}
    assert not any(k.endswith(("noise_const", "w_avg")) for k in trainable_parameters(pg))


def _tune_both(jgen, lpips_pair, num_steps, threshold):
    """Recon-only tuning on both sides from one w pivot and one set of
    stage-1 noise maps, with spi_tpu's draws (coaches.py:277; triplane.py:260)."""
    jg, params = jgen
    jl, jparams, pl = lpips_pair
    noise = {k: _rand(*v.shape, seed=60 + i) for i, (k, v) in
             enumerate(sorted(j_extract_noise(params).items()))}
    w_pivot = _rand(1, jg.num_ws, jg.w_dim, seed=61, scale=0.5)
    target = np.tanh(_rand(1, 3, 128, 128, seed=62))
    cam = np.asarray(jcam.canonical_camera(yaw=0.2))
    rng = jax.random.PRNGKey(13)
    settings = JC.pti_settings(num_steps)
    settings = JC.CoachSettings(**{**settings.__dict__, "lpips_threshold": threshold})

    g_params = j_replace_noise(params, {k: jnp.asarray(v) for k, v in noise.items()})
    jtuned, (jsteps, jlp) = JC.tune_generator(
        jg, g_params, g_params, jl, jparams,
        JC.CoachInputs(target=jnp.asarray(target), camera=jnp.asarray(cam),
                       w_pivot=jnp.asarray(w_pivot)), rng, settings)

    draws = []
    for step in range(num_steps):
        k_recon, _ = jax.random.split(jax.random.fold_in(rng, step))
        draws.append({"recon": _render_draws(jg, k_recon)})
    pg = _port_gen(params)
    before = {k: v.detach().clone() for k, v in pg.state_dict().items()}
    psettings = PC.CoachSettings(**settings.__dict__)
    snaps = []
    out, (psteps, plp) = PC.tune_generator(
        pg, pl, PC.CoachInputs(target=_t(target), camera=_t(cam), w_pivot=_t(w_pivot)),
        psettings, noise={k: _t(v) for k, v in noise.items()}, draws=draws, device="cpu",
        snapshot_cb=lambda step, img: snaps.append(step))
    assert out is pg
    return (flatten_pytree(jtuned), int(jsteps), float(jlp)), (pg, psteps, plp, before)


def test_tune_generator_two_steps(jgen, lpips_pair):
    (jflat, jsteps, jlp), (pg, psteps, plp, before) = _tune_both(jgen, lpips_pair, 2, 0.0)
    assert psteps == jsteps == 2
    np.testing.assert_allclose(plp, jlp, rtol=1e-4)
    lr = PC.CoachSettings().learning_rate
    deltas_p, deltas_j = [], []
    tuned = trainable_parameters(pg)
    for k, v in pg.state_dict().items():
        dp = (v - before[k]).numpy().ravel()
        if k not in tuned:  # the noise_const and w_avg buffers stay fixed
            assert not dp.any(), k
            continue
        deltas_p.append(dp)
        deltas_j.append((np.asarray(jflat[k]) - before[k].numpy()).ravel())
    dp, dj = np.concatenate(deltas_p), np.concatenate(deltas_j)
    assert np.abs(dj).max() > 0.5 * lr  # the weights moved
    diff = np.abs(dp - dj)
    assert diff.max() <= 2 * lr
    assert np.mean(diff > 0.05 * lr) <= 1e-4, f"{np.mean(diff > 0.05 * lr):.2e} of weights differ"


def test_tune_generator_early_stop(jgen, lpips_pair):
    """A threshold above any LPIPS value: one step is counted, none applied."""
    (jflat, jsteps, jlp), (pg, psteps, plp, before) = _tune_both(jgen, lpips_pair, 3, 1e9)
    assert psteps == jsteps == 1
    np.testing.assert_allclose(plp, jlp, rtol=1e-4)
    for k, v in pg.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k in trainable_parameters(pg):
        np.testing.assert_array_equal(np.asarray(jflat[k]), before[k].numpy())


def test_tune_generator_renders_with_stage1_noise(monkeypatch):
    """Every render of a RotBbox step (recon, rot, depth) reads the
    stage-1 noise maps in all of the generator's noise buffers, the
    superresolution's too (sr_noise_mode='const' reads them), as
    spi_tpu renders every term from its substituted params; the buffers
    are left as they were."""
    from spi_tpu_torch.utils.params import extract_noise, init_noise_like

    pg = TriPlaneGenerator(tiny_test_config(sr_noise_mode="const"), device="cpu", seed=0)
    noise = init_noise_like(pg, torch.Generator().manual_seed(3))
    assert any(k.startswith("superresolution.") for k in noise)
    before = {k: v.clone() for k, v in extract_noise(pg).items()}
    seen = []
    synth = TriPlaneGenerator.synthesis_from_planes

    def spy(self, *args, **kwargs):
        if self is pg:
            bufs = extract_noise(pg)
            seen.append(all(torch.equal(bufs[k], noise[k]) for k in noise))
        return synth(self, *args, **kwargs)

    monkeypatch.setattr(TriPlaneGenerator, "synthesis_from_planes", spy)
    res = pg.cfg.img_resolution
    inputs = PC.CoachInputs(target=torch.zeros(1, 3, res, res),
                            camera=pcam.canonical_camera(yaw=0.3),
                            w_pivot=torch.zeros(1, pg.num_ws, pg.cfg.w_dim))
    settings = PC.CoachSettings(num_steps=1, lpips_threshold=-1.0, mirror_rot_lambda=0.0)
    PC.tune_generator(pg, LPIPS(device="cpu", **SMALL_VGG), inputs, settings, noise=noise,
                      rng=torch.Generator().manual_seed(1), device="cpu")
    assert seen == [True, True, True]  # recon, rot, tuned depth
    for k, v in extract_noise(pg).items():
        assert torch.equal(v, before[k]), k


def test_tune_generator_rejects_unported_terms():
    """Every stage-2 term, bfloat16 compute and several images at once are
    ported (tests/test_torch_port_parallel.py); what the CLI still refuses
    is a batch of fewer than one image."""
    from spi_tpu_torch.cli import run_inversion

    with pytest.raises(ValueError, match="parallel_images"):
        run_inversion.main(["--data_root", "unused", "--device", "cpu", "--parallel_images", "0"])


def test_coach_settings_match_jax():
    assert PC.CoachSettings() == PC.CoachSettings(**JC.CoachSettings().__dict__)
    assert PC.pti_settings(7) == PC.CoachSettings(**JC.pti_settings(7).__dict__)
