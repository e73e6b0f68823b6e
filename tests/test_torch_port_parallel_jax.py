"""The port's batched inversion (`spi_tpu_torch.parallel.spmd_invert`)
against spi_tpu's `spmd_invert` on a one-device mesh, on the CPU.

B = 2 images, 2 'mir' projector steps and 2 PTI tuning steps, at the
scaled-down generator of tests/test_parallel.py (tiny_test_config with a
16^2 backbone and an 8^2 render of 3 + 3 samples: spi_tpu's compile of
the batched program takes about a minute at tiny_test_config's own
sizes), one set of weights on both sides and spi_tpu's per-image random
draws injected into the port, rebuilt with jax.random from the key splits
of spi_tpu's projector and coach, as tests/test_torch_port_projector_modes.py
and test_torch_port_stage2.py do for one image. The RotBbox terms'
batched form is held to the port's serial path in
tests/test_torch_port_parallel.py, and that to spi_tpu's in
tests/test_torch_port_rotbbox.py.

Tolerances: float32 on both sides, other summation orders. w and the
LPIPS values are held to tests/test_parallel.py:100-112's tolerances for
spi_tpu's own batched-against-serial check (w rtol 2e-4, atol 2e-5;
LPIPS rtol 2e-3, atol 2e-4). The tuned leaf is held as
tests/test_torch_port_stage2.py holds tuned weights to spi_tpu's, in
units of Adam's step, because the first steps move a weight by about lr
times the sign of its gradient and a gradient at rounding level may flip:
the change agrees within 2 lr everywhere and within 0.05 lr on all but 1%
of its entries (measured: 0.06 lr at most).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.criteria.lpips import LPIPS as JLPIPS
from spi_tpu.models import triplane as JT
from spi_tpu.parallel.mesh import data_mesh, index_tree, shard_batch, spmd_invert, stack_trees
from spi_tpu.training import coaches as JC
from spi_tpu.training import projectors as JP
from spi_tpu.utils import camera as jcam
from spi_tpu.utils.checkpoint import flatten_pytree
from spi_tpu.utils.params import init_noise_like as j_init_noise_like
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.models.rendering import RenderingOptions
from spi_tpu_torch.parallel import spmd_invert as p_spmd_invert
from spi_tpu_torch.training import coaches as PC
from spi_tpu_torch.training import projectors as PP
from spi_tpu_torch.utils.checkpoint import load_flat_params
from torch_threads import few_torch_threads  # noqa: F401

SMALL_VGG = dict(cfg=(8, "M", 16, "M", 16), target_layers=(1, 4, 7))
B, STEPS = 2, 2
# tests/test_parallel.py's generator
SMALL_GEN = dict(z_dim=16, w_dim=16, backbone_resolution=16, neural_rendering_resolution=8,
                 channel_base=512, channel_max=32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _render_keys(jg, render_rng, n_cams):
    """The renderer's draws for one synthesis_from_planes call with key
    `render_rng` (triplane.py:260; renderer.py:421)."""
    rng_render, _ = jax.random.split(render_rng)
    rc, rf, _ = jax.random.split(rng_render, 3)
    m = jg.neural_rendering_resolution ** 2
    rend = jg.rendering
    return {"stratified": jax.random.uniform(rc, (n_cams, m, rend.depth_resolution, 1)),
            "exponential": jax.random.exponential(
                rf, (n_cams * m, rend.depth_resolution_importance + 1))}


def _per_step(tree):
    """{key: (STEPS, ...)} nests of arrays -> a list of STEPS nests of tensors."""
    def take(t, s):
        if isinstance(t, dict):
            return {k: take(v, s) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(take(v, s) for v in t)
        return _t(t[s])
    return [take(tree, s) for s in range(STEPS)]


def _project_draws(jg, noise0s, rng_projs):
    """Each image's 'mir' projector draws as spi_tpu makes them from its step
    key (projectors.py:196-219), for all images under one jax.jit (eager
    jax.random costs seconds a call here)."""
    def one(rng_steps, step):
        step_rng = jax.random.fold_in(rng_steps, step)
        return {"w_noise": jax.random.normal(step_rng, (1, jg.num_ws, jg.w_dim)),
                "render": _render_keys(jg, jax.random.fold_in(step_rng, 1), 2)}

    made = jax.device_get(jax.jit(jax.vmap(jax.vmap(one, (None, 0)), (0, None)))(
        rng_projs, jnp.arange(STEPS)))
    out = []
    for i in range(B):
        steps = _per_step(jax.tree_util.tree_map(lambda a: a[i], made))
        out.append({"noise0": {k: _t(v) for k, v in noise0s[i].items()},
                    "w_noise": torch.stack([d["w_noise"] for d in steps]),
                    "render": [d["render"] for d in steps]})
    return out


def _tune_draws(jg, rng_tunes):
    """Each image's coach draws as spi_tpu makes them (coaches.py:139-143):
    fold_in(rng, step) -> (k_recon, k_reg); PTI renders the target camera
    only."""
    def one(rng, step):
        k_recon, _ = jax.random.split(jax.random.fold_in(rng, step))
        return {"recon": _render_keys(jg, k_recon, 1)}

    made = jax.device_get(jax.jit(jax.vmap(jax.vmap(one, (None, 0)), (0, None)))(
        rng_tunes, jnp.arange(STEPS)))
    return [_per_step(jax.tree_util.tree_map(lambda a: a[i], made)) for i in range(B)]


@pytest.fixture(scope="module")
def both():
    """Both packages' spmd_invert on the same 2 images, weights and draws."""
    jg = JT.tiny_test_config(**SMALL_GEN, rendering=JT.RenderingOptions(
        depth_resolution=3, depth_resolution_importance=3))
    pg = TriPlaneGenerator(tiny_test_config(**SMALL_GEN, rendering=RenderingOptions(
        depth_resolution=3, depth_resolution_importance=3)), device="cpu")
    with torch.no_grad():
        for k, v in pg.named_parameters():
            if k.endswith("noise_strength"):
                v.fill_(0.1)
    # spi_tpu's tree filled with the port's seeded weights (cheaper than
    # spi_tpu's init here; load_flat_params is the one-to-one inverse).
    tensors = dict(pg.named_parameters()) | dict(pg.named_buffers())
    params = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(tensors[".".join(str(getattr(p, "key", p)) for p in path)]
                                    .detach().numpy()),
        jax.eval_shape(jg.init, jax.random.PRNGKey(0)))
    jl = JLPIPS(remat=False, **SMALL_VGG)
    jlp = jl.init(jax.random.PRNGKey(7))
    proj = JP.ProjectorSettings(mode="mir", num_steps=STEPS, w_avg_samples=16)
    coach = JC.CoachSettings(**{**JC.pti_settings(STEPS).__dict__, "lpips_threshold": -1.0})

    rs = np.random.RandomState(5)
    targets = np.tanh(rs.randn(B, 1, 3, 128, 128)).astype(np.float32)
    cameras = np.stack([np.asarray(jcam.canonical_camera(yaw=y)) for y in (0.4, -0.3)])
    keys = jax.random.split(jax.random.PRNGKey(9), 3 * B)
    noise0s = [j_init_noise_like(keys[i], params) for i in range(B)]
    rng_projs, rng_tunes = keys[B:2 * B], keys[2 * B:]
    # The starting w from the port's w statistics (tests/test_torch_port_
    # projector.py holds them to spi_tpu's); the port computes its own.
    w0s, w_stds = [], []
    for i in range(B):
        w_avg, w_std = PP.compute_w_stats(pg, _t(cameras[i]), proj.w_avg_samples)
        w0s.append(np.tile(w_avg.numpy(), (1, jg.num_ws, 1)))
        w_stds.append(w_std)
    mesh = data_mesh(1)
    run = spmd_invert(jg, jl, mesh, proj, coach)
    jout = run(params, jlp, None, *(shard_batch(mesh, jnp.asarray(a)) for a in (
        targets, cameras, np.stack(w0s))), shard_batch(mesh, stack_trees(noise0s)),
        shard_batch(mesh, jnp.asarray(w_stds, jnp.float32)), shard_batch(mesh, rng_projs),
        shard_batch(mesh, rng_tunes), None, None)

    pl = LPIPS(device="cpu", **SMALL_VGG)
    load_flat_params(pl, flatten_pytree(jlp))
    start = {k: v.detach().clone() for k, v in pg.named_parameters()}
    prun = p_spmd_invert(pg, pl, PP.ProjectorSettings(**proj.__dict__),
                         PC.CoachSettings(**coach.__dict__), device="cpu")
    pout = prun(_t(targets), _t(cameras),
                proj_draws=_project_draws(jg, noise0s, rng_projs),
                tune_draws=_tune_draws(jg, rng_tunes))
    return jout, pout, flatten_pytree(params), start


def test_w_and_lpips(both):
    (jw, _, _, jsteps, jlp, jdists), (pw, _, _, psteps, plp, pdists), _, _ = both
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(pdists.numpy(), np.asarray(jdists), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(plp), np.asarray(jlp), rtol=2e-3, atol=2e-4)
    assert list(psteps) == [STEPS] * B == np.asarray(jsteps).tolist()


def test_stage1_noise(both):
    (_, jnoise, _, _, _, _), (_, pnoise, _, _, _, _), _, _ = both
    assert set(pnoise) == set(jnoise)
    for k, v in pnoise.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jnoise[k]), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("leaf", ["superresolution.block1.conv1.weight",
                                  "backbone.synthesis.b16.conv1.weight", "decoder.net.0.weight"])
def test_tuned_leaf(both, leaf):
    (_, _, jtuned, _, _, _), (_, _, ptuned, _, _, _), _, start = both
    lr = PC.CoachSettings().learning_rate
    for i in range(B):
        j = np.asarray(flatten_pytree(index_tree(jtuned, i))[leaf]) - start[leaf].numpy()
        p = (ptuned[leaf][i] - start[leaf]).numpy()
        assert np.abs(j).max() > 0.5 * lr  # the leaf moved
        diff = np.abs(p - j)
        assert diff.max() <= 2 * lr
        assert np.mean(diff > 0.05 * lr) <= 1e-2
