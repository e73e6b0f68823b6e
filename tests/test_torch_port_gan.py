"""The port's GAN trainer (spi_tpu_torch/training/gan.py) held to spi_tpu's
jitted step on the CPU, in float32, on the same weights and draws.

The tiny generator and dual discriminator of tests/test_gan.py, the ADA
pipe at p = 0.5, batch 2, r1_interval = density_reg_interval = 2: step 0
runs the lazy R1 penalty (a second-order gradient through the pipe and
D) and density TV, step 1 neither. The generator's noise strengths are
0.5, so that the random noise maps of each render count. Every draw of a
step (each render's noise maps and renderer draws, the pipe's draws at
both resolutions, density TV's points and offsets) is spi_tpu's, split
from its keys as `make_step` splits them, and handed to the port's
`step`. spi_tpu's gradients are read from its Adam states: with beta1 = 0
the first moment is the last gradient. Step 1 starts the port from
spi_tpu's weights and Adam moments after step 0 (Adam's first steps are
lr * g / (|g| + eps), so that float32 noise in a near-zero gradient
element becomes a whole step of difference, as in the ZSSGAN tests).

Tolerances: losses, rt and fake_score 1e-5 relative; every gradient 2e-3
of its leaf's largest entry (the float32 backward's bound, ROADMAP Queue
3); the updated leaves 1e-5 of their largest entry against spi_tpu's optax
update applied to the port's gradient; G_ema 1e-6 against the lerp.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from spi_tpu.models import triplane as JT
from spi_tpu.models.discriminator import DualDiscriminator as JDual
from spi_tpu.models.rendering.renderer import RenderingOptions as JRendering
from spi_tpu.training import gan as JG
from spi_tpu.training.augment import AugmentPipe as JPipe
from spi_tpu.utils import camera as jcam
from spi_tpu.utils.checkpoint import flatten_pytree, unflatten_to_nested
from spi_tpu_torch.models.discriminator import DualDiscriminator
from spi_tpu_torch.models.triplane import TriPlaneGenerator
from spi_tpu_torch.training import gan as PG
from spi_tpu_torch.training.augment import AugmentPipe
from spi_tpu_torch.utils.checkpoint import module_flat
from test_torch_port_gan_modules import pipe_draws
from test_torch_port_zssgan import render_draws
from torch_threads import few_torch_threads  # noqa: F401

TOL_LOSS = 1e-5
TOL_GRAD = 2e-3  # the float32 backward's bound (ROADMAP Queue 3)
TOL_LEAF = 1e-5
AUG_P = 0.5
BATCH = 2
CONFIG = dict(batch_per_device=BATCH, r1_interval=2, density_reg_interval=2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30)


def jax_tiny_generator():
    """tests/test_gan.py's tiny_generator."""
    return JT.TriPlaneGenerator(
        z_dim=16, c_dim=25, w_dim=16, img_resolution=128, backbone_resolution=32,
        neural_rendering_resolution=16,
        rendering=JRendering(depth_resolution=4, depth_resolution_importance=4),
        sr_variant="SuperresolutionHybrid2X", channel_base=512, channel_max=32)


def port_modules(seed=0):
    g = TriPlaneGenerator(PG.tiny_gan_config(), device="cpu", seed=seed)
    with torch.no_grad():
        for k, v in g.named_parameters():
            if k.endswith("noise_strength"):
                v.fill_(0.5)
    d = DualDiscriminator(c_dim=25, **PG.TINY_DISCRIMINATOR, device="cpu", seed=seed + 1)
    return g, d


def snapshot(module):
    """A copy of a module's state (module_flat's arrays are views of the
    CPU tensors, which the next step updates in place)."""
    return {k: v.copy() for k, v in module_flat(module).items()}


def tree_of(module):
    """A module's weights as spi_tpu's tree, copied: jnp.asarray may alias
    the numpy view of a parameter that the port's step then updates in
    place while spi_tpu's asynchronous step still reads it."""
    return jax.tree_util.tree_map(lambda v: jnp.array(v, copy=True),
                                  unflatten_to_nested(module_flat(module)))


def step_draws(jg, pipe, rng, step, n):
    """The draws of spi_tpu's step_impl (gan.py:217-250): kd, kg from
    fold_in(rng, step); each render's from split(k)[0]; the pipe's (None
    without a pipe) from fold_in(kd, 3) (generated), fold_in(kd, 4) (real),
    fold_in(kg, 2); density TV's from split(fold_in(kg, 1))."""
    kd, kg = jax.random.split(jax.random.fold_in(rng, step))
    shapes = [(3, jg.img_resolution, jg.img_resolution),
              (3, jg.neural_rendering_resolution, jg.neural_rendering_resolution)]
    kp, kn = jax.random.split(jax.random.fold_in(kg, 1))

    def aug(key):
        return None if pipe is None else pipe_draws(pipe, key, n, shapes)

    return {
        "d": {"render": render_draws(jg, jax.random.split(kd)[0], n),
              "aug_gen": aug(jax.random.fold_in(kd, 3)),
              "aug_real": aug(jax.random.fold_in(kd, 4))},
        "g": {"render": render_draws(jg, jax.random.split(kg)[0], n),
              "aug": aug(jax.random.fold_in(kg, 2)),
              "density_uniform": _t(jax.random.uniform(kp, (n, PG.DENSITY_POINTS, 3))),
              "density_normal": _t(jax.random.normal(kn, (n, PG.DENSITY_POINTS, 3)))}}


def step_inputs(n, seed):
    rng = np.random.RandomState(seed)
    real = np.clip(rng.randn(n, 3, 128, 128), -1, 1).astype(np.float32)
    z = rng.randn(n, 16).astype(np.float32)
    c = np.tile(np.asarray(jcam.canonical_camera()), (n, 1)).astype(np.float32)
    return real, z, c


def start_from(ptr, state):
    """The port's G, D, G_ema and Adam moments set to spi_tpu's state."""
    with torch.no_grad():
        for module, key in ((ptr.generator, "g"), (ptr.discriminator, "d"), (ptr.g_ema, "g_ema")):
            flat = flatten_pytree(state[key])
            for k, v in module.state_dict().items():
                v.copy_(_t(flat[k]))
        for opt, leaves, key in ((ptr.g_opt, ptr.g_leaves, "g_opt"),
                                 (ptr.d_opt, dict(ptr.discriminator.named_parameters()), "d_opt")):
            adam = state[key][0]
            mu, nu = flatten_pytree(adam.mu), flatten_pytree(adam.nu)
            for k, p in leaves.items():
                s = opt.state[p]
                s["exp_avg"].copy_(_t(mu[k]))
                s["exp_avg_sq"].copy_(_t(nu[k]))
                s["step"].fill_(float(adam.count))


@pytest.fixture(scope="module")
def steps():
    """Two steps of each package; per step spi_tpu's state before and after
    and the port's metrics, gradients, leaves and G_ema before and after."""
    jg = jax_tiny_generator()
    jd = JDual(c_dim=25, img_resolution=128, channel_base=1024, channel_max=32)
    jtr = JG.GANTrainer(jg, jd, JG.GANConfig(**CONFIG), augment=JPipe())
    g, d = port_modules()
    ptr = PG.GANTrainer(g, d, PG.GANConfig(**CONFIG), augment=AugmentPipe(), device="cpu")
    g_opt, d_opt = jtr.optimizers()
    gp, dp = tree_of(g), tree_of(d)
    state = {"g": gp, "d": dp, "g_ema": gp, "g_opt": g_opt.init(gp), "d_opt": d_opt.init(dp),
             "step": jnp.zeros((), jnp.int32)}
    step = jtr.make_step()
    rng = jax.random.PRNGKey(3)
    out = []
    for i in range(2):
        real, z, c = step_inputs(BATCH, 10 + i)
        draws = step_draws(jg, JPipe(), rng, i, BATCH)
        if i:
            start_from(ptr, state)
        before = state
        port_before = {"g": snapshot(g), "g_ema": snapshot(ptr.g_ema)}
        r1 = None
        if i == 0:
            _, aux = ptr.d_loss(_t(real), _t(z), _t(c), draws["d"], 0, AUG_P)
            r1 = float(aux["r1"].detach())
        state, metrics = step(state, jnp.asarray(real), jnp.asarray(z), jnp.asarray(c), rng,
                              jnp.float32(AUG_P))
        pm = ptr.step(_t(real), _t(z), _t(c), AUG_P, draws)
        port = {"metrics": {k: float(v) for k, v in pm.items()},
                "grads": {"g": {k: p.grad.numpy().copy() for k, p in ptr.g_leaves.items()},
                          "d": {k: p.grad.numpy().copy() for k, p in d.named_parameters()}},
                "leaves": {"g": snapshot(g), "d": snapshot(d)},
                "g_ema": snapshot(ptr.g_ema), "before": port_before, "r1": r1}
        out.append({"jax_before": before, "jax_after": state,
                    "jax_metrics": {k: float(v) for k, v in metrics.items()}, "port": port})
    return {"jtr": jtr, "steps": out}


@pytest.mark.parametrize("i", [0, 1])
def test_metrics(steps, i):
    s = steps["steps"][i]
    for k in ("loss_g", "loss_d", "rt", "fake_score"):
        want, got = s["jax_metrics"][k], s["port"]["metrics"][k]
        assert abs(got - want) <= TOL_LOSS * max(abs(want), 1e-6), (k, got, want)


def test_r1_runs_at_step_0(steps):
    """Step 0's D loss holds a positive R1 term."""
    assert steps["steps"][0]["port"]["r1"] > 0


@pytest.mark.parametrize("which", ["d", "g"])
@pytest.mark.parametrize("i", [0, 1])
def test_gradients(steps, i, which):
    """Every gradient (at step 0 with R1 in D's and density TV in G's, which
    reaches G's constant noise maps) against spi_tpu's, read from its Adam
    first moment; every leaf of spi_tpu's tree that the port does not train
    (w_avg) gets a zero gradient there."""
    s = steps["steps"][i]
    mu = flatten_pytree(s["jax_after"][f"{which}_opt"][0].mu)
    grads = s["port"]["grads"][which]
    assert set(grads) <= set(mu)
    assert not [k for k in set(mu) - set(grads) if np.any(mu[k])]
    worst = max((_rel_err(v, mu[k]), k) for k, v in grads.items())
    assert worst[0] <= TOL_GRAD, worst
    # Most parameters get a gradient (the noise maps only at a density-TV step).
    params = [v for k, v in grads.items() if not k.endswith("noise_const")]
    assert sum(np.abs(v).max() > 0 for v in params) > 0.9 * len(params)


@pytest.mark.parametrize("which", ["d", "g"])
@pytest.mark.parametrize("i", [0, 1])
def test_updated_leaves(steps, i, which):
    """The leaves after the step equal spi_tpu's optimizer (optax) applied
    to the port's gradient from the state the step started from; every
    leaf that is not a parameter (noise maps, w_avg) is unchanged."""
    s = steps["steps"][i]
    opt = dict(zip("gd", steps["jtr"].optimizers()))[which]
    params = s["jax_before"][which]
    grads = s["port"]["grads"][which]
    flat = flatten_pytree(params)
    tree = unflatten_to_nested({k: grads.get(k, np.zeros_like(v)) for k, v in flat.items()})
    update = jax.jit(lambda t, o, p: optax.apply_updates(p, opt.update(t, o, p)[0]))
    want = flatten_pytree(update(tree, s["jax_before"][f"{which}_opt"], params))
    leaves = s["port"]["leaves"][which]
    for k, v in leaves.items():
        if k in grads:
            assert _rel_err(v, want[k]) <= TOL_LEAF, k
        else:
            np.testing.assert_array_equal(v, flat[k], err_msg=k)


@pytest.mark.parametrize("i", [0, 1])
def test_g_ema(steps, i):
    """G_ema = G_ema * beta + G * (1 - beta) for parameters, beta of the
    batch; buffers copied; it moved less than G; and every leaf equals
    spi_tpu's lerp from its G_ema before the step onto the port's updated
    leaves (TOL_LEAF of the leaf's largest entry)."""
    cfg = PG.GANConfig(**CONFIG)
    beta = cfg.ema_beta(BATCH)
    assert beta == JG.GANConfig(**CONFIG).ema_beta(BATCH)
    s = steps["steps"][i]
    port = s["port"]
    grads = port["grads"]["g"]
    moved_g = moved_ema = 0.0
    for k, v in port["g_ema"].items():
        e0, g1 = port["before"]["g_ema"][k], port["leaves"]["g"][k]
        if k in grads:
            np.testing.assert_allclose(v, e0 * beta + g1 * (1 - beta), rtol=1e-6, atol=1e-7)
            moved_g += np.abs(g1 - port["before"]["g"][k]).sum()
            moved_ema += np.abs(v - e0).sum()
        else:
            np.testing.assert_array_equal(v, g1)
    assert 0 < moved_ema < moved_g
    # spi_tpu's lerp (gan.py's step) from its G_ema before the step, onto the
    # port's leaves, which test_updated_leaves holds to spi_tpu's optimizer.
    e0 = flatten_pytree(s["jax_before"]["g_ema"])
    jbeta = JG.GANConfig(**CONFIG).ema_beta(BATCH)
    want = jax.tree_util.tree_map(lambda e, p: e * jbeta + p * (1 - jbeta),
                                  {k: jnp.asarray(e0[k]) for k in port["g_ema"]},
                                  {k: jnp.asarray(v) for k, v in port["leaves"]["g"].items()})
    worst = max((_rel_err(v, want[k]), k) for k, v in port["g_ema"].items())
    assert worst[0] <= TOL_LEAF, worst


def test_config_matches():
    assert dataclasses.asdict(PG.GANConfig()) == dataclasses.asdict(JG.GANConfig())
    for batch in (1, 8, 32):
        assert PG.GANConfig().ema_beta(batch) == JG.GANConfig().ema_beta(batch)


@pytest.mark.parametrize("p,rt", [(0.0, 1.0), (0.5, 1.0), (0.5, 0.0), (0.2, 0.6), (1.0, 0.9),
                                  (0.0, -0.4), (0.123456789, 0.7)])
@pytest.mark.parametrize("batch", [8, 32])
def test_adjust_ada_p(p, rt, batch):
    """Bitwise spi_tpu's (float32 arithmetic)."""
    cfg = PG.GANConfig()
    assert PG.adjust_ada_p(p, rt, cfg, batch) == JG.adjust_ada_p(p, rt, JG.GANConfig(), batch)


def test_losses():
    rng = np.random.RandomState(4)
    real, gen = (rng.randn(5, 1).astype(np.float32) * 3 for _ in range(2))
    assert float(PG.logistic_g_loss(_t(gen))) == pytest.approx(
        float(JG.logistic_g_loss(jnp.asarray(gen))), rel=1e-6)
    assert float(PG.logistic_d_loss(_t(real), _t(gen))) == pytest.approx(
        float(JG.logistic_d_loss(jnp.asarray(real), jnp.asarray(gen))), rel=1e-6)


def test_trainer_rejects_a_module_elsewhere():
    g, d = port_modules()
    with pytest.raises(ValueError, match="the trainer on"):
        PG.GANTrainer(g, d.to("meta"), device="cpu")


def test_own_draws_run():
    """Without `draws` the trainer draws from its generator: two trainers of
    one seed take the same step; the pipe off, no draws are made for it."""
    results = []
    for _ in range(2):
        g, d = port_modules()
        tr = PG.GANTrainer(g, d, PG.GANConfig(**CONFIG), device="cpu", seed=4)
        real, z, c = step_inputs(BATCH, 20)
        m = tr.step(_t(real), _t(z), _t(c))
        results.append((float(m["loss_d"]), snapshot(g)["decoder.net.0.weight"]))
        draws = tr.draw(BATCH)
        assert draws["d"]["aug_gen"] is None
        tr.step(_t(real), _t(z), _t(c), draws=draws)  # handed back, None entries and all
    assert results[0][0] == results[1][0]
    np.testing.assert_array_equal(results[0][1], results[1][1])


def test_entry_points_need_a_gpu():
    """The discriminator and the trainer run on the card unless asked for
    the CPU: without a GPU their default raises."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no GPU is available"):
        DualDiscriminator(c_dim=25, **PG.TINY_DISCRIMINATOR)
    g, d = port_modules()
    with pytest.raises(RuntimeError, match="no GPU is available"):
        PG.GANTrainer(g, d)
