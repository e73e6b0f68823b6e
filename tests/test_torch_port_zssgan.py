"""The port's editing trainers (spi_tpu_torch/editing/{zssgan,zssgan2d,
styleclip_mapper}.py) and random noise through the synthesis, held to
spi_tpu's on the same weights and the same random draws.

tiny_test_config twins and tiny_test_clip, perturbed, load from spi_tpu's
flattened trees. The noise strengths are 1: at a first step the twins
differ only by their noise, and the directional loss normalizes the
difference of their CLIP embeddings, so that weak noise would make that
difference small and grow either package's float32 error by the ratio. Every draw of a step (z, each render's noise maps and renderer
draws) is spi_tpu's, split from its keys as its step splits them, and
handed to the port's `step`. spi_tpu's steps run jitted. A step's
gradient of every trained leaf is read from spi_tpu's Adam state: with
beta1 = 0 its first moment is the last gradient. Float32 on both sides.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.editing import styleclip_mapper as JSM
from spi_tpu.editing import zssgan as JZ
from spi_tpu.editing import zssgan2d as JZ2
from spi_tpu.editing.clip_loss import DirectionalCLIPLoss as JLoss
from spi_tpu.models import stylegan2 as JS
from spi_tpu.models import triplane as JT
from spi_tpu.utils import camera as jcam
from spi_tpu.utils.checkpoint import flatten_pytree, unflatten_to_nested
from spi_tpu_torch.cli.run_editing import CRCTokenizer
from spi_tpu_torch.editing import styleclip_mapper as PSM
from spi_tpu_torch.editing import zssgan as PZ
from spi_tpu_torch.editing import zssgan2d as PZ2
from spi_tpu_torch.editing.clip_loss import DirectionalCLIPLoss as PLoss
from spi_tpu_torch.models import stylegan2 as PS
from spi_tpu_torch.models import triplane as PT
from spi_tpu_torch.models.perception import clip as PC
from spi_tpu_torch.utils import camera as pcam
from spi_tpu_torch.utils.checkpoint import load_flat_params, module_flat
from test_torch_port_clip import port_pair
from torch_threads import few_torch_threads  # noqa: F401

TOL_GRAD = 2e-3  # the float32 backward's bound (ROADMAP Queue 3)
G2D = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=16, img_channels=3, channel_base=256,
           channel_max=32)


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a):
    return torch.from_numpy(np.array(a))


def with_noise_strength(params, value=1.0):
    return jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, value) if "noise_strength" in jax.tree_util.keystr(p)
        else v, params)


def noise_draws(net, rng, n, prefix=""):
    """The noise maps spi_tpu's SynthesisNetwork draws from `rng` under
    noise_mode='random' (stylegan2.py:319, 391-395), keyed like noise_const."""
    out = {}
    for res, brng in zip(net.block_resolutions, jax.random.split(rng, len(net.block_resolutions))):
        convs = ("conv1",) if res == 4 else ("conv0", "conv1")
        for conv, k in zip(convs, jax.random.split(brng, 2)):
            out[f"{prefix}b{res}.{conv}.noise_const"] = _t(jax.random.normal(k, (n, 1, res, res)))
    return out


def render_draws(jg, rng, n):
    """What spi_tpu's synthesis(rng, noise_mode='random') draws: the noise
    from its second key, the renderer's from its first (triplane.py:221,
    260, renderer.py:421)."""
    rng_rest, rng_noise = jax.random.split(rng)
    rc, rf, _ = jax.random.split(jax.random.split(rng_rest)[0], 3)
    m = jg.neural_rendering_resolution ** 2
    rend = jg.rendering
    return {"noise": noise_draws(jg.synthesis_net, rng_noise, n, "backbone.synthesis."),
            "stratified": _t(jax.random.uniform(rc, (n, m, rend.depth_resolution, 1))),
            "exponential": _t(jax.random.exponential(
                rf, (n * m, rend.depth_resolution_importance + 1)))}


def step_draws(jg, rng, batch):
    """make_step's draws (zssgan.py:152-157)."""
    kz, kn1, kn2, _ = jax.random.split(rng, 4)
    return {"w": {"z": _t(jax.random.normal(kz, (batch, jg.z_dim)))},
            "frozen": render_draws(jg, kn1, batch), "trainable": render_draws(jg, kn2, batch)}


def seeded_tree(module):
    """A port module's seeded weights as spi_tpu's parameter tree, noise
    strengths 1 (cheaper than spi_tpu's init, which jit-compiles)."""
    return with_noise_strength(jax.tree_util.tree_map(
        jnp.asarray, unflatten_to_nested(module_flat(module))))


@pytest.fixture(scope="module")
def setup():
    jg = JT.tiny_test_config()
    params = seeded_tree(PT.TriPlaneGenerator(PT.tiny_test_config(), device="cpu", seed=0))
    flat = flatten_pytree(params)
    jm, clip_params, pm, _ = port_pair(dataclasses.asdict(PC.tiny_test_clip()), seed=21)
    tok = CRCTokenizer(jm.vocab_size)
    # spi_tpu's text states, built once: every trainer here has the same
    # CLIP model, prompts and tokenizer.
    jstates = {"tiny": JLoss(jm).build_state(clip_params, tok, "photo", "sketch")}
    return {"jg": jg, "params": params, "flat": flat, "jm": jm, "clip_params": clip_params,
            "pm": pm, "tok": tok, "jstates": jstates}


def jax_trainer(setup, cls=JZ.ZSSGANTrainer, **settings):
    tr = cls(generator=setup["jg"], clip_losses={"tiny": JLoss(setup["jm"])},
             clip_weights={"tiny": 1.0}, settings=JZ.EditingSettings(**settings))
    return tr, setup["jstates"]


def port_trainer(setup, cls=PZ.ZSSGANTrainer, **settings):
    g = PT.TriPlaneGenerator(PT.tiny_test_config(), device="cpu", seed=5)
    load_flat_params(g, setup["flat"])
    tr = cls(g, {"tiny": PLoss(setup["pm"])}, {"tiny": 1.0}, PZ.EditingSettings(**settings),
             device="cpu")
    tr.build_states(setup["tok"])
    return tr


def true_keys(mask_tree):
    return {k for k, v in flatten_pytree(mask_tree).items() if bool(v)}


@pytest.mark.parametrize("mask", ["conv_mask", "synthesis_mask"])
def test_masks_are_spi_tpus(setup, mask):
    g = PT.TriPlaneGenerator(PT.tiny_test_config(), device="cpu")
    want = true_keys(getattr(JZ, mask)(setup["params"]))
    assert getattr(PZ, mask)(g) == want
    assert any(k.endswith("affine.weight") for k in want)
    assert any(k.endswith("noise_strength") for k in want)


def test_conv_mask_2d_is_spi_tpus():
    gen = JS.Generator(**G2D)
    g = PS.Generator(**G2D, device="cpu")
    want = true_keys(JZ2.conv_mask_2d(jax.eval_shape(gen.init, jax.random.PRNGKey(0))))
    assert PZ2.conv_mask_2d(g) == want and "synthesis.b4.const" in want


def start_from(ptr, params, opt_state):
    """The port's trained weights and Adam moments set to spi_tpu's."""
    flat, mu, nu = (flatten_pytree(t) for t in (params, opt_state[0].mu, opt_state[0].nu))
    with torch.no_grad():
        for k, p in ptr.trainable.named_parameters():
            if k in ptr.mask:
                p.copy_(_t(flat[k]))
                state = ptr.optimizer.state[p]
                state["exp_avg"].copy_(_t(mu[k]))
                state["exp_avg_sq"].copy_(_t(nu[k]))


def run_steps(setup, jtr, jstates, ptr, keys):
    """spi_tpu's step and the port's on the same draws, one per key. A step
    after the first starts the port from spi_tpu's weights and Adam
    moments: Adam divides each gradient element by its magnitude plus
    1e-8, so that float32 noise in an element near 1e-8 becomes a whole
    step of difference and two runs part. Returns each step's
    {'loss', 'grads', 'leaves', 'before'} for spi_tpu and {'loss',
    'grads', 'leaves'} for the port."""
    step = jtr.make_step(frozen_params=setup["params"])
    params, opt_state = setup["params"], jtr.init_opt_state(setup["params"])
    out = []
    for i, key in enumerate(keys):
        if i:
            start_from(ptr, params, opt_state)
        before = (params, opt_state)
        params, opt_state, loss = step(params, opt_state, {"tiny": setup["clip_params"]},
                                       jstates, key)
        port = {"loss": float(ptr.step(step_draws(setup["jg"], key, jtr.settings.batch)))}
        port["grads"] = {k: p.grad.clone() for k, p in ptr.trainable.named_parameters()
                         if p.grad is not None}
        port["leaves"] = {k: v.clone() for k, v in ptr.trainable.state_dict().items()}
        out.append(({"loss": float(loss), "grads": flatten_pytree(opt_state[0].mu),
                     "leaves": flatten_pytree(params), "before": before}, port))
    return out


def check_steps(setup, jtr, ptr, out):
    """Each step against spi_tpu's: the loss; every trained leaf's gradient
    within TOL_GRAD of its largest entry; the trained leaves after the
    step equal to spi_tpu's own optimizer (optax) applied to the port's
    gradient from the state the step started from (the optimizers'
    float32 operations come in other orders; a leaf is not compared with
    spi_tpu's updated leaf for the division by |g| + 1e-8 that
    `run_steps` gives). Every leaf that is not trained bitwise unchanged
    on both sides, the frozen twin too."""
    trained = {k for k, _ in ptr.trainable.named_parameters() if k in ptr.mask}
    opt = jtr.settings.adam
    apply = jax.jit(lambda g, o, p: optax.apply_updates(p, opt.update(g, o, p)[0]))
    for jax_step, port in out:
        assert abs(port["loss"] - jax_step["loss"]) <= 1e-4 * abs(jax_step["loss"])
        assert set(port["grads"]) == trained
        params, opt_state = jax_step["before"]
        grads = unflatten_to_nested({  # spi_tpu's masked gradient tree, with the port's values
            k: port["grads"][k].numpy() if k in trained else np.zeros_like(v)
            for k, v in flatten_pytree(params).items()})
        want = flatten_pytree(apply(grads, opt_state, params))
        for k in trained:
            assert _rel_err(port["grads"][k].numpy(), jax_step["grads"][k]) <= TOL_GRAD, k
            assert _rel_err(port["leaves"][k].numpy(), want[k]) <= 1e-5, k
        for k, v in setup["flat"].items():
            if k not in ptr.mask:
                np.testing.assert_array_equal(port["leaves"][k].numpy(), v, err_msg=k)
                np.testing.assert_array_equal(jax_step["leaves"][k], v, err_msg=k)
    assert any(not np.array_equal(out[-1][1]["leaves"][k].numpy(), setup["flat"][k])
               for k in trained)
    for k, v in ptr.frozen.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), setup["flat"][k], err_msg=k)


def test_two_zssgan_steps(setup):
    jtr, jstates = jax_trainer(setup, batch=2)
    ptr = port_trainer(setup, batch=2)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    out = run_steps(setup, jtr, jstates, ptr, keys)
    check_steps(setup, jtr, ptr, out)
    assert any(k.endswith("noise_strength") for k in out[0][1]["grads"])


def test_ide3d_step(setup):
    jtr, jstates = jax_trainer(setup, JZ.IDE3DZSSGANTrainer, batch=2)
    ptr = port_trainer(setup, PZ.IDE3DZSSGANTrainer, batch=2)
    out = run_steps(setup, jtr, jstates, ptr, [jax.random.PRNGKey(8)])
    check_steps(setup, jtr, ptr, out)
    torgb = [k for k in ptr.mask if ".torgb." in k]
    assert torgb and any(not np.array_equal(out[0][1]["leaves"][k].numpy(), setup["flat"][k])
                         for k in torgb)


def test_rank_w_slots(setup):
    jtr, jstates = jax_trainer(setup, auto_layer_iters=2, auto_layer_batch=2)
    ptr = port_trainer(setup, auto_layer_iters=2, auto_layer_batch=2)
    rng = jax.random.PRNGKey(9)
    want = jtr.rank_w_slots(setup["params"], {"tiny": setup["clip_params"]}, jstates, rng,
                            setup["params"])
    kz, kr = jax.random.split(rng)
    got = ptr.rank_w_slots({"w": {"z": _t(jax.random.normal(kz, (2, setup["jg"].z_dim)))},
                            "render": render_draws(setup["jg"], kr, 2)})
    assert got.shape == (ptr.frozen.num_ws,)
    assert _rel_err(got.numpy(), want) <= TOL_GRAD


def test_random_noise_synthesis(setup):
    """noise_mode='random' through the whole synthesis on spi_tpu's noise."""
    jg, params = setup["jg"], setup["params"]
    g = PT.TriPlaneGenerator(PT.tiny_test_config(), device="cpu")
    load_flat_params(g, setup["flat"])
    ws = np.random.RandomState(10).randn(2, jg.num_ws, jg.w_dim).astype(np.float32) * 0.5
    rng = jax.random.PRNGKey(11)
    cams = jcam.canonical_camera(batch_size=2)
    want = jax.jit(lambda w: jg.synthesis(params, rng, w, cams, noise_mode="random"))(ws)
    with torch.no_grad():
        got = g.synthesis(_t(ws), pcam.canonical_camera(batch_size=2), noise_mode="random",
                          draws=render_draws(jg, rng, 2))
        const = g.synthesis(_t(ws), pcam.canonical_camera(batch_size=2),
                            draws=render_draws(jg, rng, 2))
    for k in ("image", "image_raw", "image_depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4)
    assert not torch.allclose(got["image"], const["image"], atol=1e-3)


@pytest.mark.parametrize("mixing_prob", [0.0, 1.0])
def test_zssgan2d_step(setup, mixing_prob):
    gen = JS.Generator(**G2D)
    g = PS.Generator(**G2D, device="cpu")
    PS.seeded_init(g, 1)
    params = seeded_tree(g)
    flat = flatten_pytree(params)
    jtr = JZ2.ZSSGAN2DTrainer(generator=gen, clip_losses={"tiny": JLoss(setup["jm"])},
                              clip_weights={"tiny": 1.0}, settings=JZ.EditingSettings(batch=2),
                              mixing_prob=mixing_prob)
    jstates = setup["jstates"]
    load_flat_params(g, flat)
    ptr = PZ2.ZSSGAN2DTrainer(g, {"tiny": PLoss(setup["pm"])}, {"tiny": 1.0},
                              PZ.EditingSettings(batch=2), device="cpu", mixing_prob=mixing_prob)
    ptr.build_states(setup["tok"])
    key = jax.random.PRNGKey(12)
    _, opt_state, loss = jtr.make_step(params)(params, jtr.init_opt_state(params),
                                               {"tiny": setup["clip_params"]}, jstates, key)
    kz, kn1, kn2, _ = jax.random.split(key, 4)
    kz1, kz2, kmix, kidx = jax.random.split(kz, 4)
    w_draws = {"z1": _t(jax.random.normal(kz1, (2, 16))), "z2": _t(jax.random.normal(kz2, (2, 16))),
               "mix": _t(jax.random.uniform(kmix, (2, 1, 1))).reshape(2),
               "cross": _t(jax.random.randint(kidx, (2, 1, 1), 1, gen.num_ws)).reshape(2)}
    pl = ptr.step({"w": w_draws, "frozen": {"noise": noise_draws(gen.synthesis, kn1, 2)},
                   "trainable": {"noise": noise_draws(gen.synthesis, kn2, 2)}})
    assert abs(float(pl) - float(loss)) <= 1e-4 * abs(float(loss))
    mu = flatten_pytree(opt_state[0].mu)
    grads = {k: p.grad for k, p in ptr.trainable.named_parameters() if p.grad is not None}
    assert "synthesis.b4.const" in grads
    for k, gr in grads.items():
        assert _rel_err(gr.numpy(), mu[k]) <= TOL_GRAD, k
    for k, v in ptr.trainable.state_dict().items():
        if k not in ptr.mask:
            np.testing.assert_array_equal(v.numpy(), flat[k], err_msg=k)
    if mixing_prob:  # the crossover changed the w codes
        ws = ptr.sample_w(w_draws)
        assert not torch.equal(ws, ptr.sample_w({**w_draws, "mix": torch.ones(2)}))


def test_levels_mapper_forward():
    jm = JSM.LevelsMapper(dim=16, num_ws=14)
    params = jm.init(jax.random.PRNGKey(0))
    pm = PSM.LevelsMapper(dim=16, num_ws=14, device="cpu")
    load_flat_params(pm, flatten_pytree(params))
    w = np.random.RandomState(1).randn(2, 14, 16).astype(np.float32)
    with torch.no_grad():
        got = pm(_t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jm)(params, w)), rtol=1e-5,
                               atol=1e-5)
    coarse_only = PSM.LevelsMapper(dim=16, num_ws=14, use_medium=False, use_fine=False,
                                   device="cpu")
    assert set(coarse_only.state_dict()) == set(flatten_pytree(
        JSM.LevelsMapper(dim=16, num_ws=14, use_medium=False, use_fine=False)
        .init(jax.random.PRNGKey(0))))
    with torch.no_grad():
        assert not coarse_only(_t(w))[:, 4:].any()


def test_styleclip_coach_step(setup):
    """One coach step with the ID term on: the loss and every mapper
    gradient (spi_tpu's Adam first moment / 0.1)."""
    jmap = JSM.LevelsMapper(dim=16, num_ws=4)
    m_params = jmap.init(jax.random.PRNGKey(1))
    settings = JSM.StyleCLIPSettings(batch=1, id_lambda=0.1)
    coach = JSM.StyleCLIPCoach(jmap, settings)
    jm, clip_params = setup["jm"], setup["clip_params"]
    tok = jnp.asarray(setup["tok"].tokenize(["a sketch"], context_length=jm.context_length))

    def jrender(g_params, rng, ws):
        return jnp.tanh(jnp.mean(ws) + jax.random.normal(rng, (ws.shape[0], 3, 32, 32)) * 0.01)

    def jclip(cp, img, tokens):
        from spi_tpu.models.perception.clip import preprocess_gan_output

        logits, _ = jm(cp, preprocess_gan_output(img, 32), tokens)
        return jnp.mean(1.0 - logits / 100.0)

    def jid(id_params, a, b):
        return jnp.mean(jnp.square(a - b))

    ws = jax.random.normal(jax.random.PRNGKey(2), (1, 4, 16))
    rng = jax.random.PRNGKey(3)
    _, opt_state, loss = jax.jit(coach.make_step(jrender, jclip, jid))(
        m_params, coach.optimizer().init(m_params), None, clip_params, tok, None, ws, rng)

    pmap = PSM.LevelsMapper(dim=16, num_ws=4, device="cpu")
    load_flat_params(pmap, flatten_pytree(m_params))
    pcoach = PSM.StyleCLIPCoach(pmap, PSM.StyleCLIPSettings(batch=1, id_lambda=0.1),
                                device="cpu")
    noise = [_t(jax.random.normal(k, (1, 3, 32, 32))) for k in jax.random.split(rng)]

    def prender(w):
        return torch.tanh(w.mean() + noise.pop(0) * 0.01)

    def pclip(img, tokens):
        logits, _ = setup["pm"](PC.preprocess_gan_output(img, 32), tokens)
        return (1.0 - logits / 100.0).mean()

    ploss = pcoach.step(prender, pclip, torch.from_numpy(np.array(tok)), _t(ws),
                        id_loss=lambda a, b: (a - b).square().mean())
    assert not noise  # both renders ran
    assert abs(float(ploss) - float(loss)) <= 1e-4 * abs(float(loss))
    mu = flatten_pytree(opt_state[0].mu)
    for k, p in pmap.named_parameters():
        assert _rel_err(p.grad.numpy(), np.asarray(mu[k]) / 0.1) <= 1e-3, k
