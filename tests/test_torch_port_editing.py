"""The port's CLIP losses (spi_tpu_torch/editing/clip_loss.py) held to
spi_tpu's: the text-side state, each image-side term's value and its
gradient to the images, and img2img_direction.

Both sides load the same perturbed tiny_test_clip weights (and, for the
texture term, a small ResNet tower), tokenize with the same stand-in
tokenizer and take the patch centres spi_tpu draws. spi_tpu's functions
run under `jax.jit`. Float32 on both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.editing.clip_loss import DirectionalCLIPLoss as JLoss
from spi_tpu_torch.cli.run_editing import CRCTokenizer
from spi_tpu_torch.editing.clip_loss import DirectionalCLIPLoss as PLoss
from spi_tpu_torch.models.perception import clip as PC
from test_torch_port_clip import RN_FIELDS, port_pair
from torch_threads import few_torch_threads  # noqa: F401

SIZE = 48  # the renders' side: the patch term crops 46 x 46 about centres in [23, 25)


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def setup():
    jm, params, pm, _ = port_pair(dataclasses.asdict(PC.tiny_test_clip()), seed=11)
    jrn, rn_params, prn, _ = port_pair(RN_FIELDS, seed=12)
    tok = CRCTokenizer(jm.vocab_size)
    jloss = JLoss(jm, cnn_model=jrn)
    ploss = PLoss(pm, cnn_model=prn)
    jstate = jloss.build_state(params, tok, "photo", "sketch")
    pstate = ploss.build_state(tok, "photo", "sketch")
    rs = np.random.RandomState(13)
    src = np.tanh(rs.randn(2, 3, SIZE, SIZE)).astype(np.float32)
    tgt = np.tanh(src + 0.5 * rs.randn(2, 3, SIZE, SIZE)).astype(np.float32)
    return {"jloss": jloss, "params": params, "rn_params": rn_params, "ploss": ploss,
            "jstate": jstate, "pstate": pstate, "src": src, "tgt": tgt}


@pytest.mark.parametrize("field", ["target_direction", "src_text_features",
                                   "target_text_features", "patch_text_directions"])
def test_build_state(setup, field):
    want = getattr(setup["jstate"], field)
    got = getattr(setup["pstate"], field)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_build_state_tokens(setup):
    np.testing.assert_array_equal(setup["pstate"].target_tokens.numpy(),
                                  np.asarray(setup["jstate"].target_tokens))
    assert setup["pstate"].patch_text_directions.shape[0] == 15


def _terms(setup):
    """{term: (spi_tpu's f(params, rn_params, src, tgt, rng), the port's
    f(src, tgt, centers))}: each loss term of the target render, and the
    full weighted sum with every term on."""
    jl, pl, js, ps = setup["jloss"], setup["ploss"], setup["jstate"], setup["pstate"]
    jall = dataclasses.replace(jl, lambda_patch=0.3, lambda_global=0.5, lambda_manifold=0.2,
                               lambda_texture=0.7)
    pall = dataclasses.replace(pl, lambda_patch=0.3, lambda_global=0.5, lambda_manifold=0.2,
                               lambda_texture=0.7)
    return {
        "direction": (lambda p, rp, s, t, r: jl.directional_loss(p, s, t, js.target_direction),
                      lambda s, t, c: pl.directional_loss(s, t, ps.target_direction)),
        "global": (lambda p, rp, s, t, r: jl.global_loss(p, t, js.target_tokens),
                   lambda s, t, c: pl.global_loss(t, ps.target_tokens)),
        "manifold": (lambda p, rp, s, t, r: jl.manifold_loss(p, s, t, js),
                     lambda s, t, c: pl.manifold_loss(s, t, ps)),
        "patch": (lambda p, rp, s, t, r: jl.patch_directional_loss(p, r, s, t, js),
                  lambda s, t, c: pl.patch_directional_loss(s, t, ps, c)),
        "texture": (lambda p, rp, s, t, r: jl.texture_loss(rp, s, t),
                    lambda s, t, c: pl.texture_loss(s, t)),
        "all": (lambda p, rp, s, t, r: jall(p, r, s, t, js, params_cnn=rp, texture_img=s),
                lambda s, t, c: pall(s, t, ps, patch_centers=c, texture_img=s)),
    }


def spi_tpu_centers(rng, n, size):
    """The patch centres spi_tpu's _random_patches draws from `rng`."""
    half = min(510, size - 2) // 2
    kx, ky = jax.random.split(rng)
    return tuple(torch.from_numpy(np.array(jax.random.randint(k, (n,), half, size - half)))
                 for k in (kx, ky))


@pytest.mark.parametrize("term", ["direction", "global", "manifold", "patch", "texture", "all"])
def test_loss_term_and_image_gradient(setup, term):
    """The value, and the gradient to both images, within 1e-4 of the
    largest entry."""
    jf, pf = _terms(setup)[term]
    rng = jax.random.PRNGKey(14)
    value, (gsrc, gtgt) = jax.jit(jax.value_and_grad(
        lambda s, t: jf(setup["params"], setup["rn_params"], s, t, rng), argnums=(0, 1)))(
        jnp.asarray(setup["src"]), jnp.asarray(setup["tgt"]))
    src = torch.from_numpy(setup["src"]).requires_grad_(True)
    tgt = torch.from_numpy(setup["tgt"]).requires_grad_(True)
    got = pf(src, tgt, spi_tpu_centers(rng, 2, SIZE))
    got.backward()
    assert abs(float(got.detach()) - float(value)) <= 1e-4 * max(abs(float(value)), 1e-6)
    for g, want in ((src.grad, gsrc), (tgt.grad, gtgt)):
        if not np.asarray(want).any():  # global: no gradient to the source render
            assert g is None or not g.any()
            continue
        assert _rel_err(g.numpy(), want) <= 1e-4


def test_no_gradient_to_clip(setup):
    pl = setup["ploss"]
    assert not any(p.requires_grad for p in pl.model.parameters())
    assert not any(p.requires_grad for p in pl.cnn_model.parameters())


def test_img2img_direction(setup):
    rs = np.random.RandomState(15)
    src = np.tanh(rs.randn(2, 3, SIZE, SIZE)).astype(np.float32)
    tgt = np.tanh(rs.randn(3, 3, SIZE, SIZE)).astype(np.float32)
    want = jax.jit(setup["jloss"].img2img_direction)(setup["params"], src, tgt)
    with torch.no_grad():
        got = setup["ploss"].img2img_direction(torch.from_numpy(src), torch.from_numpy(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.norm()), 1.0, rtol=1e-5)
