"""The port's CLIP (spi_tpu_torch/models/perception/clip.py), its tokenizer
and the prompt templates, held to spi_tpu's on the same weights and inputs.

spi_tpu's parameters are written flattened (its pytree paths, OpenAI
CLIP's state_dict names) and read by `load_flat_params` key for key; every
leaf is perturbed from its init (biases, LayerNorm and batch-norm
statistics off their constants) so that each one matters. spi_tpu's
init and towers run under `jax.jit`. Float32 on both sides.
"""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.editing import text_templates as j_templates
from spi_tpu.models.perception import clip as JC
from spi_tpu.models.perception.clip_tokenizer import Tokenizer as JTokenizer
from spi_tpu.utils.checkpoint import flatten_pytree, unflatten_to_nested
from spi_tpu_torch.editing import text_templates as p_templates
from spi_tpu_torch.models.perception import clip as PC
from spi_tpu_torch.models.perception.clip_tokenizer import Tokenizer as PTokenizer
from spi_tpu_torch.utils.checkpoint import load_flat_params, module_flat
from torch_threads import few_torch_threads  # noqa: F401

RN_FIELDS = dict(embed_dim=16, image_resolution=64, vision_layers=(1, 1, 1, 1),
                 vision_width=16, vision_patch_size=None, context_length=8, vocab_size=64,
                 transformer_width=32, transformer_heads=2, transformer_layers=1)


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30)


def perturbed_flat(params, seed):
    """spi_tpu's flattened init with every leaf moved off its init value;
    running variances stay positive."""
    rs = np.random.RandomState(seed)
    out = {}
    for k, v in sorted(flatten_pytree(params).items()):
        v = np.asarray(v, np.float32)
        if k.endswith("running_var"):
            out[k] = (0.5 + rs.rand(*v.shape)).astype(np.float32)
        elif k.endswith("logit_scale"):
            out[k] = v
        else:
            out[k] = (v + 0.1 * rs.randn(*v.shape)).astype(np.float32)
    return out


def pair(fields, seed):
    """(spi_tpu CLIP, its params, port CLIP, the flat weights): spi_tpu's
    init tree, perturbed, written flattened and loaded by the port."""
    jm = JC.CLIP(**fields)
    flat = perturbed_flat(jax.jit(jm.init)(jax.random.PRNGKey(seed)), seed)
    pm = PC.CLIP(PC.CLIPConfig(**fields), device="cpu", seed=seed + 1)
    load_flat_params(pm, flat)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_to_nested(flat))
    return jm, params, pm, flat


def port_pair(fields, seed):
    """`pair` without spi_tpu's init (which jit-compiles): the port's seeded
    weights, perturbed, read into spi_tpu's tree."""
    pm = PC.CLIP(PC.CLIPConfig(**fields), device="cpu", seed=seed)
    flat = perturbed_flat(unflatten_to_nested(module_flat(pm)), seed)
    load_flat_params(pm, flat)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten_to_nested(flat))
    return JC.CLIP(**fields), params, pm, flat


def tokens(vocab, ctx, n, seed):
    """n prompts of random length, EOT (vocab - 1) the highest id, zero padded."""
    rs = np.random.RandomState(seed)
    out = np.zeros((n, ctx), np.int32)
    for i in range(n):
        length = rs.randint(1, ctx - 1)
        out[i, :length] = rs.randint(1, vocab - 1, length)
        out[i, length] = vocab - 1
    return out


@pytest.fixture(scope="module", params=["vit", "rn"])
def model(request):
    fields = (dataclasses.asdict(PC.tiny_test_clip()) if request.param == "vit"
              else RN_FIELDS)
    jm, params, pm, flat = pair(fields, seed=3)
    res = fields["image_resolution"]
    img = np.random.RandomState(4).randn(3, 3, res, res).astype(np.float32)
    tok = tokens(fields["vocab_size"], fields["context_length"], 3, seed=5)
    # One program for the three (XLA shares the towers between them).
    want = jax.jit(lambda p, i, t: {"image": jm.encode_image(p, i), "text": jm.encode_text(p, t),
                                    "logits": jm(p, i, t)[0]})(params, img, tok)
    with torch.no_grad():
        timg, ttok = torch.from_numpy(img), torch.from_numpy(tok)
        got = {"image": pm.encode_image(timg), "text": pm.encode_text(ttok),
               "logits": pm(timg, ttok)[0]}
    return want, got, pm, flat


@pytest.mark.parametrize("what", ["image", "text", "logits"])
def test_towers_match(model, what):
    want, got, _, _ = model
    assert got[what].shape == want[what].shape
    assert _rel_err(got[what].numpy(), want[what]) <= 1e-5


def test_loads_every_key(model):
    """spi_tpu's init tree (the tiny ViT, a ResNet with layers (1, 1, 1, 1)),
    flattened, fills every key of the port's state, values equal."""
    _, _, pm, flat = model
    state = pm.state_dict()
    assert set(state) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)


def test_logits_symmetric():
    pm = PC.CLIP(PC.tiny_test_clip(), device="cpu", seed=6)
    with torch.no_grad():
        li, lt = pm(torch.randn(2, 3, 32, 32), torch.from_numpy(tokens(256, 16, 2, 7)))
    torch.testing.assert_close(li, lt.T)


def test_preprocess_gan_output_512_to_224():
    img = np.tanh(np.random.RandomState(8).randn(2, 3, 512, 512)).astype(np.float32)
    want = jax.jit(JC.preprocess_gan_output, static_argnums=1)(img, 224)
    got = PC.preprocess_gan_output(torch.from_numpy(img), 224)
    assert got.shape == (2, 3, 224, 224)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["vit_b32", "vit_b16", "rn50", "tiny_test_clip"])
def test_config_fields_match(name):
    assert dataclasses.asdict(getattr(PC, name)()) == {
        f.name: getattr(getattr(JC, name)(), f.name)
        for f in dataclasses.fields(getattr(JC, name)())}


@pytest.mark.parametrize("name", ["vit_b32", "vit_b16", "rn50"])
def test_published_width_shapes(name):
    """Every key and shape of the port's state at the published widths
    equals spi_tpu's init tree's (jax.eval_shape: no weights allocated;
    the port on the meta device)."""
    shapes = jax.eval_shape(getattr(JC, name)().init, jax.random.PRNGKey(0))
    want = {".".join(str(getattr(p, "key", p)) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k: tuple(v.shape)
           for k, v in PC.CLIP(getattr(PC, name)(), device="meta").state_dict().items()}
    assert got == want


@pytest.fixture(scope="module")
def merges_file(tmp_path_factory):
    """A synthetic merges file in the released vocabulary's format (a
    header line, then one merge a line), as tests/test_editing.py builds."""
    merges = ["#version: synthetic", "h e", "he l", "hel l", "hell o</w>", "w o", "wo r",
              "wor l", "worl d</w>", "a</w> a</w>", "s k", "sk e", "ske t", "sket c",
              "sketc h</w>", "p h", "ph o", "pho t", "phot o</w>"]
    path = tmp_path_factory.mktemp("bpe") / "vocab.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges) + "\n")
    return str(path)


def test_tokenizer_bitwise(merges_file):
    jt, pt = JTokenizer(merges_file), PTokenizer(merges_file)
    texts = (["hello world", "HELLO  World!", "a a a", "café &amp; 3 sketches",
              "it's a photo", ""]
             + j_templates.compose_text_with_templates("sketch")
             + j_templates.compose_text_with_templates("photo", j_templates.part_templates))
    for t in texts:
        assert pt.encode(t) == jt.encode(t), t
        assert pt.decode(pt.encode(t)) == jt.decode(jt.encode(t))
    for ctx in (8, 77):
        np.testing.assert_array_equal(pt.tokenize(texts, context_length=ctx),
                                      jt.tokenize(texts, context_length=ctx))
    assert pt.encoder == jt.encoder and pt.bpe_ranks == jt.bpe_ranks


def test_text_templates_equal():
    assert p_templates.imagenet_templates == j_templates.imagenet_templates
    assert p_templates.part_templates == j_templates.part_templates
    assert p_templates.imagenet_templates_small == j_templates.imagenet_templates_small
    assert len(p_templates.imagenet_templates) == 79 and len(p_templates.part_templates) == 15
    assert (p_templates.compose_text_with_templates("sketch")
            == j_templates.compose_text_with_templates("sketch"))
