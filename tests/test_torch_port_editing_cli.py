"""The port's editing CLIs on the CPU: `cli/run_editing.py` (tiny generator
and CLIP, random weights) and `cli/generate_edit_videos.py` on 2D StyleGAN2
checkpoints that spi_tpu writes, held to spi_tpu's renders."""

import os

import numpy as np
import pytest
import torch

import jax

from spi_tpu.cli import generate_edit_videos as jgev
from spi_tpu.models import stylegan2 as JS
from spi_tpu.models import triplane as JT
from spi_tpu.utils.checkpoint import load_pytree, save_pytree
from spi_tpu_torch.cli import generate_edit_videos as pgev
from spi_tpu_torch.cli import run_editing
from spi_tpu_torch.editing.zssgan import conv_mask, synthesis_mask
from spi_tpu_torch.models import stylegan2 as PS
from spi_tpu_torch.models.triplane import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz
from torch_threads import few_torch_threads  # noqa: F401

G2D = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=16, img_channels=3,
           channel_base=32768 // 2, channel_max=32)


def _edit(tmp_path, name, *extra):
    out = str(tmp_path / name)
    return out, run_editing.main(["--frozen_gen_ckpt", "unused", "--output_dir", out,
                                  "--random_init", "--tiny", "--device", "cpu",
                                  "--output_interval", "1", *extra])


@pytest.fixture(scope="module")
def edited(tmp_path_factory):
    return _edit(tmp_path_factory.mktemp("edit"), "run", "--iter", "2")


def test_run_editing_writes_samples_and_checkpoint(edited):
    out, res = edited
    assert sorted(os.listdir(os.path.join(out, "sample"))) == ["dst_000000.jpg",
                                                               "dst_000001.jpg"]
    assert res["samples"] == [os.path.join(out, "sample", f) for f in
                              ("dst_000000.jpg", "dst_000001.jpg")]
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert res["checkpoint"] == os.path.join(out, "checkpoint", "final.npz")


def test_final_checkpoint_reads_in_both_packages(edited):
    """spi_tpu's load_pytree(like=its tiny init) reads final.npz key for
    key; the port's generator loads it; only the conv leaves moved from
    the seed-0 weights the run started from."""
    _, res = edited
    like = jax.eval_shape(JT.tiny_test_config().init, jax.random.PRNGKey(0))
    tree = load_pytree(res["checkpoint"], like=like)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(like)
    flat = load_npz(res["checkpoint"])
    g = TriPlaneGenerator(tiny_test_config(), device="cpu")
    load_flat_params(g, flat)
    start = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=0).state_dict()
    mask = conv_mask(g)
    moved = {k for k, v in flat.items() if not np.array_equal(v, start[k].numpy())}
    assert moved and moved <= mask


def test_run_editing_ide3d_from_a_train_checkpoint(tmp_path, edited):
    """--ide3d trains ToRGB too; --train_gen_ckpt starts the trainable twin
    from a file (the last run's), the frozen one from seed 0."""
    _, first = edited
    _, res = _edit(tmp_path, "ide3d", "--iter", "1", "--ide3d", "--train_gen_ckpt",
                   first["checkpoint"])
    trainer = res["trainer"]
    before = load_npz(first["checkpoint"])
    after = load_npz(res["checkpoint"])
    moved = {k for k in after if not np.array_equal(after[k], before[k])}
    assert any(".torgb." in k for k in moved) and moved <= synthesis_mask(trainer.trainable)
    start = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=0).state_dict()
    for k, v in trainer.frozen.state_dict().items():
        torch.testing.assert_close(v, start[k], rtol=0, atol=0)


def test_run_editing_needs_a_vocabulary(tmp_path):
    with pytest.raises(SystemExit, match="bpe_path"):
        run_editing.main(["--frozen_gen_ckpt", str(tmp_path / "g.npz"), "--output_dir",
                          str(tmp_path), "--tiny", "--device", "cpu"])


def test_crc_tokenizer_is_reproducible():
    tok = run_editing.CRCTokenizer(49408)
    out = tok.tokenize(["a photo of a face", "sketch"], context_length=77)
    assert out[0, 0] == 1 and out[0, 6] == 49407 and out[1, 2] == 49407
    assert np.array_equal(out, run_editing.CRCTokenizer(49408).tokenize(
        ["a photo of a face", "sketch"]))
    assert out.max() == 49407 and (out[0, 1:6] < 40002).all()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two 16^2 2D generators spi_tpu writes, and a source latent."""
    root = tmp_path_factory.mktemp("gev")
    gen = JS.Generator(**G2D)
    paths = []
    for seed in (0, 1):
        path = str(root / f"domain{seed}.npz")
        save_pytree(path, jax.jit(gen.init)(jax.random.PRNGKey(seed)))
        paths.append(path)
    lat = str(root / "latent.npy")
    np.save(lat, np.random.default_rng(0).normal(size=(1, gen.num_ws, 16)).astype(np.float32))
    return gen, paths, lat, root


def _jax_images(gen, paths, latents):
    """spi_tpu's render_frames before the uint8 conversion."""
    params = [load_pytree(p) for p in paths]
    synth = jax.jit(lambda p, ws: gen.synthesis(p["synthesis"], ws, noise_mode="const"))
    ws = np.concatenate(latents, axis=0)
    if len(params) == 1:
        return np.concatenate([np.asarray(synth(params[0], ws[i:i + 8]))
                               for i in range(0, len(ws), 8)])
    seg_len = len(ws) / (len(params) - 1)
    out = []
    for i in range(len(ws)):
        seg = int(i // seg_len)
        mixed = jgev.lerp_trees(params[seg], params[seg + 1], (i % seg_len) / seg_len)
        out.append(np.asarray(synth(mixed, ws[i:i + 1])))
    return np.concatenate(out)


@pytest.mark.parametrize("n_ckpt", [1, 2])
def test_render_images_match_spi_tpu(ckpts, n_ckpt):
    gen, paths, lat, _ = ckpts
    latents = [np.load(lat)] * 10
    g = PS.Generator(**G2D, device="cpu")
    params = []
    for p in paths[:n_ckpt]:
        flat = load_npz(p)
        load_flat_params(g, flat)
        params.append({k: torch.from_numpy(v) for k, v in flat.items()})
    got = pgev.render_images(g, params, latents)
    want = _jax_images(gen, paths[:n_ckpt], latents)
    assert got.shape == want.shape == (10, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_main_single_and_blended(ckpts):
    """One checkpoint, then four (the combined video's square grid; the
    blended video lerps weights across three segments): the files, and
    the frames against spi_tpu's render_frames."""
    gen, paths, lat, root = ckpts
    for ckpt in ([paths[0]], [paths[0], paths[1], paths[1], paths[0]]):
        out = str(root / f"vid{len(ckpt)}")
        res = pgev.main(["--size", "16", "--channel_multiplier", "1", "--channel_max", "32",
                         "--latent_dim", "16", "--ckpt", *ckpt, "--out_dir", out,
                         "--source_latent", lat, "--unedited_frames", "6", "-f",
                         "--device", "cpu"])
        assert all(os.path.exists(v) for v in res["videos"])
        assert len(res["videos"]) == len(ckpt) + (1 if len(ckpt) == 1 else 2)
        params = [load_pytree(p) for p in ckpt]
        checks = [(res["frames"][0], jgev.render_frames(gen, params[:1], [np.load(lat)] * 6))]
        if len(ckpt) > 1:
            checks.append((res["blended"], jgev.render_frames(gen, params, [np.load(lat)] * 6)))
        for got, want in checks:
            assert len(got) == len(want) == 6
            for a, b in zip(got, want):  # uint8: a value on a level's boundary may flip
                assert a.shape == (16, 16, 3)
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_main_base_ckpt_overlay(ckpts):
    """--base_ckpt fills the keys an editing checkpoint omits: a file with
    only the synthesis convolutions of one domain over the other as base
    renders as the two merged into one file; without the base it is
    refused."""
    _, paths, lat, root = ckpts
    base, full = load_npz(paths[0]), load_npz(paths[1])
    part = {k: v for k, v in full.items() if ".conv" in k}
    np.savez(str(root / "convs_only.npz"), **part)
    np.savez(str(root / "merged.npz"), **{**base, **part})
    args = ["--size", "16", "--channel_multiplier", "1", "--channel_max", "32", "--latent_dim",
            "16", "--source_latent", lat, "--unedited_frames", "2", "-f", "--device", "cpu"]
    got = pgev.main(args + ["--ckpt", str(root / "convs_only.npz"), "--base_ckpt", paths[0],
                            "--out_dir", str(root / "overlay")])
    want = pgev.main(args + ["--ckpt", str(root / "merged.npz"), "--out_dir",
                             str(root / "merged")])
    for a, b in zip(got["frames"][0], want["frames"][0]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="missing"):
        pgev.main(args + ["--ckpt", str(root / "convs_only.npz"), "--out_dir",
                          str(root / "refused")])
