"""The port's inversion CLI and pipeline end to end on the CPU, and their
files against spi_tpu's.

- `spi_tpu_torch.cli.run_inversion --device cpu --tiny --fp32` over
  tools/make_smoke_data.py data, SPI's RotBbox request with all four
  regularizer weights on: the results, the output tree, the npz keys,
  metric_log.txt's format and the embedding cache's reuse, as
  tests/test_cli_smoke.py checks spi_tpu's CLI;
- spi_tpu's `load_pytree` reads the port's {w, c, G} checkpoint, and the
  port reads an embedding npz that spi_tpu's pipeline wrote;
- PTIDataset (with its resume filter), the mask and image helpers and
  the perception bundle's sections against spi_tpu's;
- the parts that are not ported (--parallel_images above 1, --dataset_block
  auto) raise NotImplementedError.

Files are compared key for key and value for value (exact).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax

from spi_tpu.data import dataset as jdata
from spi_tpu.models import triplane as JT
from spi_tpu.utils.checkpoint import load_pytree
from spi_tpu_torch.cli import run_inversion
from spi_tpu_torch.data import dataset as pdata
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.training.pipeline import InversionPipeline, PipelineConfig
from spi_tpu_torch.utils.checkpoint import split_perception
from spi_tpu_torch.utils.params import extract_noise
from torch_threads import few_torch_threads  # noqa: F401

_TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _make_smoke_data(root: str, n: int):
    spec = importlib.util.spec_from_file_location(
        "make_smoke_data", os.path.join(_TOOLS, "make_smoke_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for i in range(n):
        mod.make_identity(root, f"synth{i}", seed=i)


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """One CLI run on one synthetic identity with the tiny generator."""
    data_root = str(tmp_path_factory.mktemp("smoke_data"))
    out_root = str(tmp_path_factory.mktemp("smoke_out"))
    _make_smoke_data(data_root, 1)
    argv = [
        "--data_root", data_root, "--data_mode", "png", "--output_root", out_root,
        "--device", "cpu", "--random_init", "--tiny", "--fp32",
        "--first_inv_type", "mir", "--first_inv_steps", "2",
        "--G_1_type", "RotBbox", "--G_1_step", "2",
        "--pt_rot_lambda", "0.1", "--pt_mirror_rot_lambda", "0.05", "--pt_depth_lambda", "1",
        "--pt_tv_lambda", "0.1",
        # random weights can land under the 0.05 default on step 1
        "--LPIPS_value_threshold", "-1",
        "--log_snapshot", "2",
    ]
    return data_root, out_root, argv, run_inversion.main(argv)


COACH = "RotBboxCoach_mir_2_RotBbox_2_rot_0.1_mirrorrot_0.05_depth_1.0_tv_0.1"


def test_cli_results(smoke_run):
    *_, results = smoke_run
    assert len(results) == 1
    r = results[0]
    assert r["name"] == "synth0" and r["steps_run"] == 2
    assert tuple(r["w"].shape) == (1, 8, 32)
    for key in ("l2", "lpips", "id", "l2_m", "lpips_m", "id_m"):
        assert np.isfinite(r["metrics"][key]), (key, r["metrics"])


def test_cli_output_tree(smoke_run):
    _, out_root, _, _ = smoke_run
    assert {"checkpoints", "embedding", "experiments", "image", "image_m"} <= set(
        os.listdir(out_root))
    assert os.listdir(os.path.join(out_root, "checkpoints")) == [COACH]
    for sub, name in (("checkpoints", "synth0.npz"), ("embedding", "synth0.npz"),
                      ("image", "synth0.jpg"), ("image_m", "synth0.jpg"),
                      ("image", "synth0_step0.jpg")):  # --log_snapshot 2: step 0
        assert os.path.exists(os.path.join(out_root, sub, COACH, name)), (sub, name)
    with open(os.path.join(out_root, "experiments", "metric_log.txt")) as f:
        lines = f.read().splitlines()
    assert lines[:4] == [f"Coach name: {COACH}", "first_inv_type: mir", "first_inv_steps: 2",
                         "G_1_step: 2"]
    assert lines[5] == "Mode: G1_inv" and lines[7] == "Mode: G1_inv AVG"
    assert lines[6].startswith("ID: 0 l2: ") and lines[6].endswith(";")
    assert [p.split(":")[0].strip() for p in lines[8].rstrip(";").split(";")] == [
        "l2", "lpips", "id", "l2_m", "lpips_m", "id_m"]


def test_cli_npz_keys(smoke_run):
    """The checkpoint holds w, c and G.<spi_tpu's pytree path> for every
    weight and buffer; the embedding w and noise/<buffer name>."""
    _, out_root, _, _ = smoke_run
    shapes = jax.eval_shape(JT.tiny_test_config().init, jax.random.PRNGKey(0))
    g_keys = {"G." + ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with np.load(os.path.join(out_root, "checkpoints", COACH, "synth0.npz")) as ck:
        assert set(ck.files) == {"w", "c"} | g_keys
        assert ck["w"].shape == (1, 8, 32) and ck["c"].shape == (1, 25)
    noise = extract_noise(TriPlaneGenerator(tiny_test_config(), device="cpu"))
    with np.load(os.path.join(out_root, "embedding", COACH, "synth0.npz")) as emb:
        assert set(emb.files) == {"w"} | {f"noise/{k}" for k in noise}


def test_spi_tpu_reads_the_port_checkpoint(smoke_run):
    _, out_root, _, _ = smoke_run
    path = os.path.join(out_root, "checkpoints", COACH, "synth0.npz")
    like = {"w": np.zeros((1, 8, 32), np.float32), "c": np.zeros((1, 25), np.float32),
            "G": jax.eval_shape(JT.tiny_test_config().init, jax.random.PRNGKey(0))}
    tree = load_pytree(path, like=like)
    with np.load(path) as ck:
        np.testing.assert_array_equal(np.asarray(tree["w"]), ck["w"])
        synth = tree["G"]["backbone"]["synthesis"]
        key = next(k for k in ck.files if k.startswith("G.backbone.synthesis.b4.conv1."))
        leaf = synth["b4"]["conv1"][key.rsplit(".", 1)[1]]
        np.testing.assert_array_equal(np.asarray(leaf), ck[key])


def test_cli_embedding_cache_reuse(smoke_run):
    """A second run pointed at the first run's embeddings reuses the cached
    w and noise (base_coach.py:66-79): with no tuning, its w is the cached
    pivot."""
    data_root, out_root, argv, _ = smoke_run
    with np.load(os.path.join(out_root, "embedding", COACH, "synth0.npz")) as cached:
        w = cached["w"]
    results = run_inversion.main(list(argv) + ["--load_embedding_coach_name", COACH,
                                               "--G_1_step", "0"])
    np.testing.assert_array_equal(np.asarray(results[0]["w"]), w)


def test_port_reads_a_spi_tpu_embedding(tmp_path, monkeypatch):
    """spi_tpu's pipeline writes an embedding npz (its get_inversion, with
    the projection replaced by fixed values); the port's get_inversion
    reads the same w and noise maps from it."""
    from spi_tpu.training import pipeline as jpipe

    pg = TriPlaneGenerator(tiny_test_config(), device="cpu")
    rng = np.random.RandomState(3)
    w = rng.randn(1, pg.num_ws, pg.w_dim).astype(np.float32)
    noise = {k: rng.randn(*v.shape).astype(np.float32) for k, v in extract_noise(pg).items()}
    monkeypatch.setattr(jpipe.projectors, "project",
                        lambda *a, **k: (jax.numpy.asarray(w),
                                         {n: jax.numpy.asarray(v) for n, v in noise.items()},
                                         None))
    jcfg = jpipe.PipelineConfig(output_root=str(tmp_path), first_inv_type="mir")
    stub = {"lpips": {"unused": 0}, "boxcx": {"unused": 0}, "metric": {"unused": 0}}
    jp = jpipe.InversionPipeline(JT.tiny_test_config(), None, jcfg, stub)
    sample = jdata.InversionSample(name="synth7", image=np.zeros((1, 3, 128, 128), np.float32),
                                   camera=np.zeros((1, 25), np.float32))
    jp.get_inversion(sample, jax.random.PRNGKey(0))

    cfg = PipelineConfig(output_root=str(tmp_path), first_inv_type="mir",
                         load_embedding_coach_name=jcfg.coach_name)
    assert cfg.coach_name == jcfg.coach_name and cfg.dirs() == jcfg.dirs()
    pp = InversionPipeline(pg, cfg, device="cpu")
    got_w, got_noise = pp.get_inversion(pdata.InversionSample(
        name="synth7", image=sample.image, camera=sample.camera), pp.image_rng("synth7"))
    np.testing.assert_array_equal(got_w.numpy(), w)
    assert set(got_noise) == set(noise)
    for k, v in noise.items():
        np.testing.assert_array_equal(got_noise[k].numpy(), v)


@pytest.fixture(scope="module")
def data_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data_tree"))
    _make_smoke_data(root, 5)
    return root


@pytest.mark.parametrize("kwargs", [
    {}, {"dataset_block": "1/2"}, {"dataset_block": "2/2"}, {"dataset_block": "3/3"},
    {"select_range": 3}, {"filter_index": ["synth4", "synth1"]}, {"size": 128},
    {"output_root": "done"}])
def test_dataset_matches_spi_tpu(data_tree, kwargs, tmp_path):
    if "output_root" in kwargs:  # resume: synth2 and synth3 have outputs already
        for name in ("synth2", "synth3"):
            (tmp_path / f"{name}.jpg").write_bytes(b"")
        kwargs = {"output_root": str(tmp_path)}
    roots = {k: os.path.join(data_tree, d) for k, d in (
        ("source_root", "crop"), ("c_root", "c"), ("mask_root", "mask"), ("lm_root", "lm"))}
    jd = jdata.PTIDataset(**roots, mode="png", **kwargs)
    pd = pdata.PTIDataset(**roots, mode="png", **kwargs)
    assert pd.source_paths == jd.source_paths
    for a, b in zip(pd, jd):
        assert a.name == b.name
        for f in ("image", "camera", "mask", "landmarks"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_mask_helpers():
    parse = np.random.RandomState(0).randint(0, 19, (1, 1, 16, 16)).astype(np.float32)
    np.testing.assert_array_equal(pdata.face_mask_from_parsing(parse),
                                  jdata.face_mask_from_parsing(parse))
    np.testing.assert_array_equal(pdata.foreground_mask_from_parsing(parse),
                                  jdata.foreground_mask_from_parsing(parse))


def test_perception_bundle_sections():
    flat = {"lpips.lin.0": 1, "boxcx.vgg.features.0.weight": 2, "metric.id.facenet.x": 3}
    assert split_perception(flat) == {"lpips": {"lin.0": 1}, "boxcx": {"vgg.features.0.weight": 2},
                                      "metric": {"id.facenet.x": 3}}
    with pytest.raises(ValueError, match="outside"):
        split_perception({"vgg.features.0.weight": 0})


@pytest.mark.parametrize("flag", [["--fp32", "--parallel_images", "2"],
                                  ["--fp32", "--dataset_block", "auto"]])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        run_inversion.main(["--data_root", "unused", "--device", "cpu", "--tiny", *flag])


def test_invert_batch_raises(tmp_path):
    pg = TriPlaneGenerator(tiny_test_config(), device="cpu")
    pp = InversionPipeline(pg, PipelineConfig(output_root=str(tmp_path)), device="cpu")
    with pytest.raises(NotImplementedError, match="scale-out"):
        pp.invert_batch([None, None])
    assert isinstance(pp.image_rng("a"), torch.Generator)


def test_image_helpers(tmp_path):
    """Pixels of tensor2im, tensor2depth and save_image_grid against
    spi_tpu's, from tensors on the port's side and arrays on spi_tpu's."""
    from spi_tpu.utils import image as jimage
    from spi_tpu_torch.utils import image as pimage

    x = np.tanh(np.random.RandomState(1).randn(5, 3, 12, 10) * 1.5).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(pimage.tensor2im(torch.from_numpy(x[:1]))),
                                  np.asarray(jimage.tensor2im(x[:1])))
    depth = x[:1, :1] + 2.5
    np.testing.assert_array_equal(np.asarray(pimage.tensor2depth(torch.from_numpy(depth))),
                                  np.asarray(jimage.tensor2depth(depth)))
    pimage.save_image_grid(torch.from_numpy(x), str(tmp_path / "p.png"))
    jimage.save_image_grid(x, str(tmp_path / "j.png"))
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
