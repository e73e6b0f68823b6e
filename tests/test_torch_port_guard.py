"""Guards of the PyTorch/CUDA port's boundaries.

- spi_tpu_torch and chip_smoke.py import neither JAX nor the JAX
  package: the port stands alone on a machine without JAX.
- Entry points default to CUDA and raise when no GPU is present, rather
  than running on the CPU unasked.
- chip_smoke.py fails, and prints no result, without a GPU.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "spi_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "spi_tpu", "optax", "flax")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_forbidden_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    import jax.numpy as jnp\n"
                   "from spi_tpu.ops import bias_act\nfrom spi_tpu_torch import ops\n")
    assert [n for n in _imported_modules(src) if _forbidden(n)] == ["spi_tpu.ops", "jax.numpy"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_cuda):
    from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
    from spi_tpu_torch.criteria.id_loss import IDLoss
    from spi_tpu_torch.criteria.lpips import LPIPS
    from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
    from spi_tpu_torch.training.coaches import (
        CoachInputs,
        CoachSettings,
        pti_settings,
        tune_generator,
    )
    from spi_tpu_torch.training.projectors import ProjectorSettings, project
    from spi_tpu_torch.utils import camera

    with pytest.raises(RuntimeError, match="no GPU"):
        TriPlaneGenerator(tiny_test_config())
    with pytest.raises(RuntimeError, match="no GPU"):
        LPIPS(cfg=(8,), target_layers=(1,))
    g = TriPlaneGenerator(tiny_test_config(), device="cpu")
    lp = LPIPS(cfg=(8,), target_layers=(1,), device="cpu")
    for mode in ("sg", "sgw+", "mir"):
        with pytest.raises(RuntimeError, match="no GPU"):
            project(g, lp, torch.zeros(1, 3, 128, 128), camera.canonical_camera(),
                    ProjectorSettings(mode=mode, num_steps=1, w_avg_samples=2))
    for settings in (pti_settings(1), CoachSettings(num_steps=1, tv_lambda=0.1)):
        with pytest.raises(RuntimeError, match="no GPU"):
            tune_generator(g, lp, CoachInputs(torch.zeros(1, 3, 128, 128),
                                              camera.canonical_camera(),
                                              torch.zeros(1, g.num_ws, g.w_dim)),
                           settings, box_cx=BoxCXLoss(device="cpu"))
    for module in (BoxCXLoss, IDLoss):
        with pytest.raises(RuntimeError, match="no GPU"):
            module()


def test_pipeline_and_cli_raise_without_gpu(no_cuda, tmp_path):
    from spi_tpu_torch.cli import run_inversion
    from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
    from spi_tpu_torch.training.pipeline import InversionPipeline, PipelineConfig

    g = TriPlaneGenerator(tiny_test_config(), device="cpu")
    with pytest.raises(RuntimeError, match="no GPU"):
        InversionPipeline(g, PipelineConfig(output_root=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no GPU"):
        run_inversion.main(["--data_root", str(tmp_path), "--output_root", str(tmp_path),
                            "--random_init", "--tiny", "--fp32"])


def test_outputs_and_preprocess_raise_without_gpu(no_cuda, tmp_path):
    """The orbit video / shape CLI, the preprocess CLI and networks and the
    benchmark entry point default to the card and raise without one."""
    from spi_tpu_torch.cli import run_preprocess, run_video
    from spi_tpu_torch.models.perception.bisenet import BiSeNet
    from spi_tpu_torch.models.perception.face_recon import FaceReconNet
    from spi_tpu_torch.models.perception.fan import FAN
    from spi_tpu_torch.preprocess.pipeline import PreprocessModels
    from spi_tpu_torch.tools import bench

    for module in (FAN, FaceReconNet, BiSeNet, PreprocessModels.random_init):
        with pytest.raises(RuntimeError, match="no GPU"):
            module()
    ckpt = tmp_path / "a.npz"
    ckpt.write_bytes(b"")
    calls = [lambda: run_video.main(["--checkpoint", str(ckpt), "--output", "unused"]),
             lambda: run_preprocess.main(["--input_dir", str(tmp_path), "--output_dir",
                                          str(tmp_path), "--random_init"]),
             lambda: run_preprocess.main(["--input_dir", str(tmp_path), "--output_dir",
                                          str(tmp_path), "--ckpt_dir", str(tmp_path)]),
             lambda: bench.main(["--tiny"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no GPU"):
            call()


def test_editing_raises_without_gpu(no_cuda, tmp_path):
    """CLIP (at the published width and the tiny one), the ZSSGAN trainers,
    the StyleCLIP mapper and coach and both editing CLIs default to the
    card and raise without one."""
    from spi_tpu_torch.cli import generate_edit_videos, run_editing
    from spi_tpu_torch.editing import DirectionalCLIPLoss, IDE3DZSSGANTrainer, ZSSGANTrainer
    from spi_tpu_torch.editing.styleclip_mapper import LevelsMapper, StyleCLIPCoach
    from spi_tpu_torch.editing.zssgan2d import ZSSGAN2DTrainer
    from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
    from spi_tpu_torch.models.perception.clip import CLIP, tiny_test_clip, vit_b32
    from spi_tpu_torch.models.stylegan2 import Generator

    for cfg in (vit_b32(), tiny_test_clip()):
        with pytest.raises(RuntimeError, match="no GPU"):
            CLIP(cfg)
    loss = {"tiny": DirectionalCLIPLoss(CLIP(tiny_test_clip(), device="cpu"))}
    g = TriPlaneGenerator(tiny_test_config(), device="cpu")
    g2d = Generator(16, 0, 16, 16, 3, channel_base=256, channel_max=32, device="cpu")
    for cls, gen in ((ZSSGANTrainer, g), (IDE3DZSSGANTrainer, g), (ZSSGAN2DTrainer, g2d)):
        with pytest.raises(RuntimeError, match="no GPU"):
            cls(gen, loss, {"tiny": 1.0})
    with pytest.raises(RuntimeError, match="no GPU"):
        LevelsMapper(dim=16, num_ws=4)
    with pytest.raises(RuntimeError, match="no GPU"):
        StyleCLIPCoach(LevelsMapper(dim=16, num_ws=4, device="cpu"))
    calls = [lambda: run_editing.main(["--frozen_gen_ckpt", "unused", "--output_dir",
                                       str(tmp_path / "edit"), "--random_init", "--tiny"]),
             lambda: generate_edit_videos.main(["--ckpt", "unused.npz", "--out_dir",
                                                str(tmp_path / "vid"), "--source_latent",
                                                "unused.npy"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no GPU"):
            call()
    assert not any(tmp_path.iterdir())


def test_resolve_device_names_the_card(monkeypatch):
    """`cuda` resolves to the current card's index, the device a module on
    the card reports, so that the entry points' device checks agree."""
    from spi_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device() == resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_turns_tf32_off(monkeypatch):
    """The port's one precision policy: resolving a CUDA device turns TF32
    off for matmuls and cuDNN convolutions, so that every entry point
    (the CLIs, the tools, chip_smoke.py) computes float32 in float32;
    resolving the CPU leaves the flags alone."""
    from spi_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("tool", ["profile_gather", "probe_scatter", "probe_winscatter"])
def test_tools_raise_without_gpu(no_cuda, tool):
    import importlib

    mod = importlib.import_module(f"spi_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no GPU"):
        mod.run()
    with pytest.raises(RuntimeError, match="no GPU"):
        mod.main()


@pytest.mark.parametrize("mode", ["sg", "tune", "rotbbox"])
def test_step_time_raises_without_gpu(no_cuda, mode):
    from spi_tpu_torch.tools import step_time

    with pytest.raises(RuntimeError, match="no GPU"):
        step_time.main(["--mode", mode, "--steps", "1"])


def test_chip_smoke_fails_without_gpu(no_cuda, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.main([]) != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the package, it exits non-zero and
    prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
