"""The port's entry points around the inversion, end to end on the CPU at
the tiny size: the inversion CLI's --save_video (its video file, and
run_video on the checkpoint it wrote). Their modules are held to spi_tpu
in tests/test_torch_port_outputs.py.
"""

import os

from spi_tpu_torch.cli import run_inversion, run_video
from torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_cli_save_video(tmp_path):
    """--save_video renders each tuned generator's orbit into video/<coach>/;
    run_video then reads the checkpoint the CLI wrote."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_smoke_data", os.path.join(ROOT, "tools", "make_smoke_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.make_identity(str(tmp_path / "data"), "synth0", seed=0)
    out_root = tmp_path / "out"
    results = run_inversion.main([
        "--data_root", str(tmp_path / "data"), "--data_mode", "png", "--output_root",
        str(out_root), "--device", "cpu", "--random_init", "--tiny", "--first_inv_type", "sg",
        "--first_inv_steps", "1", "--G_1_type", "pti", "--G_1_step", "1", "--save_video"])
    (coach,) = os.listdir(out_root / "video")
    video = results[0]["video"]
    assert os.path.dirname(video) == str(out_root / "video" / coach)
    assert os.path.basename(video).startswith("synth0.") and os.path.exists(video)
    out = run_video.main(["--checkpoint", str(out_root / "checkpoints" / coach / "synth0.npz"),
                          "--output", str(tmp_path / "v.mp4"), "--frames", "2", "--tiny",
                          "--device", "cpu"])
    assert out["frames"].shape == (2, 128, 128, 3)
