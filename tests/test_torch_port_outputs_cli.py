"""The port's entry points around the inversion, end to end on the CPU at
the tiny size: the inversion CLI's --save_video (its video file, and
run_video on the checkpoint it wrote) and the benchmark line of
tools/bench.py (one JSON line last, with bench.py's metric string and no
vs_baseline). Their modules are held to spi_tpu in
tests/test_torch_port_outputs.py.
"""

import json
import math
import os
import re

import pytest

from spi_tpu_torch.cli import run_inversion, run_video
from spi_tpu_torch.tools import bench
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


def test_bench_line_at_tiny(capsys, monkeypatch):
    """tools/bench.py --device cpu --tiny prints one JSON line last with
    bench.py's metric string, no vs_baseline, and finite positive times.
    Each stage times 1 step here (N_STEPS, 8 on the card): 2 runs of 2."""
    monkeypatch.setattr(bench, "N_STEPS", 1)
    with open(os.path.join(ROOT, "bench.py")) as f:
        metric = re.search(r'"metric": "([^"]+)"', f.read()).group(1)
    result = bench.main(["--device", "cpu", "--tiny", "--s1_steps", "1", "--s2_steps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert all(line.startswith("# ") for line in lines[:-1])
    assert json.loads(lines[-1]) == result
    assert result["metric"] == bench.METRIC == metric
    assert set(result) == {"metric", "value", "unit", "detail"} and result["unit"] == "s"
    d = result["detail"]
    assert set(d) == {"stage1_s_per_step", "stage2_s_per_step", "pipeline_scaled_s", "dtype",
                      "device"}
    assert d["dtype"] == "bfloat16" and d["device"] == "cpu"
    for v in (result["value"], d["stage1_s_per_step"], d["stage2_s_per_step"],
              d["pipeline_scaled_s"]):
        assert math.isfinite(v) and v > 0
    assert result["value"] == pytest.approx(500 * d["stage1_s_per_step"]
                                            + 1000 * d["stage2_s_per_step"])
