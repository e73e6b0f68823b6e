"""spi_tpu_torch's preprocess orchestration on the CPU: `run_total`'s
failure records, and the preprocess CLI (`cli/run_preprocess.py`) end to
end with random weights and with npz weights. `run_total` against
spi_tpu's is in tests/test_torch_port_preprocess.py, beside the networks
whose JAX programs it shares.

The photo is a synthetic 640^2 portrait-like image from a seed
(`write_photo` of spi_tpu_torch/tools/workloads.py, which chip_smoke.py
preprocesses too).
"""

import numpy as np
import torch
from PIL import Image

from spi_tpu.models.perception import fan as JF
from spi_tpu_torch.cli import run_preprocess
from spi_tpu_torch.models.perception.face_recon import FaceReconNet
from spi_tpu_torch.models.perception.fan import FAN
from spi_tpu_torch.preprocess import pipeline as ppipe
from spi_tpu_torch.tools.workloads import write_photo
from test_torch_port_preprocess import numpy_weights
from torch_threads import few_torch_threads  # noqa: F401


def test_run_total_records_a_failure(tmp_path):
    """A file that is no image fails alone: the others are done, and the
    failure is returned, as spi_tpu's loop returns it."""
    raw = tmp_path / "raw"
    raw.mkdir()
    write_photo(raw / "a.png", seed=1, size=320)
    (raw / "b.jpg").write_bytes(b"not an image")
    models = ppipe.PreprocessModels(fan=FAN(num_modules=1, device="cpu"),
                                    face_recon=FaceReconNet(device="cpu"))
    done, failures = ppipe.run_total(str(raw), str(tmp_path / "out"), models, verbose=False)
    assert done == ["a"]
    assert [n for n, _ in failures] == ["b"] and "UnidentifiedImageError" in failures[0][1]


def test_run_preprocess_cli(tmp_path, capsys):
    """--random_init --mirror at full width: the tree the inversion CLI
    reads, with every file of the right shape."""
    raw = tmp_path / "raw"
    raw.mkdir()
    write_photo(raw / "face0.png", seed=0)
    out = tmp_path / "data"
    done, failures = run_preprocess.main(["--input_dir", str(raw), "--output_dir", str(out),
                                          "--random_init", "--mirror", "--device", "cpu"])
    assert done == ["face0"] and failures == []
    assert "preprocessed 1 images, 0 failures" in capsys.readouterr().out
    for sub in ("crop/face0/target.jpg", "crop/face0/target_m.jpg"):
        assert Image.open(out / sub).size == (512, 512)
    for sub in ("c/face0/target.npy", "c/face0/target_m.npy"):
        c = np.load(out / sub)
        assert c.shape == (25,) and c.dtype == np.float32
        np.testing.assert_allclose(np.linalg.norm(c[:16].reshape(4, 4)[:3, 3]), 2.7, rtol=1e-5)
    assert np.load(out / "lm/face0/target.npy").shape == (68, 2)
    mask = np.load(out / "mask/face0/target.npy")
    assert mask.shape == (512, 512) and mask.dtype == np.int64 and mask.max() < 19


def test_load_models_reads_npz_and_warns(tmp_path, capsys):
    """fan.npz present: its weights are loaded; the other two files are
    missing: seeded random weights and a warning for each, as spi_tpu."""
    fan = numpy_weights(JF.FAN(), 23)
    np.savez(tmp_path / "fan.npz", **fan)
    models = run_preprocess.load_models(str(tmp_path), device="cpu")
    for k, v in models.fan.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), fan[k])
    out = capsys.readouterr().out
    assert "facerecon.npz missing" in out and "bisenet.npz missing" in out
    assert "fan.npz missing" not in out
    with torch.no_grad():
        assert float(models.face_recon(torch.rand(1, 3, 64, 64)).abs().max()) == 0.0
