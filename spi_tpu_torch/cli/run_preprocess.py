"""Preprocess CLI of the PyTorch/CUDA port: raw portraits -> the crop/ c/
lm/ mask/ dataset tree (counterpart of spi_tpu/cli/run_preprocess.py: the
same flags, plus --device; spec preprocess/run_total.py).

Network weights are flat npz files, as spi_tpu reads them:
  fan.npz       2DFAN4 landmarks  (face_alignment release)
  facerecon.npz Deep3DFaceRecon epoch_20.pth (prefix net_recon.)
  bisenet.npz   face-parsing BiSeNet
A missing file is replaced by seeded random weights, with a warning, as
spi_tpu does.

    python -m spi_tpu_torch.cli.run_preprocess \\
        --input_dir raw/ --output_dir data/ \\
        --ckpt_dir checkpoints/preprocess [--mirror]

Runs on the card (`--device cuda`, the default; raises without a GPU) or
on the CPU with `--device cpu`.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SPI preprocess on PyTorch/CUDA")
    p.add_argument("--input_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--ckpt_dir", type=str, default="checkpoints/preprocess")
    p.add_argument("--mirror", action="store_true", default=False)
    p.add_argument("--random_init", action="store_true", default=False,
                   help="random perception weights (smoke runs only)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def load_models(ckpt_dir: str, device=None):
    """The three networks with the npz weights found in `ckpt_dir`, seeded
    random weights (and a warning) where a file is missing."""
    from spi_tpu_torch.preprocess.pipeline import PreprocessModels
    from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz

    models = PreprocessModels.random_init(device)
    for name, module in (("fan.npz", models.fan), ("facerecon.npz", models.face_recon),
                         ("bisenet.npz", models.bisenet)):
        path = os.path.join(ckpt_dir, name)
        if os.path.exists(path):
            load_flat_params(module, load_npz(path))
        else:
            print(f"warning: {path} missing; using random init")
    return models


def main(argv=None):
    """Returns run_total's (names done, failures)."""
    args = parse_args(argv)
    from spi_tpu_torch.preprocess.pipeline import PreprocessModels, run_total
    from spi_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.random_init:
        models = PreprocessModels.random_init(dev)
    else:
        models = load_models(args.ckpt_dir, dev)
    results, failures = run_total(args.input_dir, args.output_dir, models, mirror=args.mirror)
    print(f"preprocessed {len(results)} images, {len(failures)} failures")
    for name, err in failures:
        print(f"  FAILED {name}: {err}")
    return results, failures


if __name__ == "__main__":
    main()
