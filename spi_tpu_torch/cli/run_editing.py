"""CLIP-guided domain editing CLI, StyleGAN-NADA / ZSSGAN over EG3D
(counterpart of spi_tpu/cli/run_editing.py: the same flags and defaults,
plus --device and --tiny).

Loads a (usually SPI-tuned) EG3D generator npz twice, a frozen and a
trainable copy, and CLIP npz weights (`python -m spi_tpu_torch.convert clip`
writes them; `load_flat_params` reads them as they are), runs the
twin-generator directional-CLIP loop in float32, writes a sample grid
every --output_interval steps and checkpoint/final.npz (every key of the
generator's state, which both packages read).

    python -m spi_tpu_torch.cli.run_editing \\
        --frozen_gen_ckpt out/tuned_g.npz --output_dir experiments/edit_sketch \\
        --source_class photo --target_class sketch \\
        --clip_ckpt_dir checkpoints/clip \\
        --bpe_path checkpoints/clip/bpe_simple_vocab_16e6.txt.gz

Runs on the card (`--device cuda`, the default; raises without a GPU) or
on the CPU with `--device cpu`; --tiny builds tiny_test_config and
tiny_test_clip (tests). --random_init seeds the generator from 0 and each
CLIP model from the CRC-32 of its name, and without --bpe_path tokenizes
with a stand-in that maps each word to its CRC-32 (spi_tpu uses Python's
`hash`, which is salted per process).
"""

from __future__ import annotations

import argparse
import os
import time
import zlib

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ZSSGAN editing on PyTorch/CUDA")
    p.add_argument("--frozen_gen_ckpt", type=str, required=True)
    p.add_argument("--train_gen_ckpt", type=str, default=None,
                   help="defaults to frozen_gen_ckpt (twin init)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--source_class", type=str, default="photo")
    p.add_argument("--target_class", type=str, default="sketch")
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--g_reg_every", type=int, default=4)
    p.add_argument("--iter", type=int, default=301)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--n_sample", type=int, default=4)
    p.add_argument("--sample_truncation", type=float, default=0.7)
    p.add_argument("--output_interval", type=int, default=50)
    p.add_argument("--save_interval", type=int, default=None)
    p.add_argument("--clip_models", nargs="+", type=str, default=["ViT-B/32", "ViT-B/16"])
    p.add_argument("--clip_model_weights", nargs="+", type=float, default=[1.0, 1.0])
    p.add_argument("--lambda_direction", type=float, default=1.0)
    p.add_argument("--lambda_patch", type=float, default=0.0)
    p.add_argument("--lambda_global", type=float, default=0.0)
    p.add_argument("--lambda_manifold", type=float, default=0.0)
    p.add_argument("--lambda_texture", type=float, default=0.0)
    p.add_argument("--auto_layer_iters", type=int, default=0)
    p.add_argument("--auto_layer_k", type=int, default=0)
    p.add_argument("--auto_layer_batch", type=int, default=8)
    p.add_argument("--clip_ckpt_dir", type=str, default="checkpoints/clip",
                   help="dir with ViT-B-32.npz / ViT-B-16.npz / RN50.npz "
                        "from `python -m spi_tpu_torch.convert clip ...`")
    p.add_argument("--bpe_path", type=str, default=None,
                   help="bpe_simple_vocab_16e6.txt.gz for the tokenizer")
    p.add_argument("--ide3d", action="store_true", default=False,
                   help="IDE3D-flavored layer selection: train ALL synthesis-block layers "
                        "incl. ToRGB (ZSSGAN_IDE3D.py:49-51) instead of the EG3D conv-only set")
    p.add_argument("--random_init", action="store_true", default=False,
                   help="random generator/CLIP weights (smoke runs)")
    p.add_argument("--seed", type=int, default=2)  # train.py:62
    p.add_argument("--tiny", action="store_true", default=False,
                   help="tiny_test_config and tiny_test_clip (tests)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


_CLIP_CONFIGS = {
    "ViT-B/32": ("vit_b32", "ViT-B-32.npz"),
    "ViT-B/16": ("vit_b16", "ViT-B-16.npz"),
    "RN50": ("rn50", "RN50.npz"),
}


class CRCTokenizer:
    """Stand-in tokenizer for runs without the BPE vocabulary: SOT 1, each
    word's CRC-32 into [2, 2 + min(40000, vocab - 3)), EOT vocab - 1 (the
    highest id, as CLIP's EOT), zero padding."""

    def __init__(self, vocab_size: int):
        self.span = min(40000, vocab_size - 3)
        self.eot = vocab_size - 1

    def tokenize(self, texts, context_length=77):
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            toks = [1] + [zlib.crc32(w.encode()) % self.span + 2 for w in t.split()]
            toks = toks[: context_length - 1] + [self.eot]
            out[i, : len(toks)] = toks
        return out


def main(argv=None) -> dict:
    """Returns {'losses': [each step's loss], 'samples': [grid files],
    'checkpoint': final.npz, 'trainer', 'states_s', 'steps_s'}."""
    args = parse_args(argv)
    if not (args.bpe_path or args.random_init):
        raise SystemExit("--bpe_path is required unless --random_init")

    import torch

    from spi_tpu_torch.editing.clip_loss import DirectionalCLIPLoss
    from spi_tpu_torch.editing.zssgan import EditingSettings, IDE3DZSSGANTrainer, ZSSGANTrainer
    from spi_tpu_torch.models.perception import clip as clip_models
    from spi_tpu_torch.models.perception.clip_tokenizer import Tokenizer
    from spi_tpu_torch.models.triplane import (
        TriPlaneGenerator,
        ffhq512_128_config,
        tiny_test_config,
    )
    from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz, module_flat, save_flat
    from spi_tpu_torch.utils.device import resolve_device
    from spi_tpu_torch.utils.image import save_image_grid

    dev = resolve_device(args.device)
    cfg = (tiny_test_config if args.tiny else ffhq512_128_config)()
    frozen = TriPlaneGenerator(cfg, device=dev, seed=0)
    if not args.random_init:
        load_flat_params(frozen, load_npz(args.frozen_gen_ckpt))
    trainable = None
    if args.train_gen_ckpt:
        trainable = TriPlaneGenerator(cfg, device=dev)
        load_flat_params(trainable, load_npz(args.train_gen_ckpt))

    losses, weights = {}, {}
    for name, w in zip(args.clip_models, args.clip_model_weights):
        config_name, fname = _CLIP_CONFIGS[name]
        clip_cfg = getattr(clip_models, "tiny_test_clip" if args.tiny else config_name)()
        model = clip_models.CLIP(clip_cfg, device=dev, seed=zlib.crc32(name.encode()) % 2**31)
        if not args.random_init:
            load_flat_params(model, load_npz(os.path.join(args.clip_ckpt_dir, fname)))
        losses[name] = DirectionalCLIPLoss(
            model, lambda_direction=args.lambda_direction, lambda_patch=args.lambda_patch,
            lambda_global=args.lambda_global, lambda_manifold=args.lambda_manifold,
            lambda_texture=args.lambda_texture)
        weights[name] = w

    settings = EditingSettings(
        source_class=args.source_class, target_class=args.target_class, lr=args.lr,
        g_reg_every=args.g_reg_every, batch=args.batch, iterations=args.iter,
        sample_truncation=args.sample_truncation, auto_layer_iters=args.auto_layer_iters,
        auto_layer_k=args.auto_layer_k, auto_layer_batch=args.auto_layer_batch,
        lambda_direction=args.lambda_direction, lambda_patch=args.lambda_patch,
        lambda_global=args.lambda_global, lambda_manifold=args.lambda_manifold,
        lambda_texture=args.lambda_texture,
    )
    trainer_cls = IDE3DZSSGANTrainer if args.ide3d else ZSSGANTrainer
    trainer = trainer_cls(frozen, losses, weights, settings, trainable=trainable, device=dev,
                          seed=args.seed)

    if args.bpe_path:
        tokenizer = Tokenizer(args.bpe_path)
    else:
        tokenizer = CRCTokenizer(next(iter(losses.values())).model.cfg.vocab_size)

    t0 = time.perf_counter()
    trainer.build_states(tokenizer)
    states_s = time.perf_counter() - t0

    sample_dir = os.path.join(args.output_dir, "sample")
    ckpt_dir = os.path.join(args.output_dir, "checkpoint")
    os.makedirs(sample_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)

    # The sample grid's w codes and render draws, fixed for the whole run.
    fixed = trainer.draw(args.n_sample, torch.Generator(device=dev).manual_seed(args.seed + 1))
    out = {"losses": [], "samples": [], "trainer": trainer, "states_s": states_s}
    t0 = time.perf_counter()
    for i in range(args.iter):
        loss = float(trainer.step())
        out["losses"].append(loss)
        if i % 10 == 0:
            print(f"iter {i}: clip loss {loss:.4f} ({time.perf_counter() - t0:.1f}s)")
        if i % args.output_interval == 0:
            with torch.no_grad():
                ws = trainer.sample_w(fixed["w"], truncation=args.sample_truncation)
                dst = trainer.render(trainer.trainable, ws, fixed["trainable"])
            path = os.path.join(sample_dir, f"dst_{i:06d}.jpg")
            save_image_grid(dst, path)
            out["samples"].append(path)
        if args.save_interval and i > 0 and i % args.save_interval == 0:
            save_flat(os.path.join(ckpt_dir, f"{i:06d}.npz"), module_flat(trainer.trainable))
    out["steps_s"] = time.perf_counter() - t0
    out["checkpoint"] = os.path.join(ckpt_dir, "final.npz")
    save_flat(out["checkpoint"], module_flat(trainer.trainable))
    print(f"done in {out['steps_s']:.1f}s -> {out['checkpoint']}")
    return out


if __name__ == "__main__":
    main()
