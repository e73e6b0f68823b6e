"""SPI inversion CLI of the PyTorch/CUDA port (counterpart of
spi_tpu/cli/run_inversion.py: the same flags, plus --device; the same
output tree, npz keys and metric_log.txt).

    python -m spi_tpu_torch.cli.run_inversion --data_root D --output_root O \\
        --eg3d_ckpt checkpoints/ffhqrebalanced512-128.npz \\
        --first_inv_type mir --first_inv_steps 500 \\
        --G_1_type RotBbox --G_1_step 1000 \\
        --pt_rot_lambda 0.1 --pt_mirror_rot_lambda 0.05 --pt_depth_lambda 1

Computes in bfloat16 (the generator's `compute_dtype`), as spi_tpu's CLI
does, unless given --fp32. Runs on the card (`--device cuda`, the
default; raises without a GPU) or on the CPU with `--device cpu`. Not
ported, each raising NotImplementedError: --parallel_images above 1 and
--dataset_block auto. --save_video renders each tuned generator's orbit
video into video/<coach>/ (spi_tpu_torch.utils.video).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="SPI inversion on PyTorch/CUDA")
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--data_mode", type=str, default="png")
    parser.add_argument("--output_root", type=str, default="test/output/")
    parser.add_argument("--eg3d_ckpt", type=str, default="checkpoints/ffhqrebalanced512-128.npz")
    parser.add_argument("--perception_ckpt", type=str, default=None,
                        help="npz bundle with VGG/ArcFace weights (lpips., boxcx., metric. keys)")
    parser.add_argument("--random_init", action="store_true", default=False,
                        help="random generator/perception weights (smoke/perf runs)")
    parser.add_argument("--use_adapt_yaw_range", action="store_true", default=False)
    parser.add_argument("--not_use_wandb", action="store_true", default=False)

    parser.add_argument("--first_inv_type", type=str, default="sg")
    parser.add_argument("--first_inv_steps", type=int, default=500)
    parser.add_argument("--G_1_step", type=int, default=500)
    parser.add_argument("--G_1_type", type=str, default="RotBbox")
    parser.add_argument("--G_2_step", type=int, default=500)
    parser.add_argument("--load_embedding_coach_name", type=str, default=None)

    parser.add_argument("--pt_rot_lambda", type=float, default=0)
    parser.add_argument("--pt_mirror_rot_lambda", type=float, default=0)
    parser.add_argument("--pt_depth_lambda", type=float, default=0)
    parser.add_argument("--pt_tv_lambda", type=float, default=0)
    parser.add_argument("--LPIPS_value_threshold", type=float, default=0.05,
                        help="early-stop when the recon LPIPS drops below this "
                             "(hyperparameters.py:13); negative disables")

    parser.add_argument("--description", type=str, default=None)
    parser.add_argument("--dataset_block", type=str, default=None,
                        help="'i/N' worklist slice (images_dataset.py:149-158)")
    parser.add_argument("--select_range", type=int, default=None)
    parser.add_argument("--filter_index", type=str, default=None, help="1,2,3")
    parser.add_argument("--save_video", action="store_true", default=False)
    parser.add_argument("--log_snapshot", type=int, default=0,
                        help="save the in-progress reconstruction every N tuning steps; 0 = off")
    parser.add_argument("--parallel_images", type=int, default=1)
    parser.add_argument("--fp32", action="store_true", default=False,
                        help="disable the bfloat16 compute path (slower, "
                             "reference-exact numerics)")
    parser.add_argument("--tiny", action="store_true", default=False,
                        help="scaled-down generator (128^2, 4+4 depth samples) for smoke runs "
                             "and tests; the dataset is resized to match")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    unported = [
        (args.parallel_images > 1, "--parallel_images > 1 is not ported: ROADMAP Queue 1 "
                                   "item 10, scale-out"),
        (args.dataset_block == "auto", "--dataset_block auto is not ported: ROADMAP Queue 1 "
                                       "item 10, scale-out; pass i/N"),
    ]
    for cond, what in unported:
        if cond:
            raise NotImplementedError(what)

    from spi_tpu_torch.data.dataset import PTIDataset
    from spi_tpu_torch.models.triplane import (
        TriPlaneGenerator,
        ffhq512_128_config,
        tiny_test_config,
    )
    from spi_tpu_torch.training.pipeline import InversionPipeline, PipelineConfig
    from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz
    from spi_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    compute_dtype = "float32" if args.fp32 else "bfloat16"
    config_fn = tiny_test_config if args.tiny else ffhq512_128_config
    generator = TriPlaneGenerator(config_fn(compute_dtype=compute_dtype), device=dev, seed=0)
    perception = None
    if not args.random_init:
        load_flat_params(generator, load_npz(args.eg3d_ckpt))
        if args.perception_ckpt:
            perception = load_npz(args.perception_ckpt)

    config = PipelineConfig(
        output_root=args.output_root, first_inv_type=args.first_inv_type,
        first_inv_steps=args.first_inv_steps, G_1_type=args.G_1_type, G_1_step=args.G_1_step,
        pt_rot_lambda=args.pt_rot_lambda, pt_mirror_rot_lambda=args.pt_mirror_rot_lambda,
        pt_depth_lambda=args.pt_depth_lambda, pt_tv_lambda=args.pt_tv_lambda,
        lpips_threshold=args.LPIPS_value_threshold,
        use_adapt_yaw_range=args.use_adapt_yaw_range,
        load_embedding_coach_name=args.load_embedding_coach_name,
        description=args.description, log_snapshot=args.log_snapshot,
        save_video=args.save_video,
    )
    dataset = PTIDataset(
        source_root=os.path.join(args.data_root, "crop"),
        c_root=os.path.join(args.data_root, "c"),
        mask_root=os.path.join(args.data_root, "mask"),
        lm_root=os.path.join(args.data_root, "lm"),
        target_name="target", mode=args.data_mode, dataset_block=args.dataset_block,
        select_range=args.select_range,
        filter_index=args.filter_index.split(",") if args.filter_index else None,
        size=generator.cfg.img_resolution,
    )
    pipeline = InversionPipeline(generator, config, perception, device=dev)
    results = pipeline.run(dataset)
    for r in results:
        print(f"{r['name']}: w {tuple(r['w'].shape)} stage1={r['stage1_s']:.1f}s "
              f"stage2={r['stage2_s']:.1f}s steps={r['steps_run']} metrics={r['metrics']}",
              flush=True)
    return results


if __name__ == "__main__":
    main()
