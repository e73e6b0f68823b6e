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
default; raises without a GPU) or on the CPU with `--device cpu`.
--save_video renders each tuned generator's orbit video into
video/<coach>/ (spi_tpu_torch.utils.video).

Scale-out. --parallel_images B inverts B images at a time in one batched
program on the card (training/pipeline.py `invert_batch`). Several cards
are several processes, one card each, under torchrun:

    torchrun --nproc_per_node N -m spi_tpu_torch.cli.run_inversion \
        --dataset_block auto ...

where `auto` gives each process its stripe of the worklist from its rank
(parallel/multihost.py); every process then joins one all-gather of its
metric sums, and rank 0 prints the global means and appends them to
experiments/metric_log_global.txt.
"""

from __future__ import annotations

import argparse
import os
import warnings

import torch


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
                        help="'i/N' worklist slice (images_dataset.py:149-158); 'auto' "
                             "derives it from the torchrun process group "
                             "(spi_tpu_torch.parallel.multihost)")
    parser.add_argument("--select_range", type=int, default=None)
    parser.add_argument("--filter_index", type=str, default=None, help="1,2,3")
    parser.add_argument("--save_video", action="store_true", default=False)
    parser.add_argument("--log_snapshot", type=int, default=0,
                        help="save the in-progress reconstruction every N tuning steps; 0 = off")
    parser.add_argument("--parallel_images", type=int, default=1,
                        help="invert N images at a time in one batched program on the card")
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
    if args.parallel_images < 1:
        raise ValueError(f"--parallel_images must be >= 1, got {args.parallel_images}")

    from spi_tpu_torch.data.dataset import PTIDataset
    from spi_tpu_torch.models.triplane import (
        TriPlaneGenerator,
        ffhq512_128_config,
        tiny_test_config,
    )
    from spi_tpu_torch.training.pipeline import InversionPipeline, PipelineConfig
    from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz
    from spi_tpu_torch.utils.device import resolve_device

    distributed = False
    if args.dataset_block == "auto":
        from spi_tpu_torch.parallel.multihost import host_block, initialize

        # Without a process group every launched process would take block
        # 1/1, the whole worklist; a single process does so knowingly.
        distributed = initialize()
        if not distributed:
            warnings.warn(
                "--dataset_block auto: WORLD_SIZE is absent or 1, so no process group was "
                "started; this process takes the whole worklist (block 1/1). To split it, "
                "launch with torchrun --nproc_per_node N (or set MASTER_ADDR, MASTER_PORT, "
                "RANK and WORLD_SIZE), or pass an explicit --dataset_block i/N.")
        args.dataset_block = host_block()
        if distributed and torch.device(args.device).type == "cuda" and torch.cuda.is_available():
            # One card a process: LOCAL_RANK's, shared where there are fewer cards.
            local = int(os.environ.get("LOCAL_RANK", "0"))
            torch.cuda.set_device(local % torch.cuda.device_count())

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
        save_video=args.save_video, parallel_images=args.parallel_images,
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
    if distributed:
        _aggregate(results, pipeline.dirs["experiments"])
    return results


def _aggregate(results, experiments_dir):
    """Global metric means over every process (one all-gather, which every
    process enters, an empty stripe too); rank 0 prints them and appends
    them to metric_log_global.txt. Ends the process group."""
    import torch.distributed as dist

    from spi_tpu_torch.parallel.multihost import aggregate_metrics

    sums: dict[str, float] = {"n": float(len(results))}
    for r in results:
        for k, v in r["metrics"].items():
            sums[k] = sums.get(k, 0.0) + float(v)
    try:
        global_means = aggregate_metrics(sums)
        if dist.get_rank() == 0:
            print(f"global metric means over all processes: {global_means}", flush=True)
            with open(os.path.join(experiments_dir, "metric_log_global.txt"), "a") as f:
                f.write(f"{global_means}\n")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
