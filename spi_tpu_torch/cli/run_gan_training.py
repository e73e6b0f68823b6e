"""EG3D GAN training CLI (counterpart of spi_tpu/cli/run_gan_training.py:
the same flags and defaults, plus --device and --tiny).

The host loop around `training/gan.GANTrainer.step` (spec eg3d/training/
training_loop.py): ffhq512_128_config at --resolution with
--neural_rendering_resolution, computing in bfloat16 (as spi_tpu's CLI),
and a DualDiscriminator on the dataset's labels in float32, both from
seeded random weights; the ADA pipe unless --aug noaug, its p moved every
ada_interval steps from rt; stats.jsonl every tick and G_ema's weights
(every key of the generator's state, which both packages read) as
network-<kimg>.npz every --snap ticks and network-final.npz at the end.

    python -m spi_tpu_torch.cli.run_gan_training \\
        --data path/to/images_or_zip --outdir runs/gan --batch 8 --kimg 25000

Runs on the card (`--device cuda`, the default; raises without a GPU) or
on the CPU with `--device cpu`; --tiny builds the tiny generator and
discriminator of spi_tpu's GAN tests (128^2 images). Under `torchrun
--nproc_per_node N` each process takes --batch / N images a step from its
rank's stripe of the sampler (EG3D's InfiniteSampler) and the gradients
are averaged over the processes: over nccl where every process has a
card of its own, else over gloo (the CPU; several processes on one
card). --n_devices, where given, must equal the number of processes.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="EG3D GAN training on PyTorch/CUDA")
    p.add_argument("--data", type=str, required=True)
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--batch", type=int, default=8, help="global batch")
    p.add_argument("--kimg", type=float, default=25000.0)
    p.add_argument("--glr", type=float, default=0.0025)
    p.add_argument("--dlr", type=float, default=0.002)
    p.add_argument("--gamma", type=float, default=1.0, help="R1 weight")
    p.add_argument("--density_reg", type=float, default=0.25)
    p.add_argument("--aug", type=str, default="ada", choices=["ada", "noaug", "fixed"])
    p.add_argument("--p", type=float, default=0.0, help="fixed aug p")
    p.add_argument("--target", type=float, default=0.6, help="ADA target")
    p.add_argument("--snap", type=int, default=50, help="snapshot every N ticks")
    p.add_argument("--tick_kimg", type=float, default=4.0)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--neural_rendering_resolution", type=int, default=64)
    p.add_argument("--sr_variant", type=str, default="SuperresolutionHybrid8XDC",
                   help="must match --resolution (8XDC->512, 8X->256, 2X->128)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="the number of processes (torchrun's), checked")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=None,
                   help="debug: stop after N steps regardless of kimg")
    p.add_argument("--tiny", action="store_true", default=False,
                   help="the tiny generator and discriminator of the GAN tests (128^2)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def _process_group(device):
    """(this process's device, rank, number of processes). Joins torchrun's
    process group: nccl where every local process has a card of its own,
    else gloo; prints which."""
    import torch

    from spi_tpu_torch.parallel import multihost

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return device, 0, 1
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    own_card = device.type == "cuda" and torch.cuda.device_count() >= local_world
    if own_card:
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    backend = "nccl" if own_card else "gloo"
    multihost.initialize(backend)
    rank = torch.distributed.get_rank()
    if rank == 0:
        print(f"process group: {backend}, {world} processes")
    return device, rank, world


def main(argv=None):
    """Train; returns the GANTrainer (its G, D and G_ema after the last step).
    Under torchrun it joins the process group and leaves it at the end."""
    args = parse_args(argv)

    import torch

    from spi_tpu_torch.utils.device import resolve_device

    device, rank, world = _process_group(resolve_device(args.device))
    try:
        return _train(args, device, rank, world)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def _train(args, device, rank, world):
    import torch

    from spi_tpu_torch.data.gan_dataset import ImageFolderDataset, batch_iterator
    from spi_tpu_torch.models.discriminator import DualDiscriminator
    from spi_tpu_torch.models.triplane import TriPlaneGenerator, ffhq512_128_config
    from spi_tpu_torch.parallel import check_replica_consistency
    from spi_tpu_torch.training.augment import AugmentPipe
    from spi_tpu_torch.training.gan import (
        TINY_DISCRIMINATOR,
        GANConfig,
        GANTrainer,
        adjust_ada_p,
        tiny_gan_config,
    )
    from spi_tpu_torch.utils.checkpoint import module_flat, save_flat
    from spi_tpu_torch.utils.stats import Collector

    if args.n_devices is not None and args.n_devices != world:
        raise ValueError(f"--n_devices {args.n_devices} but {world} processes run")
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} does not split over {world} processes")
    os.makedirs(args.outdir, exist_ok=True)

    if args.tiny:
        g_cfg = tiny_gan_config(compute_dtype="bfloat16")
        d_kwargs = TINY_DISCRIMINATOR
    else:
        g_cfg = ffhq512_128_config(
            img_resolution=args.resolution,
            neural_rendering_resolution=args.neural_rendering_resolution,
            sr_variant=args.sr_variant, compute_dtype="bfloat16")
        d_kwargs = {"img_resolution": args.resolution}
    dataset = ImageFolderDataset(args.data, resolution=g_cfg.img_resolution)
    if rank == 0:
        print(f"dataset: {len(dataset)} images, label_dim {dataset.label_dim}")

    generator = TriPlaneGenerator(g_cfg, device=device, seed=args.seed)
    discriminator = DualDiscriminator(c_dim=dataset.label_dim, **d_kwargs, device=device,
                                      seed=args.seed + 1)
    local_batch = args.batch // world
    config = GANConfig(batch_per_device=local_batch, g_lr=args.glr, d_lr=args.dlr,
                       r1_gamma=args.gamma, density_reg=args.density_reg,
                       ada_target=args.target)
    # The pipe lives inside the trainer: it augments both real and
    # generated pairs (upstream EG3D loss), not just the real batch.
    augment = AugmentPipe() if args.aug != "noaug" else None
    trainer = GANTrainer(generator, discriminator, config, augment=augment, device=device,
                         seed=args.seed + 1 + rank)
    aug_p = args.p

    stats = Collector()
    batches = batch_iterator(dataset, local_batch, rank=rank, num_replicas=world,
                             seed=args.seed)
    total_steps = int(args.kimg * 1000 / args.batch)
    if args.max_steps is not None:
        total_steps = min(total_steps, args.max_steps)
    tick_interval = max(int(args.tick_kimg * 1000 / args.batch), 1)

    def snapshot(name):
        """G_ema's weights to `name`; with several processes, first the
        replicas of G, D and G_ema against rank 0's, bitwise (EG3D's
        check_ddp_consistency at every snapshot)."""
        if world > 1:
            bad = [f"{label}.{n}" for label, m in (("G", generator), ("D", discriminator),
                                                   ("G_ema", trainer.g_ema))
                   for n in check_replica_consistency(m)]
            if bad:
                raise RuntimeError(f"replicas differ from rank 0's in {bad}")
        if rank == 0:
            save_flat(os.path.join(args.outdir, name), module_flat(trainer.g_ema))
            if world > 1:
                print(f"{name}: G, D and G_ema bitwise equal over {world} processes",
                      flush=True)

    t0 = time.time()
    for step in range(total_steps):
        real, labels = next(batches)
        real = torch.from_numpy(real).to(device)
        c = torch.from_numpy(labels).to(device)
        z = torch.randn((local_batch, g_cfg.z_dim), generator=trainer.rng, device=device)
        metrics = trainer.step(real, z, c, aug_p)

        if args.aug == "ada" and (step + 1) % config.ada_interval == 0:
            aug_p = adjust_ada_p(aug_p, float(metrics["rt"]), config, args.batch)

        stats.report("Loss/G", metrics["loss_g"])
        stats.report("Loss/D", metrics["loss_d"])
        stats.report("Progress/augment_p", aug_p)

        if (step + 1) % tick_interval == 0:
            kimg_done = (step + 1) * args.batch / 1000
            if rank == 0:
                print(f"tick kimg {kimg_done:.1f} lossG {stats.mean('Loss/G'):.3f} "
                      f"lossD {stats.mean('Loss/D'):.3f} p {aug_p:.3f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
                stats.write_jsonl(os.path.join(args.outdir, "stats.jsonl"), kimg=kimg_done)
            stats.reset()
            if ((step + 1) // tick_interval) % args.snap == 0:
                snapshot(f"network-{int(kimg_done):06d}.npz")

    snapshot("network-final.npz")
    if rank == 0:
        print(f"done: {total_steps} steps in {time.time() - t0:.0f}s")
    return trainer


if __name__ == "__main__":
    main()
