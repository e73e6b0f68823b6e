"""Domain-interpolation editing videos (counterpart of
spi_tpu/cli/generate_edit_videos.py; spec ZSSGAN/generate_videos.py:1-230;
the same flags, plus --device).

Given a source w latent and one or more domain-adapted 2D StyleGAN2
checkpoints, interpolates latent codes toward targets (explicit target
latents, InterfaceGAN boundary directions, or none) and, with several
checkpoints, blends the generator weights across consecutive domains
over the timeline; renders every frame (batches of 8 under no_grad,
noise_mode='const') and writes per-domain and combined videos through
`utils/video.write_frames` (mp4, else GIF, else `.frames.npz`).

    python -m spi_tpu_torch.cli.generate_edit_videos \\
        --ckpt out/pixar/checkpoint/final.npz out/sketch/checkpoint/final.npz \\
        --out_dir out/videos --source_latent latents/latent000.npy \\
        [--target_latents latents/] [--unedited_frames 40]

Runs on the card (`--device cuda`, the default; raises without a GPU) or
on the CPU with `--device cpu`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

SUGGESTED_DISTANCES = {
    "pose": (3.0, -3.0),
    "smile": (2.0, -2.0),
    "age": (4.0, -4.0),
    "gender": (3.0, -3.0),
    "hair_length": (None, -4.0),
    "beard": (2.0, None),
}


def project_code(latent_code: np.ndarray, boundary: np.ndarray, distance: float):
    """latent + distance * boundary (generate_videos.py:47-52)."""
    if boundary.ndim == 2:
        boundary = boundary.reshape(1, 1, -1)
    return latent_code + distance * boundary


def interpolate_forward_backward(source, target, alphas, dwell: int = 20):
    """source -> target, dwell at target, target -> source
    (generate_videos.py:95-99)."""
    forward = [a * target + (1 - a) * source for a in alphas]
    return forward + [target] * dwell + forward[::-1]


def build_latents(args, source_latent: np.ndarray) -> list[np.ndarray]:
    alphas = np.linspace(0, 1, num=20)
    if args.unedited_frames:
        return [source_latent] * args.unedited_frames
    if args.target_latents:
        latents = []
        for path in args.target_latents:
            if os.path.abspath(path) == os.path.abspath(args.source_latent):
                continue
            target = np.load(path, allow_pickle=True)
            latents.extend(interpolate_forward_backward(source_latent, target, alphas))
        return latents
    latents = []
    directions = args.edit_directions or ["pose", "smile", "gender", "age", "hair_length"]
    for direction in directions:
        boundary = np.load(os.path.join(args.boundary_dir, f"{direction}.npy"),
                           allow_pickle=True).astype(np.float32)
        for distance in SUGGESTED_DISTANCES[direction]:
            if distance:
                target = project_code(source_latent, boundary, distance)
                latents.extend(interpolate_forward_backward(source_latent, target, alphas))
    return latents


def lerp_trees(a: dict, b: dict, t: float) -> dict:
    """(1 - t) a + t b, key by key, over flat dicts of tensors."""
    return {k: (1.0 - t) * a[k] + t * b[k] for k in a}


def render_images(generator, params_list, latents, batch: int = 8):
    """Every frame as (n, 3, H, W) float32 in [-1, 1]. params_list: flat
    {dotted key: tensor} weights of `generator` (a models/stylegan2
    Generator). With more than one, the weights are blended across
    consecutive domains over the timeline (generate_videos.py:62-87),
    frame by frame; else frames render `batch` at a time."""
    import torch

    from spi_tpu_torch.utils.device import module_device
    from spi_tpu_torch.utils.params import functional_apply

    dev = module_device(generator)
    ws = torch.from_numpy(np.concatenate(latents, axis=0).astype(np.float32)).to(dev)

    def synth(params, w):
        return functional_apply(generator, params, generator.synthesis, w, noise_mode="const")

    n = len(latents)
    segments = len(params_list) - 1
    with torch.no_grad():
        if segments == 0:
            return torch.cat([synth(params_list[0], ws[i:i + batch]) for i in range(0, n, batch)])
        seg_len = n / segments
        images = []
        for i in range(n):
            seg = int(i // seg_len)
            params = lerp_trees(params_list[seg], params_list[seg + 1], (i % seg_len) / seg_len)
            images.append(synth(params, ws[i:i + 1]))
        return torch.cat(images)


def render_frames(generator, params_list, latents, batch: int = 8) -> list[np.ndarray]:
    """`render_images` as uint8 (H, W, 3) frames."""
    from spi_tpu_torch.utils.image import tensor2im

    images = render_images(generator, params_list, latents, batch).cpu()
    return [np.asarray(tensor2im(img)) for img in images]


def merge_grid(per_ckpt_frames: list[list[np.ndarray]]):
    """Square grid of the per-domain videos (generate_videos.py:157-193)."""
    k = len(per_ckpt_frames)
    side = int(k ** 0.5)
    if side * side != k:
        raise ValueError("Number of checkpoints cannot be arranged in a square grid")
    n = min(len(f) for f in per_ckpt_frames)
    combined = []
    for i in range(n):
        rows = [np.concatenate([per_ckpt_frames[r * side + c][i] for c in range(side)], axis=1)
                for r in range(side)]
        combined.append(np.concatenate(rows, axis=0))
    return combined


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ZSSGAN domain-interpolation videos")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--ckpt", type=str, nargs="+", required=True,
                   help="one or more domain-adapted generator npz checkpoints")
    p.add_argument("--base_ckpt", type=str, default=None,
                   help="full generator npz for weights the editing ckpts omit (frozen "
                        "layers); required when --ckpt holds trainable-only trees")
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--channel_max", type=int, default=512)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--source_latent", type=str, required=True,
                   help=".npy with a (1, L, C) or (1, C) w latent")
    p.add_argument("--target_latents", nargs="+", type=str, default=None)
    p.add_argument("--edit_directions", nargs="+", type=str, default=None)
    p.add_argument("--boundary_dir", type=str, default="editing/interfacegan_boundaries")
    p.add_argument("--unedited_frames", type=int, default=0)
    p.add_argument("--fps", type=int, default=35)
    p.add_argument("--force", "-f", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {'frames': [each checkpoint's uint8 frames], 'blended':
    frames or None, 'videos': [files written]}."""
    args = parse_args(argv)

    import torch

    from spi_tpu_torch.models.stylegan2 import Generator
    from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz
    from spi_tpu_torch.utils.device import resolve_device
    from spi_tpu_torch.utils.video import write_frames

    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    if not args.force and os.listdir(args.out_dir):
        raise SystemExit("Output directory is not empty. Delete its contents or pass -f.")

    if (args.target_latents and len(args.target_latents) == 1
            and os.path.isdir(args.target_latents[0])):
        args.target_latents = sorted(
            os.path.join(args.target_latents[0], f)
            for f in os.listdir(args.target_latents[0]) if f.endswith(".npy"))

    generator = Generator(
        z_dim=args.latent_dim, c_dim=0, w_dim=args.latent_dim, img_resolution=args.size,
        img_channels=3, channel_base=32768 * args.channel_multiplier // 2,
        channel_max=args.channel_max, device=dev)
    base = load_npz(args.base_ckpt) if args.base_ckpt else {}

    def load_full(path):
        # Editing checkpoints may hold only the trained subset: the base
        # fills the rest. load_flat_params checks every key and shape.
        flat = {**base, **load_npz(path)}
        load_flat_params(generator, flat)
        return {k: torch.from_numpy(v).to(dev) for k, v in flat.items()}

    params_list = [load_full(p) for p in args.ckpt]

    source_latent = np.load(args.source_latent, allow_pickle=True).astype(np.float32)
    if source_latent.ndim == 2:  # (1, C) -> broadcast over the layers
        source_latent = np.repeat(source_latent[:, None, :], generator.num_ws, axis=1)
    latents = build_latents(args, source_latent)

    out = {"frames": [], "blended": None, "videos": []}
    for idx, params in enumerate(params_list):
        frames = render_frames(generator, [params], latents)
        out["frames"].append(frames)
        path = write_frames(np.stack(frames), os.path.join(args.out_dir, str(idx), "out.mp4"),
                            args.fps)
        out["videos"].append(path)
        print(f"[{idx}] {len(frames)} frames -> {path}")

    combined = os.path.join(args.out_dir, "combined.mp4")
    if len(params_list) > 1:
        # The reference's combined video: domain-blended weights over time.
        out["blended"] = render_frames(generator, params_list, latents)
        out["videos"].append(write_frames(np.stack(out["blended"]),
                                          os.path.join(args.out_dir, "blended.mp4"), args.fps))
        out["videos"].append(write_frames(np.stack(merge_grid(out["frames"])), combined,
                                          args.fps))
    else:
        out["videos"].append(write_frames(np.stack(out["frames"][0]), combined, args.fps))
    print(f"done -> {args.out_dir}")
    return out


if __name__ == "__main__":
    main()
