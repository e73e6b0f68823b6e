"""Orbit video and shape export from an inversion artifact (counterpart of
spi_tpu/cli/run_video.py: the same flags, plus --device and --tiny).

Covers the reference's inference tooling: InferenceCoach's orbit video
(spi/training/coaches/inference_coach.py:41-44 via
spi/utils/video_utils.py:74-227) and the shape export (video_utils.py
gen_shapes + eg3d/shape_utils.py).

Input: a per-image inversion checkpoint npz, as either package's pipeline
writes it: `w`, `c` and the generator's weights under `G.<dotted path>`.

    python -m spi_tpu_torch.cli.run_video \\
        --checkpoint out/checkpoints/<coach>/face0.npz \\
        --output face0.mp4 [--frames 120] [--shape face0.ply]

Computes in bfloat16 (the generator's `compute_dtype`) unless given
--fp32. Runs on the card (`--device cuda`, the default; raises without a
GPU) or on the CPU with `--device cpu`; --tiny reads a tiny_test_config
checkpoint (tests).
"""

from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Orbit video rendering on PyTorch/CUDA")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="inversion artifact npz with w/c/G entries")
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--yaw", type=float, default=0.5)
    p.add_argument("--pitch", type=float, default=0.15)
    p.add_argument("--shape", type=str, default=None,
                   help="also export a marching-tetrahedra PLY here")
    p.add_argument("--shape_resolution", type=int, default=128)
    p.add_argument("--fp32", action="store_true", default=False)
    p.add_argument("--tiny", action="store_true", default=False,
                   help="the checkpoint is of tiny_test_config (tests)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns {'frames': uint8 (T, H, W, 3), 'video': the file written,
    'render_s'} and, with --shape, {'verts', 'faces', 'probe_s', 'mesh_s'}:
    the seconds of the orbit's renders (with their conversion to uint8),
    of the density probes and of the marching tetrahedra with the PLY."""
    args = parse_args(argv)

    import torch

    from spi_tpu_torch.models.triplane import (
        TriPlaneGenerator,
        ffhq512_128_config,
        tiny_test_config,
    )
    from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz
    from spi_tpu_torch.utils.device import resolve_device
    from spi_tpu_torch.utils.video import render_orbit_frames, write_frames

    dev = resolve_device(args.device)
    flat = load_npz(args.checkpoint)
    if "w" not in flat or not any(k.startswith("G.") for k in flat):
        raise ValueError(f"{args.checkpoint} is no inversion artifact npz with G/w entries")
    config_fn = tiny_test_config if args.tiny else ffhq512_128_config
    generator = TriPlaneGenerator(
        config_fn(compute_dtype="float32" if args.fp32 else "bfloat16"), device=dev)
    load_flat_params(generator, {k[2:]: v for k, v in flat.items() if k.startswith("G.")})
    w = torch.from_numpy(flat["w"]).to(dev)
    if w.ndim == 2:
        w = w[None]

    # Each part ends in a copy to the host, which waits for the card.
    t0 = time.perf_counter()
    frames = render_orbit_frames(generator, w, num_frames=args.frames, yaw_amplitude=args.yaw,
                                 pitch_amplitude=args.pitch)
    out = {"frames": frames, "render_s": time.perf_counter() - t0}
    out["video"] = write_frames(frames, args.output, args.fps)
    print(f"wrote {len(frames)} frames -> {out['video']} (rendered in {out['render_s']:.2f} s)")

    if args.shape:
        from spi_tpu_torch.utils.shape import mesh_from_grid, sample_density_grid, write_ply

        t0 = time.perf_counter()
        sigmas = sample_density_grid(generator, w, resolution=args.shape_resolution)
        out["probe_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["verts"], out["faces"] = mesh_from_grid(sigmas)
        write_ply(args.shape, out["verts"], out["faces"])
        out["mesh_s"] = time.perf_counter() - t0
        print(f"wrote shape ({len(out['verts'])} verts, {len(out['faces'])} faces) -> "
              f"{args.shape} (density probes {out['probe_s']:.2f} s, marching tetrahedra and "
              f"PLY {out['mesh_s']:.2f} s)")
    return out


if __name__ == "__main__":
    main()
