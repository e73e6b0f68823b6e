"""Turntable video of a tuned generator (counterpart of spi_tpu/utils/video.py;
spec spi/utils/video_utils.py:74-227).

The orbit's cameras are rendered `batch` at a time under `torch.no_grad()`
with `noise_mode='const'`, from planes computed once for the latent (they
depend on w alone). Every chunk renders with the renderer draws of
`torch.Generator(...).manual_seed(0)`, as spi_tpu renders every chunk with
`PRNGKey(0)`, and the last chunk is padded with its last camera, as
spi_tpu pads it, so that one set of draws serves every chunk. Frames are
encoded on the host: mp4 through imageio, else a GIF, else the raw frames
as `<path>.frames.npz` (an output-format choice: no encoder need be
installed).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from spi_tpu_torch.utils import camera as cam
from spi_tpu_torch.utils.device import module_device
from spi_tpu_torch.utils.image import tensor2im


def orbit_cameras(num_frames: int, yaw_amplitude: float = 0.5,
                  pitch_amplitude: float = 0.15, device=None) -> torch.Tensor:
    """(num_frames, 25) cameras along one period of a yaw sine and a pitch
    cosine about the canonical view."""
    cams = []
    for t in np.linspace(0, 1, num_frames, endpoint=False):
        yaw = yaw_amplitude * math.sin(2 * math.pi * t)
        pitch = pitch_amplitude * math.cos(2 * math.pi * t)
        cams.append(cam.canonical_camera(yaw=yaw, pitch=pitch, device=device))
    return torch.cat(cams, dim=0)


@torch.no_grad()
def render_orbit_images(generator, w, num_frames: int = 60, yaw_amplitude: float = 0.5,
                        pitch_amplitude: float = 0.15, batch: int = 4,
                        draws: dict | None = None) -> torch.Tensor:
    """The orbit's images (num_frames, 3, H, W) in [-1, 1], float32 on the
    generator's device. w: (1, num_ws, w_dim). draws: one chunk's renderer
    draws for `batch` cameras, used for every chunk; else drawn from a
    generator seeded 0 for each chunk."""
    dev = module_device(generator)
    w = w.to(dev)
    cams = orbit_cameras(num_frames, yaw_amplitude, pitch_amplitude, device=dev)
    planes = generator.planes_nhwc(w, noise_mode="const")
    images = []
    for i in range(0, num_frames, batch):
        chunk = cams[i:i + batch]
        n = chunk.shape[0]
        if n < batch:
            chunk = torch.cat([chunk, chunk[-1:].expand(batch - n, -1)], dim=0)
        rng = None if draws is not None else torch.Generator(device=dev).manual_seed(0)
        img = generator.synthesis_from_planes(planes, w, chunk, draws=draws, generator=rng)
        images.append(img["image"][:n])
    return torch.cat(images, dim=0)


def render_orbit_frames(generator, w, num_frames: int = 60, yaw_amplitude: float = 0.5,
                        pitch_amplitude: float = 0.15, batch: int = 4,
                        draws: dict | None = None) -> np.ndarray:
    """The orbit's frames as uint8 (T, H, W, 3)."""
    images = render_orbit_images(generator, w, num_frames, yaw_amplitude, pitch_amplitude,
                                 batch, draws)
    return np.stack([np.asarray(tensor2im(img)) for img in images.cpu()])


def write_frames(frames: np.ndarray, path: str, fps: int = 30) -> str:
    """Encode frames as an mp4 at `path` through imageio; without an mp4
    encoder as a GIF beside it; without imageio as `<path>.frames.npz`.
    Returns the file written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, list(frames), fps=fps)
        return path
    except Exception:
        # No mp4 encoder (ffmpeg): a GIF (imageio's pillow plugin), then
        # the raw frames.
        try:
            import imageio.v2 as imageio

            gif = os.path.splitext(path)[0] + ".gif"
            imageio.mimwrite(gif, list(frames), duration=1000.0 / fps, loop=0)
            return gif
        except Exception:
            np.savez(path + ".frames.npz", frames=frames)
            return path + ".frames.npz"


def render_orbit_video(generator, w, path: str, num_frames: int = 60, fps: int = 30,
                       yaw_amplitude: float = 0.5, pitch_amplitude: float = 0.15):
    """Render the orbit and encode it (`write_frames`). Returns (frames,
    the file written)."""
    frames = render_orbit_frames(generator, w, num_frames=num_frames,
                                 yaw_amplitude=yaw_amplitude, pitch_amplitude=pitch_amplitude)
    return frames, write_frames(frames, path, fps)
