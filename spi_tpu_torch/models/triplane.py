"""TriPlaneGenerator: the EG3D generator (counterpart of
spi_tpu/models/triplane.py; spec EG3D triplane.py).

camera 25-vector -> rays; StyleGAN2 backbone -> 3 x 32-channel planes,
kept channels-last (N, 3, H*W, C) at the public functions; importance
render of a 32-channel feature image and depth at the neural
resolution; superresolution to the output resolution.

Configurations are `TriPlaneConfig` values (`ffhq512_128_config`,
`tiny_test_config`); `TriPlaneGenerator(cfg, device=...)` builds the
module on its device, with weights drawn from `seed`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from spi_tpu_torch.models.rendering import ImportanceRenderer, RenderingOptions, sample_rays
from spi_tpu_torch.models.stylegan2 import FullyConnected, Generator, seeded_init
from spi_tpu_torch.models.superresolution import Superresolution
from spi_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TriPlaneConfig:
    """Architecture of a TriPlaneGenerator (fields of spi_tpu's
    TriPlaneGenerator dataclass that the port reads)."""

    z_dim: int = 512
    c_dim: int = 25
    w_dim: int = 512
    img_resolution: int = 512
    img_channels: int = 3
    backbone_resolution: int = 256
    plane_channels: int = 32
    neural_rendering_resolution: int = 128
    rendering: RenderingOptions = RenderingOptions()
    sr_variant: str = "SuperresolutionHybrid8XDC"
    sr_antialias: bool = True
    sr_noise_mode: str = "none"
    sr_channel_max: int | None = None
    c_gen_conditioning_zero: bool = False
    c_scale: float = 1.0
    channel_base: int = 32768
    channel_max: int = 512


def ffhq512_128_config(**overrides) -> TriPlaneConfig:
    """Architecture of the ffhqrebalanced512-128.pkl checkpoint
    (spi/utils/load_utils.py:15-33; EG3D FFHQ rendering kwargs)."""
    defaults = dict(
        z_dim=512, c_dim=25, w_dim=512, img_resolution=512,
        neural_rendering_resolution=128,
        rendering=RenderingOptions(depth_resolution=48, depth_resolution_importance=48,
                                   ray_start=2.25, ray_end=3.3, box_warp=1.0,
                                   white_back=False),
        sr_variant="SuperresolutionHybrid8XDC", sr_antialias=True,
        c_gen_conditioning_zero=False, c_scale=1.0,
    )
    defaults.update(overrides)
    return TriPlaneConfig(**defaults)


def tiny_test_config(**overrides) -> TriPlaneConfig:
    """Scaled-down generator of the same family: 128^2 output, 16^2 neural
    render, 4+4 depth samples."""
    defaults = dict(
        z_dim=32, c_dim=25, w_dim=32, img_resolution=128, backbone_resolution=32,
        neural_rendering_resolution=16,
        rendering=RenderingOptions(depth_resolution=4, depth_resolution_importance=4),
        sr_variant="SuperresolutionHybrid2X", channel_base=1024, channel_max=64,
    )
    defaults.update(overrides)
    return TriPlaneConfig(**defaults)


class OSGDecoder(nn.Module):
    """2-layer softplus MLP 32 -> 64 -> 1+32 with the MipNeRF sigmoid clamp
    (EG3D triplane.py:112-135). Parameters: net.0 and net.2, the
    reference's Sequential indices."""

    def __init__(self, n_features=32, hidden_dim=64, output_dim=32, lr_multiplier=1.0,
                 device=None):
        super().__init__()
        self.net = nn.ModuleDict({
            "0": FullyConnected(n_features, hidden_dim, lr_multiplier=lr_multiplier,
                                device=device),
            "2": FullyConnected(hidden_dim, 1 + output_dim, lr_multiplier=lr_multiplier,
                                device=device),
        })

    def forward(self, sampled_features, ray_directions):
        """features (N, M, C), plane-aggregated -> (rgb (N, M, out), sigma (N, M, 1))."""
        n, m, c = sampled_features.shape
        x = self.net["0"](sampled_features.reshape(n * m, c))
        x = F.softplus(x)
        x = self.net["2"](x).reshape(n, m, -1)
        rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001
        sigma = x[..., 0:1]
        return rgb, sigma


class TriPlaneGenerator(nn.Module):
    """EG3D's generator: backbone (mapping + synthesis), decoder,
    superresolution. Entry points mirror spi_tpu's: `mapping`,
    `planes_nhwc` (spi_tpu's `_planes_nhwc`), `synthesis`,
    `synthesis_from_planes`.

    device: None means `cuda`, and raises when no GPU is present;
    pass `device='cpu'` to run the plain versions on the CPU.
    """

    def __init__(self, cfg: TriPlaneConfig, device=None, seed: int = 0):
        super().__init__()
        if cfg.sr_noise_mode not in ("none", "const"):
            raise ValueError(f"sr_noise_mode {cfg.sr_noise_mode!r} is not supported")
        dev = resolve_device(device)
        self.cfg = cfg
        self.backbone = Generator(cfg.z_dim, cfg.c_dim, cfg.w_dim, cfg.backbone_resolution,
                                  cfg.plane_channels * 3, channel_base=cfg.channel_base,
                                  channel_max=cfg.channel_max, device=dev)
        self.decoder = OSGDecoder(cfg.plane_channels, output_dim=cfg.plane_channels,
                                  device=dev)
        self.superresolution = Superresolution(
            cfg.sr_variant, cfg.img_resolution, channels=cfg.plane_channels,
            sr_antialias=cfg.sr_antialias, w_dim=cfg.w_dim,
            channel_max=cfg.sr_channel_max, device=dev,
        )
        self.renderer = ImportanceRenderer(cfg.rendering)
        seeded_init(self, seed)

    @property
    def num_ws(self) -> int:
        return self.backbone.num_ws

    @property
    def w_dim(self) -> int:
        return self.cfg.w_dim

    @property
    def z_dim(self) -> int:
        return self.cfg.z_dim

    def mapping(self, z, c, truncation_psi=1.0, truncation_cutoff=None):
        if self.cfg.c_gen_conditioning_zero:
            c = torch.zeros_like(c)
        return self.backbone.mapping(z, c * self.cfg.c_scale, truncation_psi=truncation_psi,
                                     truncation_cutoff=truncation_cutoff)

    def planes_nhwc(self, ws, noise_mode="const"):
        """ws (N, num_ws, w_dim) -> planes (N, 3, H*W, plane_channels)."""
        planes = self.backbone.synthesis(ws, noise_mode=noise_mode)  # (N, 96, H, W)
        n, _, h, w = planes.shape
        pc = self.cfg.plane_channels
        return planes.reshape(n, 3, pc, h, w).permute(0, 1, 3, 4, 2).reshape(n, 3, h * w, pc)

    def synthesis(self, ws, c, neural_rendering_resolution=None, noise_mode="const",
                  draws: dict | None = None, generator=None):
        """ws: (N, num_ws, w_dim); c: (N, 25) -> {'image', 'image_raw',
        'image_depth'} (EG3D triplane.py:53-89).

        draws: the renderer's random numbers as tensors
        ({'stratified', 'exponential'}, see ImportanceRenderer); what is
        not given is drawn from `generator`.
        """
        planes = self.planes_nhwc(ws, noise_mode=noise_mode)
        out = self.synthesis_from_planes(planes, ws, c, neural_rendering_resolution,
                                         draws=draws, generator=generator)
        return {k: out[k] for k in ("image", "image_raw", "image_depth")}

    def synthesis_from_planes(self, planes, ws, c, neural_rendering_resolution=None,
                              draws: dict | None = None, generator=None):
        """Render camera batch `c` (N, 25) from precomputed planes
        (1|N, 3, H*W, C), broadcast over the cameras."""
        res = neural_rendering_resolution or self.cfg.neural_rendering_resolution
        n = c.shape[0]
        cam2world = c[:, :16].reshape(-1, 4, 4)
        intrinsics = c[:, 16:25].reshape(-1, 3, 3)
        ray_origins, ray_directions = sample_rays(cam2world, intrinsics, res)
        feature_samples, depth_samples, _ = self.renderer(
            planes, self.decoder, ray_origins, ray_directions, draws=draws,
            generator=generator, rays_w=res,
        )
        feature_image = feature_samples.permute(0, 2, 1).reshape(n, feature_samples.shape[-1],
                                                                 res, res)
        depth_image = depth_samples.permute(0, 2, 1).reshape(n, 1, res, res)
        rgb_image = feature_image[:, :3]
        out = {"image_raw": rgb_image, "image_depth": depth_image}
        if ws.shape[0] != n:
            ws = ws.expand(n, *ws.shape[1:])
        out["image"] = self.superresolution(rgb_image, feature_image, ws,
                                            noise_mode=self.cfg.sr_noise_mode)
        return out
