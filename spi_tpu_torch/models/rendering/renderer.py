"""Two-pass (coarse + importance) triplane volume renderer (counterpart of
spi_tpu/models/rendering/renderer.py; spec EG3D renderer.py).

Every pass samples the planes through `ops.sample_planes`, whose
backward is the splat kernel: coarse, fine and multi-camera alike.
The coarse and fine samples are composited by sorting their union
(`march_rays_merge`), and the importance inverse CDF brackets with
`searchsorted`; spi_tpu's sortless rank merge and masked reductions
were TPU choices.

Randomness: the stratified jitter (N, M, S, 1) uniforms and the
order-statistics (N*M, I+1) exponentials come either from a
`torch.Generator` or, as tensors, from the caller, so that a test can
hand this renderer and spi_tpu's the same draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from spi_tpu_torch.models.rendering import math_utils
from spi_tpu_torch.models.rendering.ray_marcher import march_rays, march_rays_merge
from spi_tpu_torch.ops.plane_splat import RayGeom, project_onto_planes, sample_planes

__all__ = [
    "ImportanceRenderer",
    "RayGeom",
    "RenderingOptions",
    "project_onto_planes",
    "sample_from_planes",
    "sample_importance",
    "sample_pdf",
    "sample_stratified",
]


@dataclasses.dataclass(frozen=True)
class RenderingOptions:
    """The rendering_kwargs the renderer consumes (EG3D triplane.py:44,
    renderer.py:91-140)."""

    depth_resolution: int = 48
    depth_resolution_importance: int = 48
    ray_start: float | str = 2.25  # 'auto' = box intersection
    ray_end: float | str = 3.3
    box_warp: float = 1.0
    disparity_space_sampling: bool = False
    white_back: bool = False


def sample_from_planes(planes_nhwc, coordinates, box_warp: float, geom: RayGeom | None = None):
    """Bilinear-sample (N|1, 3, H*W, C) channels-last planes at (N, M, 3)
    world points -> (N, 3, M, C) (EG3D renderer.py:55-65). `geom`, the ray
    geometry of the N * M points (spi_tpu's `geom=RayGeom`), only decides
    which points share a tile of the splat kernel."""
    n_tab, n_planes, _, c = planes_nhwc.shape
    n, m, _ = coordinates.shape
    if n_tab == 1 and n > 1:
        # Planes shared by a camera batch: merge the batch into the point
        # axis so each plane is one table.
        out = sample_planes(planes_nhwc, coordinates.reshape(1, n * m, 3), box_warp, geom)
        return out[0].reshape(n_planes, n, m, c).permute(1, 0, 2, 3)
    if n_tab != n:
        raise ValueError(f"{n_tab} plane sets for {n} point sets")
    return sample_planes(planes_nhwc, coordinates, box_warp, geom)


def _draw_uniform(shape, device, generator):
    return torch.rand(shape, generator=generator, device=device)


def sample_stratified(ray_origins, ray_start, ray_end, depth_resolution: int,
                      disparity_space_sampling: bool = False, uniform=None,
                      generator=None):
    """Jittered uniform depths (N, M, S, 1) (EG3D renderer.py:169-192).

    ray_start/ray_end: floats, or (N, M, 1) tensors from the box
    intersection. `uniform`: the (N, M, S, 1) jitter draws, else drawn
    from `generator`.
    """
    n, m, _ = ray_origins.shape
    s = depth_resolution
    dev = ray_origins.device
    if uniform is None:
        uniform = _draw_uniform((n, m, s, 1), dev, generator)
    if disparity_space_sampling:
        depths = torch.linspace(0.0, 1.0, s, device=dev).reshape(1, 1, s, 1)
        depths = depths + uniform * (1.0 / (s - 1))
        return 1.0 / (1.0 / ray_start * (1.0 - depths) + 1.0 / ray_end * depths)
    if isinstance(ray_start, (float, int)):
        depths = torch.linspace(float(ray_start), float(ray_end), s, device=dev)
        delta = (float(ray_end) - float(ray_start)) / (s - 1)
        return depths.reshape(1, 1, s, 1) + uniform * delta
    depths = math_utils.linspace_batched(ray_start, ray_end, s).permute(1, 2, 0, 3)
    delta = (ray_end - ray_start) / (s - 1)
    return depths + uniform * delta[..., None]


def sample_pdf(bins, weights, n_importance: int, det: bool = False, eps: float = 1e-5,
               exponential=None, generator=None):
    """Inverse-CDF sampling (EG3D renderer.py:214-253), with ascending
    uniforms: u_k = S_k / S_{I+1} for S the running sum of I+1
    Exp(1) draws (`exponential`, (R, I+1), else drawn from `generator`),
    which is distributed as the sorted draw of I uniforms.

    bins: (R, B); weights: (R, W). Returns (R, n_importance).
    """
    r, n_bins_w = weights.shape
    if n_bins_w == 0:
        # depth_resolution <= 3 trims the smoothed weights to nothing:
        # fall back to a uniform pdf over the bin segments.
        n_bins_w = bins.shape[1] - 1
        if n_bins_w < 1:
            raise ValueError(f"need >= 2 bins, got {tuple(bins.shape)}")
        weights = torch.ones(r, n_bins_w, dtype=bins.dtype, device=bins.device)
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)

    if det:
        u = torch.linspace(0.0, 1.0, n_importance, device=bins.device).expand(r, n_importance)
    else:
        if exponential is None:
            exponential = torch.empty(r, n_importance + 1, device=bins.device).exponential_(
                generator=generator)
        cum = torch.cumsum(exponential, dim=-1)
        u = cum[:, :n_importance] / cum[:, n_importance:]
    u = u.contiguous()

    nb = n_bins_w + 1  # cdf entries; bins[j] pairs with cdf[j]
    bins_nb = bins[:, :nb]
    inds = torch.searchsorted(cdf, u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=nb - 1)
    cdf_g0 = torch.gather(cdf, 1, below)
    cdf_g1 = torch.gather(cdf, 1, above)
    bins_g0 = torch.gather(bins_nb, 1, below)
    bins_g1 = torch.gather(bins_nb, 1, above)
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_g0 + (u - cdf_g0) / denom * (bins_g1 - bins_g0)


@torch.no_grad()
def sample_importance(z_vals, weights, n_importance: int, exponential=None, generator=None):
    """Importance depths (N, M, I, 1) from the coarse depths (N, M, S, 1)
    and weights (N, M, S-1, 1) (EG3D renderer.py:194-212); no gradient."""
    n, m, s, _ = z_vals.shape
    z = z_vals.reshape(n * m, s)
    w = weights.reshape(n * m, -1)
    # max_pool1d(k=2, s=1, p=1) then avg_pool1d(k=2, s=1), -inf padding.
    wp = F.pad(w, (1, 1), value=float("-inf"))
    w_max = torch.maximum(wp[:, :-1], wp[:, 1:])
    w_smooth = (w_max[:, :-1] + w_max[:, 1:]) / 2.0 + 0.01
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    samples = sample_pdf(z_mid, w_smooth[:, 1:-1], n_importance,
                         exponential=exponential, generator=generator)
    return samples.reshape(n, m, n_importance, 1)


@dataclasses.dataclass(frozen=True)
class ImportanceRenderer:
    """Two-pass renderer (EG3D renderer.py:82-148). `decoder` is supplied
    per call: (features (N, P, C), directions (N, P, 3)) -> (rgb, sigma)."""

    options: RenderingOptions

    def __call__(self, planes_nhwc, decoder: Callable, ray_origins, ray_directions,
                 draws: dict | None = None, generator=None, rays_w: int | None = None):
        """Render (N, M, 3) rays -> (rgb (N, M, C), depth (N, M, 1),
        weight sum (N, M, 1)).

        draws: optional {'stratified': (N, M, S, 1) uniforms,
        'exponential': (N*M, I+1) Exp(1) draws}; what is not given is
        drawn from `generator`. rays_w: the scanline width of the rays
        (the render resolution); it only informs the splat kernel's ray
        tiles and may be omitted.
        """
        opts = self.options
        draws = draws or {}

        if opts.ray_start == opts.ray_end == "auto":
            ray_start, ray_end = math_utils.get_ray_limits_box(
                ray_origins.detach(), ray_directions.detach(), box_side_length=opts.box_warp)
            is_valid = ray_end > ray_start
            valid_min = torch.where(is_valid, ray_start, torch.full_like(ray_start, float("inf"))).min()
            valid_max = torch.where(is_valid, ray_start, torch.full_like(ray_start, float("-inf"))).max()
            ray_start = torch.where(is_valid, ray_start, valid_min)
            ray_end = torch.where(is_valid, ray_end, valid_max)
        else:
            ray_start, ray_end = opts.ray_start, opts.ray_end

        depths_coarse = sample_stratified(
            ray_origins, ray_start, ray_end, opts.depth_resolution,
            opts.disparity_space_sampling, uniform=draws.get("stratified"),
            generator=generator,
        )
        n, m, _, _ = depths_coarse.shape

        def run(depths, fine):
            k = depths.shape[2]
            pts = (ray_origins[:, :, None, :] + depths * ray_directions[:, :, None, :])
            geom = (RayGeom(n, m // rays_w, rays_w, k, fine)
                    if rays_w and m % rays_w == 0 else None)
            feats = sample_from_planes(planes_nhwc, pts.reshape(n, -1, 3), opts.box_warp, geom)
            feats = feats.mean(dim=1)  # aggregate planes (EG3D triplane.py:125)
            dirs = ray_directions[:, :, None, :].expand(n, m, k, 3).reshape(n, -1, 3)
            rgb, sigma = decoder(feats, dirs)
            return rgb.reshape(n, m, k, rgb.shape[-1]), sigma.reshape(n, m, k, 1)

        colors_coarse, densities_coarse = run(depths_coarse, False)

        n_imp = opts.depth_resolution_importance
        if n_imp > 0:
            _, _, weights = march_rays(colors_coarse, densities_coarse, depths_coarse,
                                       white_back=opts.white_back)
            depths_fine = sample_importance(depths_coarse, weights, n_imp,
                                            exponential=draws.get("exponential"),
                                            generator=generator)
            colors_fine, densities_fine = run(depths_fine, True)
            rgb_final, depth_final, weights = march_rays_merge(
                colors_coarse, densities_coarse, depths_coarse,
                colors_fine, densities_fine, depths_fine, white_back=opts.white_back,
            )
        else:
            rgb_final, depth_final, weights = march_rays(
                colors_coarse, densities_coarse, depths_coarse, white_back=opts.white_back)
        return rgb_final, depth_final, weights.sum(dim=2)
