"""MipNeRF-style alpha compositing (counterpart of
spi_tpu/models/rendering/ray_marcher.py; spec EG3D ray_marcher.py:25-57)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _CumprodPositive(torch.autograd.Function):
    """torch.cumprod along `dim` of an input with no zero entry, whose
    backward never reads back to the host. PyTorch's own backward tests
    `(input == 0).any()` on the host to pick a formula; on an input without
    zeros it takes the reversed cumulative sum of output * grad, divided by
    the input, which is this backward, operation for operation, so the
    results are bitwise PyTorch's. A zero in the input gives inf or nan
    gradients here: the caller guarantees there is none."""

    @staticmethod
    def forward(x, dim):
        return torch.cumprod(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dim = inputs
        ctx.save_for_backward(x, output)
        ctx.dim = dim

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        if x.shape[ctx.dim] == 1:
            return g, None
        return (out * g).flip(ctx.dim).cumsum(ctx.dim).flip(ctx.dim).div(x), None

    @staticmethod
    def vmap(info, in_dims, x, dim):
        """Under torch.func.vmap: one call over the batch, its axis first."""
        if in_dims[0] is None:
            return _CumprodPositive.apply(x, dim), None
        return _CumprodPositive.apply(x.movedim(in_dims[0], 0), dim + 1 if dim >= 0 else dim), 0


def cumprod_positive(x, dim: int):
    """torch.cumprod(x, dim) for an `x` with no zero entry (not checked):
    the same values and gradients, without a host read-back in the
    backward, so it runs inside a CUDA graph capture."""
    return _CumprodPositive.apply(x, dim)


def march_rays(colors, densities, depths, *, white_back: bool = False):
    """Composite samples along each ray.

    colors (N, M, S, C), densities (N, M, S, 1), depths (N, M, S, 1)
    ascending along S -> (composite_rgb (N, M, C) in [-1, 1],
    composite_depth (N, M, 1), weights (N, M, S-1, 1)).
    """
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    densities_mid = (densities[:, :, :-1] + densities[:, :, 1:]) / 2
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2

    densities_mid = F.softplus(densities_mid - 1.0)
    alpha = 1.0 - torch.exp(-densities_mid * deltas)
    # Positive by construction: 1 - alpha = exp(-density * delta) >= 0, plus 1e-10.
    alpha_shifted = torch.cat([torch.ones_like(alpha[:, :, :1]), 1.0 - alpha + 1e-10], dim=-2)
    weights = alpha * cumprod_positive(alpha_shifted, -2)[:, :, :-1]

    composite_rgb = (weights * colors_mid).sum(dim=-2)
    weight_total = weights.sum(dim=2)
    composite_depth = (weights * depths_mid).sum(dim=-2) / weight_total
    composite_depth = torch.nan_to_num(composite_depth, nan=float("inf"))
    composite_depth = torch.clamp(composite_depth, depths.min(), depths.max())

    if white_back:
        composite_rgb = composite_rgb + 1.0 - weight_total
    composite_rgb = composite_rgb * 2.0 - 1.0
    return composite_rgb, composite_depth, weights


def march_rays_merge(colors1, densities1, depths1, colors2, densities2, depths2,
                     *, white_back: bool = False):
    """march_rays over the union of two sample groups, sorted by depth
    (EG3D renderer.py:157-167 unify_samples). A stable sort keeps group 1
    first on ties, as spi_tpu's rank merge does."""
    depths = torch.cat([depths1, depths2], dim=-2)
    order = torch.sort(depths[..., 0], dim=-1, stable=True).indices[..., None]

    def take(x):
        return torch.gather(x, 2, order.expand(*order.shape[:-1], x.shape[-1]))

    return march_rays(
        take(torch.cat([colors1, colors2], dim=-2)),
        take(torch.cat([densities1, densities2], dim=-2)),
        take(depths),
        white_back=white_back,
    )
