"""Density regularizers at free points (counterpart of
spi_tpu/criteria/tv_loss.py; spec spi/criteria/tv_loss.py).

`tv_loss`: L1 between the densities at `n_points` uniform points of the
[-1, 1]^3 box and at the same points moved by N(0, 0.004^2) (:9-19).
`monotonic_loss`: density must not grow toward the camera (:22-32).
The points lie on no ray, so the splat kernel tiles them as runs of
consecutive points.

Random draws come from `draws` (so that a test can hand both sides
spi_tpu's numbers) or from a `torch.Generator`.
"""

from __future__ import annotations

import torch

DENSITY_REG_P_DIST = 0.004


def _draw(draws, key, shape, kind, device, generator):
    if draws is not None and key in draws:
        return draws[key].to(device)
    if kind == "uniform":
        return torch.rand(shape, generator=generator, device=device)
    return torch.randn(shape, generator=generator, device=device)


def tv_draws(draws: dict | None, n: int, n_points: int = 1000, dev=None, rng=None) -> dict:
    """`tv_loss`'s draws for `n` point sets: those in `draws`, the rest
    drawn from `rng` in the order tv_loss uses them."""
    uniform = _draw(draws, "uniform", (n, n_points, 3), "uniform", dev, rng)
    perturb = _draw(draws, "perturb", (n, n_points, 3), "normal", dev, rng)
    directions = _draw(draws, "directions", (n, 2 * n_points, 3), "normal", dev, rng)
    return {"uniform": uniform, "perturb": perturb, "directions": directions}


def tv_loss(generator, ws, n_points: int = 1000, draws: dict | None = None, rng=None,
            planes=None):
    """draws: {'uniform': (N, n, 3) U[0, 1), 'perturb': (N, n, 3) N(0, 1),
    'directions': (N, 2n, 3) N(0, 1)}; what is missing is drawn from
    `rng`. planes: `generator.planes_nhwc(ws)`, where the caller has them."""
    d = tv_draws(draws, ws.shape[0], n_points, ws.device, rng)
    initial = d["uniform"] * 2 - 1
    perturbed = initial + d["perturb"] * DENSITY_REG_P_DIST
    coords = torch.cat([initial, perturbed], dim=1)
    _, sigma = generator.sample_mixed(ws, coords, d["directions"], planes=planes)
    return (sigma[:, :n_points] - sigma[:, n_points:]).abs().mean()


def monotonic_loss(generator, ws, n_points: int = 2000, box_warp: float = 1.0,
                   draws: dict | None = None, rng=None, planes=None):
    """draws: {'uniform': (N, n, 3) U[0, 1), 'directions': (N, 2n, 3)
    N(0, 1)}; what is missing is drawn from `rng`."""
    n, dev = ws.shape[0], ws.device
    initial = _draw(draws, "uniform", (n, n_points, 3), "uniform", dev, rng) * 2 - 1
    behind = initial + torch.tensor([0.0, 0.0, -1.0], device=dev) * (1 / 256) * box_warp
    coords = torch.cat([initial, behind], dim=1)
    directions = _draw(draws, "directions", coords.shape, "normal", dev, rng)
    _, sigma = generator.sample_mixed(ws, coords, directions, planes=planes)
    return torch.relu(sigma[:, :n_points] - sigma[:, n_points:]).mean() * 10
