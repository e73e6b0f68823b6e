"""The ray marcher's cumulative product (`ray_marcher.cumprod_positive`) on
the CPU, no JAX: its forward and backward bitwise torch.cumprod's on
inputs without zeros, in float32 and bfloat16, alone and under
torch.func.vmap (one call over the batch); `march_rays`' outputs and input
gradients bitwise those it gave with torch.cumprod."""

import pytest
import torch

from spi_tpu_torch.models.rendering import ray_marcher
from spi_tpu_torch.utils.params import vmap_strict
from torch_threads import few_torch_threads  # noqa: F401


def _positive(shape, dtype, seed):
    """Entries in [0.05, 1.55): no zero, some products above and below 1."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=gen) * 1.5 + 0.05).to(dtype)


def _grads(fn, x, g):
    x = x.clone().requires_grad_(True)
    y = fn(x)
    y.backward(g)
    return y.detach(), x.grad


@pytest.mark.parametrize("shape,dim", [((3, 5, 7, 1), -2), ((4, 9), 1), ((6, 2, 3), 0),
                                       ((2, 1, 5), 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cumprod_matches_torch(dtype, shape, dim):
    x = _positive(shape, dtype, 0)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    y, dx = _grads(lambda t: ray_marcher.cumprod_positive(t, dim), x, g)
    want_y, want_dx = _grads(lambda t: torch.cumprod(t, dim), x, g)
    assert y.dtype == dtype and torch.equal(y, want_y)
    assert torch.equal(dx, want_dx)


@pytest.mark.parametrize("dim", [-2, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cumprod_under_vmap(dtype, dim):
    """Three images of (4, 6, 1): the batched forward and the backward run
    after it equal torch.cumprod's over the stacked batch."""
    x = _positive((3, 4, 6, 1), dtype, 2)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(dtype)
    batched = vmap_strict(lambda t: ray_marcher.cumprod_positive(t, dim))
    y, dx = _grads(batched, x, g)
    want_y, want_dx = _grads(lambda t: torch.cumprod(t, dim + 1 if dim >= 0 else dim), x, g)
    assert torch.equal(y, want_y)
    assert torch.equal(dx, want_dx)


@pytest.mark.parametrize("white_back", [False, True])
def test_march_rays_as_with_torch_cumprod(monkeypatch, white_back):
    """Densities up to 40 over unit depth steps: 1 - alpha underflows to 0
    on some samples, where the + 1e-10 keeps the product's input
    positive."""
    gen = torch.Generator().manual_seed(4)
    n, m, s = 2, 16, 12
    colors = torch.rand(n, m, s, 3, generator=gen) * 2 - 1
    densities = torch.randn(n, m, s, 1, generator=gen) * 20
    depths = torch.sort(torch.rand(n, m, s, 1, generator=gen) * s, dim=2).values
    cotangents = [torch.randn(shape, generator=gen) for shape in
                  ((n, m, 3), (n, m, 1), (n, m, s - 1, 1))]

    def run():
        inputs = [t.clone().requires_grad_(True) for t in (colors, densities, depths)]
        outs = ray_marcher.march_rays(*inputs, white_back=white_back)
        torch.autograd.backward(outs, cotangents)
        return [o.detach() for o in outs], [t.grad for t in inputs]

    outs, grads = run()
    monkeypatch.setattr(ray_marcher, "cumprod_positive", torch.cumprod)
    want_outs, want_grads = run()
    for got, want in zip(outs + grads, want_outs + want_grads):
        assert torch.equal(got, want)
