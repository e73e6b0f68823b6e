"""Noise-map and trainable-parameter utilities (counterpart of
spi_tpu/utils/params.py).

The noise maps are the generator's `noise_const` buffers, keyed by
their dotted names, which equal the JAX package's pytree paths
(`backbone.synthesis.b8.conv0.noise_const`, ...).
"""

from __future__ import annotations

import contextlib
import itertools

import torch
from torch import nn


def extract_noise(module: nn.Module) -> dict[str, torch.Tensor]:
    """The `noise_const` buffers of `module`, by dotted name."""
    return {k: v for k, v in module.named_buffers() if k.endswith("noise_const")}


@contextlib.contextmanager
def replace_noise(module: nn.Module, noise: dict[str, torch.Tensor]):
    """Within the block, `module` reads `noise[name]` in place of each
    named buffer (the tensors may require grad); restored on exit."""
    saved = []
    try:
        for name, value in noise.items():
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if attr not in owner._buffers:
                raise KeyError(f"{name} is not a buffer of the module")
            saved.append((owner, attr, owner._buffers[attr]))
            owner._buffers[attr] = value
        yield module
    finally:
        for owner, attr, value in reversed(saved):
            owner._buffers[attr] = value


def init_noise_like(module: nn.Module, generator=None) -> dict[str, torch.Tensor]:
    """Fresh standard-normal noise maps, one per buffer, drawn in sorted
    name order (w_projector.py:58-60)."""
    noise = extract_noise(module)
    return {
        k: torch.randn(v.shape, generator=generator, device=v.device, dtype=v.dtype)
        for k, v in sorted(noise.items())
    }


def trainable_parameters(module: nn.Module) -> dict[str, nn.Parameter]:
    """The parameters the stage-2 optimizer updates, by dotted name: the
    counterpart of `trainable_mask`, which is True for every leaf but the
    `noise_const` and `w_avg` buffers (base_coach.py:132-135). In the port
    those are buffers, not parameters, so this is every parameter."""
    return dict(module.named_parameters())


def cast_call(module: nn.Module, dtype: torch.dtype, *args, **kwargs):
    """`module(*args, **kwargs)` on copies of its floating parameters and
    buffers cast to `dtype` (spi_tpu's `_cast` of a parameter subtree): the
    module keeps its float32 master weights, and their gradients come back
    float32 through the casts. The buffers read are those in place at the
    call, so noise maps swapped in by `replace_noise` are cast too.
    float32 calls the module as it is."""
    if dtype == torch.float32:
        return module(*args, **kwargs)
    tensors = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in itertools.chain(module.named_parameters(), module.named_buffers())}
    return torch.func.functional_call(module, tensors, args, kwargs)
