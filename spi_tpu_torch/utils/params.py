"""Noise-map and trainable-parameter utilities (counterpart of
spi_tpu/utils/params.py).

The noise maps are the generator's `noise_const` buffers, keyed by
their dotted names, which equal the JAX package's pytree paths
(`backbone.synthesis.b8.conv0.noise_const`, ...).
"""

from __future__ import annotations

import contextlib
import itertools

import numpy as np
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


class _Apply(nn.Module):
    """Runs fn(*args, **kwargs) as its forward, with `module` registered
    under it so that functional_call can stand tensors in for its state."""

    def __init__(self, module: nn.Module, fn):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def functional_apply(module: nn.Module, tensors: dict[str, torch.Tensor], fn, *args, **kwargs):
    """fn(*args, **kwargs) (typically a method of `module`) with `tensors`,
    by dotted name, standing in for those parameters and buffers of
    `module`: `torch.func.functional_call`, the functional form of
    `replace_noise`. No tensor of the module is written, so `tensors` may
    be batched under `torch.func.vmap`: each image's noise maps (handed in
    as buffers) or its own tuned weights. Names that are neither a
    parameter nor a buffer of the module raise."""
    known = {k for k, _ in itertools.chain(module.named_parameters(), module.named_buffers())}
    unknown = set(tensors) - known
    if unknown:
        raise KeyError(f"not a parameter or buffer of the module: {sorted(unknown)[:4]}")
    return torch.func.functional_call(
        _Apply(module, fn), {f"module.{k}": v for k, v in tensors.items()}, args, kwargs,
        tie_weights=False)


def vmap_strict(fn, in_dims=0):
    """`torch.func.vmap(fn, in_dims)` with PyTorch's per-image fallback off
    while it runs: an operator without a batching rule raises rather than
    quietly looping over the images, so a batched step is one launch a
    layer or an error."""
    batched = torch.func.vmap(fn, in_dims=in_dims)

    def run(*args):
        before = torch._C._functorch._is_vmap_fallback_enabled()
        torch._C._functorch._set_vmap_fallback_enabled(False)
        try:
            return batched(*args)
        finally:
            torch._C._functorch._set_vmap_fallback_enabled(before)

    return run


def stack_trees(trees):
    """Stack same-structure nests of dicts, lists and tuples of tensors
    along a new leading image axis."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return type(first)(stack_trees(list(parts)) for parts in zip(*trees))


def index_tree(tree, i: int):
    """Image i of a nest with a leading image axis."""
    if torch.is_tensor(tree):
        return tree[i]
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return type(tree)(index_tree(v, i) for v in tree)


def to_device(tree, device):
    """A nest of dicts, lists and tuples of tensors (and None) with every
    tensor on `device`."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return type(tree)(to_device(v, device) for v in tree)


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
    call, so noise maps swapped in by `replace_noise` are cast too, and
    under `functional_apply` (inside `torch.func.vmap` too) the tensors it
    stands in, each image's own, are the ones cast. float32 calls the
    module as it is."""
    if dtype == torch.float32:
        return module(*args, **kwargs)
    tensors = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in itertools.chain(module.named_parameters(), module.named_buffers())}
    return torch.func.functional_call(module, tensors, args, kwargs)


def count_params(tree) -> int:
    """Entries in a module's parameters, or in a nest of dicts, lists and
    tuples of tensors or arrays (spi_tpu's count over a pytree's leaves)."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return tree.numel() if torch.is_tensor(tree) else int(np.size(tree))
