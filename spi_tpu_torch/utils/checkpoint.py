"""Flat dotted-key npz checkpoints (counterpart of spi_tpu/utils/checkpoint.py).

The JAX package writes parameters as a flat npz whose keys are the
dotted pytree paths (`backbone.synthesis.b4.conv1.weight`,
`decoder.net.0.weight`, `lin.0`, ...). The port names its parameters and
buffers after the same paths, so loading is a checked one-to-one copy,
and what the port writes (`save_flat`, `module_flat`) the JAX package's
`load_pytree` reads, and the other way round.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# The perception bundle's sections (spi_tpu/training/pipeline.py:108-125):
# the LPIPS of the losses, the BoxCX VGG19 and the metric's LPIPS + ID net.
PERCEPTION_PREFIXES = ("lpips", "boxcx", "metric")


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Read an npz written by `spi_tpu.utils.checkpoint.save_pytree`."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return {k: np.asarray(data[k]) for k in data.files}


def load_flat_params(module: torch.nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Copy a flat {dotted key: array} dict into `module`'s parameters and
    buffers, in place.

    The copy is one-to-one: every key of `flat` must name a tensor of
    the module and every tensor must be given, with equal shapes.
    Raises ValueError listing what does not match.
    """
    # Every parameter and persistent buffer; constants such as the FIR
    # filters are non-persistent and not in the checkpoint.
    state = module.state_dict(keep_vars=True)
    missing = sorted(set(state) - set(flat))
    unexpected = sorted(set(flat) - set(state))
    if missing or unexpected:
        raise ValueError(
            f"checkpoint keys do not match the module: missing {missing[:8]} "
            f"({len(missing)}), unexpected {unexpected[:8]} ({len(unexpected)})"
        )
    bad = [
        (k, tuple(np.shape(flat[k])), tuple(t.shape))
        for k, t in state.items()
        if tuple(np.shape(flat[k])) != tuple(t.shape)
    ]
    if bad:
        raise ValueError(f"shape mismatch (key, checkpoint, module): {bad[:8]}")
    with torch.no_grad():
        for k, t in state.items():
            t.copy_(torch.tensor(np.asarray(flat[k]), dtype=t.dtype))


def module_flat(module: torch.nn.Module, prefix: str = "") -> dict[str, np.ndarray]:
    """A module's parameters and persistent buffers as {prefix + dotted key:
    array}: the keys `spi_tpu.utils.checkpoint.flatten_pytree` gives the
    same weights under `prefix`."""
    return {prefix + k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def save_flat(path: str, flat: dict) -> None:
    """Write {dotted key: array or tensor} as an npz, as `save_pytree` does."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                      for k, v in flat.items()})


def split_perception(flat: dict[str, np.ndarray]) -> dict[str, dict[str, np.ndarray]]:
    """A perception bundle's flat keys -> {section: {key within it: array}}
    for the sections present. Raises on a key outside PERCEPTION_PREFIXES."""
    out: dict[str, dict[str, np.ndarray]] = {}
    for k, v in flat.items():
        section, _, rest = k.partition(".")
        if section not in PERCEPTION_PREFIXES or not rest:
            raise ValueError(f"perception bundle key {k!r} is outside {PERCEPTION_PREFIXES}")
        out.setdefault(section, {})[rest] = v
    return out
