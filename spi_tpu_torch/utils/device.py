"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another, with the current card's index where none is given (the
    device that modules moved to `cuda` report). Raises when CUDA is asked
    for (explicitly or by default) and no GPU is present, so that a run
    meant for the card never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spi_tpu_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    """The device of a module's first parameter or buffer."""
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    raise ValueError("module holds no tensors")
