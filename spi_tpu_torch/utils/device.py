"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def full_float32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions (cuDNN's
    default is on), so that float32 work on the card computes in float32,
    as on the CPU and in spi_tpu. The port's one precision policy:
    `resolve_device` applies it on every entry path that runs on CUDA."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another, with the current card's index where none is given (the
    device that modules moved to `cuda` report). Raises when CUDA is asked
    for (explicitly or by default) and no GPU is present, so that a run
    meant for the card never falls back to the CPU silently. On CUDA it
    applies `full_float32`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spi_tpu_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    if dev.type == "cuda":
        full_float32()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    """The device of a module's first parameter or buffer."""
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    raise ValueError("module holds no tensors")
