"""The benchmark's machinery: seeds, the measured window, the traced slice
and the check of `correct`. Nothing here knows a cell: cells, entries,
configurations and metrics are files found by name."""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def sub_seed(seed: int, label: str) -> int:
    """A 63-bit seed for one named stream of the run's draws."""
    return int.from_bytes(hashlib.sha256(f"{seed}/{label}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, label: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, label))


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Ctx:
    """What an entry is built from."""

    name: str
    workload: dict
    config: dict
    seed: int
    device: torch.device
    tiny: bool = False

    @property
    def generator_cfg(self) -> dict:
        g = dict(self.config["generator"])
        if self.tiny:
            g.update(self.config["tiny"]["generator"])
        return g
