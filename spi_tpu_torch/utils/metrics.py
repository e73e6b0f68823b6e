"""Quality metrics: L2, LPIPS and ID similarity, plus their mirrored
variants, and the metric log (counterpart of spi_tpu/utils/metrics.py;
spec spi/utils/metric_utils.py:6-17 and base_coach.py:141-198)."""

from __future__ import annotations

import torch
from torch import nn

from spi_tpu_torch.criteria.id_loss import IDLoss
from spi_tpu_torch.criteria.l2_loss import l2_loss
from spi_tpu_torch.criteria.lpips import LPIPS


class Metric(nn.Module):
    """Parameters `lpips.*` and `id.facenet.*`, as spi_tpu's metric
    pytree. The LPIPS module may be shared with the losses."""

    def __init__(self, lpips: LPIPS, id_loss: IDLoss):
        super().__init__()
        self.lpips = lpips
        self.id = id_loss

    @torch.no_grad()
    def run(self, gt, fake) -> dict[str, float]:
        """gt, fake: (1, 3, R, R) in [-1, 1] -> {'l2', 'lpips', 'id'} floats;
        the ID similarity at 256^2 (id_loss.py:17-21)."""
        return {"l2": float(l2_loss(gt, fake)), "lpips": float(self.lpips(gt, fake)),
                "id": float(self.id.similarity(_to256(gt), _to256(fake))[0])}


def _to256(x):
    n, c, h, w = x.shape
    if h == 256:
        return x
    if h < 256:  # scaled-down configurations: nearest upsampling to the crop's size
        f = 256 // h
        if h * f != 256:
            raise ValueError(f"image side {h} does not divide 256")
        return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)
    f = h // 256
    return x.reshape(n, c, 256, f, 256, f).mean(dim=(3, 5))


class MetricLog:
    """Accumulates per-image metrics and writes metric_log.txt in the
    reference's format (base_coach.py:156-198)."""

    KEYS = ("l2", "lpips", "id", "l2_m", "lpips_m", "id_m")

    def __init__(self):
        self.data: dict[str, list[dict]] = {}

    def add(self, mode: str, values: dict, mirrored: dict | None = None):
        entry = dict(values)
        if mirrored is not None:
            entry.update({f"{k}_m": v for k, v in mirrored.items()})
        self.data.setdefault(mode, []).append(entry)

    def render(self, header: str = "") -> str:
        lines = [header] if header else []
        for mode, entries in self.data.items():
            lines.append(f"Mode: {mode}")
            sums = dict.fromkeys(self.KEYS, 0.0)
            for i, e in enumerate(entries):
                parts = []
                for k in self.KEYS:
                    v = e.get(k, 0.0)
                    sums[k] += v
                    parts.append(f"{k}: {v:.6f}")
                lines.append(f"ID: {i} " + "; ".join(parts) + ";")
            n = max(len(entries), 1)
            lines.append(f"Mode: {mode} AVG")
            lines.append("; ".join(f"{k}: {sums[k] / n:.6f}" for k in self.KEYS) + ";")
        return "\n".join(lines) + "\n"

    def write(self, path: str, header: str = ""):
        with open(path, "a") as f:
            f.write(self.render(header))
