"""Identity loss and similarity by ArcFace IR-SE50 (counterpart of
spi_tpu/criteria/id_loss.py; spec spi/criteria/id_loss/id_loss.py).

The face region of a 256^2 image (rows 35:223, columns 32:220) is pooled
to 112^2 and embedded; the similarity is the embeddings' dot product.
The reference pools with AdaptiveAvgPool2d; 188 -> 112 has no integer
factor, and spi_tpu resizes bilinearly there instead, as the port does.
Parameters: `facenet.*`.
"""

from __future__ import annotations

from torch import nn

from spi_tpu_torch.models.perception.arcface import IRSE50
from spi_tpu_torch.ops import resize_bilinear


def _adaptive_avg_pool(x, out: int):
    """AdaptiveAvgPool2d for integer factors; bilinear resize otherwise
    (spi_tpu's stand-in)."""
    n, c, h, w = x.shape
    if h == out and w == out:
        return x
    if h % out == 0 and w % out == 0:
        return x.reshape(n, c, out, h // out, out, w // out).mean(dim=(3, 5))
    return resize_bilinear(x, (out, out))


class IDLoss(nn.Module):
    """device: None means `cuda` (raises without a GPU)."""

    def __init__(self, device=None, seed: int = 3):
        super().__init__()
        self.facenet = IRSE50(device=device, seed=seed)

    def extract_feats(self, x):
        """x: (N, 3, 256, 256) in [-1, 1] -> (N, 512)."""
        return self.facenet(_adaptive_avg_pool(x[:, :, 35:223, 32:220], 112))

    def similarity(self, x, y):
        return (self.extract_feats(x) * self.extract_feats(y)).sum(dim=-1)

    def forward(self, x, y):
        return (1.0 - self.similarity(x, y)).mean()
