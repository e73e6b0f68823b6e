"""Facial-region contextual (CX) loss on landmark boxes (counterpart of
spi_tpu/criteria/bbox_cx.py; spec spi/criteria/bbox_cx_loss.py).

Mouth and eye boxes from 68-point landmarks (:20-37), 80x80 ROI-align
crops (:41-61), VGG19 conv2_1 features (:76-90), and the contextual
loss: cosine distance -> relative distance -> softmax CX -> -log max
(:93-182). The RotBbox coach's mirror-rot term (rot_bbox_cx_coach.py:
107-131). Parameters: `vgg.features.*`, as in the JAX pytree.
"""

from __future__ import annotations

import torch
from torch import nn

from spi_tpu_torch.models.perception.vgg import VGG19_CFG, VGGFeatures
from spi_tpu_torch.models.stylegan2 import seeded_init
from spi_tpu_torch.ops import resize_bilinear
from spi_tpu_torch.ops.roi_align import roi_align
from spi_tpu_torch.utils.device import resolve_device
from spi_tpu_torch.utils.stats import span

_VGG_MEAN = (0.485, 0.456, 0.406)
_VGG_STD = (0.229, 0.224, 0.225)


def landmark_boxes(lm):
    """68-point landmarks (N, 68, 2) at 256 scale -> [mouth, left eye, right
    eye] boxes, each (N, 4) as (x1, y1, x2, y2) (bbox_cx_loss.py:20-37)."""
    boxes = []
    for i, (lo, hi) in enumerate([(48, 68), (36, 42), (42, 48)]):
        pts = lm[:, lo:hi]
        pad = 15.0 if i > 0 else 8.0
        x1 = torch.floor(pts[:, :, 0].amin(dim=1)) - pad
        x2 = torch.floor(pts[:, :, 0].amax(dim=1)) + pad
        y1 = torch.floor(pts[:, :, 1].amin(dim=1)) - pad
        y2 = torch.floor(pts[:, :, 1].amax(dim=1)) + pad
        boxes.append(torch.stack([x1, y1, x2, y2], dim=1))
    return boxes


def _cosine_distance(x, y):
    """Features (N, C, H, W) pairs -> (N, HW, HW) cosine distances, both
    centred on y's mean over batch and space (bbox_cx_loss.py:93-115)."""
    y_mu = y.mean(dim=(0, 2, 3), keepdim=True)
    xc, yc = x - y_mu, y - y_mu
    xn = xc / (torch.linalg.vector_norm(xc, dim=1, keepdim=True) + 1e-12)
    yn = yc / (torch.linalg.vector_norm(yc, dim=1, keepdim=True) + 1e-12)
    n, c = x.shape[:2]
    return 1.0 - torch.einsum("ncp,ncq->npq", xn.reshape(n, c, -1), yn.reshape(n, c, -1))


def _cx(dist, band_width: float):
    dist_min = dist.amin(dim=2, keepdim=True)
    dist_tilde = (dist / (dist_min + 1e-5)).clamp(-10.0, 10.0)
    w = torch.exp((1.0 - dist_tilde) / band_width)
    return w / w.sum(dim=2, keepdim=True)


class _BoxFeatures(nn.Module):
    """VGG19 up to conv2_1 over the three landmark boxes' crops."""

    def __init__(self, device=None, seed: int = 2):
        super().__init__()
        dev = resolve_device(device)
        self.vgg = VGGFeatures(cfg=VGG19_CFG, target_layers=(5,), device=dev)
        self.register_buffer("mean", torch.tensor(_VGG_MEAN, device=dev).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("std", torch.tensor(_VGG_STD, device=dev).reshape(1, 3, 1, 1),
                             persistent=False)
        seeded_init(self.vgg, seed)

    def box_features(self, x, y, lm):
        """x, y: (N, 3, R, R) images; lm: (N, 68, 2) at 256 scale -> per box
        (features of x's crop, features of y's crop)."""
        if x.shape[-1] > 256:
            x = resize_bilinear(x, (256, 256))
        if y.shape[-1] > 256:
            y = resize_bilinear(y, (256, 256))
        x = (x - self.mean) / self.std
        y = (y - self.mean) / self.std
        for box in landmark_boxes(lm):
            yield (self.vgg(roi_align(x, box, output_size=80))[0],
                   self.vgg(roi_align(y, box, output_size=80))[0])


class BoxCXLoss(_BoxFeatures):
    """Contextual loss over the mouth and eye crops, x 0.1.
    device: None means `cuda` (raises without a GPU)."""

    def __init__(self, band_width: float = 0.5, device=None, seed: int = 2):
        super().__init__(device=device, seed=seed)
        self.band_width = band_width

    def forward(self, x, y, lm):
        with span("spi.box_cx"):
            loss = 0.0
            for fx, fy in self.box_features(x, y, lm):
                cx = _cx(_cosine_distance(fx, fy), self.band_width)
                cx = cx.amax(dim=1).mean(dim=1)
                loss = loss + (-torch.log(cx + 1e-5)).mean()
            return loss * 0.1


class BoxLoss(_BoxFeatures):
    """SmoothL1 between the same crops' features (bbox_cx_loss.py:185-221)."""

    def forward(self, x, y, lm):
        loss = 0.0
        for fx, fy in self.box_features(x, y, lm):
            d = (fx - fy).abs()
            loss = loss + torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()
        return loss
