"""Plain float32 losses of SPI's stage 2: LPIPS-VGG16 (Zhang et al., CVPR
2018; spi/criteria/lpips), the depth warp (spi/utils/rotate.py) and the
contextual loss on the mouth and eye boxes through VGG19 to conv2_1
(spi/criteria/bbox_cx_loss.py). Functional over flat dicts of tensors
named as the published state dicts."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import quant
from benchmark.reference.camera import unpack

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")
LPIPS_LAYERS = (3, 8, 15, 22, 29)  # relu1_2 ... relu5_3
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _mods(cfg):
    """[(torchvision index, kind, in, out)]."""
    mods, idx, cin = [], 0, 3
    for v in cfg:
        if v == "M":
            mods.append((idx, "pool", cin, cin))
            idx += 1
        else:
            mods += [(idx, "conv", cin, v), (idx + 1, "relu", v, v)]
            idx, cin = idx + 2, v
    return mods


def vgg_spec(prefix, cfg):
    spec = []
    for idx, kind, cin, cout in _mods(cfg):
        if kind == "conv":
            spec += [(f"{prefix}features.{idx}.weight", (cout, cin, 3, 3),
                      ("normal", math.sqrt(2.0 / (cin * 9)))),
                     (f"{prefix}features.{idx}.bias", (cout,), ("const", 0.0))]
    return spec


def lpips_spec(cfg=VGG16_CFG, layers=LPIPS_LAYERS):
    out = {idx: cout for idx, _, _, cout in _mods(cfg)}
    return vgg_spec("net.", cfg) + [(f"lin.{i}", (out[k],), ("abs_normal", 1.0 / out[k]))
                                    for i, k in enumerate(layers)]


def box_cx_spec():
    return vgg_spec("vgg.", VGG19_CFG)


def vgg(P, prefix, cfg, x, layers):
    outs = []
    for idx, kind, _, _ in _mods(cfg):
        if kind == "conv":
            x = quant.conv2d(x, P[f"{prefix}features.{idx}.weight"],
                             P[f"{prefix}features.{idx}.bias"], padding=1)
        elif kind == "relu":
            x = F.relu(x)
        else:
            x = F.max_pool2d(x, 2, 2)
        if idx in layers:
            outs.append(x)
        if idx >= max(layers):
            return outs
    return outs


def resize(x, size):
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False)


def lpips_features(P, x, cfg=VGG16_CFG, layers=LPIPS_LAYERS):
    if x.shape[-1] > 256:
        x = resize(x, 256)
    shift = torch.tensor(_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=x.device).reshape(1, 3, 1, 1)
    feats = vgg(P, "net.", cfg, (x - shift) / scale, layers)
    return [f / (f.square().sum(dim=1, keepdim=True).sqrt() + 1e-10) for f in feats]


def lpips(P, x, y_feats, cfg=VGG16_CFG, layers=LPIPS_LAYERS):
    """Distance of x (N, 3, H, W) in [-1, 1] to features `y_feats`, summed
    over layers and averaged over the batch."""
    total = 0.0
    for i, (fx, fy) in enumerate(zip(lpips_features(P, x, cfg, layers), y_feats)):
        total = total + torch.einsum("nchw,c->nhw", (fx - fy).square(), P[f"lin.{i}"]) \
            .mean(dim=(1, 2)).sum()
    return total / x.shape[0]


# ---------------------------------------------------------------- BoxCX

def landmark_boxes(lm):
    boxes = []
    for i, (lo, hi) in enumerate([(48, 68), (36, 42), (42, 48)]):
        pts = lm[:, lo:hi]
        pad = 15.0 if i > 0 else 8.0
        boxes.append(torch.stack([torch.floor(pts[:, :, 0].amin(1)) - pad,
                                  torch.floor(pts[:, :, 1].amin(1)) - pad,
                                  torch.floor(pts[:, :, 0].amax(1)) + pad,
                                  torch.floor(pts[:, :, 1].amax(1)) + pad], dim=1))
    return boxes


def roi_align(x, box, size=80, ratio=2):
    """One box per sample, 2 x 2 bilinear samples a bin, clamped to the map."""
    n, c, h, w = x.shape
    x1, y1, x2, y2 = box.unbind(1)
    offs = (torch.arange(size, device=x.device)[:, None]
            + (torch.arange(ratio, device=x.device)[None] + 0.5) / ratio).reshape(-1)
    xs = (x1[:, None] + offs * ((x2 - x1) / size)[:, None]).clamp(0, w - 1)
    ys = (y1[:, None] + offs * ((y2 - y1) / size)[:, None]).clamp(0, h - 1)
    # Sample with grid_sample at pixel centres (align_corners=True maps
    # -1..1 onto the first..last pixel centre).
    gx = xs / (w - 1) * 2 - 1
    gy = ys / (h - 1) * 2 - 1
    p = xs.shape[1]
    grid = torch.stack([gx[:, None, :].expand(n, p, p), gy[:, :, None].expand(n, p, p)], -1)
    vals = F.grid_sample(x, grid, mode="bilinear", padding_mode="border", align_corners=True)
    return vals.reshape(n, c, size, ratio, size, ratio).mean(dim=(3, 5))


def box_cx(P, x, y, lm, band_width=0.5):
    if x.shape[-1] > 256:
        x, y = resize(x, 256), resize(y, 256)
    mean = torch.tensor(_IMAGENET_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(_IMAGENET_STD, device=x.device).reshape(1, 3, 1, 1)
    x, y = (x - mean) / std, (y - mean) / std
    loss = 0.0
    for box in landmark_boxes(lm):
        fx = vgg(P, "vgg.", VGG19_CFG, roi_align(x, box), (5,))[0]
        fy = vgg(P, "vgg.", VGG19_CFG, roi_align(y, box), (5,))[0]
        mu = fy.mean(dim=(0, 2, 3), keepdim=True)
        xn = (fx - mu) / (torch.linalg.vector_norm(fx - mu, dim=1, keepdim=True) + 1e-12)
        yn = (fy - mu) / (torch.linalg.vector_norm(fy - mu, dim=1, keepdim=True) + 1e-12)
        n, c = fx.shape[:2]
        dist = 1.0 - quant.matmul(xn.reshape(n, c, -1).transpose(1, 2), yn.reshape(n, c, -1))
        tilde = (dist / (dist.amin(dim=2, keepdim=True) + 1e-5)).clamp(-10.0, 10.0)
        wgt = torch.exp((1.0 - tilde) / band_width)
        cx = (wgt / wgt.sum(dim=2, keepdim=True)).amax(dim=1).mean(dim=1)
        loss = loss + (-torch.log(cx + 1e-5)).mean()
    return loss * 0.1


# ---------------------------------------------------------------- depth warp

def _intr(k):
    return tuple(k[:, i, j][:, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2), (0, 1)))


def warp(target_cam, target_depth, src, src_cam, src_depth, src_mask, eps, depth_res):
    """Warp `src` (N, C, R, R) seen from `src_cam` into `target_cam` by the
    neural depths (N, 1, d, d) resized to R (spi/utils/rotate.py:56-116).
    Returns (image, mask)."""
    n, _, r, _ = src.shape

    def fit(d):
        d = d.reshape(n, 1, depth_res, depth_res)
        return (resize(d, r) if depth_res != r else d).reshape(n, r, r)

    d1, d2 = fit(target_depth), fit(src_depth)
    ex1, in1 = unpack(target_cam)
    ex2, in2 = unpack(src_cam)
    fx, fy, cx, cy, sk = _intr(in1)
    coords = (torch.arange(r, dtype=src.dtype, device=src.device) + 0.5) / r
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    x_cam, y_cam = xx.reshape(1, -1).expand(n, -1), yy.reshape(1, -1).expand(n, -1)
    z = d1.reshape(n, -1)
    pts = torch.stack([(x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z,
                       (y_cam - cy) / fy * z, z, torch.ones_like(z)], dim=-1)
    world = torch.einsum("nij,npj->npi", ex1, pts)
    rel = torch.einsum("nij,npj->npi", torch.linalg.inv(ex2), world)
    fx, fy, cx, cy, sk = _intr(in2)
    y_uv = rel[..., 1] / rel[..., 2] * fy + cy
    x_uv = rel[..., 0] / rel[..., 2] * fx + sk * y_uv / fy - cy * sk / fy + cx
    grid = torch.stack([x_uv, y_uv], -1).reshape(n, r, r, 2) * 2.0 - 1.0

    def sample(t):
        return F.grid_sample(t, grid, mode="bilinear", padding_mode="zeros", align_corners=False)

    inside = ((grid[..., 0] >= -1) & (grid[..., 0] <= 1) & (grid[..., 1] >= -1)
              & (grid[..., 1] <= 1)).to(src.dtype)
    depth_ok = ((sample(d2[:, None])[:, 0] - rel[..., 2].reshape(n, r, r)).abs() < eps).to(src.dtype)
    mask = (depth_ok * inside)[:, None]
    img = sample(src) * mask
    if src_mask is not None:
        m = sample(src_mask.reshape(n, 1, r, r))
        img, mask = img * m, mask * m
    return img, mask
