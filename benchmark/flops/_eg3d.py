"""Floating-point operations of the EG3D generator and the perception nets
at their published widths, counted analytically: 2 per multiply-add of
every convolution, matrix product and FIR filter (the resampling filters
are convolutions too); elementwise work, the plane lookup and the
compositing are not counted. The synthesis parts return {'conv': the
modulated convolutions and their affines, 'torgb': the ToRGB layers and
their affines, 'fir': the fixed resampling filters, whose backward has no
weight gradient}."""

from __future__ import annotations

import math

SR_BLOCKS = {  # variant -> [(in width, out width, resolution, up)]
    "SuperresolutionHybrid8XDC": [(32, 256, 256, 2), (256, 128, 512, 2)],
    "SuperresolutionHybrid2X": [(32, 128, 64, 1), (128, 64, 128, 2)],
}
VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M")
VGG19_TO_CONV2_1 = (64, 64, "M", 128)


def _fc(n, cin, cout):
    return 2 * n * cin * cout


def _block(w_dim, cin, cout, res, img_ch, up, first=False):
    """A synthesis block at output resolution `res`."""
    out = {"conv": 0, "torgb": 0, "fir": 0}
    if not first:
        src = res // up
        out["conv"] += _fc(1, w_dim, cin) + 2 * cin * cout * 9 * src * src
        if up > 1:
            out["fir"] += 2 * 16 * cout * res * res
            out["fir"] += 2 * 16 * img_ch * res * res  # the skip image's upsampling
    out["conv"] += _fc(1, w_dim, cout) + 2 * cout * cout * 9 * res * res
    out["torgb"] += _fc(1, w_dim, cout) + 2 * cout * img_ch * res * res
    return out


def _sum(blocks):
    return {k: sum(b[k] for b in blocks) for k in ("conv", "torgb", "fir")}


def synthesis(g):
    """The backbone's synthesis for one image."""
    blocks = []
    for i in range(2, int(math.log2(g["backbone_resolution"])) + 1):
        res = 2 ** i
        cout = min(g["channel_base"] // res, g["channel_max"])
        cin = min(g["channel_base"] // (res // 2), g["channel_max"]) if res > 4 else cout
        blocks.append(_block(g["w_dim"], cin, cout, res, 3 * g["plane_channels"], 2,
                             first=res == 4))
    return _sum(blocks)


def superresolution(g):
    return _sum([_block(g["w_dim"], cin, cout, res, 3, up)
                 for cin, cout, res, up in SR_BLOCKS[g["sr_variant"]]])


def decoder(g, cams=1):
    """Both sampling passes of a render of `cams` cameras."""
    pts = cams * g["neural_rendering_resolution"] ** 2 * (
        g["depth_resolution"] + g["depth_resolution_importance"])
    pc = g["plane_channels"]
    return _fc(pts, pc, 64) + _fc(pts, 64, 1 + pc)


def mapping(g):
    return _fc(1, g["c_dim"], g["w_dim"]) + _fc(1, g["z_dim"] + g["w_dim"], g["w_dim"]) \
        + (g["mapping_layers"] - 1) * _fc(1, g["w_dim"], g["w_dim"])


def vgg(cfg, res, cin=3):
    total = 0
    for v in cfg:
        if v == "M":
            res //= 2
        else:
            total += 2 * cin * v * 9 * res * res
            cin = v
    return total


def lpips(res=256):
    """LPIPS-VGG16 features of one image at `res`."""
    return vgg(VGG16, res)


def box_cx(crop=80, boxes=3):
    """VGG19 to conv2_1 over one image's box crops, and the contextual
    loss's cosine matrix ((crop / 2)^2 positions squared, 128 channels)."""
    hw = (crop // 2) ** 2
    return boxes * vgg(VGG19_TO_CONV2_1, crop), boxes * 2 * hw * hw * 128


def vit_image(cfg):
    """A CLIP ViT image tower on one image."""
    w, p, r = cfg["vision_width"], cfg["vision_patch_size"], cfg["image_resolution"]
    grid = r // p
    tokens = grid * grid + 1
    per_layer = 2 * tokens * w * (4 * w + 8 * w) + 2 * 2 * tokens * tokens * w
    return 2 * 3 * p * p * w * grid * grid + cfg["vision_layers"] * per_layer \
        + 2 * w * cfg["embed_dim"]
