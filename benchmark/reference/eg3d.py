"""Plain float32 EG3D generator: mapping, StyleGAN2 synthesis, triplane
renderer with its importance pass, decoder and superresolution (Chan et
al., CVPR 2022; NVlabs/eg3d `triplane.py`, `networks_stylegan2.py`,
`renderer.py`, `superresolution.py`).

Functional: every function reads a flat dict `P` of tensors named as the
published state dict. The lookup of the planes is `F.grid_sample`, as in
EG3D itself, and its backward is autograd's; the activations, filters and
compositing are plain PyTorch. Every product goes through `quant`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import quant

SQRT2 = math.sqrt(2.0)
SR_VARIANTS = {  # variant -> (input resolution, block0 width, resolution, up, block1 width)
    "SuperresolutionHybrid8XDC": (128, 256, 256, 2, 128),
    "SuperresolutionHybrid2X": (64, 128, 64, 1, 64),
}


def _channels(cfg, res):
    return min(cfg["channel_base"] // res, cfg["channel_max"])


def block_resolutions(cfg):
    return [2 ** i for i in range(2, int(math.log2(cfg["backbone_resolution"])) + 1)]


def num_ws(cfg):
    return 1 + 2 * (len(block_resolutions(cfg)) - 1) + 1


def _layer_spec(prefix, cin, cout, w_dim, res, k=3, noise=True):
    spec = [(prefix + "affine.weight", (cin, w_dim), ("normal", 1.0)),
            (prefix + "affine.bias", (cin,), ("const", 1.0)),
            (prefix + "weight", (cout, cin, k, k), ("normal", 1.0)),
            (prefix + "bias", (cout,), ("const", 0.0))]
    if noise:
        spec += [(prefix + "noise_const", (res, res), ("normal", 1.0)),
                 (prefix + "noise_strength", (), ("const", 0.0))]
    return spec


def _block_spec(prefix, cin, cout, w_dim, res, img_channels):
    spec = []
    if cin:
        spec += _layer_spec(prefix + "conv0.", cin, cout, w_dim, res)
    spec += _layer_spec(prefix + "conv1.", cout, cout, w_dim, res)
    spec += _layer_spec(prefix + "torgb.", cout, img_channels, w_dim, res, k=1, noise=False)
    return spec


def generator_spec(cfg):
    """[(name, shape, init)] of the generator's persistent tensors, with the
    published initialisation: ('normal', scale) or ('const', value)."""
    w, z, c = cfg["w_dim"], cfg["z_dim"], cfg["c_dim"]
    lr = 0.01
    spec = [("backbone.mapping.embed.weight", (w, c), ("normal", 1.0)),
            ("backbone.mapping.embed.bias", (w,), ("const", 0.0))]
    for i in range(cfg["mapping_layers"]):
        spec += [(f"backbone.mapping.fc{i}.weight", (w, z + w if i == 0 else w), ("normal", 1 / lr)),
                 (f"backbone.mapping.fc{i}.bias", (w,), ("const", 0.0))]
    spec.append(("backbone.mapping.w_avg", (w,), ("const", 0.0)))
    planes = 3 * cfg["plane_channels"]
    for res in block_resolutions(cfg):
        p = f"backbone.synthesis.b{res}."
        cout = _channels(cfg, res)
        if res == 4:
            spec.append((p + "const", (cout, 4, 4), ("normal", 1.0)))
            spec += _block_spec(p, 0, cout, w, res, planes)
        else:
            spec += _block_spec(p, _channels(cfg, res // 2), cout, w, res, planes)
    pc = cfg["plane_channels"]
    spec += [("decoder.net.0.weight", (64, pc), ("normal", 1.0)),
             ("decoder.net.0.bias", (64,), ("const", 0.0)),
             ("decoder.net.2.weight", (1 + pc, 64), ("normal", 1.0)),
             ("decoder.net.2.bias", (1 + pc,), ("const", 0.0))]
    _, ch0, res0, _, ch1 = SR_VARIANTS[cfg["sr_variant"]]
    spec += _block_spec("superresolution.block0.", pc, ch0, w, res0, 3)
    spec += _block_spec("superresolution.block1.", ch0, ch1, w, cfg["img_resolution"], 3)
    return spec


# ---------------------------------------------------------------- layers

def fc(P, prefix, x, act="linear", lr=1.0):
    wt = P[prefix + "weight"]
    y = quant.linear(x, wt * (lr / math.sqrt(wt.shape[1])))
    y = y + P[prefix + "bias"] * lr
    if act == "lrelu":
        y = F.leaky_relu(y, 0.2) * SQRT2
    return y


def _fir(device):
    """EG3D's [1, 3, 3, 1] resampling filter, 2D, normalized."""
    f = torch.tensor([1.0, 3.0, 3.0, 1.0], device=device)
    f = torch.outer(f, f)
    return f / f.sum()


def upfirdn2d(x, f, up=1, pad=(0, 0, 0, 0), gain=1.0):
    """Zero-upsample by `up`, pad (x0, x1, y0, y1; negative crops), filter
    with the (flipped) 2D FIR `f` times `gain` (EG3D `_upfirdn2d_ref`)."""
    n, c, h, w = x.shape
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1]).reshape(n, c, h * up, w * up)
    x0, x1, y0, y1 = pad
    x = F.pad(x, [max(x0, 0), max(x1, 0), max(y0, 0), max(y1, 0)])
    x = x[:, :, max(-y0, 0):x.shape[2] - max(-y1, 0), max(-x0, 0):x.shape[3] - max(-x1, 0)]
    wt = (f * gain).flip([0, 1])[None, None].repeat(c, 1, 1, 1)
    return quant.conv2d(x, wt, groups=c)


def conv_up2(x, w, f):
    """conv2d_resample with up = 2 and a 3x3 kernel: a transposed strided
    convolution, then the FIR filter (EG3D conv2d_resample.py:118-131)."""
    kh = w.shape[2]
    p0 = kh // 2 + 2 - (kh - 1)  # padding + (fw + up - 1) // 2 - (kw - 1)
    p1 = kh // 2 + 1 - (kh - 2)  # padding + (fw - up) // 2 - (kw - up)
    pt = max(min(-p0, -p1), 0)
    x = quant.conv_transpose2d(x, w.transpose(0, 1), stride=2, padding=pt)
    return upfirdn2d(x, f, pad=(p0 + pt, p1 + pt, p0 + pt, p1 + pt), gain=4.0)


def upsample2d(img, f):
    return upfirdn2d(img, f, up=2, pad=(2, 1, 2, 1), gain=4.0)


def synthesis_layer(P, prefix, x, w, up, noise, clamp, f):
    styles = fc(P, prefix + "affine.", w)
    weight = P[prefix + "weight"]
    dcoefs = (quant.matmul(styles.square(), weight.square().sum(dim=(2, 3)).T) + 1e-8).rsqrt()
    x = x * styles[:, :, None, None]
    x = conv_up2(x, weight, f) if up == 2 else quant.conv2d(x, weight, padding=1)
    x = x * dcoefs[:, :, None, None]
    if noise is not None:
        x = x + noise * P[prefix + "noise_strength"]
    x = F.leaky_relu(x + P[prefix + "bias"][None, :, None, None], 0.2) * SQRT2
    return x.clamp(-clamp, clamp) if clamp is not None else x


def torgb(P, prefix, x, w, clamp):
    weight = P[prefix + "weight"]
    styles = fc(P, prefix + "affine.", w) / math.sqrt(weight.shape[1])
    x = quant.conv2d(x * styles[:, :, None, None], weight)
    x = x + P[prefix + "bias"][None, :, None, None]
    return x.clamp(-clamp, clamp) if clamp is not None else x


def synthesis_block(P, prefix, x, img, ws, noise, clamp, up, f):
    """ws (N, 3, w_dim) (or 2 for the 4x4 block); noise: {'conv0', 'conv1'}
    maps or None each."""
    if x is None:
        x = P[prefix + "const"][None].expand(ws.shape[0], -1, -1, -1)
        x = synthesis_layer(P, prefix + "conv1.", x, ws[:, 0], 1, noise.get("conv1"), clamp, f)
        k = 1
    else:
        x = synthesis_layer(P, prefix + "conv0.", x, ws[:, 0], up, noise.get("conv0"), clamp, f)
        x = synthesis_layer(P, prefix + "conv1.", x, ws[:, 1], 1, noise.get("conv1"), clamp, f)
        k = 2
    if img is not None and up > 1:
        img = upsample2d(img, f)
    y = torgb(P, prefix + "torgb.", x, ws[:, k], clamp)
    return x, (img + y if img is not None else y)


# ---------------------------------------------------------------- generator

def mapping(P, cfg, z, c, psi=1.0):
    def norm2(v):
        return v * (v.square().mean(dim=1, keepdim=True) + 1e-8).rsqrt()

    x = torch.cat([norm2(z), norm2(fc(P, "backbone.mapping.embed.", c))], dim=1)
    for i in range(cfg["mapping_layers"]):
        x = fc(P, f"backbone.mapping.fc{i}.", x, act="lrelu", lr=0.01)
    x = x[:, None].repeat(1, num_ws(cfg), 1)
    if psi != 1.0:
        w_avg = P["backbone.mapping.w_avg"]
        x = w_avg + psi * (x - w_avg)
    return x


def planes(P, cfg, ws, noise):
    """ws (N, num_ws, w_dim) -> planes (N, 3, C, H, W). noise: {buffer name:
    (N, 1, R, R) map} for every noise buffer of the backbone."""
    f = _fir(ws.device)
    x = img = None
    i = 0
    for res in block_resolutions(cfg):
        p = f"backbone.synthesis.b{res}."
        k = 1 if res == 4 else 2
        maps = {layer: noise.get(f"{p}{layer}.noise_const") for layer in ("conv0", "conv1")}
        x, img = synthesis_block(P, p, x, img, ws[:, i:i + k + 1], maps, 256.0, 2, f)
        i += k
    n, _, h, w = img.shape
    return img.reshape(n, 3, cfg["plane_channels"], h, w)


def superresolution(P, cfg, rgb, feats, ws):
    in_res, _, _, up0, _ = SR_VARIANTS[cfg["sr_variant"]]
    ws = ws[:, -1:].repeat(1, 3, 1)
    f = _fir(ws.device)
    if feats.shape[-1] != in_res:
        feats, rgb = (F.interpolate(t, size=(in_res, in_res), mode="bilinear",
                                    align_corners=False, antialias=True) for t in (feats, rgb))
    x, img = synthesis_block(P, "superresolution.block0.", feats, rgb, ws, {}, None, up0, f)
    _, img = synthesis_block(P, "superresolution.block1.", x, img, ws, {}, None, 2, f)
    return img


# ---------------------------------------------------------------- renderer

def sample_rays(cam2world, intrinsics, res):
    n = cam2world.shape[0]
    fx, fy = intrinsics[:, 0, 0][:, None], intrinsics[:, 1, 1][:, None]
    cx, cy = intrinsics[:, 0, 2][:, None], intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    coords = (torch.arange(res, dtype=torch.float32, device=cam2world.device) + 0.5) / res
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    x_cam, y_cam = xx.reshape(1, -1).expand(n, -1), yy.reshape(1, -1).expand(n, -1)
    z_cam = torch.ones_like(x_cam)
    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    cam_rel = torch.stack([x_lift, y_lift, z_cam, torch.ones_like(z_cam)], dim=-1)
    world = torch.einsum("nij,npj->npi", cam2world, cam_rel)[..., :3]
    origin = cam2world[:, :3, 3]
    dirs = world - origin[:, None]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return origin[:, None].expand(dirs.shape), dirs


def sample_planes(pl, pts, box_warp):
    """planes (3, C, H, W) of one image, points (M, 3) -> (M, C), the mean
    over the planes of `F.grid_sample` at the projections (x, y), (x, z),
    (z, x) (EG3D renderer.py:23-65)."""
    p = pts * (2.0 / box_warp)
    x, y, z = p.unbind(-1)
    grid = torch.stack([torch.stack([x, y], -1), torch.stack([x, z], -1),
                        torch.stack([z, x], -1)])[:, None]  # (3, 1, M, 2)
    out = F.grid_sample(pl, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    return out[:, :, 0].mean(dim=0).T


def decoder(P, feats):
    x = F.softplus(fc(P, "decoder.net.0.", feats))
    x = fc(P, "decoder.net.2.", x)
    return torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001, x[..., :1]


def march(colors, densities, depths):
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    dens_mid = F.softplus((densities[:, :, :-1] + densities[:, :, 1:]) / 2 - 1.0)
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2
    alpha = 1.0 - torch.exp(-dens_mid * deltas)
    shifted = torch.cat([torch.ones_like(alpha[:, :, :1]), 1.0 - alpha + 1e-10], dim=-2)
    weights = alpha * torch.cumprod(shifted, dim=-2)[:, :, :-1]
    rgb = (weights * colors_mid).sum(dim=-2)
    depth = (weights * depths_mid).sum(dim=-2) / weights.sum(dim=2)
    depth = torch.nan_to_num(depth, nan=float("inf")).clamp(depths.min(), depths.max())
    return rgb * 2.0 - 1.0, depth, weights


@torch.no_grad()
def importance_depths(z_vals, weights, n_imp, exponential, eps=1e-5):
    """EG3D renderer.py:194-253, with u_k = S_k / S_{I+1} from I + 1 Exp(1)
    draws per ray (the sorted uniforms, in distribution)."""
    n, m, s, _ = z_vals.shape
    z = z_vals.reshape(n * m, s)
    w = F.pad(weights.reshape(n * m, -1), (1, 1), value=float("-inf"))
    w = torch.maximum(w[:, :-1], w[:, 1:])
    w = (w[:, :-1] + w[:, 1:]) / 2.0 + 0.01
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    w = w[:, 1:-1] + eps
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    cum = torch.cumsum(exponential, dim=-1)
    u = (cum[:, :n_imp] / cum[:, n_imp:]).contiguous()
    nb = cdf.shape[1]
    inds = torch.searchsorted(cdf, u, right=True)
    below, above = (inds - 1).clamp(min=0), inds.clamp(max=nb - 1)
    c0, c1 = cdf.gather(1, below), cdf.gather(1, above)
    b0, b1 = bins[:, :nb].gather(1, below), bins[:, :nb].gather(1, above)
    denom = torch.where(c1 - c0 < eps, torch.ones_like(c1), c1 - c0)
    return (b0 + (u - c0) / denom * (b1 - b0)).reshape(n, m, n_imp, 1)


def render(P, cfg, pl, ws, cams, draws, want_sr=True):
    """One image's planes (3, C, H, W) seen by cameras (K, 25) with the
    renderer's draws {'stratified' (K, M, S, 1), 'exponential' (K*M, I+1)}
    -> {'image_raw', 'image_depth', 'image'}. ws (1, num_ws, w_dim)."""
    res = cfg["neural_rendering_resolution"]
    k = cams.shape[0]
    origins, dirs = sample_rays(cams[:, :16].reshape(-1, 4, 4), cams[:, 16:25].reshape(-1, 3, 3),
                                res)
    s, n_imp = cfg["depth_resolution"], cfg["depth_resolution_importance"]
    start, end = cfg["ray_start"], cfg["ray_end"]
    depths = (torch.linspace(start, end, s, device=cams.device).reshape(1, 1, s, 1)
              + draws["stratified"] * ((end - start) / (s - 1)))
    m = res * res

    def run(dp):
        pts = (origins[:, :, None] + dp * dirs[:, :, None]).reshape(-1, 3)
        rgb, sigma = decoder(P, sample_planes(pl, pts, cfg["box_warp"]))
        n_s = dp.shape[2]
        return rgb.reshape(k, m, n_s, -1), sigma.reshape(k, m, n_s, 1)

    col_c, den_c = run(depths)
    _, _, weights = march(col_c, den_c, depths)
    fine = importance_depths(depths, weights, n_imp, draws["exponential"])
    col_f, den_f = run(fine)
    all_d = torch.cat([depths, fine], dim=-2)
    order = torch.sort(all_d[..., 0], dim=-1, stable=True).indices[..., None]

    def take(a, b):
        x = torch.cat([a, b], dim=-2)
        return x.gather(2, order.expand(*order.shape[:-1], x.shape[-1]))

    rgb, depth, _ = march(take(col_c, col_f), take(den_c, den_f), all_d.gather(2, order))
    feat = rgb.permute(0, 2, 1).reshape(k, -1, res, res)
    out = {"image_raw": feat[:, :3], "image_depth": depth.permute(0, 2, 1).reshape(k, 1, res, res)}
    if want_sr:
        out["image"] = superresolution(P, cfg, feat[:, :3], feat, ws.expand(k, -1, -1))
    return out


def make_tensors(spec, gen, device):
    """The spec's tensors from one standard-normal draw on `device` (in the
    spec's order) and constants: {name: float32 tensor}."""
    sizes = [int(np.prod(shape)) for _, shape, init in spec if init[0] == "normal"]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, (kind, value) in spec:
        if kind == "normal":
            n = int(np.prod(shape))
            out[name] = flat[at:at + n].reshape(shape) * value
            at += n
        elif kind == "abs_normal":
            out[name] = torch.randn(shape, generator=gen, device=device).abs() * value
        else:
            out[name] = torch.full(shape, float(value), device=device)
    return out
