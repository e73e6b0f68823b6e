"""ADA augmentation of the discriminator's inputs (counterpart of
spi_tpu/training/augment.py; spec eg3d/training/augment.py AugmentPipe).

Every group of spi_tpu's pipe, with its defaults: blit (xflip, 90-degree
rotations, integer translation) and geom (isotropic and anisotropic
scaling, rotation, fractional translation) composed into one affine per
sample and applied as its inverse through one `ops/grid_sample.grid_sample`
(zeros padding, half-pixel centres); color (brightness, contrast,
luma flip, hue, saturation) as one 4x4 matrix per sample; the wavelet
imgfilter, additive noise and cutout. Each is gated per sample by a
Bernoulli of probability p times its own weight.

Drawing and applying are apart: `draw` takes every per-sample gate and
parameter from a `torch.Generator`, `apply` is a function of the images,
p and those draws, so one set of draws serves both images of the dual
discriminator (the image and the raw render), and tests can hand in
spi_tpu's draws. The draws do not depend on p. At p = 0 every gate is
shut and the pipe returns its input exactly, but for imgfilter, whose
filter at p = 0 is the identity only to float32 rounding, as spi_tpu's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from spi_tpu_torch.ops.grid_sample import grid_sample

# sym2 wavelet lowpass (augment.py:34 wavelets['sym2'])
_SYM2 = np.array(
    [-0.12940952255092145, 0.22414386804185735, 0.836516303737469, 0.48296291314469025]
)


def _make_fbank(num_bands: int = 4) -> np.ndarray:
    """4-band wavelet filter bank of the imgfilter group (augment.py:176-186):
    Bandpass(H(z), b_i) built from the sym2 QMF pair by repeated a-trous
    lowpass convolution and a centered highpass."""
    hz_lo = _SYM2
    hz_hi = hz_lo * ((-1.0) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(num_bands, 1)
    for i in range(1, num_bands):
        # upsample the taps 2x (insert zeros), drop the trailing zero
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(fbank.shape[0], -1)[:, :-1]
        fbank = np.stack([np.convolve(row, hz_lo2) for row in fbank])
        lo = (fbank.shape[1] - hz_hi2.size) // 2
        fbank[i, lo: lo + hz_hi2.size] += hz_hi2
    return fbank.astype(np.float32)


_HZ_FBANK = _make_fbank()
# Expected power spectrum 1/f (augment.py:385)
_EXPECTED_POWER = np.array([10, 1, 1, 1], np.float32) / 13


def _mat3(rows):
    """(n, 3, 3) from three rows of three (n,) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _rot2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat3([[c, -s, z], [s, c, z], [z, z, o]])


def _scale2d(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat3([[sx, z, z], [z, sy, z], [z, z, o]])


def _translate2d(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat3([[o, z, tx], [z, o, ty], [z, z, o]])


def _rot3d_about(axis, theta):
    """Rodrigues rotation about `axis` (3,), embedded in a 4x4 color matrix."""
    x, y, z = (float(a) for a in axis)
    zero = torch.zeros_like(theta)
    k = _mat3([[zero, -z + zero, y + zero], [z + zero, zero, -x + zero],
               [-y + zero, x + zero, zero]])
    eye = torch.eye(3, device=theta.device)[None]
    r = eye + torch.sin(theta)[:, None, None] * k + (1 - torch.cos(theta))[:, None, None] * (k @ k)
    out = torch.eye(4, device=theta.device).repeat(theta.shape[0], 1, 1)
    out[:, :3, :3] = r
    return out


def _reflect_index(size: int, pad: int, device):
    """Indices of numpy's 'reflect' padding of `size` entries by `pad` on
    each side, reflecting as often as needed (the 43-tap filter bank pads
    more than a small image holds, which F.pad refuses)."""
    period = 2 * (size - 1)
    i = torch.arange(-pad, size + pad, device=device).abs() % max(period, 1)
    return torch.where(i >= size, period - i, i)


def filter_images(images, hz):
    """Separable per-sample FIR filtering with reflect padding
    (augment.py:399-411): one grouped convolution per axis over a
    (1, N*C, H, W) layout; the taps are used as they are (both this and
    spi_tpu's convolution cross-correlate). images (N, C, H, W), hz (N, taps)."""
    n, c, h, w = images.shape
    taps = hz.shape[-1]
    pad = taps // 2
    x = images.reshape(1, n * c, h, w)
    x = x.index_select(2, _reflect_index(h, pad, x.device))
    x = x.index_select(3, _reflect_index(w, pad, x.device))
    rows = hz[:, None].repeat(1, c, 1).reshape(n * c, 1, 1, taps)
    x = F.conv2d(x, rows, groups=n * c)
    x = F.conv2d(x, rows.reshape(n * c, 1, taps, 1), groups=n * c)
    return x.reshape(n, c, h, w)


def _uniform(shape, generator, device, low=0.0, high=1.0):
    return torch.rand(shape, generator=generator, device=device) * (high - low) + low


def _normal(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device)


@dataclasses.dataclass(frozen=True)
class AugmentPipe:
    # blit group
    xflip: float = 1.0
    rotate90: float = 1.0
    xint: float = 1.0
    xint_max: float = 0.125
    # geom group
    scale: float = 1.0
    rotate: float = 1.0
    aniso: float = 1.0
    xfrac: float = 1.0
    scale_std: float = 0.2
    rotate_max: float = 1.0  # fraction of pi
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    # color group
    brightness: float = 1.0
    contrast: float = 1.0
    lumaflip: float = 1.0
    hue: float = 1.0
    saturation: float = 1.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    # cutout
    cutout: float = 0.0
    cutout_size: float = 0.5
    # imgfilter group: per-band wavelet amplification (augment.py:382-411)
    imgfilter: float = 0.0
    imgfilter_bands: tuple = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    # additive RGB noise (augment.py:417-421)
    noise: float = 0.0
    noise_std: float = 0.1

    def draw(self, n: int, generator=None, device=None, shapes=()) -> dict:
        """One application's draws for n samples, from `generator`: for each
        enabled group its gate uniforms `<group>` (n,) in [0, 1) and its
        parameters (`rotate90_k` in 0..3, `xint_t` and `rotate_t` and
        `hue_t` uniform in [-1, 1), `cutout_center` in [0, 1), the others
        standard normal). The noise group's per-pixel field is drawn for each
        image shape (C, H, W) of `shapes`, keyed by H."""
        d = {}

        def gate(name, *extra):
            d[name] = _uniform((n, *extra), generator, device)

        if self.xflip > 0:
            gate("xflip")
        if self.rotate90 > 0:
            gate("rotate90")
            d["rotate90_k"] = torch.randint(0, 4, (n,), generator=generator, device=device)
        if self.xint > 0:
            gate("xint")
            d["xint_t"] = _uniform((n, 2), generator, device, -1.0)
        if self.scale > 0:
            gate("scale")
            d["scale_s"] = _normal((n,), generator, device)
        if self.rotate > 0:
            gate("rotate")
            d["rotate_t"] = _uniform((n,), generator, device, -1.0)
        if self.aniso > 0:
            gate("aniso")
            d["aniso_s"] = _normal((n,), generator, device)
        if self.xfrac > 0:
            gate("xfrac")
            d["xfrac_t"] = _normal((n, 2), generator, device)
        for name in ("brightness", "contrast"):
            if getattr(self, name) > 0:
                gate(name)
                d[f"{name}_s"] = _normal((n,), generator, device)
        if self.lumaflip > 0:
            gate("lumaflip")
        if self.hue > 0:
            gate("hue")
            d["hue_t"] = _uniform((n,), generator, device, -1.0)
        if self.saturation > 0:
            gate("saturation")
            d["saturation_s"] = _normal((n,), generator, device)
        if self.imgfilter > 0:
            gate("imgfilter", len(self.imgfilter_bands))
            d["imgfilter_t"] = _normal((n, len(self.imgfilter_bands)), generator, device)
        if self.noise > 0:
            gate("noise")
            d["noise_sigma"] = _normal((n,), generator, device)
            d["noise_field"] = {s[-2]: _normal((n, *s[-3:]), generator, device) for s in shapes}
        if self.cutout > 0:
            gate("cutout")
            d["cutout_center"] = _uniform((n, 2), generator, device)
        return d

    def __call__(self, images, p, generator=None, draws=None):
        """images (N, C, H, W) in [-1, 1]; p: the probability (a number).
        Draws from `generator` unless `draws` are given."""
        if draws is None:
            draws = self.draw(images.shape[0], generator, images.device, [images.shape])
        return self.apply(images, p, draws)

    def apply(self, images, p, draws: dict):
        """The augmented images, from `draw`'s draws (same shape)."""
        n, c, h, w = images.shape
        dev = images.device
        d = draws
        p = float(p)

        def on(name, prob):
            return d[name] < p * prob

        # ---- geometric: one 3x3 matrix per sample ------------------------
        g = torch.eye(3, device=dev).repeat(n, 1, 1)
        one = torch.ones(n, device=dev)
        if self.xflip > 0:
            g = _scale2d(torch.where(on("xflip", self.xflip), -1.0, 1.0), one) @ g
        if self.rotate90 > 0:
            theta = torch.where(on("rotate90", self.rotate90),
                                d["rotate90_k"].float() * (math.pi / 2), 0.0)
            g = _rot2d(theta) @ g
        if self.xint > 0:
            t = d["xint_t"] * self.xint_max
            size = torch.tensor([w, h], dtype=torch.float32, device=dev)
            t = torch.where(on("xint", self.xint)[:, None], torch.round(t * size), 0.0)
            g = _translate2d(2 * t[:, 0] / w, 2 * t[:, 1] / h) @ g
        if self.scale > 0:
            s = torch.where(on("scale", self.scale), torch.exp2(d["scale_s"] * self.scale_std),
                            1.0)
            g = _scale2d(s, s) @ g
        if self.rotate > 0:
            theta = d["rotate_t"] * math.pi * self.rotate_max
            g = _rot2d(torch.where(on("rotate", self.rotate), theta, 0.0)) @ g
        if self.aniso > 0:
            s = torch.where(on("aniso", self.aniso), torch.exp2(d["aniso_s"] * self.aniso_std),
                            1.0)
            g = _scale2d(s, 1.0 / s) @ g
        if self.xfrac > 0:
            t = torch.where(on("xfrac", self.xfrac)[:, None], d["xfrac_t"] * self.xfrac_std, 0.0)
            g = _translate2d(2 * t[:, 0], 2 * t[:, 1]) @ g

        # the inverse affine through grid_sample; half-pixel centres, so
        # that the identity affine samples every pixel exactly
        inv = torch.linalg.inv(g)
        ys, xs = torch.meshgrid((torch.arange(h, device=dev) + 0.5) * 2.0 / h - 1.0,
                                (torch.arange(w, device=dev) + 0.5) * 2.0 / w - 1.0,
                                indexing="ij")
        base = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(-1, 3)  # (HW, 3)
        grid = torch.einsum("nij,pj->npi", inv, base)[..., :2].reshape(n, h, w, 2)
        images = grid_sample(images, grid)

        # ---- color: one 4x4 matrix per sample -----------------------------
        eye4 = torch.eye(4, device=dev)[None]
        m = eye4.repeat(n, 1, 1)
        v_axis = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev) / math.sqrt(3)
        vv = torch.outer(v_axis, v_axis)[None]
        if self.brightness > 0:
            b = torch.where(on("brightness", self.brightness),
                            d["brightness_s"] * self.brightness_std, 0.0)
            t = torch.zeros(n, 4, 4, device=dev)
            t[:, :3, 3] = b[:, None]
            m = (eye4 + t) @ m
        if self.contrast > 0:
            cm = torch.where(on("contrast", self.contrast),
                             torch.exp2(d["contrast_s"] * self.contrast_std), 1.0)
            m = torch.diag_embed(torch.cat([cm[:, None].repeat(1, 3), one[:, None]], dim=1)) @ m
        if self.lumaflip > 0:
            sign = torch.where(on("lumaflip", self.lumaflip), 1.0, 0.0)
            m = (eye4 - 2 * vv * sign[:, None, None]) @ m
        if self.hue > 0:
            theta = torch.where(on("hue", self.hue), d["hue_t"] * math.pi * self.hue_max, 0.0)
            m = _rot3d_about(v_axis[:3].tolist(), theta) @ m
        if self.saturation > 0:
            s = torch.where(on("saturation", self.saturation),
                            torch.exp2(d["saturation_s"] * self.saturation_std), 1.0)
            m = (vv + (eye4 - vv) * s[:, None, None]) @ m
        rgb1 = torch.cat([images.reshape(n, c, h * w), torch.ones(n, 1, h * w, device=dev)],
                         dim=1)  # (N, 4, HW)
        images = torch.einsum("nij,njp->nip", m, rgb1)[:, :3].reshape(n, c, h, w)

        # ---- image-space filtering (augment.py:382-411) -------------------
        if self.imgfilter > 0:
            num_bands = _HZ_FBANK.shape[0]
            if len(self.imgfilter_bands) != num_bands:
                raise ValueError(f"imgfilter_bands needs {num_bands} entries")
            expected = torch.from_numpy(_EXPECTED_POWER).to(dev)
            gain = torch.ones(n, num_bands, device=dev)
            for i, strength in enumerate(self.imgfilter_bands):
                t_i = torch.where(d["imgfilter"][:, i] < self.imgfilter * p * strength,
                                  torch.exp2(d["imgfilter_t"][:, i] * self.imgfilter_std), 1.0)
                t = torch.ones(n, num_bands, device=dev)
                t[:, i] = t_i
                gain = gain * (t / torch.sqrt((expected * t.square()).sum(-1, keepdim=True)))
            images = filter_images(images, gain @ torch.from_numpy(_HZ_FBANK).to(dev))

        # ---- additive RGB noise (augment.py:417-421) ----------------------
        if self.noise > 0:
            sigma = d["noise_sigma"].abs() * self.noise_std
            sigma = torch.where(d["noise"] < self.noise * p, sigma, 0.0)
            images = images + d["noise_field"][h] * sigma[:, None, None, None]

        # ---- cutout -------------------------------------------------------
        if self.cutout > 0:
            center = d["cutout_center"]
            half = self.cutout_size / 2
            yy = torch.linspace(0, 1, h, device=dev)[None, :, None]
            xx = torch.linspace(0, 1, w, device=dev)[None, None, :]
            mask = (((yy - center[:, 0, None, None]).abs() >= half)
                    | ((xx - center[:, 1, None, None]).abs() >= half)).to(images.dtype)
            mask = torch.where(on("cutout", self.cutout)[:, None, None], mask, 1.0)
            images = images * mask[:, None]
        return images
