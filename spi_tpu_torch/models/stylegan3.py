"""StyleGAN3 (alias-free) generator networks (counterpart of
spi_tpu/models/stylegan3.py; spec eg3d/training/networks_stylegan3.py:
SynthesisInput :171-254, SynthesisLayer :258-396, SynthesisNetwork
:400-489, Generator :493-523). Needed only for SG3-backbone checkpoints;
the shipped FFHQ EG3D checkpoint uses the StyleGAN2 backbone.

Names follow spi_tpu's pytree paths, so `load_flat_params` reads its
flattened tree one-to-one: `input.{weight, affine.*, transform, freqs,
phases}`, `L{idx}_{size}_{channels}.{affine.*, weight, bias,
magnitude_ema}`. `magnitude_ema` and the input's `transform`, `freqs` and
`phases` are persistent buffers (parameters in spi_tpu, never trained); the
up and down FIR filters are non-persistent buffers computed from the
configuration. `forward(..., update_emas=True)` renews each layer's
`magnitude_ema` in place from its input before using it, as EG3D does
(spi_tpu's functional `updated_magnitude_ema`). The nonlinearity is
`ops.filtered_lrelu` (on a card its fused kernel, csrc/filtered_lrelu.cu,
for every layer of the 1-D filters; the bias_act and upfirdn2d kernels for
radial ones). Float32.
`SG3SynthesisNetwork.forward` opens the `spi.synthesis` span.

`stylegan3_t_ffhq1024()` and `tiny_stylegan3()` give `SG3Generator`'s
arguments for the published StyleGAN3-T FFHQ-1024 and for the CPU tests;
`generator_kwargs` reads them from the init kwargs of NVIDIA's network
pickle (the `.json` of `python -m spi_tpu_torch.convert stylegan3`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from spi_tpu_torch.models.stylegan2 import FullyConnected, MappingNetwork, _normal, seeded_init
from spi_tpu_torch.ops import conv2d_resample, filtered_lrelu
from spi_tpu_torch.utils.device import resolve_device
from spi_tpu_torch.utils.stats import span


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float,
                          radial: bool = False):
    """Kaiser low-pass FIR design (networks_stylegan3.py:364-386).

    Returns a float32 numpy 1D separable filter, a 2D radial (jinc)
    filter, or None for the identity (numtaps == 1).
    """
    if numtaps < 1:
        raise ValueError(f"numtaps must be >= 1, got {numtaps}")
    if numtaps == 1:
        return None
    import scipy.signal

    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return np.asarray(f, dtype=np.float32)

    import scipy.special

    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    # For odd taps r hits 0: the analytic limit j1(2πc r)/(π r) -> c there.
    if numtaps % 2 == 1:
        mid = (numtaps - 1) // 2
        f[mid, mid] = cutoff
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f = f * np.outer(w, w)
    f = f / np.sum(f)
    return np.asarray(f, dtype=np.float32)


def modulated_conv2d_sg3(x, weight, styles, input_gain=None, demodulate=True, padding=0):
    """SG3-flavoured modulated conv (networks_stylegan3.py:26-67), in the
    non-fused scale -> shared-weight conv -> scale form, as spi_tpu."""
    if demodulate:
        weight = weight * weight.square().mean(dim=(1, 2, 3), keepdim=True).rsqrt()
        styles = styles * styles.square().mean().rsqrt()
        w2 = weight.square().sum(dim=(2, 3))  # (O, I)
        dcoefs = (styles.square() @ w2.T + 1e-8).rsqrt()  # (N, O)
    scale = styles if input_gain is None else styles * input_gain
    x = x * scale[:, :, None, None].to(x.dtype)
    x = conv2d_resample(x, weight.to(x.dtype), padding=padding)
    if demodulate:
        x = x * dcoefs[:, :, None, None].to(x.dtype)
    return x


def _filter_buffer(f, device):
    return None if f is None else torch.tensor(f, device=device)


class _InputAffine(FullyConnected):
    """SynthesisInput's affine: weight 0, bias (1, 0, 0, 0), the identity
    transform (networks_stylegan3.py:189)."""

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.zero_()
            self.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))


class SynthesisInput(nn.Module):
    """Fourier features at `bandwidth`, rotated and translated by an affine
    of w (networks_stylegan3.py:171-254)."""

    def __init__(self, w_dim, channels, size, sampling_rate, bandwidth, device=None):
        super().__init__()
        self.channels = channels
        self.size = size
        self.sampling_rate = sampling_rate
        self.bandwidth = bandwidth
        self.affine = _InputAffine(w_dim, 4, device=device)
        self.weight = nn.Parameter(torch.empty(channels, channels, device=device))
        self.register_buffer("transform", torch.eye(3, device=device))
        self.register_buffer("freqs", torch.empty(channels, 2, device=device))
        self.register_buffer("phases", torch.empty(channels, device=device))

    def reset_parameters(self, gen):
        """Random frequencies from a uniform 2D disc scaled to the
        bandwidth, uniform phases, normal weights (spi_tpu's init)."""
        with torch.no_grad():
            freqs = torch.randn(self.channels, 2, generator=gen)
            radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
            freqs = freqs / (radii * radii.square().exp() ** 0.25) * self.bandwidth
            self.freqs.copy_(freqs)
            self.phases.copy_(torch.rand(self.channels, generator=gen) - 0.5)
            self.weight.copy_(_normal(self.weight.shape, gen, self.weight.device))
            self.transform.copy_(torch.eye(3))

    def forward(self, w):
        n = w.shape[0]
        freqs = self.freqs[None].expand(n, -1, -1)
        phases = self.phases[None].expand(n, -1)

        # Learned rotation / translation, applied inversely to the grid.
        t = self.affine(w)  # (N, 4) = (r_c, r_s, t_x, t_y)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        zeros = torch.zeros(n, dtype=t.dtype, device=t.device)
        ones = torch.ones(n, dtype=t.dtype, device=t.device)
        m_r = torch.stack([t[:, 0], -t[:, 1], zeros, t[:, 1], t[:, 0], zeros,
                           zeros, zeros, ones], dim=1).reshape(n, 3, 3)
        m_t = torch.stack([ones, zeros, -t[:, 2], zeros, ones, -t[:, 3],
                           zeros, zeros, ones], dim=1).reshape(n, 3, 3)
        transforms = m_r @ m_t @ self.transform[None]  # (N, 3, 3)

        phases = phases + (freqs @ transforms[:, :2, 2:])[..., 0]
        freqs = freqs @ transforms[:, :2, :2]

        # Dampen out-of-band frequencies introduced by the transform.
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0.0, 1.0)

        # Pixel-centre sampling grid in [-0.5, 0.5] * size / sampling_rate.
        half = 0.5 * self.size / self.sampling_rate
        coords = (torch.arange(self.size, dtype=torch.float32, device=w.device) * 2 + 1) \
            / self.size - 1
        gx = coords[None, :].expand(self.size, self.size) * half
        gy = coords[:, None].expand(self.size, self.size) * half
        grid = torch.stack([gx, gy], dim=-1)  # (H, W, 2)

        # Fourier features: sin(2π (g·f + phase)) * amplitude.
        x = torch.einsum("hwd,ncd->nhwc", grid, freqs) + phases[:, None, None, :]
        x = torch.sin(x * (2 * math.pi)) * amplitudes[:, None, None, :]
        x = x @ (self.weight / math.sqrt(self.channels)).T
        return x.permute(0, 3, 1, 2)  # (N, C, H, W)


class SG3SynthesisLayer(nn.Module):
    """networks_stylegan3.py:258-396: modulated conv, then filtered_lrelu
    between the layer's input and output sampling rates."""

    def __init__(self, w_dim, is_torgb, is_critically_sampled, in_channels, out_channels,
                 in_size, out_size, in_sampling_rate, out_sampling_rate, in_cutoff, out_cutoff,
                 in_half_width, out_half_width, conv_kernel=3, filter_size=6,
                 lrelu_upsampling=2, use_radial_filters=False, conv_clamp=256.0,
                 magnitude_ema_beta=0.999, device=None):
        super().__init__()
        self.is_torgb = is_torgb
        self.in_channels = in_channels
        self.out_size = out_size
        self.conv_kernel = 1 if is_torgb else conv_kernel
        self.conv_clamp = conv_clamp
        self.magnitude_ema_beta = magnitude_ema_beta

        tmp_sampling_rate = max(in_sampling_rate, out_sampling_rate) * (
            1 if is_torgb else lrelu_upsampling)
        self.up_factor = int(round(tmp_sampling_rate / in_sampling_rate))
        self.down_factor = int(round(tmp_sampling_rate / out_sampling_rate))
        up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        down_taps = filter_size * self.down_factor if self.down_factor > 1 and not is_torgb else 1
        up_filter = design_lowpass_filter(numtaps=up_taps, cutoff=in_cutoff,
                                          width=in_half_width * 2, fs=tmp_sampling_rate)
        down_filter = design_lowpass_filter(
            numtaps=down_taps, cutoff=out_cutoff, width=out_half_width * 2,
            fs=tmp_sampling_rate, radial=use_radial_filters and not is_critically_sampled)
        self.register_buffer("up_filter", _filter_buffer(up_filter, device), persistent=False)
        self.register_buffer("down_filter", _filter_buffer(down_filter, device),
                             persistent=False)

        # networks_stylegan3.py:322-328
        pad_total = (out_size - 1) * self.down_factor + 1
        pad_total -= (in_size + self.conv_kernel - 1) * self.up_factor
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi)]

        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, device=device)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, self.conv_kernel,
                                               self.conv_kernel, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        self.register_buffer("magnitude_ema", torch.ones((), device=device))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(_normal(self.weight.shape, gen, self.weight.device))
            self.bias.zero_()
            self.magnitude_ema.fill_(1.0)

    def update_magnitude_ema(self, x):
        """magnitude_ema <- mean(x²) + beta (magnitude_ema - mean(x²)), in
        place (networks_stylegan3.py:336-340)."""
        with torch.no_grad():
            cur = x.detach().float().square().mean()
            self.magnitude_ema.copy_(cur + self.magnitude_ema_beta * (self.magnitude_ema - cur))

    def forward(self, x, w, update_emas=False):
        if update_emas:
            self.update_magnitude_ema(x)
        input_gain = self.magnitude_ema.rsqrt()
        styles = self.affine(w)
        if self.is_torgb:
            styles = styles / math.sqrt(self.in_channels * self.conv_kernel**2)
        x = modulated_conv2d_sg3(x, self.weight, styles, input_gain=input_gain,
                                 demodulate=not self.is_torgb, padding=self.conv_kernel - 1)
        x = filtered_lrelu(x, fu=self.up_filter, fd=self.down_filter, b=self.bias.to(x.dtype),
                           up=self.up_factor, down=self.down_factor, padding=self.padding,
                           gain=1.0 if self.is_torgb else math.sqrt(2.0),
                           slope=1.0 if self.is_torgb else 0.2, clamp=self.conv_clamp)
        if x.shape[2] != self.out_size or x.shape[3] != self.out_size:
            raise ValueError(f"layer output {tuple(x.shape)} is not {self.out_size}^2")
        return x


def _schedule(img_resolution, img_channels, channel_base, channel_max, num_layers,
              num_critical, first_cutoff, first_stopband, last_stopband_rel, margin_size):
    """Per-layer cutoffs, stopbands, sampling rates, half widths, sizes and
    channels (networks_stylegan3.py:430-443)."""
    last_cutoff = img_resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
    half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
    sizes = sampling_rates + margin_size * 2
    sizes[-2:] = img_resolution
    channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
    channels[-1] = img_channels
    return cutoffs, stopbands, sampling_rates, half_widths, sizes, channels


class SG3SynthesisNetwork(nn.Module):
    """networks_stylegan3.py:400-489: the input, `num_layers` layers and a
    ToRGB layer, named `L{idx}_{size}_{channels}`."""

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768,
                 channel_max=512, num_layers=14, num_critical=2, first_cutoff=2.0,
                 first_stopband=2**2.1, last_stopband_rel=2**0.3, margin_size=10,
                 output_scale=0.25, use_radial_filters=False, device=None):
        super().__init__()
        self.num_ws = num_layers + 2
        self.output_scale = output_scale
        cutoffs, _, rates, half_widths, sizes, channels = _schedule(
            img_resolution, img_channels, channel_base, channel_max, num_layers, num_critical,
            first_cutoff, first_stopband, last_stopband_rel, margin_size)
        self.input = SynthesisInput(w_dim=w_dim, channels=int(channels[0]), size=int(sizes[0]),
                                    sampling_rate=float(rates[0]),
                                    bandwidth=float(cutoffs[0]), device=device)
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            layer = SG3SynthesisLayer(
                w_dim=w_dim, is_torgb=idx == num_layers,
                is_critically_sampled=idx >= num_layers - num_critical,
                in_channels=int(channels[prev]), out_channels=int(channels[idx]),
                in_size=int(sizes[prev]), out_size=int(sizes[idx]),
                in_sampling_rate=int(rates[prev]), out_sampling_rate=int(rates[idx]),
                in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
                in_half_width=float(half_widths[prev]), out_half_width=float(half_widths[idx]),
                use_radial_filters=use_radial_filters, device=device)
            name = f"L{idx}_{int(sizes[idx])}_{int(channels[idx])}"
            self.add_module(name, layer)
            self.layer_names.append(name)

    def forward(self, ws, noise_mode="const", update_emas=False):
        """ws: (N, num_ws, w_dim) -> (N, img_channels, R, R), float32. SG3
        has no noise inputs; `noise_mode` is accepted for the callers'
        sake. update_emas: renew every layer's magnitude_ema first."""
        del noise_mode
        with span("spi.synthesis"):
            x = self.input(ws[:, 0].float())
            for idx, name in enumerate(self.layer_names):
                x = getattr(self, name)(x, ws[:, idx + 1].float(), update_emas=update_emas)
            if self.output_scale != 1:
                x = x * self.output_scale
            return x.float()


class SG3Generator(nn.Module):
    """networks_stylegan3.py:493-523: StyleGAN2's mapping network and the
    SG3 synthesis. The defaults are StyleGAN3-T FFHQ-1024's
    (`stylegan3-t-ffhq-1024x1024.pkl`) but for the resolution and
    channels, which are required. device: None means `cuda` (raises
    without a GPU); weights are drawn from `seed` with spi_tpu's init's
    distributions."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels, channel_base=32768,
                 channel_max=512, mapping_layers=2, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.synthesis = SG3SynthesisNetwork(w_dim, img_resolution, img_channels,
                                             channel_base=channel_base, channel_max=channel_max,
                                             device=dev)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, num_ws=self.num_ws,
                                      num_layers=mapping_layers, device=dev)
        seeded_init(self, seed)

    def forward(self, z, c, truncation_psi=1.0, noise_mode="const", update_emas=False):
        ws = self.mapping(z, c, truncation_psi=truncation_psi)
        return self.synthesis(ws, noise_mode=noise_mode, update_emas=update_emas)


def stylegan3_t_ffhq1024() -> dict:
    """`SG3Generator`'s arguments for StyleGAN3-T FFHQ-1024
    (`stylegan3-t-ffhq-1024x1024.pkl`: NVlabs/stylegan3 train.py's
    stylegan3-t with cbase 32768, cmax 512, map 2)."""
    return dict(z_dim=512, c_dim=0, w_dim=512, img_resolution=1024, img_channels=3,
                channel_base=32768, channel_max=512, mapping_layers=2)


def tiny_stylegan3() -> dict:
    """A tiny SG3-T for the CPU tests: 14 layers at 32^2, one of them
    upsampling by 4."""
    return dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=32, img_channels=3,
                channel_base=128, channel_max=16, mapping_layers=2)


# Synthesis arguments of NVIDIA's Generator that this port builds only at
# their StyleGAN3-T values.
_T_ONLY = {"conv_kernel": 3, "use_radial_filters": False, "num_layers": 14,
           "num_critical": 2, "first_cutoff": 2, "first_stopband": 2 ** 2.1,
           "last_stopband_rel": 2 ** 0.3, "margin_size": 10, "output_scale": 0.25,
           "filter_size": 6, "lrelu_upsampling": 2, "conv_clamp": 256}


def generator_kwargs(init_kwargs: dict) -> dict:
    """NVIDIA's `networks_stylegan3.Generator` init kwargs -> `SG3Generator`'s
    arguments. Raises on a synthesis argument this port does not build (the
    StyleGAN3-R's 1x1 kernels and radial filters, another layer count)."""
    for k, want in _T_ONLY.items():
        if k in init_kwargs and init_kwargs[k] != want:
            raise ValueError(f"{k}={init_kwargs[k]!r}: the port builds StyleGAN3-T ({want!r})")
    mapping = init_kwargs.get("mapping_kwargs") or {}
    return dict(z_dim=int(init_kwargs["z_dim"]), c_dim=int(init_kwargs["c_dim"]),
                w_dim=int(init_kwargs["w_dim"]), img_resolution=int(init_kwargs["img_resolution"]),
                img_channels=int(init_kwargs["img_channels"]),
                channel_base=int(init_kwargs.get("channel_base", 32768)),
                channel_max=int(init_kwargs.get("channel_max", 512)),
                mapping_layers=int(mapping.get("num_layers", 2)))
