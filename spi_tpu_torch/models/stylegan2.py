"""StyleGAN2 generator networks (counterpart of spi_tpu/models/stylegan2.py;
spec EG3D networks_stylegan2.py).

Parameter and buffer names follow the JAX package's pytree paths, which
follow the reference state_dict, so `load_flat_params` is a one-to-one
copy. `modulated_conv2d` is the non-fused formulation (scale the
activations, one shared-weight conv, demodulate after), as in spi_tpu.
The noise maps `noise_const` are buffers; stage-1 inversion swaps in
its own optimised tensors (utils/params.functional_apply). Under
`noise_mode="random"` every call takes fresh (N, 1, R, R) maps, keyed by
the name of the `noise_const` buffer each one stands in for
(`SynthesisNetwork.draw_noise`); CLIP-guided editing renders so.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from spi_tpu_torch.ops import bias_act, conv2d_resample, setup_filter, upsample2d
from spi_tpu_torch.ops.bias_act import activation_funcs


def normalize_2nd_moment(x, dim=-1, eps=1e-8):
    """networks_stylegan2.py:28-29."""
    return x * (x.square().mean(dim=dim, keepdim=True) + eps).rsqrt()


def _normal(shape, gen, device):
    """Standard normal draws from a CPU generator, placed on `device`, so a
    seed gives the same weights on every device."""
    return torch.randn(shape, generator=gen).to(device)


class FullyConnected(nn.Module):
    """networks_stylegan2.py:96-127."""

    def __init__(self, in_features, out_features, bias=True, activation="linear",
                 lr_multiplier=1.0, bias_init=0.0, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device)) if bias else None

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(_normal(self.weight.shape, gen, self.weight.device)
                              / self.lr_multiplier)
            if self.bias is not None:
                self.bias.fill_(self.bias_init)

    def forward(self, x):
        w = self.weight * (self.lr_multiplier / math.sqrt(self.in_features))
        # An output width that is not a multiple of 8 (the decoder's 1 + 32)
        # is padded with zero rows for the product and cut after it: under
        # torch.func.vmap with each image's own weights the product is a
        # batched matmul, which otherwise runs on an unaligned kernel.
        pad = -self.out_features % 8
        if pad:
            w = F.pad(w, (0, 0, 0, pad))
        x = x @ w.T
        if pad:
            x = x[..., :self.out_features]
        b = self.bias
        if b is not None and self.lr_multiplier != 1.0:
            b = b * self.lr_multiplier
        return bias_act(x, b, act=self.activation)


def modulated_conv2d(x, weight, styles, noise=None, up=1, down=1, padding=0,
                     resample_filter=None, demodulate=True, flip_weight=True):
    """Style-modulated convolution, non-fused (networks_stylegan2.py:34-91).

    x: (N, I, H, W); weight: (O, I, kh, kw); styles: (N, I).
    """
    dcoefs = None
    if demodulate:
        # sum_{i,k,k} (w_oik * s_i)^2 = sum_i (sum_kk w^2)_oi * s_i^2
        w2 = weight.square().sum(dim=(2, 3))  # (O, I)
        dcoefs = (styles.square() @ w2.T + 1e-8).rsqrt()  # (N, O)
    x = x * styles[:, :, None, None]
    x = conv2d_resample(x, weight, f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs[:, :, None, None]
    if noise is not None:
        x = x + noise
    return x


def _resample_filter_buffer(module: nn.Module, device):
    module.register_buffer("resample_filter", setup_filter([1, 3, 3, 1], device=device),
                           persistent=False)


class SynthesisLayer(nn.Module):
    """networks_stylegan2.py:276-335."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, kernel_size=3,
                 up=1, use_noise=True, activation="lrelu", conv_clamp=256.0, device=None):
        super().__init__()
        self.up = up
        self.use_noise = use_noise
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, device=device)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))
        if use_noise:
            self.register_buffer("noise_const", torch.empty(resolution, resolution, device=device))
            self.noise_strength = nn.Parameter(torch.empty((), device=device))
        _resample_filter_buffer(self, device)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(_normal(self.weight.shape, gen, self.weight.device))
            self.bias.zero_()
            if self.use_noise:
                self.noise_const.copy_(_normal(self.noise_const.shape, gen,
                                               self.noise_const.device))
                self.noise_strength.zero_()

    def forward(self, x, w, noise_mode="const", gain=1.0, noise=None):
        """noise: this layer's (N, 1, R, R) map under noise_mode='random'."""
        if noise_mode not in ("const", "none", "random"):
            raise ValueError(f"noise_mode must be 'const', 'none' or 'random', "
                             f"got {noise_mode!r}")
        styles = self.affine(w)
        if not self.use_noise or noise_mode == "none":
            noise = None
        elif noise_mode == "const":
            noise = self.noise_const * self.noise_strength
        elif noise is None:
            raise ValueError("noise_mode='random' needs this layer's noise map")
        else:
            noise = noise.to(x.dtype) * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.padding, resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """networks_stylegan2.py:340-360."""

    def __init__(self, in_channels, out_channels, w_dim, kernel_size=1, conv_clamp=256.0,
                 device=None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size**2)
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1.0, device=device)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size,
                                               kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(_normal(self.weight.shape, gen, self.weight.device))
            self.bias.zero_()

    def forward(self, x, w):
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """networks_stylegan2.py:365-464, 'skip' architecture; `up=1` is the
    superresolution's SynthesisBlockNoUp (superresolution.py:158-257)."""

    def __init__(self, in_channels, out_channels, w_dim, resolution, img_channels,
                 is_last, architecture="skip", conv_clamp=256.0, up=2, device=None):
        super().__init__()
        self.in_channels = in_channels
        self.up = up
        self.num_conv = 1 if in_channels == 0 else 2
        self.num_torgb = 1 if (is_last or architecture == "skip") else 0
        if in_channels == 0:
            self.const = nn.Parameter(torch.empty(out_channels, resolution, resolution,
                                                  device=device))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution, up=up,
                                        conv_clamp=conv_clamp, device=device)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim, resolution,
                                    conv_clamp=conv_clamp, device=device)
        if self.num_torgb:
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim, conv_clamp=conv_clamp,
                                    device=device)
        _resample_filter_buffer(self, device)

    def reset_parameters(self, gen):
        if self.in_channels == 0:
            with torch.no_grad():
                self.const.copy_(_normal(self.const.shape, gen, self.const.device))

    def forward(self, x, img, ws, noise_mode="const", noise=None):
        """ws: (N, num_conv + num_torgb, w_dim). noise: {'conv0', 'conv1':
        (N, 1, R, R)} under noise_mode='random'."""
        noise = noise or {}
        if self.in_channels == 0:
            x = self.const[None].expand(ws.shape[0], -1, -1, -1)
            x = self.conv1(x, ws[:, 0], noise_mode=noise_mode, noise=noise.get("conv1"))
        else:
            x = self.conv0(x, ws[:, 0], noise_mode=noise_mode, noise=noise.get("conv0"))
            x = self.conv1(x, ws[:, 1], noise_mode=noise_mode, noise=noise.get("conv1"))
        if img is not None and self.up > 1:
            img = upsample2d(img, self.resample_filter)
        if self.num_torgb:
            y = self.torgb(x, ws[:, self.num_conv])
            img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """networks_stylegan2.py:469-524."""

    def __init__(self, w_dim, img_resolution, img_channels, channel_base=32768,
                 channel_max=512, conv_clamp=256.0, device=None):
        super().__init__()
        log2 = int(math.log2(img_resolution))
        self.block_resolutions = tuple(2**i for i in range(2, log2 + 1))

        def channels(res):
            return min(channel_base // res, channel_max)

        self.num_ws = 0
        for res in self.block_resolutions:
            block = SynthesisBlock(
                in_channels=channels(res // 2) if res > 4 else 0,
                out_channels=channels(res), w_dim=w_dim, resolution=res,
                img_channels=img_channels, is_last=(res == img_resolution),
                conv_clamp=conv_clamp, device=device,
            )
            self.add_module(f"b{res}", block)
            self.num_ws += block.num_conv + (block.num_torgb if res == img_resolution else 0)

    def draw_noise(self, n, generator=None, out=None):
        """Fresh standard-normal noise maps for noise_mode='random', one per
        noise_const buffer, in the order of synthesis: {its name: (n, 1, R,
        R)} from `generator`, on the buffers' device (spi_tpu draws each
        from its own split key); into `out`'s tensors where it is given (a
        dict as this returns)."""
        out = out or {}
        return {k: torch.randn((n, 1, *v.shape), generator=generator, device=v.device,
                               out=out.get(k))
                for k, v in self.named_buffers() if k.endswith("noise_const")}

    def forward(self, ws, noise_mode="const", noise=None):
        """ws: (N, num_ws, w_dim) -> (N, img_channels, R, R). noise: under
        noise_mode='random', the maps ({noise_const name: (N, 1, R, R)}, as
        `draw_noise` gives)."""
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            block_noise = {k.split(".")[1]: v for k, v in (noise or {}).items()
                           if k.startswith(f"b{res}.")}
            # A block's torgb w is the next block's first w
            # (networks_stylegan2.py:503-512).
            block_ws = ws[:, w_idx:w_idx + block.num_conv + block.num_torgb]
            x, img = block(x, img, block_ws, noise_mode=noise_mode, noise=block_noise)
            w_idx += block.num_conv
        return img


class MappingNetwork(nn.Module):
    """networks_stylegan2.py:193-271."""

    def __init__(self, z_dim, c_dim, w_dim, num_ws, num_layers=8, lr_multiplier=0.01,
                 w_avg_beta=0.998, device=None):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        embed_features = w_dim if c_dim > 0 else 0
        if c_dim > 0:
            self.embed = FullyConnected(c_dim, embed_features, device=device)
        features = [z_dim + embed_features] + [w_dim] * num_layers
        for i in range(num_layers):
            self.add_module(f"fc{i}", FullyConnected(
                features[i], features[i + 1], activation="lrelu",
                lr_multiplier=lr_multiplier, device=device))
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros(w_dim, device=device))

    def reset_parameters(self, gen):
        if hasattr(self, "w_avg"):
            self.w_avg.zero_()

    def forward(self, z, c, truncation_psi=1.0, truncation_cutoff=None):
        x = None
        if self.z_dim > 0:
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        if self.num_ws is not None:
            x = x[:, None].repeat(1, self.num_ws, 1)
        if truncation_psi != 1.0:
            w_avg = self.w_avg
            if self.num_ws is None or truncation_cutoff is None:
                x = w_avg + truncation_psi * (x - w_avg)
            else:
                head = w_avg + truncation_psi * (x[:, :truncation_cutoff] - w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x


class Generator(nn.Module):
    """networks_stylegan2.py:529-552: mapping + synthesis."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 channel_base=32768, channel_max=512, device=None):
        super().__init__()
        self.synthesis = SynthesisNetwork(w_dim, img_resolution, img_channels,
                                          channel_base=channel_base,
                                          channel_max=channel_max, device=device)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, num_ws=self.num_ws, device=device)

    def forward(self, z, c, truncation_psi=1.0, noise_mode="const"):
        ws = self.mapping(z, c, truncation_psi=truncation_psi)
        return self.synthesis(ws, noise_mode=noise_mode)


def seeded_init(module: nn.Module, seed: int) -> None:
    """Draw every weight of `module` from one CPU generator seeded with
    `seed`, with the distributions of the JAX package's `init`: normal
    weights (divided by the FC lr multiplier), biases at their init
    value, zero noise strengths, normal noise maps."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(gen)
