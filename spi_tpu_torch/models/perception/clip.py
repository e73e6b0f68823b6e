"""CLIP image and text encoders (counterpart of
spi_tpu/models/perception/clip.py; spec: the OpenAI `clip` package that
ZSSGAN/criteria/clip_loss.py:42,67 loads: 'ViT-B/32' and 'ViT-B/16' for
the directional loss, 'RN50' for the texture loss).

Parameter and buffer names are OpenAI CLIP's state_dict names
(`visual.transformer.resblocks.{i}.attn.in_proj_weight`, `mlp.c_fc`,
`ln_1`, ...), which are spi_tpu's pytree paths, so `load_flat_params`
reads both spi_tpu's flattened parameters and the npz of `python -m
spi_tpu_torch.convert clip`.
Attention is plain matmul -> softmax -> matmul, LayerNorm and quick-GELU
plain ops, as spi_tpu computes them (no kernel stands behind them there).
The ResNet tower's batch norm is the eval form with stored statistics.
Float32 throughout.

Configurations are `CLIPConfig` values (`vit_b32`, `vit_b16`, `rn50`,
`tiny_test_clip`); `CLIP(cfg, device=..., seed=...)` builds the module on
its device (None: the card) with seeded random weights. On the `meta`
device it holds shapes only.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from spi_tpu_torch.models.perception.layers import BatchNorm, Conv2d
from spi_tpu_torch.models.stylegan2 import seeded_init
from spi_tpu_torch.ops import resize_bilinear
from spi_tpu_torch.utils.device import resolve_device

# CLIP input normalization (applied after scaling images to [0, 1]).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(x01):
    """(N, 3, H, W) in [0, 1] -> CLIP-normalized."""
    mean = torch.tensor(CLIP_MEAN, dtype=x01.dtype, device=x01.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, dtype=x01.dtype, device=x01.device)[None, :, None, None]
    return (x01 - mean) / std


def preprocess_gan_output(img, resolution: int):
    """GAN output in [-1, 1] at any square size -> CLIP input: to [0, 1],
    bilinear resize (Resize + CenterCrop of a square image), normalize
    (ZSSGAN/criteria/clip_loss.py:46-48)."""
    x01 = img * 0.5 + 0.5
    return clip_normalize(resize_bilinear(x01, (resolution, resolution)))


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _normal(shape, gen, scale):
    return torch.randn(shape, generator=gen) * scale


class LayerNorm(nn.Module):
    """LayerNorm over the last dim, eps 1e-5: `weight`, `bias`."""

    def __init__(self, width, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))

    def forward(self, x):
        return F.layer_norm(x, self.weight.shape, self.weight, self.bias, eps=1e-5)


class Linear(nn.Module):
    """x @ weight.T + bias, weight (out, in) drawn normal * `scale`
    (spi_tpu's init: the input width ** -0.5 unless given)."""

    def __init__(self, cin, cout, scale=None, device=None):
        super().__init__()
        self.scale = cin ** -0.5 if scale is None else scale
        self.weight = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.weight.copy_(_normal(self.weight.shape, gen, self.scale))
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


def _heads(x, h):
    """(N, L, W) -> (N, h, L, W / h)."""
    n, l, w = x.shape
    return x.reshape(n, l, h, w // h).transpose(1, 2)


def _attend(q, k, v, mask=None):
    """Softmax attention over (N, h, L, d): matmul, softmax, matmul."""
    logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits + mask
    out = torch.softmax(logits, dim=-1) @ v
    n, h, l, d = out.shape
    return out.transpose(1, 2).reshape(n, l, h * d)


class MultiheadAttention(nn.Module):
    """Self-attention with nn.MultiheadAttention's parameter names:
    `in_proj_weight` (3W, W), `in_proj_bias`, `out_proj`."""

    def __init__(self, width, heads, device=None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width, device=device))
        self.out_proj = Linear(width, width, device=device)

    def reset_parameters(self, gen):
        with torch.no_grad():
            w = self.in_proj_weight.shape[1]
            self.in_proj_weight.copy_(_normal(self.in_proj_weight.shape, gen, w ** -0.5))
            self.in_proj_bias.zero_()

    def forward(self, x, mask=None):
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        out = _attend(_heads(q, self.heads), _heads(k, self.heads), _heads(v, self.heads), mask)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, device)
        self.attn = MultiheadAttention(width, heads, device)
        self.ln_2 = LayerNorm(width, device)
        self.mlp = nn.ModuleDict({"c_fc": Linear(width, 4 * width, device=device),
                                  "c_proj": Linear(4 * width, width, scale=width ** -0.5,
                                                   device=device)})

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp["c_proj"](quick_gelu(self.mlp["c_fc"](self.ln_2(x))))


class Transformer(nn.Module):
    def __init__(self, width, layers, heads, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads, device)
                                       for _ in range(layers))

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class VisionTransformer(nn.Module):
    """Patch conv (stride = patch), class token, positional embedding,
    ln_pre, transformer, ln_post on token 0, proj (clip.py:151-200)."""

    def __init__(self, input_resolution, patch_size, width, layers, heads, output_dim,
                 device=None):
        super().__init__()
        self.patch_size = patch_size
        n_tok = (input_resolution // patch_size) ** 2 + 1
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.empty(width, device=device))
        self.positional_embedding = nn.Parameter(torch.empty(n_tok, width, device=device))
        self.ln_pre = LayerNorm(width, device)
        self.transformer = Transformer(width, layers, heads, device)
        self.ln_post = LayerNorm(width, device)
        self.proj = nn.Parameter(torch.empty(width, output_dim, device=device))

    def reset_parameters(self, gen):
        s = self.class_embedding.shape[0] ** -0.5
        with torch.no_grad():
            for p in (self.class_embedding, self.positional_embedding, self.proj):
                p.copy_(_normal(p.shape, gen, s))

    def forward(self, x):
        """x: (N, 3, R, R) CLIP-normalized -> (N, output_dim)."""
        x = self.conv1(x)
        n, w = x.shape[:2]
        x = x.reshape(n, w, -1).transpose(1, 2)  # (N, grid^2, W)
        x = torch.cat([self.class_embedding.expand(n, 1, w), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding)
        x = self.transformer(x)
        return self.ln_post(x[:, 0, :]) @ self.proj


def _avg_pool(x, k):
    return F.avg_pool2d(x, k) if k > 1 else x


class Bottleneck(nn.Module):
    """ModifiedResNet's bottleneck: the stride is an average pool after
    the 3x3 convolution, and on the shortcut before its 1x1 convolution
    (clip.py:214-260)."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, device=None):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, device=device)
        self.bn1 = BatchNorm(planes, device)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False, device=device)
        self.bn2 = BatchNorm(planes, device)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False, device=device)
        self.bn3 = BatchNorm(planes * 4, device)
        self.downsample = None
        if stride > 1 or inplanes != planes * 4:
            self.downsample = nn.ModuleDict({
                "0": Conv2d(inplanes, planes * 4, 1, bias=False, device=device),
                "1": BatchNorm(planes * 4, device)})

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(_avg_pool(out, self.stride)))
        if self.downsample is not None:
            x = self.downsample["1"](self.downsample["0"](_avg_pool(x, self.stride)))
        return F.relu(out + x)


class AttentionPool2d(nn.Module):
    """Attention pooling with the mean token as the one query
    (clip.py:263-305)."""

    def __init__(self, spacial_dim, embed_dim, num_heads, output_dim, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim, device=device))
        for name in ("k_proj", "q_proj", "v_proj"):
            self.add_module(name, Linear(embed_dim, embed_dim, device=device))
        self.c_proj = Linear(embed_dim, output_dim, device=device)

    def reset_parameters(self, gen):
        p = self.positional_embedding
        with torch.no_grad():
            p.copy_(_normal(p.shape, gen, p.shape[1] ** -0.5))

    def forward(self, x):
        """x: (N, C, H, W) -> (N, output_dim)."""
        n, c = x.shape[:2]
        x = x.reshape(n, c, -1).transpose(1, 2)  # (N, HW, C)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + self.positional_embedding
        h = self.num_heads
        out = _attend(_heads(self.q_proj(x[:, :1]), h), _heads(self.k_proj(x), h),
                      _heads(self.v_proj(x), h))
        return self.c_proj(out[:, 0])


class ModifiedResNet(nn.Module):
    """RN50's image tower: a 3-convolution stem, an average pool, four
    stages of bottlenecks (torch names layer1..layer4), attention pooling
    (clip.py:308-386)."""

    def __init__(self, layers, output_dim, heads, input_resolution=224, width=64, device=None):
        super().__init__()
        self.conv1 = Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False, device=device)
        self.bn1 = BatchNorm(width // 2, device)
        self.conv2 = Conv2d(width // 2, width // 2, 3, padding=1, bias=False, device=device)
        self.bn2 = BatchNorm(width // 2, device)
        self.conv3 = Conv2d(width // 2, width, 3, padding=1, bias=False, device=device)
        self.bn3 = BatchNorm(width, device)
        inplanes, planes = width, width
        for si, n_blocks in enumerate(layers):
            stride = 1 if si == 0 else 2
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes, stride if bi == 0 else 1, device))
                inplanes = planes * 4
            self.add_module(f"layer{si + 1}", nn.ModuleList(blocks))
            planes *= 2
        self.num_stages = len(layers)
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads, output_dim,
                                        device)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = _avg_pool(F.relu(self.bn3(self.conv3(x))), 2)
        for si in range(self.num_stages):
            for block in getattr(self, f"layer{si + 1}"):
                x = block(x)
        return self.attnpool(x)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Architecture of a CLIP model (spi_tpu's CLIP dataclass fields)."""

    embed_dim: int
    image_resolution: int
    vision_layers: int | tuple  # int: ViT depth; tuple: ResNet stage depths
    vision_width: int
    vision_patch_size: int | None
    context_length: int
    vocab_size: int
    transformer_width: int
    transformer_heads: int
    transformer_layers: int


class CLIP(nn.Module):
    """Image tower (ViT or ModifiedResNet) + text transformer.

    device: None means `cuda`, and raises when no GPU is present; `cpu`
    runs on the CPU; `meta` builds the shapes only (no weights drawn)."""

    def __init__(self, cfg: CLIPConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if isinstance(cfg.vision_layers, tuple):
            self.visual = ModifiedResNet(cfg.vision_layers, cfg.embed_dim,
                                         cfg.vision_width * 32 // 64, cfg.image_resolution,
                                         cfg.vision_width, device=dev)
        else:
            self.visual = VisionTransformer(cfg.image_resolution, cfg.vision_patch_size,
                                            cfg.vision_width, cfg.vision_layers,
                                            cfg.vision_width // 64, cfg.embed_dim, device=dev)
        w = cfg.transformer_width
        self.transformer = Transformer(w, cfg.transformer_layers, cfg.transformer_heads, dev)
        self.token_embedding = nn.Module()
        self.token_embedding.weight = nn.Parameter(torch.empty(cfg.vocab_size, w, device=dev))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, w, device=dev))
        self.ln_final = LayerNorm(w, dev)
        self.text_projection = nn.Parameter(torch.empty(w, cfg.embed_dim, device=dev))
        self.logit_scale = nn.Parameter(torch.empty((), device=dev))
        self.register_buffer("causal_mask", torch.full(
            (cfg.context_length, cfg.context_length), float("-inf"), device=dev).triu(1),
            persistent=False)
        if dev.type != "meta":
            seeded_init(self, seed)

    def reset_parameters(self, gen):
        w = self.cfg.transformer_width
        with torch.no_grad():
            self.token_embedding.weight.copy_(_normal(self.token_embedding.weight.shape, gen,
                                                      0.02))
            self.positional_embedding.copy_(_normal(self.positional_embedding.shape, gen, 0.01))
            self.text_projection.copy_(_normal(self.text_projection.shape, gen, w ** -0.5))
            self.logit_scale.fill_(math.log(1 / 0.07))

    @property
    def image_resolution(self) -> int:
        return self.cfg.image_resolution

    @property
    def context_length(self) -> int:
        return self.cfg.context_length

    def encode_image(self, image):
        """image: (N, 3, R, R) CLIP-normalized -> (N, embed_dim)."""
        return self.visual(image)

    def encode_text(self, tokens):
        """tokens: (N, context_length) integers -> (N, embed_dim), the
        feature at each sequence's arg-max token (EOT has the highest id
        in the CLIP vocabulary)."""
        tokens = tokens.long()
        x = self.token_embedding.weight[tokens] + self.positional_embedding
        x = self.ln_final(self.transformer(x, self.causal_mask))
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection

    def forward(self, image, tokens):
        """-> (logits_per_image, logits_per_text): cosine * exp(logit_scale)."""
        img = self.encode_image(image)
        txt = self.encode_text(tokens)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        logits_per_image = self.logit_scale.exp() * img @ txt.T
        return logits_per_image, logits_per_image.T


def vit_b32() -> CLIPConfig:
    return CLIPConfig(
        embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
        vision_patch_size=32, context_length=77, vocab_size=49408,
        transformer_width=512, transformer_heads=8, transformer_layers=12,
    )


def vit_b16() -> CLIPConfig:
    return CLIPConfig(
        embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
        vision_patch_size=16, context_length=77, vocab_size=49408,
        transformer_width=512, transformer_heads=8, transformer_layers=12,
    )


def rn50() -> CLIPConfig:
    return CLIPConfig(
        embed_dim=1024, image_resolution=224, vision_layers=(3, 4, 6, 3),
        vision_width=64, vision_patch_size=None, context_length=77,
        vocab_size=49408, transformer_width=512, transformer_heads=8,
        transformer_layers=12,
    )


def tiny_test_clip() -> CLIPConfig:
    """Miniature configuration for tests (structure-identical)."""
    return CLIPConfig(
        embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
        vision_patch_size=16, context_length=16, vocab_size=256,
        transformer_width=64, transformer_heads=2, transformer_layers=2,
    )
