"""Plain float32 CLIP ViT towers (Radford et al., 2021; openai/CLIP
`model.py`) and StyleGAN-NADA's directional loss (Gal et al., 2022;
ZSSGAN/criteria/clip_loss.py), functional over a flat dict named as the
published state dict. The tokenizer is a stand-in for the BPE vocabulary,
which is not in the repository: SOT 1, each word's CRC-32 into [2, 2 +
min(40000, vocab - 3)), EOT the highest id, zero padding."""

from __future__ import annotations

import math
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import quant

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
TEMPLATES = Path(__file__).with_name("imagenet_templates.txt")


class CRCTokenizer:
    def __init__(self, vocab_size: int):
        self.span = min(40000, vocab_size - 3)
        self.eot = vocab_size - 1

    def tokenize(self, texts, context_length=77):
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            toks = [1] + [zlib.crc32(w.encode()) % self.span + 2 for w in t.split()]
            toks = toks[: context_length - 1] + [self.eot]
            out[i, : len(toks)] = toks
        return out


def templates():
    return TEMPLATES.read_text().splitlines()


def _block_spec(p, w):
    return [(p + "ln_1.weight", (w,), ("const", 1.0)), (p + "ln_1.bias", (w,), ("const", 0.0)),
            (p + "attn.in_proj_weight", (3 * w, w), ("normal", w ** -0.5)),
            (p + "attn.in_proj_bias", (3 * w,), ("const", 0.0)),
            (p + "attn.out_proj.weight", (w, w), ("normal", w ** -0.5)),
            (p + "attn.out_proj.bias", (w,), ("const", 0.0)),
            (p + "ln_2.weight", (w,), ("const", 1.0)), (p + "ln_2.bias", (w,), ("const", 0.0)),
            (p + "mlp.c_fc.weight", (4 * w, w), ("normal", w ** -0.5)),
            (p + "mlp.c_fc.bias", (4 * w,), ("const", 0.0)),
            (p + "mlp.c_proj.weight", (w, 4 * w), ("normal", w ** -0.5)),
            (p + "mlp.c_proj.bias", (w,), ("const", 0.0))]


def clip_spec(cfg):
    """[(name, shape, init)] of a ViT CLIP model (spi_tpu's init scales)."""
    vw, p, tw = cfg["vision_width"], cfg["vision_patch_size"], cfg["transformer_width"]
    n_tok = (cfg["image_resolution"] // p) ** 2 + 1
    spec = [("visual.conv1.weight", (vw, 3, p, p), ("normal", math.sqrt(2.0 / (3 * p * p)))),
            ("visual.class_embedding", (vw,), ("normal", vw ** -0.5)),
            ("visual.positional_embedding", (n_tok, vw), ("normal", vw ** -0.5)),
            ("visual.ln_pre.weight", (vw,), ("const", 1.0)),
            ("visual.ln_pre.bias", (vw,), ("const", 0.0))]
    for i in range(cfg["vision_layers"]):
        spec += _block_spec(f"visual.transformer.resblocks.{i}.", vw)
    spec += [("visual.ln_post.weight", (vw,), ("const", 1.0)),
             ("visual.ln_post.bias", (vw,), ("const", 0.0)),
             ("visual.proj", (vw, cfg["embed_dim"]), ("normal", vw ** -0.5))]
    for i in range(cfg["transformer_layers"]):
        spec += _block_spec(f"transformer.resblocks.{i}.", tw)
    spec += [("token_embedding.weight", (cfg["vocab_size"], tw), ("normal", 0.02)),
             ("positional_embedding", (cfg["context_length"], tw), ("normal", 0.01)),
             ("ln_final.weight", (tw,), ("const", 1.0)), ("ln_final.bias", (tw,), ("const", 0.0)),
             ("text_projection", (tw, cfg["embed_dim"]), ("normal", tw ** -0.5)),
             ("logit_scale", (), ("const", math.log(1 / 0.07)))]
    return spec


def _ln(P, p, x):
    return F.layer_norm(x, x.shape[-1:], P[p + "weight"], P[p + "bias"], eps=1e-5)


def _transformer(P, prefix, x, layers, heads, mask=None):
    for i in range(layers):
        p = f"{prefix}resblocks.{i}."
        n, length, w = x.shape
        qkv = quant.linear(_ln(P, p + "ln_1.", x), P[p + "attn.in_proj_weight"],
                           P[p + "attn.in_proj_bias"])
        q, k, v = (t.reshape(n, length, heads, w // heads).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        logits = quant.matmul(q, k.transpose(-1, -2)) / math.sqrt(w // heads)
        if mask is not None:
            logits = logits + mask
        a = quant.matmul(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(n, length, w)
        x = x + quant.linear(a, P[p + "attn.out_proj.weight"], P[p + "attn.out_proj.bias"])
        h = quant.linear(_ln(P, p + "ln_2.", x), P[p + "mlp.c_fc.weight"], P[p + "mlp.c_fc.bias"])
        h = h * torch.sigmoid(1.702 * h)
        x = x + quant.linear(h, P[p + "mlp.c_proj.weight"], P[p + "mlp.c_proj.bias"])
    return x


def encode_image(P, cfg, img):
    """GAN output (N, 3, H, W) in [-1, 1] -> unit embedding (N, D): to [0, 1],
    bilinear resize to the input resolution, CLIP normalization, ViT."""
    r = cfg["image_resolution"]
    x = F.interpolate(img * 0.5 + 0.5, size=(r, r), mode="bilinear", align_corners=False)
    mean = torch.tensor(CLIP_MEAN, device=img.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=img.device)[None, :, None, None]
    p = cfg["vision_patch_size"]
    x = quant.conv2d((x - mean) / std, P["visual.conv1.weight"], stride=p)
    n, w = x.shape[:2]
    x = x.reshape(n, w, -1).transpose(1, 2)
    x = torch.cat([P["visual.class_embedding"].expand(n, 1, w), x], dim=1)
    x = _ln(P, "visual.ln_pre.", x + P["visual.positional_embedding"])
    x = _transformer(P, "visual.transformer.", x, cfg["vision_layers"], w // 64)
    x = quant.matmul(_ln(P, "visual.ln_post.", x[:, 0]), P["visual.proj"])
    return x / x.norm(dim=-1, keepdim=True)


def encode_text(P, cfg, tokens):
    tokens = tokens.long()
    x = P["token_embedding.weight"][tokens] + P["positional_embedding"]
    length = cfg["context_length"]
    mask = torch.full((length, length), float("-inf"), device=x.device).triu(1)
    x = _ln(P, "ln_final.", _transformer(P, "transformer.", x, cfg["transformer_layers"],
                                        cfg["transformer_heads"], mask))
    x = quant.matmul(x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)],
                     P["text_projection"])
    return x / x.norm(dim=-1, keepdim=True)


@torch.no_grad()
def text_direction(P, cfg, tokenizer, source, target):
    """The unit mean direction from the source to the target text over the
    ImageNet templates (clip_loss.py:117-124)."""
    dev = P["text_projection"].device

    def feats(text):
        toks = tokenizer.tokenize([t.format(text) for t in templates()], cfg["context_length"])
        return encode_text(P, cfg, torch.as_tensor(toks, device=dev))

    d = (feats(target) - feats(source)).mean(dim=0, keepdim=True)
    return d / d.norm(dim=-1, keepdim=True)


def directional_loss(P, cfg, src_img, tgt_img, direction):
    """1 - cos(image edit direction, text direction), mean over the batch."""
    edit = encode_image(P, cfg, tgt_img) - encode_image(P, cfg, src_img)
    edit = edit + 1e-8
    edit = edit / edit.norm(dim=-1, keepdim=True)
    return (1.0 - (edit * direction).sum(dim=-1)).mean()
