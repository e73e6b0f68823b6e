"""CLIP losses for domain editing (counterpart of spi_tpu/editing/clip_loss.py;
spec ZSSGAN/criteria/clip_loss.py).

The text side is computed once into a `CLIPLossState` (`build_state`,
under `torch.no_grad`); the image-side terms run every step and carry a
gradient to the images, never to CLIP's weights. The numerics are
spi_tpu's: `_normalize` has no epsilon, an edit direction gets `+ 1e-8`
before it is normalized, the manifold cosine is clipped to [-1, 1], and
the patch term takes one centre per image, the same for the source and
the target render.
"""

from __future__ import annotations

import dataclasses

import torch

from spi_tpu_torch.editing.text_templates import (
    compose_text_with_templates,
    imagenet_templates,
    part_templates,
)
from spi_tpu_torch.models.perception.clip import CLIP, preprocess_gan_output
from spi_tpu_torch.utils.device import module_device
from spi_tpu_torch.utils.stats import span


def _normalize(x):
    return x / x.norm(dim=-1, keepdim=True)


@dataclasses.dataclass
class CLIPLossState:
    """Text-side quantities, unit-normalized, on the model's device."""

    target_direction: torch.Tensor  # (1, D) mean template direction src -> tgt
    src_text_features: torch.Tensor  # (1, D) mean src template embedding
    target_text_features: torch.Tensor  # (1, D) mean tgt template embedding
    target_tokens: torch.Tensor  # (1, L) tokens of "a {target}"
    patch_text_directions: torch.Tensor  # (P, D) per part-template directions


def patch_size(img_size: int) -> int:
    """The side of the patch term's crops (clip_loss.py:259-286)."""
    return min(510, img_size - 2)


def draw_patch_centers(n: int, img_size: int, generator=None, device=None):
    """One patch centre (cx, cy) per image, each (n,) in [half, size - half)."""
    half = patch_size(img_size) // 2
    return tuple(torch.randint(half, img_size - half, (n,), generator=generator, device=device)
                 for _ in range(2))


@dataclasses.dataclass(frozen=True)
class DirectionalCLIPLoss:
    """One CLIP model's edit losses (clip_loss.py:294-312).

    `model` serves the directional, global, manifold and patch terms;
    `cnn_model` (RN50 in the reference) only the texture term, and may
    be None. Both are frozen: their weights get no gradient.
    """

    model: CLIP
    lambda_direction: float = 1.0
    lambda_patch: float = 0.0
    lambda_global: float = 0.0
    lambda_manifold: float = 0.0
    lambda_texture: float = 0.0
    cnn_model: CLIP | None = None

    def __post_init__(self):
        for m in (self.model, self.cnn_model):
            if m is not None:
                m.eval().requires_grad_(False)

    # -- encoders ----------------------------------------------------------
    def encode_image(self, img, norm: bool = True):
        """img: GAN output (N, 3, H, W) in [-1, 1] -> (N, D) embedding."""
        feat = self.model.encode_image(preprocess_gan_output(img, self.model.image_resolution))
        return _normalize(feat) if norm else feat

    def encode_text(self, tokens, norm: bool = True):
        feat = self.model.encode_text(torch.as_tensor(tokens, device=module_device(self.model)))
        return _normalize(feat) if norm else feat

    # -- the text side, once ----------------------------------------------
    @torch.no_grad()
    def build_state(self, tokenizer, source_class: str, target_class: str) -> CLIPLossState:
        """Text directions for a (source, target) pair: compute_text_direction
        (clip_loss.py:117-124), set_text_features (:150-155) and the patch
        direction table (:261-267), each part sentence expanded through
        every ImageNet template. One text encode per template set."""
        ctx = self.model.context_length

        def feats(texts):
            return self.encode_text(tokenizer.tokenize(texts, context_length=ctx))

        def direction(src_text, tgt_text):
            src = feats(compose_text_with_templates(src_text, imagenet_templates))
            tgt = feats(compose_text_with_templates(tgt_text, imagenet_templates))
            return _normalize((tgt - src).mean(dim=0, keepdim=True)), src, tgt

        target_direction, src, tgt = direction(source_class, target_class)
        src_parts = compose_text_with_templates(source_class, part_templates)
        tgt_parts = compose_text_with_templates(target_class, part_templates)
        part_dirs = torch.cat([direction(sp, tp)[0] for sp, tp in zip(src_parts, tgt_parts)])
        return CLIPLossState(
            target_direction=target_direction,
            src_text_features=_normalize(src.mean(dim=0, keepdim=True)),
            target_text_features=_normalize(tgt.mean(dim=0, keepdim=True)),
            target_tokens=torch.as_tensor(
                tokenizer.tokenize([f"a {target_class}"], context_length=ctx),
                device=module_device(self.model)),
            patch_text_directions=part_dirs,
        )

    def img2img_direction(self, source_images, target_images):
        """compute_img2img_direction (clip_loss.py:126-148): the mean target
        embedding minus the mean source embedding, unit-normalized."""
        src = self.encode_image(source_images).mean(dim=0, keepdim=True)
        tgt = self.encode_image(target_images).mean(dim=0, keepdim=True)
        return _normalize(tgt - src)

    # -- the image side, each step ----------------------------------------
    def directional_loss(self, src_img, target_img, target_direction):
        """1 - cos(image edit direction, text direction) (clip_loss.py:178-193)."""
        edit = self.encode_image(target_img) - self.encode_image(src_img)
        # Identical images: the nudge keeps the norm finite (the reference
        # re-encodes target + 1e-6, clip_loss.py:187-189).
        edit = _normalize(edit + 1e-8)
        return (1.0 - (edit * target_direction).sum(dim=-1)).mean()

    def global_loss(self, img, tokens):
        """(1 - logits / 100).mean() (clip_loss.py:195-204)."""
        logits, _ = self.model(preprocess_gan_output(img, self.model.image_resolution), tokens)
        return (1.0 - logits / 100.0).mean()

    def manifold_loss(self, src_img, target_img, state: CLIPLossState):
        """clip_angle_loss (clip_loss.py:157-173): L1 between each image
        pair's cosine (a render against its own frozen render) and the
        text pair's."""
        cos_text = (state.target_text_features @ state.src_text_features.T).squeeze()
        src = self.encode_image(src_img)
        tgt = self.encode_image(target_img)
        cos_img = (tgt * src).sum(dim=-1).clamp(-1.0, 1.0)
        return (cos_img - cos_text).abs().mean()

    @staticmethod
    def random_patches(img, centers, size: int):
        """(N, 3, H, W) -> (N, 3, size, size) crops about `centers` (cx, cy)
        (clip_loss.py:206-234, one patch an image)."""
        half = size // 2
        with span("spi.sync"):
            xs, ys = (c.tolist() for c in centers)
        return torch.stack([img[i, :, y - half:y - half + size, x - half:x - half + size]
                            for i, (x, y) in enumerate(zip(xs, ys))])

    def patch_directional_loss(self, src_img, target_img, state: CLIPLossState, centers):
        """patch_directional_loss (clip_loss.py:259-286): cosine distance of
        each patch's edit direction to the part-template text directions,
        weighted by a softmax over them."""
        size = patch_size(src_img.shape[-1])
        src = self.encode_image(self.random_patches(src_img, centers, size))
        tgt = self.encode_image(self.random_patches(target_img, centers, size))
        edit = _normalize(tgt - src + 1e-8)
        sims = edit @ state.patch_text_directions.T
        return ((1.0 - sims) * torch.softmax(sims, dim=-1)).mean()

    def texture_loss(self, texture_img, target_img):
        """cnn_feature_loss (clip_loss.py:288-292): MSE of the RN50 embeddings."""
        if self.cnn_model is None:
            raise ValueError("the texture loss needs cnn_model (RN50)")
        res = self.cnn_model.image_resolution
        fx = self.cnn_model.encode_image(preprocess_gan_output(texture_img, res))
        fy = self.cnn_model.encode_image(preprocess_gan_output(target_img, res))
        return (fx - fy).square().mean()

    def __call__(self, src_img, target_img, state: CLIPLossState, patch_centers=None,
                 texture_img=None):
        """The weighted sum of CLIPLoss.forward (clip_loss.py:294-312).
        patch_centers: the patch term's (cx, cy) (`draw_patch_centers`)."""
        with span("spi.clip"):
            loss = 0.0
            if self.lambda_global:
                loss += self.lambda_global * self.global_loss(target_img, state.target_tokens)
            if self.lambda_patch:
                if patch_centers is None:
                    raise ValueError("the patch term needs its patch_centers")
                loss += self.lambda_patch * self.patch_directional_loss(
                    src_img, target_img, state, patch_centers)
            if self.lambda_direction:
                loss += self.lambda_direction * self.directional_loss(
                    src_img, target_img, state.target_direction)
            if self.lambda_manifold:
                loss += self.lambda_manifold * self.manifold_loss(src_img, target_img, state)
            if self.lambda_texture and texture_img is not None:
                loss += self.lambda_texture * self.texture_loss(texture_img, target_img)
            return loss
