"""FLOPs of one image-step of CLIP-guided editing (the `zssgan_step`
entry): each image renders through the frozen generator (forward) and the
trainable twin, whose synthesis convolutions and their affines train
(3x) while its ToRGB layers, decoder and superresolution pass the
gradient on (2x); each CLIP model encodes both renders, the trainable one
with an input gradient (3x). The FIR filters have no weight gradient."""

from __future__ import annotations

from benchmark.flops import _eg3d as f


def image_step(config, workload):
    g = config["generator"]
    syn, sr = f.synthesis(g), f.superresolution(g)
    dec = f.decoder(g, 1)
    frozen = f.mapping(g) + sum(syn.values()) + dec + sum(sr.values())
    trainable = 3 * syn["conv"] + 2 * (syn["torgb"] + syn["fir"]) + 2 * dec + 2 * sum(sr.values())
    clip = sum(3 * f.vit_image(config["clip"][name]) for name in config["clip_models"])
    return frozen + trainable + clip
