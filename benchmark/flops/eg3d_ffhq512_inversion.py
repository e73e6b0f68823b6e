"""FLOPs of one image-step of SPI's RotBbox stage 2 (the `rotbbox_batch`
entry) on EG3D FFHQ-512, averaged over the regularizer cadence: every
step renders the target camera and back-propagates through the tuned
generator; every `rot_bs`-th step adds the rotation, mirror and depth
terms. Trained weights count forward, input and weight gradient (3x);
frozen LPIPS and VGG19 count forward and input gradient (2x) where a
gradient passes, forward alone where it does not; the FIR filters have no
weight gradient (2x); recomputed work is not counted."""

from __future__ import annotations

from benchmark.flops import _eg3d as f


def _trained(part):
    return 3 * (part["conv"] + part["torgb"]) + 2 * part["fir"]


def image_step(config, workload):
    g = config["generator"]
    c = workload["coach"]
    k = c["rot_bs"]
    synthesis, sr = _trained(f.synthesis(g)), _trained(f.superresolution(g))
    lp = f.lpips()
    recon = synthesis + 3 * f.decoder(g, 1) + sr + 2 * lp
    render_k = 3 * f.decoder(g, k) + k * sr
    extra = 0
    if c["rot_lambda"] > 0:
        extra += render_k + k * (2 * lp + lp)  # the renders' LPIPS; the warped targets'
    if c["mirror_rot_lambda"] > 0:
        vgg, cx = f.box_cx()
        extra += render_k + k * (2 * vgg + vgg + 2 * cx)  # renders' crops; warped crops
    if c["depth_lambda"] > 0:
        extra += 3 * f.decoder(g, k) + f.decoder(g, k)  # tuned depth renders; the frozen copy's
    return recon + extra / k
