"""The EG3D generator's kernel work by part, from a configuration's
published widths: every bias + activation (each fully connected layer,
each synthesis layer's output, each ToRGB), and the triplane renderer's
sampling passes."""

from __future__ import annotations

import math

from benchmark.counts import BiasAct, RenderPass

SR_BLOCKS = {  # variant -> ((block width, resolution), (block width, resolution))
    "SuperresolutionHybrid8XDC": ((256, 256), (128, 512)),
    "SuperresolutionHybrid2X": ((128, 64), (64, 128)),
}


def _channels(g, res):
    return min(g["channel_base"] // res, g["channel_max"])


def _block(n, cin, cout, res, img_ch, dtype, grad, affines, rgb_affine, first=False):
    """A synthesis block: per layer its affine (n, cin) and its output (n,
    cout, res, res); ToRGB's affine and output. `grad`: whether the outputs'
    backward runs; `affines`, `rgb_affine`: whether the layers' and
    ToRGB's affines' does (their weights train)."""
    calls = []
    layers = [(cout, cout)] if first else [(cin, cout), (cout, cout)]
    for lin, lout in layers:
        calls += [BiasAct(n * lin, lin, dtype, affines),
                  BiasAct(n * lout * res * res, lout, dtype, grad)]
    calls += [BiasAct(n * cout, cout, dtype, rgb_affine),
              BiasAct(n * img_ch * res * res, img_ch, dtype, grad)]
    return calls


def synthesis(g, n, dtype, grad, affines=None, rgb_affine=None):
    """The backbone's synthesis network for n images; the affines'
    backward runs where their weights train (by default: with `grad`)."""
    affines = grad if affines is None else affines
    rgb_affine = grad if rgb_affine is None else rgb_affine
    calls = []
    for i in range(2, int(math.log2(g["backbone_resolution"])) + 1):
        res = 2 ** i
        cout = _channels(g, res)
        cin = _channels(g, res // 2) if res > 4 else 0
        calls += _block(n, cin, cout, res, 3 * g["plane_channels"], dtype, grad, affines,
                        rgb_affine, first=res == 4)
    return calls


def mapping(g, n, grad):
    """Embedding and mapping layers, float32."""
    return [BiasAct(n * g["w_dim"], g["w_dim"], "float32", grad)
            for _ in range(1 + g["mapping_layers"])]


def decoder(g, points, dtype, grad):
    """The two fully connected layers of the decoder over `points` samples."""
    pc = g["plane_channels"]
    return [BiasAct(points * 64, 64, dtype, grad), BiasAct(points * (1 + pc), 1 + pc, dtype, grad)]


def superresolution(g, n, dtype, grad, affines=None):
    affines = grad if affines is None else affines
    (c0, r0), (c1, r1) = SR_BLOCKS[g["sr_variant"]]
    return (_block(n, g["plane_channels"], c0, r0, 3, dtype, grad, affines, affines)
            + _block(n, c0, c1, r1, 3, dtype, grad, affines, affines))


def render(g, cams, dtype, grad, sr=True, sr_affines=None):
    """One render of `cams` cameras: the decoder over both passes and, with
    `sr`, the superresolution."""
    points = cams * g["neural_rendering_resolution"] ** 2
    calls = (decoder(g, points * g["depth_resolution"], dtype, grad)
             + decoder(g, points * g["depth_resolution_importance"], dtype, grad))
    return calls + (superresolution(g, cams, dtype, grad, sr_affines) if sr else [])


def render_passes(g, cams, tables, plane_dtype, grad):
    """The coarse and the fine sampling pass of a render of `cams` cameras
    from `tables` plane sets."""
    points = cams * g["neural_rendering_resolution"] ** 2
    return [RenderPass(points * s, tables, g["backbone_resolution"] ** 2, g["plane_channels"],
                       plane_dtype, grad)
            for s in (g["depth_resolution"], g["depth_resolution_importance"])]
