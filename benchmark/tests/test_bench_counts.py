"""The yardstick's arithmetic: the roofline counts reproduce the port's
recorded whole-table bounds (PERF.md, kernel table), the bias_act calls
the cells count are the calls the port makes, and each configuration's
FLOPs a step agree with a sum over a hand-written table of its layers."""

import importlib

import pytest
import torch

from benchmark import counts, harness
from benchmark.counts import BiasAct, RenderPass
from benchmark.counts import eg3d as work
from benchmark.flops import _eg3d as f

INV = harness.load_json("configs", "eg3d_ffhq512_inversion")
EDIT = harness.load_json("configs", "eg3d_ffhq512_clip_edit")
G = INV["generator"]


def test_coarse_pass_bounds():
    """786,432 points, 3 planes of 256^2 x 32: 336.6 MB either way, the
    float32 lookup 0.1005 ms, bf16 planes 0.0967 ms."""
    p = RenderPass(128 * 128 * 48, 1, 256 * 256, 32, "float32", True)
    assert counts.lookup_bytes(p) == counts.splat_bytes(p) == 336_592_896
    assert counts.lookup_s(p) * 1e3 == pytest.approx(0.1005, abs=5e-5)
    assert counts.splat_s(p) * 1e3 == pytest.approx(0.1005, abs=5e-5)
    bf = RenderPass(128 * 128 * 48, 1, 256 * 256, 32, "bfloat16", True)
    assert counts.lookup_s(bf) * 1e3 == pytest.approx(0.0967, abs=5e-5)
    assert work.render_passes(G, 1, 1, "float32", True) == [p, p]


@pytest.mark.parametrize("dtype, fwd, bwd", [("float32", 0.0200, 0.0300),
                                              ("bfloat16", 0.0100, 0.0150)])
def test_bias_act_bounds(dtype, fwd, bwd):
    c = BiasAct(128 * 256 * 256, 128, dtype, True)
    assert counts.bias_act_fwd_s(c) * 1e3 == pytest.approx(fwd, abs=5e-5)
    assert counts.bias_act_bwd_s(c) * 1e3 == pytest.approx(bwd, abs=5e-5)


def _rotbbox_cell(g, b=1):
    from benchmark.entries import rotbbox_batch

    cell = rotbbox_batch.Cell.__new__(rotbbox_batch.Cell)
    cell.g, cell.images_per_step, cell.dtype = g, b, "bfloat16"
    cell.coach = harness.load_json("workloads", "inv_rotbbox_b4")["coach"]
    return cell


def _edit_cell(g, b=2):
    from benchmark.entries import zssgan_step

    cell = zssgan_step.Cell.__new__(zssgan_step.Cell)
    cell.g, cell.images_per_step = g, b
    return cell


def test_launches_as_the_port_counts_them():
    """Forward and backward bias_act launches a step at full width, as the
    port's launch counters read them on the card (PERF.md: RotBbox 96 / 92
    a regularizer step, 56 / 56 a reconstruction step; editing 121 / 43),
    and the lookup's and splat's passes (10 / 8 and 2 / 2; editing 4 / 2)."""
    rb, ed = _rotbbox_cell(G), _edit_cell(G)
    for it, fwd, bwd, look, splat in ((0, 96, 92, 10, 8), (1, 56, 56, 2, 2)):
        calls = rb.bias_act_calls(it)
        assert (len(calls), sum(c.backward for c in calls)) == (fwd, bwd)
        passes = rb.render_passes(it)
        assert (len(passes), sum(p.backward for p in passes)) == (look, splat)
    calls = ed.bias_act_calls(0)
    assert (len(calls), sum(c.backward for c in calls)) == (121, 43)
    passes = ed.render_passes(0)
    assert (len(passes), sum(p.backward for p in passes)) == (4, 2)


def test_bias_act_calls_match_the_ports_forward(monkeypatch):
    """At the test sizes on the CPU, the forward calls of a RotBbox
    reconstruction step (1) and regularizer step (4), by size, are the ones
    the counts list (step 0 also holds the coach's one-time synthesis of the
    depth anchor's planes)."""
    ba = importlib.import_module("spi_tpu_torch.ops.bias_act")

    from benchmark.entries import rotbbox_batch
    from benchmark.harness import Ctx
    from benchmark.harness.window import Stop

    wl = harness.load_json("workloads", "inv_rotbbox_b4")
    wl = {**wl, "images": 1, "warmup_steps": 2, "check_steps": 2}
    ctx = Ctx("inv_rotbbox_b4", wl, INV, 5, torch.device("cpu"), tiny=True)
    cell = rotbbox_batch.Cell(ctx)
    seen, plain = [], ba.bias_act_plain

    def record(x, b=None, **kw):
        seen.append(x.numel())
        return plain(x, b, **kw)

    monkeypatch.setattr(ba, "bias_act_plain", record)
    sizes = []

    def on_step(it):
        sizes.append(sorted(seen))
        seen.clear()
        if it == 4:
            raise Stop

    try:
        cell.run(on_step)
    except Stop:
        pass
    cell.dtype = "float32"
    for it in (1, 4):
        assert sizes[it] == sorted(c.elements for c in cell.bias_act_calls(it))


# ---------------------------------------------------------------- FLOPs
# The published layers, written out: (input width, output width, kernel,
# output resolution, input resolution) of every convolution.
BACKBONE = [(512, 512, 3, 4, 4), (512, 96, 1, 4, 4)] + [
    layer for cin, cout, res in ((512, 512, 8), (512, 512, 16), (512, 512, 32), (512, 512, 64),
                                 (512, 256, 128), (256, 128, 256))
    for layer in ((cin, cout, 3, res, res // 2), (cout, cout, 3, res, res), (cout, 96, 1, res, res))]
SR = [(32, 256, 3, 256, 128), (256, 256, 3, 256, 256), (256, 3, 1, 256, 256),
      (256, 128, 3, 512, 256), (128, 128, 3, 512, 512), (128, 3, 1, 512, 512)]
VGG16_256 = [(3, 64, 256), (64, 64, 256), (64, 128, 128), (128, 128, 128), (128, 256, 64),
             (256, 256, 64), (256, 256, 64), (256, 512, 32), (512, 512, 32), (512, 512, 32),
             (512, 512, 16), (512, 512, 16), (512, 512, 16)]
VGG19_80 = [(3, 64, 80), (64, 64, 80), (64, 128, 40)]


def table_sum(layers, w_dim=512):
    """Convolutions (MACs on the input grid for an upsampling one), their
    affines, and the 4x4 FIR filters after each upsampling convolution and
    on each upsampled skip image."""
    conv = torgb = fir = 0
    for cin, cout, k, res, src in layers:
        macs = cin * cout * k * k * src * src + w_dim * cin
        if k == 1:
            torgb += 2 * macs
        else:
            conv += 2 * macs
        if src < res:
            fir += 2 * 16 * cout * res * res
            fir += 2 * 16 * (96 if layers is BACKBONE else 3) * res * res
    return {"conv": conv, "torgb": torgb, "fir": fir}


def test_flops_parts_against_the_tables():
    assert f.synthesis(G) == table_sum(BACKBONE)
    assert f.superresolution(G) == table_sum(SR)
    assert f.lpips() == sum(2 * a * b * 9 * r * r for a, b, r in VGG16_256)
    assert f.box_cx()[0] == 3 * sum(2 * a * b * 9 * r * r for a, b, r in VGG19_80)
    assert f.decoder(G) == 2 * 128 * 128 * 96 * (32 * 64 + 64 * 33)
    # ViT-B/32: 50 tokens, ViT-B/16: 197, width 768, 12 layers.
    for name, tokens, p in (("ViT-B/32", 50, 32), ("ViT-B/16", 197, 16)):
        per_layer = 2 * tokens * 768 * 768 * 12 + 4 * tokens * tokens * 768
        want = 2 * 3 * p * p * 768 * (tokens - 1) + 12 * per_layer + 2 * 768 * 512
        assert f.vit_image(EDIT["clip"][name]) == want


def test_image_step_flops():
    from benchmark.harness import load_module

    syn, sr = table_sum(BACKBONE), table_sum(SR)
    tr = 3 * (syn["conv"] + syn["torgb"]) + 2 * syn["fir"]
    tsr = 3 * (sr["conv"] + sr["torgb"]) + 2 * sr["fir"]
    dec = 2 * 128 * 128 * 96 * (32 * 64 + 64 * 33)
    lp = sum(2 * a * b * 9 * r * r for a, b, r in VGG16_256)
    vgg = 3 * sum(2 * a * b * 9 * r * r for a, b, r in VGG19_80)
    cx = 3 * 2 * 1600 * 1600 * 128
    recon = tr + 3 * dec + tsr + 2 * lp
    reg = (3 * 4 * dec + 4 * tsr + 4 * 3 * lp) + (3 * 4 * dec + 4 * tsr + 4 * (3 * vgg + 2 * cx)) \
        + 4 * 4 * dec
    wl = harness.load_json("workloads", "inv_rotbbox_b4")
    got = load_module("flops", "eg3d_ffhq512_inversion").image_step(INV, wl)
    assert got == pytest.approx(recon + reg / 4, rel=1e-12)
    assert 1.5e12 < got < 4e12  # between a reconstruction step's and a regularizer step's
    edit = load_module("flops", "eg3d_ffhq512_clip_edit").image_step(EDIT, {})
    assert 0.8e12 < edit < 1.6e12
