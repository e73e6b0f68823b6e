"""The StyleGAN3-T editing cell (`edit_sg3t_b2`) run whole at the
configuration's test sizes on the CPU; its counts of work held to the
published layers written out by hand and to the calls the port makes; its
readers on made-up slices, with the alias-free nonlinearity as separate
kernels and fused; and `correct` coming out false under the control and
with half of the batch left out of the loss."""

import argparse

import pytest
import torch

from benchmark import counts, harness, run
from benchmark.counts import stylegan3 as work
from benchmark.harness import Ctx, check, load_module
from benchmark.harness.trace import Slice
from benchmark.tests.test_bench_cells import E2E, REQUIRED, tiny_run

CELL = "edit_sg3t_b2"
CONFIG = harness.load_json("configs", "stylegan3_t_ffhq1024_clip_edit")
G = CONFIG["generator"]
NEW = {"fir_ms_per_step", "roofline.filtered_lrelu", "filtered_lrelu_host_ms_per_step"}

# StyleGAN3-T FFHQ-1024's layers (networks_stylegan3.py's schedule at the
# published arguments): (input size, output size, input width, output width,
# up, down); ToRGB last, with its 1x1 kernel.
LAYERS = [(36, 36, 512, 512, 2, 2), (36, 36, 512, 512, 2, 2), (36, 52, 512, 512, 4, 2),
          (52, 52, 512, 512, 2, 2), (52, 84, 512, 512, 4, 2), (84, 148, 512, 512, 4, 2),
          (148, 148, 512, 512, 2, 2), (148, 276, 512, 323, 4, 2), (276, 276, 323, 203, 2, 2),
          (276, 532, 203, 128, 4, 2), (532, 1044, 128, 81, 4, 2), (1044, 1044, 81, 51, 2, 2),
          (1044, 1044, 51, 32, 2, 2), (1044, 1024, 32, 32, 2, 2), (1024, 1024, 32, 3, 1, 1)]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(monkeypatch, trace):
    out = tiny_run(monkeypatch, CELL, trace, trace_steps=2)
    assert out["correct"], out["compared"]
    assert REQUIRED <= set(out) and list(out)[-1] == "compared"
    if trace:
        # On the CPU no kernel is named upfirdn2d: the span reader alone reads.
        assert "filtered_lrelu_host_ms_per_step" in out["metrics"]
        assert {"launches_per_step", "idle_share", "step_mfu"} <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == E2E


def test_schedule_is_the_published_one():
    from benchmark.reference import stylegan3 as sg3

    layers, inp = sg3.schedule(G)
    assert inp == (512, 36, 16.0, 2.0)
    assert [(L["in_size"], L["out_size"], L["cin"], L["cout"], L["up"], L["down"])
            for L in layers] == LAYERS
    assert [L["name"] for L in layers][10] == "L10_1044_81"


def test_counts_of_one_layer():
    """L10, the largest: 128 -> 81 channels, 532^2 in; its 3x3 convolution
    (padding 2) gives 534^2, up 4 through 24 taps gives 534 * 4 - 15 - 23 =
    2098^2, down 2 through 12 taps gives 1044^2."""
    c = work.layer_calls(G, 1, False)[10]
    assert c == work.FilteredLReLU(1, 81, 534, 2098, 1044, 4, 24, 12, False)
    up = 2 * 81 * (534 * 2098 + 2098 * 2098) * 6
    down = 2 * 81 * (2098 * 1044 + 1044 * 1044) * 12
    assert work.fir_flops(c) == up + down
    assert work.flops(c) == up + down + 81 * 534 ** 2 + 3 * 81 * 2098 ** 2
    assert work.fwd_bytes(c) == 4 * (81 * 534 ** 2 + 81 + 81 * 1044 ** 2)
    assert work.bwd_bytes(c) == 4 * (81 * 1044 ** 2 + 2 * 81 * 534 ** 2 + 81)
    # Bound by the operations: 16.5 GFLOP at 67 TFLOP/s against 136 MB.
    assert work.filtered_lrelu_fwd_s(c) == pytest.approx(work.flops(c) / 67e12)
    torgb = work.layer_calls(G, 2, True)[14]
    assert (torgb.size, torgb.up_size, torgb.out_size, work.fir_flops(torgb)) == (1024, 1024,
                                                                                 1024, 0)


def test_flops_against_the_table():
    flops = load_module("flops", "stylegan3_t_ffhq1024_clip_edit")
    syn = flops.synthesis(G)
    conv = sum(2 * ci * co * 9 * (i + 2) ** 2 + 2 * 512 * ci for i, _, ci, co, _, _ in LAYERS[:-1])
    assert syn["conv"] == conv
    assert syn["torgb"] == 2 * 32 * 3 * 1024 ** 2 and syn["torgb_affine"] == 2 * 512 * 32
    assert syn["input"] == 2 * 512 * 4 + 2 * 36 * 36 * 2 * 512 + 2 * 36 * 36 * 512 * 512
    assert syn["fir"] == sum(work.fir_flops(c) for c in work.layer_calls(G, 1, False))
    # ViT-B/32: 50 tokens, ViT-B/16: 197, width 768, 12 layers (test_bench_counts).
    vit = sum(2 * 3 * p * p * 768 * (t - 1) + 12 * (2 * t * 768 * 768 * 12 + 4 * t * t * 768)
              + 2 * 768 * 512 for t, p in ((50, 32), (197, 16)))
    mapping = 2 * 512 * 512 * 2
    frozen = sum(syn.values())
    trainable = 3 * syn["conv"] + 2 * (syn["torgb"] + syn["fir"]) + syn["input"] \
        + syn["torgb_affine"]
    step = flops.image_step(CONFIG, {})
    assert step == mapping + frozen + trainable + 3 * vit
    # A forward image at 1024^2 is about 0.62 TFLOP, 0.57 of it the convolutions.
    assert 2.4e12 < step < 2.7e12 and 0.6e12 < frozen < 0.63e12


def test_calls_match_the_ports(monkeypatch):
    """At the test sizes, one step's bias_act calls (by size) and
    filtered_lrelu calls (input, upsampled and output size) are the ones
    the cell counts."""
    ba = pytest.importorskip("spi_tpu_torch.ops.bias_act")
    fl = pytest.importorskip("spi_tpu_torch.ops.filtered_lrelu")
    from benchmark.harness.window import Stop

    wl = harness.load_json("workloads", CELL)
    ctx = Ctx(CELL, {**wl, "warmup_steps": 3}, CONFIG, 5, torch.device("cpu"), tiny=True)
    cell = load_module("entries", wl["entry"]).build(ctx)
    seen, ups, plain, fir = [], [], ba.bias_act_plain, fl.upfirdn2d

    def record(x, b=None, **kw):
        seen.append(x.numel())
        return plain(x, b, **kw)

    def record_fir(x, f, **kw):
        y = fir(x, f, **kw)
        ups.append((x.shape[-1], y.shape[-1]))
        return y

    monkeypatch.setattr(ba, "bias_act_plain", record)
    monkeypatch.setattr(fl, "upfirdn2d", record_fir)
    steps = []

    def on_step(it):
        steps.append((sorted(seen), list(ups)))
        seen.clear()
        ups.clear()
        if it == 1:
            raise Stop

    try:
        cell.run(on_step)
    except Stop:
        pass
    sizes, firs = steps[1]
    assert sizes == sorted(c.elements for c in cell.bias_act_calls(1))
    calls = cell.filtered_lrelu_calls(1)
    assert len(calls) == 30 and sum(c.backward for c in calls) == 15
    # Each call's up FIR (input -> upsampled) then its down FIR (-> output).
    assert firs == [p for c in calls for p in ((c.size, c.up_size), (c.up_size, c.out_size))]


class _Cell:
    """The counts a reader asks of a cell: one tiny layer's call a step,
    and `affine`, one bias_act call of the affines, if given."""

    def __init__(self, affine=None):
        self.call = work.FilteredLReLU(1, 2, 10, 20, 10, 2, 12, 12, True)
        self.affine = affine

    def filtered_lrelu_calls(self, it):
        return [self.call]

    def fc_bias_act_calls(self, it):
        return [self.affine] if self.affine else []


class _EG3DCell:
    """A cell without the nonlinearity: two bias_act calls a step."""

    calls = [counts.BiasAct(4096, 64, "float32", True), counts.BiasAct(512, 512, "float32", False)]

    def bias_act_calls(self, it):
        return self.calls


CONV_KERNEL = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw"


def _slice():
    """The nonlinearity as the port runs it today: two FIR kernels and
    bias_act, beside a product and a convolution."""
    ops = [("upfirdn2d_depthwise_sep_kernel", 0.0, 30.0, "kernel"),
           ("bias_act_fwd_kernel", 40.0, 10.0, "kernel"), ("ampere_sgemm", 60.0, 100.0, "kernel"),
           (CONV_KERNEL, 165.0, 20.0, "kernel"),
           ("upfirdn2d_depthwise_sep_kernel", 200.0, 30.0, "kernel")]
    host = [("spi.step", 0.0, 150.0), ("spi.filtered_lrelu", 10.0, 20.0),
            ("spi.step", 160.0, 100.0), ("spi.filtered_lrelu", 170.0, 40.0),
            ("spi.filtered_lrelu", 300.0, 5.0)]  # the last outside any step
    return Slice(ops, host, 3e-4, [0, 1])


def _fused_slice(cell, stretch=1.0):
    """The nonlinearity as one kernel each way, each step's launches taking
    `stretch` times the counted least time, and one bias_act launch a step
    for the affines, at its least time; a product and a convolution."""
    c = cell.call
    fwd, bwd = (1e6 * stretch * t for t in (work.filtered_lrelu_fwd_s(c),
                                             work.filtered_lrelu_bwd_s(c)))
    affine = 1e6 * (counts.bias_act_fwd_s(cell.affine) + counts.bias_act_bwd_s(cell.affine))
    ops = []
    for t0 in (0.0, 200.0):
        ops += [("filtered_lrelu_fwd_kernel", t0, fwd, "kernel"),
                ("filtered_lrelu_bwd_kernel", t0 + 20.0, bwd, "kernel"),
                ("bias_act_fwd_kernel", t0 + 40.0, affine, "kernel"),
                ("ampere_sgemm", t0 + 60.0, 100.0, "kernel"), (CONV_KERNEL, t0 + 165.0, 20.0,
                                                               "kernel")]
    host = [("spi.step", 0.0, 190.0), ("spi.filtered_lrelu", 0.0, 15.0),
            ("spi.step", 200.0, 190.0), ("spi.filtered_lrelu", 200.0, 15.0)]
    return Slice(ops, host, 4e-4, [0, 1]), 2 * (fwd + bwd), 2 * affine


def _m(cell, sl):
    return argparse.Namespace(cell=cell, slice=sl, e2e={}, config={})


def _reader(name):
    return load_module("metrics", name).read


def test_readers_on_a_slice():
    m = _m(_Cell(), _slice())
    read = {name: _reader(name) for name in NEW}
    assert read["fir_ms_per_step"](m) == pytest.approx(0.03)
    assert read["filtered_lrelu_host_ms_per_step"](m) == pytest.approx(0.03)
    least = 2 * (work.filtered_lrelu_fwd_s(m.cell.call) + work.filtered_lrelu_bwd_s(m.cell.call))
    assert read["roofline.filtered_lrelu"](m) == pytest.approx(100 * least / 70e-6)
    # A cell without the nonlinearity, and a slice without the spans, read nothing.
    eg3d = _m(object(), _slice())
    assert read["fir_ms_per_step"](eg3d) is None
    assert read["roofline.filtered_lrelu"](eg3d) is None
    bare = Slice(_slice().device_ops, [("spi.step", 0.0, 150.0)], 3e-4, [0, 1])
    assert read["filtered_lrelu_host_ms_per_step"](_m(_Cell(), bare)) is None


def test_conv_leaves_the_nonlinearitys_firs_out():
    """In the SG3 cell the FIR kernels are `fir_ms_per_step`'s, and
    `conv_ms_per_step` reads the convolution alone, on either slice; in a
    cell without the nonlinearity they are resampling convolutions."""
    conv = _reader("conv_ms_per_step")
    cell = _Cell(counts.BiasAct(512, 512, "float32", True))
    fused, _, _ = _fused_slice(cell)
    assert conv(_m(cell, _slice())) == pytest.approx(0.01)
    assert conv(_m(cell, fused)) == pytest.approx(0.02)
    assert conv(_m(object(), _slice())) == pytest.approx(0.04)


def test_readers_on_a_fused_slice():
    """One `filtered_lrelu` kernel each way: the FIR reader reads the fused
    kernels, `roofline.filtered_lrelu` the same least time over the fused
    and bias_act kernels' time, and no roofline reads over 100% where the
    fused kernels take at least their least time."""
    cell = _Cell(counts.BiasAct(512, 512, "float32", True))
    least = 2 * (work.filtered_lrelu_fwd_s(cell.call) + work.filtered_lrelu_bwd_s(cell.call)
                 + counts.bias_act_fwd_s(cell.affine) + counts.bias_act_bwd_s(cell.affine))
    for stretch in (1.0, 3.0):
        sl, fused_us, affine_us = _fused_slice(cell, stretch)
        m = _m(cell, sl)
        assert _reader("fir_ms_per_step")(m) == pytest.approx(fused_us / 2e3)
        share = _reader("roofline.filtered_lrelu")(m)
        assert share == pytest.approx(100 * least / (1e-6 * (fused_us + affine_us)))
        if stretch == 1.0:
            assert share == pytest.approx(100.0, rel=1e-9)
        for path in sorted((harness.ROOT / "metrics").glob("roofline.*.py")):
            value = _reader(path.stem)(m)
            assert value is None or value <= 100.0 * (1 + 1e-9), (path.stem, value)


@pytest.mark.parametrize("fused", [False, True])
def test_bias_act_roofline_is_the_eg3d_cells(fused):
    """`roofline.bias_act` reads nothing in a cell that counts
    `filtered_lrelu_calls`, and its arithmetic elsewhere is unchanged."""
    read = _reader("roofline.bias_act")
    cell = _Cell(counts.BiasAct(512, 512, "float32", True))
    sl = _fused_slice(cell)[0] if fused else _slice()
    assert read(_m(cell, sl)) is None
    eg3d = _EG3DCell()
    seconds, n = sl.kernel_s(lambda k: "bias_act" in k)
    least = 2 * sum(counts.bias_act_fwd_s(c) + (counts.bias_act_bwd_s(c) if c.backward else 0.0)
                    for c in eg3d.calls)
    assert n and read(_m(eg3d, sl)) == pytest.approx(100 * least / seconds)


def test_fault_half_batch(monkeypatch):
    from benchmark.calibrate import half_batch

    with half_batch():
        out = tiny_run(monkeypatch, CELL)
    assert not out["correct"]
    assert any(v["value"] > v["limit"] for v in out["compared"].values())


def test_control_fails():
    """The reference with bfloat16 products in the program's place reads
    above a limit."""
    wl = harness.load_json("workloads", CELL)
    ctx = Ctx(CELL, wl, CONFIG, 17, torch.device("cpu"), tiny=True)
    entry = load_module("entries", wl["entry"]).build(ctx)
    entry.release()
    ref = entry.reference()
    control = entry.reference(getattr(torch, CONFIG["control_dtype"]))
    ok, lines = check.judge(check.numbers(control, ref), wl["limits"])
    assert not ok, lines


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
