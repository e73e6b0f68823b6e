"""The port's spans (`spi_tpu_torch.utils.stats.span`) in torch.profiler's
Chrome trace, on the CPU at tiny sizes: each loop run under the profiler
and its exported trace read back as the benchmark's readers read it.

- `tune_batch` (B = 2, rot, mirror-rot, depth and TV, `rot_bs` 2, 4
  steps), `tune_generator` (2 steps), `project_batch` (2 steps), one
  `ZSSGANTrainer.step` and one `ZSSGANSG3Trainer.step`: one `spi.step` a
  step; every other `spi.*` span inside a step, but for the networks'
  spans of the loop's set-up, before its first step; the `spi.term.*`
  spans only in regularizer steps; the `spi.sync` spans a step as the
  loops' blocking reads give them (none in an editing step after the
  first); each operator that starts inside a span
  ends inside it, on the same thread and clock.
- With no profiler running, `span` calls no profiler operator, and a
  loop's spans make no `record_function`.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spi_tpu_torch.cli.run_editing import CRCTokenizer
from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.editing.clip_loss import DirectionalCLIPLoss
from spi_tpu_torch.editing.zssgan import EditingSettings, ZSSGANTrainer
from spi_tpu_torch.editing.zssgan2d import ZSSGANSG3Trainer
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.models.perception.clip import CLIP, tiny_test_clip
from spi_tpu_torch.models.perception.vgg import VGGFeatures
from spi_tpu_torch.models.stylegan2 import seeded_init
from spi_tpu_torch.models.stylegan3 import SG3Generator, tiny_stylegan3
from spi_tpu_torch.training import coaches as C
from spi_tpu_torch.training import projectors as P
from spi_tpu_torch.utils import camera as cam
from spi_tpu_torch.utils import stats
from torch_threads import few_torch_threads  # noqa: F401

# The networks' spans, which the loops' set-up also opens (target features,
# the depth anchor's planes, the w statistics' mapping).
NETWORKS = {"spi.mapping", "spi.synthesis", "spi.render", "spi.superres", "spi.lpips",
            "spi.box_cx", "spi.clip"}
TERMS = {"spi.term.rot", "spi.term.mirror", "spi.term.depth", "spi.term.tv"}


@pytest.fixture(scope="module")
def model():
    """The tiny generator with nonzero noise strengths, a small LPIPS and a
    BoxCX loss on a small stand-in VGG."""
    g = TriPlaneGenerator(tiny_test_config(), device="cpu")
    with torch.no_grad():
        for k, v in g.named_parameters():
            if k.endswith("noise_strength"):
                v.fill_(0.1)
    box = BoxCXLoss(device="cpu")
    box.vgg = VGGFeatures(cfg=(8, "M", 8, "M", 16), target_layers=(6,), device="cpu")
    seeded_init(box.vgg, 2)
    lpips = LPIPS(device="cpu", cfg=(8, "M", 16, "M", 16), target_layers=(1, 4, 7))
    return g, lpips, box


def _inputs(g, b):
    """RotBbox inputs of b images: the first camera yawed (its mirror term
    on), the second frontal (off)."""
    rs = np.random.RandomState(3)
    target = torch.from_numpy(np.tanh(rs.randn(b, 1, 3, 128, 128)).astype(np.float32))
    camera = torch.stack([cam.canonical_camera(yaw=y) for y in (0.4, 0.0)[:b]])
    w = torch.from_numpy(rs.randn(b, 1, g.num_ws, g.w_dim).astype(np.float32) * 0.3)
    lm = torch.from_numpy(rs.uniform(70, 190, (b, 1, 68, 2)).astype(np.float32))
    noise = {k: torch.from_numpy(rs.randn(b, *v.shape).astype(np.float32))
             for k, v in sorted(g.named_buffers()) if k.endswith("noise_const")}
    return C.CoachInputs(target, camera, w, torch.ones(b, 1, 1, 128, 128), lm), noise


def _rngs(b):
    return [torch.Generator().manual_seed(40 + i) for i in range(b)]


ROTBBOX = C.CoachSettings(num_steps=4, lpips_threshold=-1.0, tv_lambda=0.1, rot_bs=2)


class Trace:
    """The exported trace of `fn()`: the `spi.*` spans and the operators
    (name, start us, end us) of the thread that opened the spans."""

    def __init__(self, fn, tmp_path):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        path = tmp_path / "trace.json"
        prof.export_chrome_trace(str(path))
        events = [e for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
        marks = [e for e in events
                 if e.get("cat") == "user_annotation" and e["name"].startswith("spi.")]
        assert len({e["tid"] for e in marks}) == 1
        tid = marks[0]["tid"]

        def interval(e):
            return e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])

        self.spans = sorted((interval(e) for e in marks), key=lambda s: s[1])
        self.ops = [interval(e) for e in events
                    if e.get("cat") == "cpu_op" and e["tid"] == tid]
        self.steps = [s for s in self.spans if s[0] == "spi.step"]

    def inside(self, outer, name=None):
        """The spans (of `name`) that lie within span `outer`."""
        return [s for s in self.spans if s is not outer and outer[1] <= s[1] and s[2] <= outer[2]
                and (name is None or s[0] == name)]

    def check_nesting(self):
        """Every span but a step lies within a step, or is a network's span
        of the set-up; every operator that starts inside a span ends inside
        it; every step issues operators."""
        first = self.steps[0][1]
        for s in self.spans:
            if s[0] == "spi.step":
                continue
            within = any(t[1] <= s[1] and s[2] <= t[2] for t in self.steps)
            assert within or (s[0] in NETWORKS and s[2] <= first), s
        for s in self.spans:
            for op in self.ops:
                if s[1] <= op[1] < s[2]:
                    assert op[2] <= s[2], (s, op)
        for step in self.steps:
            assert any(step[1] <= op[1] and op[2] <= step[2] for op in self.ops)

    def syncs(self):
        return [len(self.inside(step, "spi.sync")) for step in self.steps]

    def terms(self):
        return [{s[0] for s in self.inside(step) if s[0].startswith("spi.term.")}
                for step in self.steps]


def test_tune_batch_spans(model, tmp_path):
    g, lpips, box = model
    inputs, noise = _inputs(g, 2)
    t = Trace(lambda: C.tune_batch(g, lpips, inputs, ROTBBOX, noise=noise, rngs=_rngs(2),
                                   device="cpu", box_cx=box), tmp_path)
    assert len(t.steps) == 4
    t.check_nesting()
    # Every step: the LPIPS read back, the applied mask. Regularizer steps 0
    # and 2 besides: the mirror lanes' mask, the rot term's and the mirror
    # term's inverse of the cameras (`torch.linalg.inv` reads its error
    # code), the mirror term's yaw signs, the depth term's look-at point,
    # up vector and intrinsics (`torch.tensor` of constants on the device).
    assert t.terms() == [TERMS, set(), TERMS, set()]
    assert t.syncs() == [9, 2, 9, 2]
    for step in t.steps:
        names = [s[0] for s in t.inside(step)]
        assert names.count("spi.draws") == names.count("spi.recon") == 1
        assert names.count("spi.optimizer") == 1 and names.count("spi.backward") == 2
        assert {"spi.synthesis", "spi.render", "spi.superres", "spi.lpips"} <= set(names)
    mirror = [s for s in t.spans if s[0] == "spi.term.mirror"]
    assert all(len(t.inside(s, "spi.sync")) == 3 for s in mirror)
    assert all(len(t.inside(s, "spi.box_cx")) == 1 for s in mirror)


def test_tune_generator_spans(model, tmp_path):
    g, lpips, box = model
    inputs, noise = _inputs(g, 1)
    one = C.CoachInputs(*(None if x is None else x[0] for x in (
        inputs.target, inputs.camera, inputs.w_pivot, inputs.face_mask, inputs.landmarks)))
    before = {k: v.detach().clone() for k, v in g.state_dict().items()}
    try:
        settings = C.CoachSettings(num_steps=2, lpips_threshold=-1.0, tv_lambda=0.1, rot_bs=2)
        t = Trace(lambda: C.tune_generator(g, lpips, one, settings,
                                           noise={k: v[0] for k, v in noise.items()},
                                           rng=_rngs(1)[0], device="cpu", box_cx=box), tmp_path)
    finally:
        g.load_state_dict(before)
    assert len(t.steps) == 2
    t.check_nesting()
    assert t.terms() == [TERMS, set()]
    assert t.syncs() == [7, 1]  # the LPIPS read back; the terms' six as in tune_batch


def test_project_batch_spans(model, tmp_path):
    g, lpips, _ = model
    inputs, _ = _inputs(g, 2)
    settings = P.ProjectorSettings(mode="sg", num_steps=2, w_avg_samples=8)
    t = Trace(lambda: P.project_batch(g, lpips, inputs.target, inputs.camera, settings,
                                      rngs=_rngs(2), device="cpu"), tmp_path)
    assert len(t.steps) == 2
    t.check_nesting()
    assert t.syncs() == [1, 1]  # the w noise scales
    for step in t.steps:
        names = {s[0] for s in t.inside(step)}
        assert {"spi.draws", "spi.backward", "spi.optimizer", "spi.synthesis",
                "spi.render", "spi.superres", "spi.lpips"} <= names


def test_zssgan_step_spans(tmp_path):
    g = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=5)
    cfg = tiny_test_clip()
    clip = CLIP(cfg, device="cpu")
    trainer = ZSSGANTrainer(g, {"tiny": DirectionalCLIPLoss(clip)}, {"tiny": 1.0},
                            EditingSettings(batch=2), device="cpu")
    trainer.build_states(CRCTokenizer(cfg.vocab_size))
    float(trainer.step())  # makes the canonical camera and CLIP's mean and std
    t = Trace(lambda: float(trainer.step()), tmp_path)
    assert len(t.steps) == 1
    t.check_nesting()
    # The camera and CLIP's constants are made once, the cumulative product's
    # backward reads nothing back: a step blocks on no transfer.
    assert t.syncs() == [0]
    names = [s[0] for s in t.inside(t.steps[0])]
    for name, n in (("spi.draws", 1), ("spi.mapping", 1), ("spi.synthesis", 2),
                    ("spi.render", 2), ("spi.superres", 2), ("spi.clip", 1),
                    ("spi.backward", 1), ("spi.optimizer", 1), ("spi.filtered_lrelu", 0)):
        assert names.count(name) == n, name
    # The caller's read of the loss lies after the step.
    ops_after = [op for op in t.ops if op[1] >= t.steps[0][2]]
    assert any(op[0] == "aten::_local_scalar_dense" for op in ops_after)


def test_zssgan_sg3_step_spans(tmp_path):
    """StyleGAN3's editing step: the mapping, one synthesis a twin and one
    `spi.filtered_lrelu` a layer inside it (15 a twin), no renderer."""
    g = SG3Generator(**tiny_stylegan3(), device="cpu", seed=5)
    cfg = tiny_test_clip()
    trainer = ZSSGANSG3Trainer(g, {"tiny": DirectionalCLIPLoss(CLIP(cfg, device="cpu"))},
                               {"tiny": 1.0}, EditingSettings(batch=2), device="cpu")
    trainer.build_states(CRCTokenizer(cfg.vocab_size))
    float(trainer.step())  # makes CLIP's mean and std
    t = Trace(lambda: float(trainer.step()), tmp_path)
    assert len(t.steps) == 1
    t.check_nesting()
    assert t.syncs() == [0]
    names = [s[0] for s in t.inside(t.steps[0])]
    for name, n in (("spi.draws", 1), ("spi.mapping", 1), ("spi.synthesis", 2),
                    ("spi.filtered_lrelu", 30), ("spi.render", 0), ("spi.clip", 1),
                    ("spi.backward", 1), ("spi.optimizer", 1)):
        assert names.count(name) == n, name
    for syn in t.inside(t.steps[0], "spi.synthesis"):
        assert len(t.inside(syn, "spi.filtered_lrelu")) == 15


def test_span_calls_no_profiler_op_when_off(model, monkeypatch):
    g, lpips, box = model
    enter = torch.ops.profiler._record_function_enter_new
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0])
        return enter(*args, **kwargs)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counted)
    with stats.span("spi.step"), stats.span("spi.sync"):
        pass
    assert calls == []
    with profile(activities=[ProfilerActivity.CPU]):
        with stats.span("spi.step"), stats.span("spi.sync"):
            pass
    assert calls == ["spi.step", "spi.sync"]

    # A loop's spans make no record_function with no profiler running.
    made = []

    class Counted(torch.profiler.record_function):
        def __init__(self, name, args=None):
            made.append(name)
            super().__init__(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    inputs, noise = _inputs(g, 2)
    settings = C.CoachSettings(num_steps=1, lpips_threshold=-1.0, rot_bs=2)
    C.tune_batch(g, lpips, inputs, settings, noise=noise, rngs=_rngs(2), device="cpu",
                 box_cx=box)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        C.tune_batch(g, lpips, inputs, settings, noise=noise, rngs=_rngs(2), device="cpu",
                     box_cx=box)
    assert made.count("spi.step") == 1 and "spi.term.mirror" in made
