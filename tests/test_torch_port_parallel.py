"""Several images in one batched step (spi_tpu_torch.parallel) against the
port's own serial path, on the CPU, at tiny_test_config (no JAX here; the
comparison with spi_tpu's `spmd_invert` is in
tests/test_torch_port_parallel_jax.py).

- `project_batch` (each mode) and `tune_batch` (PTI, and RotBbox with all
  four regularizers and BoxCX on) against `project` and `tune_generator`
  per image, B = 2 and B = 3, every image drawing from its own seeded
  generator on both sides;
- the lane gating: one LPIPS threshold that the images cross at different
  steps; a stopped lane's weights and Adam moments stay bitwise as they
  were;
- the torch.func.vmap rules of `sample_planes` and `bias_act` against a
  loop over the images (and `_BiasActCuda`'s rule, on an emulation of the
  kernels, for its folding and its per-image db);
- `InversionPipeline.run`'s remainder batch, and bfloat16, where each
  image's own weights are cast inside the batched call.

Tolerances (float32; measured on these inputs in brackets). Batched and
serial compute the same function in other summation orders (grouped
convolutions, folded gathers), so values agree to float32 rounding: the
stage-1 distances within 1e-5 relative [1.4e-7], w within 5e-5 absolute
[1.1e-5] and the noise maps within 1e-4 [0: the same operations].
The tuned weights are held as tests/test_torch_port_stage2.py holds
them to spi_tpu's: Adam's first steps move each weight by about lr times
the sign of its gradient, so a weight whose gradient is at rounding level
may move another way; the weight changes agree within 2 lr everywhere and
within 0.05 lr on all but 0.1% of the weights [0.53 lr; 0.004%]. The
LPIPS values within 1e-5 relative [2e-7]; the steps run exactly. The vmap
rules: the gathers and elementwise chains exactly (one operation on the
same numbers), the splat's index_add and the bias sums within 1e-6
relative.
"""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.data.dataset import PTIDataset
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.models.perception.vgg import VGGFeatures
from spi_tpu_torch.models.stylegan2 import seeded_init
from spi_tpu_torch.ops import plane_splat as PS
from spi_tpu_torch.parallel import index_tree, spmd_invert, stack_trees
from spi_tpu_torch.training import coaches as C
from spi_tpu_torch.training import projectors as P
from spi_tpu_torch.training.pipeline import InversionPipeline, PipelineConfig
from spi_tpu_torch.utils import camera as cam
from spi_tpu_torch.utils.params import functional_apply, trainable_parameters, vmap_strict
from torch_threads import few_torch_threads  # noqa: F401

BA = importlib.import_module("spi_tpu_torch.ops.bias_act")  # the package exports the function
SMALL_VGG = dict(cfg=(8, "M", 16, "M", 16), target_layers=(1, 4, 7))
YAWS = (0.4, 0.0, -0.3)  # the mirror term on, off (frontal), on
LR = C.CoachSettings().learning_rate


def _gen(dtype="float32"):
    """tiny_test_config with nonzero noise strengths, so that the noise maps
    get a gradient."""
    g = TriPlaneGenerator(tiny_test_config(compute_dtype=dtype), device="cpu")
    with torch.no_grad():
        for k, v in g.named_parameters():
            if k.endswith("noise_strength"):
                v.fill_(0.1)
    return g


@pytest.fixture(scope="module")
def model():
    """The tiny generator, a small LPIPS and a BoxCX loss whose VGG19 is cut
    to a small stand-in (8 and 16 channels, two poolings: 20^2 positions a
    crop in place of 40^2), to keep the contextual loss's CPU time down."""
    box = BoxCXLoss(device="cpu")
    box.vgg = VGGFeatures(cfg=(8, "M", 8, "M", 16), target_layers=(6,), device="cpu")
    seeded_init(box.vgg, 2)
    return _gen(), LPIPS(device="cpu", **SMALL_VGG), box


def _images(b):
    rs = np.random.RandomState(3)
    targets = torch.from_numpy(np.tanh(rs.randn(b, 1, 3, 128, 128)).astype(np.float32))
    cameras = torch.stack([cam.canonical_camera(yaw=y) for y in YAWS[:b]])
    return targets, cameras


def _rngs(b, seed):
    return [torch.Generator().manual_seed(seed + i) for i in range(b)]


def _close_rel(got, want, tol):
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert err <= tol, f"relative error {err:.3e} > {tol}"


def _weights_agree(deltas_b, deltas_s, lr=LR):
    """Weight changes (batched, serial) within 2 lr everywhere and 0.05 lr
    on all but 0.1%."""
    db = torch.cat([d.reshape(-1) for d in deltas_b])
    ds = torch.cat([d.reshape(-1) for d in deltas_s])
    assert float(ds.abs().max()) > 0.5 * lr  # the weights moved
    diff = (db - ds).abs()
    assert float(diff.max()) <= 2 * lr
    assert float((diff > 0.05 * lr).float().mean()) <= 1e-3


@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("mode", ["sg", "sgw+", "mir"])
def test_project_batch_matches_serial(model, mode, b):
    g, lpips, _ = model
    targets, cameras = _images(b)
    # Two steps: the first has learning rate 0, the second moves w and the maps.
    settings = P.ProjectorSettings(mode=mode, num_steps=2, w_avg_samples=8)
    w_b, noise_b, dists_b = P.project_batch(g, lpips, targets, cameras, settings,
                                            rngs=_rngs(b, 20), device="cpu")
    assert w_b.shape == (b, 1, g.num_ws, g.w_dim) and dists_b.shape == (b, 2)
    for i, rng in enumerate(_rngs(b, 20)):
        w, noise, dists = P.project(g, lpips, targets[i], cameras[i], settings, rng=rng,
                                    device="cpu")
        _close_rel(dists_b[i], dists, 1e-5)
        assert float((w_b[i] - w).abs().max()) <= 5e-5
        for k, v in noise.items():
            assert float((noise_b[k][i] - v).abs().max()) <= 1e-4, k
    assert not torch.equal(w_b[0], w_b[1])  # each image its own draws and target


def _coach_inputs(g, b):
    targets, cameras = _images(b)
    rs = np.random.RandomState(4)
    w = torch.from_numpy(rs.randn(b, 1, g.num_ws, g.w_dim).astype(np.float32) * 0.3)
    lm = torch.from_numpy(rs.uniform(70, 190, (b, 1, 68, 2)).astype(np.float32))
    mask = torch.ones(b, 1, 1, 128, 128)
    noise = {k: torch.from_numpy(rs.randn(b, *v.shape).astype(np.float32))
             for k, v in sorted(g.named_buffers()) if k.endswith("noise_const")}
    return C.CoachInputs(targets, cameras, w, mask, lm), noise


def _serial_tune(g, lpips, box, inputs, noise, settings, i, seed):
    """Image i alone through tune_generator from g's weights, which are
    restored after. Returns (weight changes, steps, last LPIPS)."""
    before = {k: v.detach().clone() for k, v in g.state_dict().items()}
    one = C.CoachInputs(*(None if t is None else t[i] for t in dataclasses.astuple(inputs)))
    _, (steps, lp) = C.tune_generator(g, lpips, one, settings, noise=index_tree(noise, i),
                                      rng=torch.Generator().manual_seed(seed + i),
                                      device="cpu", box_cx=box)
    deltas = {k: (v - before[k]).detach().clone() for k, v in trainable_parameters(g).items()}
    g.load_state_dict(before)
    return deltas, steps, lp


@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("coach", ["pti", "rotbbox"])
def test_tune_batch_matches_serial(model, coach, b):
    g, lpips, box = model
    inputs, noise = _coach_inputs(g, b)
    if coach == "pti":
        settings = dataclasses.replace(C.pti_settings(3), lpips_threshold=-1.0)
    else:  # one step, step 0: rot, mirror-rot (BoxCX; lanes 0 and 2), depth (B = 2: and TV)
        settings = C.CoachSettings(num_steps=1, lpips_threshold=-1.0,
                                   tv_lambda=0.1 if b == 2 else 0.0)
    start = {k: v.detach().clone() for k, v in trainable_parameters(g).items()}
    tuned, steps_b, lps_b = C.tune_batch(g, lpips, inputs, settings, noise=noise,
                                         rngs=_rngs(b, 40), device="cpu", box_cx=box)
    assert all(torch.equal(v, start[k]) for k, v in trainable_parameters(g).items())
    deltas_b, deltas_s = [], []
    for i in range(b):
        deltas, steps, lp = _serial_tune(g, lpips, box, inputs, noise, settings, i, 40)
        assert steps_b[i] == steps == settings.num_steps
        assert abs(lps_b[i] - lp) <= 1e-5 * abs(lp)
        deltas_b += [tuned[k][i] - start[k] for k in deltas]
        deltas_s += list(deltas.values())
    _weights_agree(deltas_b, deltas_s)


class _RecordingAdam(torch.optim.Adam):
    """torch.optim.Adam that keeps a copy of the weights and moments at each
    `zero_grad`, which tune_batch calls before a step's backward and after
    its loop: the state after each step, stopped lanes' restores included."""

    made = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.history = []
        _RecordingAdam.made.append(self)

    def zero_grad(self, set_to_none=True):
        p = self.param_groups[0]["params"]
        seen = [(t.detach().clone(), self.state[t]["exp_avg"].clone(),
                 self.state[t]["exp_avg_sq"].clone()) for t in p if t in self.state]
        if seen:
            self.history.append(seen)
        super().zero_grad(set_to_none)


def test_lane_gating(model, monkeypatch):
    """The images cross one threshold at different steps: the lane that
    stops first counts fewer steps, keeps its weights and Adam moments
    bitwise from the step it stopped, and ends where it ends alone."""
    g, lpips, _ = model
    b = 2
    inputs, noise = _coach_inputs(g, b)
    # A learning rate at which the LPIPS falls step by step.
    free = dataclasses.replace(C.pti_settings(4), lpips_threshold=-1.0, learning_rate=3e-3)
    lps = []
    C.tune_batch(g, lpips, inputs, free, noise=noise, rngs=_rngs(b, 60), device="cpu",
                 on_step=lambda step, v: lps.append(v))
    # A threshold that lane `a` crosses at step k in 1..3 and the other lane never.
    a, k = min(((i, j) for i in range(b) for j in range(1, 4)
                if lps[j][i] < min(v[i] for v in lps[:j])
                and lps[j][i] < min(v[1 - i] for v in lps)), key=lambda ij: ij[1])
    settings = dataclasses.replace(free, lpips_threshold=lps[k][a])
    _RecordingAdam.made.clear()
    monkeypatch.setattr(torch.optim, "Adam", _RecordingAdam)
    start = {k: v.detach().clone() for k, v in trainable_parameters(g).items()}
    tuned, steps, last = C.tune_batch(g, lpips, inputs, settings, noise=noise,
                                      rngs=_rngs(b, 60), device="cpu")
    (opt,) = _RecordingAdam.made
    assert steps[1 - a] == 4 and steps[a] == k + 1, steps
    stopped = k  # the step whose LPIPS was at the threshold: counted, not applied
    assert last[a] <= settings.lpips_threshold < last[1 - a]
    assert len(opt.history) == 4
    for later in opt.history[stopped:]:
        for (p, m, v), (p0, m0, v0) in zip(later, opt.history[stopped - 1]):
            assert torch.equal(p[a], p0[a]) and torch.equal(m[a], m0[a])
            assert torch.equal(v[a], v0[a])
    for i in range(b):
        deltas, s_steps, s_lp = _serial_tune(g, lpips, None, inputs, noise, settings, i, 60)
        assert s_steps == steps[i] and abs(s_lp - last[i]) <= 1e-5 * abs(s_lp)
        _weights_agree([tuned[n][i] - start[n] for n in deltas], list(deltas.values()),
                       settings.learning_rate)


@pytest.mark.parametrize("b", [2, 3])
@pytest.mark.parametrize("shared_planes", [False, True])
def test_vmap_sample_planes(b, shared_planes):
    """`sample_planes` under vmap (one folded call for the batch, the ray
    geometry's views times B) against a loop, forward and the splat
    backward; planes shared by the images are expanded, their gradient
    summed over the batch."""
    gen = torch.Generator().manual_seed(5)
    n, m, hw, c = 2, 64, 16 * 16, 8
    planes = torch.randn(*(() if shared_planes else (b,)), n, 3, hw, c, generator=gen)
    planes.requires_grad_(True)
    coords = torch.rand(b, n, m, 3, generator=gen) * 1.8 - 0.9
    cot = torch.randn(b, n, 3, m, c, generator=gen)
    geom = PS.RayGeom(n, 4, 4, 4)
    out = vmap_strict(lambda p, x: PS.sample_planes(p, x, 1.0, geom),
                      in_dims=(None if shared_planes else 0, 0))(planes, coords)
    (grad,) = torch.autograd.grad(out, planes, cot)
    want_g = torch.zeros_like(planes)
    for i in range(b):
        p = (planes if shared_planes else planes[i]).detach().requires_grad_(True)
        o = PS.sample_planes(p, coords[i], 1.0, geom)
        assert torch.equal(out[i], o)
        (gi,) = torch.autograd.grad(o, p, cot[i])
        if shared_planes:
            want_g += gi
        else:
            want_g[i] = gi
    _close_rel(grad, want_g, 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batched_bias", [False, True])
def test_vmap_bias_act_plain(dtype, batched_bias):
    """The CPU path of `bias_act` (the plain chain under autograd) under
    vmap, x batched and the bias shared or each image's own, against a
    loop: y and dx exactly, db within 1e-6 relative."""
    b, gen = 3, torch.Generator().manual_seed(6)
    x = (torch.randn(b, 2, 5, 4, 4, generator=gen) * 3).to(dtype).requires_grad_(True)
    bias = torch.randn(*((b,) if batched_bias else ()), 5, generator=gen).requires_grad_(True)
    g = torch.randn(b, 2, 5, 4, 4, generator=gen).to(dtype)

    def f(xi, bi):
        return BA.bias_act(xi, bi, act="lrelu", gain=1.7, clamp=2.5)

    y = vmap_strict(f, in_dims=(0, 0 if batched_bias else None))(x, bias)
    dx, db = torch.autograd.grad(y, (x, bias), g)
    want_db = torch.zeros_like(bias)
    for i in range(b):
        xi = x[i].detach().requires_grad_(True)
        bi = (bias[i] if batched_bias else bias).detach().requires_grad_(True)
        yi = f(xi, bi)
        dxi, dbi = torch.autograd.grad(yi, (xi, bi), g[i])
        assert torch.equal(y[i], yi) and torch.equal(dx[i], dxi)
        if batched_bias:
            want_db[i] = dbi
        else:
            want_db += dbi
    # bf16: the bias gradient is a bf16 sum, taken in another order.
    _close_rel(db, want_db, 1e-6 if dtype == torch.float32 else 2.0 ** -8)


def _emulated_kernels(monkeypatch):
    """The CUDA wrappers' contract on the CPU: a (C,) bias, or a (B, C)
    bias with one row an image along x's first axis, from `bias_act_plain`
    and `bias_act_grad_plain`; each call counted."""
    names = {spec.cuda_id: name for name, spec in BA.activation_funcs.items()}
    calls = []

    def per_image(fn, b, *xs):
        if b.ndim == 1:
            return fn(*xs, b)
        return torch.stack([fn(*(t[i] for t in xs), b[i]) for i in range(b.shape[0])])

    def fwd(x, b, dim, act_id, alpha, gain, clamp):
        calls.append(("fwd", tuple(b.shape)))
        d = dim - (b.ndim == 2)
        return per_image(lambda xi, bi: BA.bias_act_plain(xi, bi, d, names[act_id], alpha,
                                                          gain, clamp), b, x)

    def bwd(g, x, b, dim, act_id, alpha, gain, clamp):
        calls.append(("bwd", tuple(b.shape)))
        d = dim - (b.ndim == 2)
        return per_image(lambda gi, xi, bi: BA.bias_act_grad_plain(gi, xi, bi, d, names[act_id],
                                                                   alpha, gain, clamp), b, g, x)

    monkeypatch.setattr(BA, "bias_act_fwd_cuda", fwd)
    monkeypatch.setattr(BA, "bias_act_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("batched_bias", [False, True])
def test_bias_act_cuda_vmap_rule(monkeypatch, batched_bias):
    """`_BiasActCuda`'s vmap rule on emulated kernels: one forward and one
    backward call for the batch (the bias (C,) folded, or (B, C) in the
    batched-bias form), dim shifted past the image axis, db summed per
    image; equal to the same Function called image by image."""
    calls = _emulated_kernels(monkeypatch)
    b, gen = 3, torch.Generator().manual_seed(7)
    spec = BA.activation_funcs["lrelu"]
    x = torch.randn(b, 2, 5, 3, generator=gen).requires_grad_(True)
    bias = torch.randn(*((b,) if batched_bias else ()), 5, generator=gen).requires_grad_(True)
    g = torch.randn(b, 2, 5, 3, generator=gen)
    in_dims = (0, 0 if batched_bias else None)

    def kernel(xi, bi):
        return BA._BiasActCuda.apply(xi, bi, 1, spec.cuda_id, spec.def_alpha, 1.7, 2.5)

    y = torch.func.vmap(kernel, in_dims=in_dims)(x, bias)
    dx, db = torch.autograd.grad(y, (x, bias), g)
    shape = (b, 5) if batched_bias else (5,)
    assert calls == [("fwd", shape), ("bwd", shape)]
    want_db = torch.zeros_like(bias)
    for i in range(b):
        bi = (bias[i] if batched_bias else bias).detach().requires_grad_(True)
        xi = x[i].detach().requires_grad_(True)
        yi = kernel(xi, bi)
        dxi, dbi = torch.autograd.grad(yi, (xi, bi), g[i])
        assert torch.equal(y[i], yi) and torch.equal(dx[i], dxi)
        if batched_bias:
            want_db[i] = dbi
        else:
            want_db += dbi
    _close_rel(db, want_db, 1e-6)


def test_bf16_batch_casts_each_images_weights():
    """bfloat16: `cast_call` inside the batched call casts each image's own
    (batched) weights; after one update the images' weights differ from the
    module's, so two PTI steps agree with the serial path only if the
    second step read them."""
    g = _gen("bfloat16")
    lpips = LPIPS(device="cpu", **SMALL_VGG)
    b = 2
    inputs, noise = _coach_inputs(g, b)
    settings = dataclasses.replace(C.pti_settings(2), lpips_threshold=-1.0)
    start = {k: v.detach().clone() for k, v in trainable_parameters(g).items()}
    lps = []
    tuned, _, _ = C.tune_batch(g, lpips, inputs, settings, noise=noise, rngs=_rngs(b, 80),
                               device="cpu", on_step=lambda step, v: lps.append(v))
    for i in range(b):
        seen = []
        before = {k: v.detach().clone() for k, v in g.state_dict().items()}
        one = C.CoachInputs(*(t[i] for t in dataclasses.astuple(inputs)))
        C.tune_generator(g, lpips, one, settings, noise=index_tree(noise, i),
                         rng=torch.Generator().manual_seed(80 + i), device="cpu",
                         on_step=lambda step, v: seen.append(v))
        deltas = {k: v - start[k] for k, v in trainable_parameters(g).items()}
        g.load_state_dict(before)
        for step in range(2):
            assert abs(lps[step][i] - seen[step]) <= 1e-2 * abs(seen[step]), (step, i)
        # bf16 roundings may flip a weight's first move: held as in float32, 10x looser.
        db = torch.cat([(tuned[k][i] - start[k]).reshape(-1) for k in deltas])
        ds = torch.cat([d.reshape(-1) for d in deltas.values()])
        assert float(((db - ds).abs() > 0.05 * LR).float().mean()) <= 1e-2


def test_functional_apply_rejects_unknown_names():
    g = _gen()
    with pytest.raises(KeyError, match="not a parameter or buffer"):
        functional_apply(g, {"backbone.nope": torch.zeros(1)}, g.planes_nhwc,
                         torch.zeros(1, g.num_ws, g.w_dim))


def test_trees():
    trees = [{"a": torch.full((2,), float(i)), "b": (torch.tensor(i), torch.zeros(1))}
             for i in range(3)]
    stacked = stack_trees(trees)
    assert stacked["a"].shape == (3, 2) and stacked["b"][0].tolist() == [0, 1, 2]
    back = index_tree(stacked, 2)
    assert torch.equal(back["a"], trees[2]["a"]) and int(back["b"][0]) == 2


def _make_data(root, n):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_smoke_data", os.path.join(os.path.dirname(__file__), "..", "tools",
                                        "make_smoke_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for i in range(n):
        mod.make_identity(root, f"synth{i}", seed=i)
    return PTIDataset(source_root=os.path.join(root, "crop"), c_root=os.path.join(root, "c"),
                      mask_root=os.path.join(root, "mask"), lm_root=os.path.join(root, "lm"),
                      target_name="target", mode="png", size=128)


def test_run_remainder_batch(tmp_path):
    """`run` with parallel_images 2 over 3 images: one batch of 2, then a
    batch of 1 (each image's agreement with the serial path is the tests'
    above); every image gets its artifacts, its steps and finite metrics,
    and metric_log.txt lists the three."""
    data = _make_data(str(tmp_path / "data"), 3)
    cfg = PipelineConfig(output_root=str(tmp_path / "out"), first_inv_type="mir",
                         first_inv_steps=1, G_1_type="pti", G_1_step=1, lpips_threshold=-1.0,
                         parallel_images=2)
    pipe = InversionPipeline(_gen(), cfg, device="cpu")
    pipe.lpips = LPIPS(device="cpu", **SMALL_VGG)
    batches = []
    real = pipe.invert_batch
    pipe.invert_batch = lambda samples: (batches.append([s.name for s in samples]),
                                         real(samples))[1]
    results = pipe.run(data)
    assert batches == [["synth0", "synth1"], ["synth2"]]
    assert [r["name"] for r in results] == ["synth0", "synth1", "synth2"]
    coach = cfg.coach_name
    for r in results:
        assert r["steps_run"] == 1 and r["stage2_s"] == 0.0 and r["stage1_s"] > 0
        assert all(np.isfinite(v) for v in r["metrics"].values()) and len(r["metrics"]) == 6
        for sub, ext in (("checkpoints", "npz"), ("embedding", "npz"), ("image", "jpg"),
                         ("image_m", "jpg")):
            assert os.path.exists(os.path.join(cfg.output_root, sub, coach, f"{r['name']}.{ext}"))
        with np.load(os.path.join(cfg.output_root, "embedding", coach, f"{r['name']}.npz")) as e:
            assert np.array_equal(e["w"], r["w"].numpy())
    log = open(os.path.join(cfg.output_root, "experiments", "metric_log.txt")).read()
    assert log.count("ID: ") == 3


def test_batched_path_needs_a_device(monkeypatch):
    """Without a GPU the batched path raises unless given the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = _gen()
    run = spmd_invert(g, LPIPS(device="cpu", **SMALL_VGG), P.ProjectorSettings(num_steps=1),
                      C.pti_settings(1))
    targets, cameras = _images(2)
    with pytest.raises(RuntimeError, match="no GPU"):
        run(targets, cameras, rngs=_rngs(2, 0))
