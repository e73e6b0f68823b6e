"""spi_tpu_torch's bfloat16 compute path (`compute_dtype='bfloat16'`, the
CLI's default) against spi_tpu's, on the CPU, at tiny_test_config.

Weights enter the port only through the flat npz that spi_tpu's
`save_pytree` writes; spi_tpu's random draws are rebuilt with jax.random
and handed to the port, as tests/test_torch_port_generator.py,
test_torch_port_projector.py and test_torch_port_rotbbox.py do in
float32. bf16 rounds at other places in the two packages (XLA's CPU
compiler keeps some bf16 values in f32; the port's bias_act rounds once,
as the Pallas kernel, where spi_tpu's XLA chain rounds after each op), so
the port's bf16 is held to spi_tpu's bf16 by how far each lies from
float32, not entry by entry:
- synthesis outputs: RMS of port minus spi_tpu below 0.05 (the bound of
  spi_tpu's own bf16 test, tests/test_generator.py:450-466), and the
  port's bf16 error against float32 at most 2x spi_tpu's + 1e-3;
- weight gradients: every one float32 and finite (tests/test_generator.py:
  468-480); the largest and the median, over the weight tensors, of the
  error against float32 relative to each tensor's largest entry at most
  2x spi_tpu's. A few tensors' bf16 gradients are mostly rounding noise
  (errors near 1), so a per-tensor ratio would compare noise with noise.
  The float32 reference is the port's float32 run, which
  tests/test_torch_port_generator.py holds to spi_tpu's to 1e-4 (outputs)
  and 2e-3 (gradients), far inside these bf16 errors;
- LPIPS in bf16: within 5% of float32 (tests/test_inversion.py:235-247)
  and within 1e-5 relative of spi_tpu's bf16 LPIPS;
- two 'sg' updates (three steps, the first at lr 0): distances within
  1e-2 relative; the change of w and of each noise map held to spi_tpu's
  change in units of the learning rate (stated in the test);
- the CLI without --fp32 writes the float32 run's tree and npz keys.
One bf16 RotBbox step is in tests/test_torch_port_bf16_ops.py, so that
`--dist loadfile` runs the two files' largest JAX compiles on two workers.
"""

import importlib.util
import os
import statistics

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.criteria.lpips import LPIPS as JLPIPS
from spi_tpu.criteria.noise_reg import normalize_noise as j_normalize_noise
from spi_tpu.models import triplane as JT
from spi_tpu.training import projectors as JP
from spi_tpu.utils import camera as jcam
from spi_tpu.utils.checkpoint import flatten_pytree, save_pytree
from spi_tpu.utils.params import init_noise_like as j_init_noise_like
from spi_tpu_torch.cli import run_inversion
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.training import projectors as PP
from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz
from torch_threads import few_torch_threads  # noqa: F401

SMALL_VGG = dict(cfg=(8, "M", 16, "M", 16), target_layers=(1, 4, 7))
BF16 = "bfloat16"
_TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _np(a):
    return np.asarray(a.detach().float() if torch.is_tensor(a) else jnp.asarray(a, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _render_draws(jg, render_rng, n_cams=1):
    """The renderer's draws for one synthesis_from_planes call with key
    `render_rng` (triplane.py:260; renderer.py:421)."""
    rng_render, _ = jax.random.split(render_rng)
    rc, rf, _ = jax.random.split(rng_render, 3)
    m = jg.neural_rendering_resolution ** 2
    rend = jg.rendering
    return {
        "stratified": _t(jax.random.uniform(rc, (n_cams, m, rend.depth_resolution, 1))),
        "exponential": _t(jax.random.exponential(
            rf, (n_cams * m, rend.depth_resolution_importance + 1))),
    }


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """spi_tpu's tiny_test_config weights with nonzero noise strengths, and
    the flat npz the port loads."""
    params = JT.tiny_test_config().init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, 0.1) if "noise_strength" in jax.tree_util.keystr(p) else v,
        params)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    save_pytree(path, params)
    return params, load_npz(path)


def _port_gen(flat, dtype):
    pg = TriPlaneGenerator(tiny_test_config(compute_dtype=dtype), device="cpu", seed=123)
    load_flat_params(pg, flat)
    return pg


@pytest.fixture(scope="module")
def synthesis(weights):
    """One synthesis forward and backward: spi_tpu in bf16 (jitted, with
    the gradient of every weight); the port in bf16 and in float32.
    Returns {side: (outputs, weight gradients, planes dtype)}."""
    params, flat = weights
    jg = JT.tiny_test_config(compute_dtype=BF16)
    ws = _rand(1, jg.num_ws, jg.w_dim, seed=30, scale=0.5)
    cam = np.asarray(jcam.canonical_camera(yaw=0.2))
    r1, r2 = _rand(1, 3, 128, 128, seed=31), _rand(1, 3, 16, 16, seed=32)
    rng = jax.random.PRNGKey(5)

    def jloss(p):
        out = jg.synthesis(p, rng, jnp.asarray(ws), jnp.asarray(cam))
        return jnp.sum(out["image"] * r1) + jnp.sum(out["image_raw"] * r2), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    jplanes = jax.eval_shape(lambda p: jg._planes_nhwc(p, jnp.asarray(ws)), params)
    runs = {"spi_tpu": (dict(jout), flatten_pytree(jgrads), jplanes.dtype.name)}
    rng_rest, _ = jax.random.split(rng)
    draws = _render_draws(jg, rng_rest)
    for dtype in (BF16, "float32"):
        pg = _port_gen(flat, dtype)
        out = pg.synthesis(_t(ws), _t(cam), draws=draws)
        ((out["image"] * _t(r1)).sum() + (out["image_raw"] * _t(r2)).sum()).backward()
        grads = {k: p.grad for k, p in pg.named_parameters() if p.grad is not None}
        planes = pg.planes_nhwc(_t(ws)).dtype
        runs[dtype] = (out, grads, str(planes).removeprefix("torch."))
    return runs


def test_synthesis_dtypes(synthesis):
    """bf16 planes, float32 outputs, on both sides."""
    for side, (out, _, planes) in synthesis.items():
        assert planes == (BF16 if side != "float32" else "float32"), side
        for k in ("image", "image_raw", "image_depth"):
            assert str(out[k].dtype).removeprefix("torch.") == "float32", (side, k)


@pytest.mark.parametrize("key", ["image", "image_raw", "image_depth"])
def test_synthesis_bf16_output(synthesis, key):
    got, want, ref = (_np(synthesis[s][0][key]) for s in (BF16, "spi_tpu", "float32"))
    assert got.shape == want.shape
    assert np.sqrt(np.mean((got - want) ** 2)) < 0.05
    err_port = np.sqrt(np.mean((got - ref) ** 2))
    err_jax = np.sqrt(np.mean((want - ref) ** 2))
    assert err_port <= 2 * err_jax + 1e-3, (err_port, err_jax)


def test_synthesis_bf16_weight_gradients(synthesis):
    grads, jgrads, ref = synthesis[BF16][1], synthesis["spi_tpu"][1], synthesis["float32"][1]
    assert set(grads) == set(ref)
    for k, g in grads.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), k
    e_port = [_rel(grads[k], ref[k]) for k in ref]
    e_jax = [_rel(jgrads[k], ref[k]) for k in ref]
    assert max(e_port) <= 2 * max(e_jax), (max(e_port), max(e_jax))
    assert statistics.median(e_port) <= 2 * statistics.median(e_jax), (
        statistics.median(e_port), statistics.median(e_jax))


def test_lpips_bf16_close_to_f32():
    """The VGG16 LPIPS in bf16: within 5% of float32 (as spi_tpu's
    tests/test_inversion.py:235-247), and within 1e-5 relative of spi_tpu's
    `LPIPS(compute_dtype='bfloat16')` on the same weights (measured 4.5e-7;
    bf16 moves the distance from float32's by 1.2e-4 here), with float32
    features."""
    jparams = JLPIPS().init(jax.random.PRNGKey(0))
    x = np.random.RandomState(1).uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    y = np.random.RandomState(2).uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    jl = JLPIPS(remat=False, compute_dtype=BF16)
    want = float(jax.jit(jl)(jparams, _j(x), _j(y)))
    l32 = LPIPS(device="cpu")
    lbf = LPIPS(device="cpu", compute_dtype=BF16)
    for m in (l32, lbf):
        load_flat_params(m, flatten_pytree(jparams))
    with torch.no_grad():
        a, b = float(l32(_t(x), _t(y))), float(lbf(_t(x), _t(y)))
        assert all(f.dtype == torch.float32 for f in lbf.features(_t(x)))
    assert abs(a - b) / max(abs(a), 1e-6) < 0.05
    assert abs(b - want) <= 1e-5 * abs(want), (b, want)


def test_pipeline_lpips_compute_dtype(tmp_path):
    """`PipelineConfig.lpips_compute_dtype` sets the loss LPIPS's dtype, as
    spi_tpu/training/pipeline.py:113; the metric keeps a float32 LPIPS of
    the same weights, as spi_tpu's Metric."""
    from spi_tpu_torch.training.pipeline import InversionPipeline, PipelineConfig

    pg = TriPlaneGenerator(tiny_test_config(), device="cpu")
    bundle = {f"lpips.{k}": v.numpy() for k, v in LPIPS(device="cpu", seed=9).state_dict().items()}
    for dtype in ("float32", BF16):
        pp = InversionPipeline(pg, PipelineConfig(output_root=str(tmp_path),
                                                  lpips_compute_dtype=dtype), bundle, device="cpu")
        assert pp.lpips.compute_dtype == getattr(torch, dtype)
        metric_lpips = pp.metric.lpips
        assert metric_lpips.compute_dtype == torch.float32
        for k, v in metric_lpips.state_dict().items():  # the bundle's weights on both
            np.testing.assert_array_equal(v.numpy(), bundle[f"lpips.{k}"], err_msg=k)
            assert torch.equal(v, pp.lpips.state_dict()[k]), k


@pytest.fixture(scope="module")
def lpips_pair():
    jl = JLPIPS(remat=False, **SMALL_VGG)
    jparams = jl.init(jax.random.PRNGKey(7))
    pl = LPIPS(device="cpu", **SMALL_VGG)
    load_flat_params(pl, flatten_pytree(jparams))
    return jl, jparams, pl


def test_project_sg_two_steps_bf16(weights, lpips_pair):
    """Two bf16 'sg' updates with spi_tpu's draws (as
    tests/test_torch_port_projector.py's float32 test): three steps, of
    which step 0 has lr 0 (the rampup starts at 0) and steps 1 and 2 lr
    5e-3. w and the noise maps stay float32 and change as spi_tpu's do."""
    params, flat = weights
    jl, jparams, pl = lpips_pair
    jg = JT.tiny_test_config(compute_dtype=BF16)
    pg = _port_gen(flat, BF16)
    settings = JP.ProjectorSettings(mode="sg", num_steps=3, w_avg_samples=32)
    cam = np.asarray(jcam.canonical_camera(yaw=0.1))
    target = np.tanh(_rand(1, 3, 128, 128, seed=50))
    rng = jax.random.PRNGKey(9)
    jw, jnoise, jdists = JP.project(jg, params, jl, jparams, jnp.asarray(target),
                                    jnp.asarray(cam), rng, settings)
    w0, _ = JP.compute_w_stats(jg, params, jnp.asarray(cam), settings.w_avg_samples)

    rng_noise_init, rng_steps = jax.random.split(rng)
    noise0 = j_init_noise_like(rng_noise_init, params)
    w_noise, render = [], []
    for step in range(settings.num_steps):
        step_rng = jax.random.fold_in(rng_steps, step)
        w_noise.append(np.asarray(jax.random.normal(step_rng, (1, 1, jg.w_dim))))
        rng_rest, _ = jax.random.split(jax.random.fold_in(step_rng, 1))
        render.append(_render_draws(jg, rng_rest))
    draws = {"noise0": {k: _t(v) for k, v in noise0.items()},
             "w_noise": _t(np.stack(w_noise)), "render": render}
    pw, pnoise, pdists = PP.project(pg, pl, _t(target), _t(cam),
                                    PP.ProjectorSettings(**settings.__dict__), draws=draws,
                                    device="cpu")
    # dists[2] is measured after the first update.
    np.testing.assert_allclose(pdists.numpy(), np.asarray(jdists), rtol=1e-2)
    assert pw.dtype == torch.float32 and all(v.dtype == torch.float32 for v in pnoise.values())
    assert set(pnoise) == set(jnoise)
    lr = settings.initial_lr
    # w moves about 1 lr an update (Adam), 1.9 lr in all at the median. Its
    # bf16 gradient is noisy at that scale: the change is held to 0.5 lr
    # everywhere and 0.2 lr on all but 10% of the entries (measured: 0.27 lr
    # and 6% between the packages; spi_tpu's own bf16 against float32 0.33
    # lr and 6%). A missing or reversed update misses by 1 lr or more.
    dj = (np.asarray(jw) - np.asarray(w0)).ravel()
    dp = (pw.numpy() - np.asarray(w0)).ravel()
    assert np.median(np.abs(dj)) > lr  # w moved
    diff = np.abs(dp - dj)
    assert diff.max() <= 0.5 * lr, diff.max() / lr
    assert np.mean(diff > 0.2 * lr) <= 0.1, np.mean(diff > 0.2 * lr)
    # The noise maps are renormalised each step (the same float32 arithmetic
    # on both sides) and take about lr an update from Adam, mostly from the
    # float32 noise regularizer: their change is held to 0.05 lr everywhere
    # (measured 1.5e-3 lr).
    still = j_normalize_noise(noise0)  # where the maps would be without an update
    for k, v in pnoise.items():
        dj = np.asarray(jnoise[k]) - np.asarray(noise0[k])
        dp = v.numpy() - np.asarray(noise0[k])
        assert np.abs(np.asarray(jnoise[k]) - np.asarray(still[k])).max() > 0.5 * lr, k
        assert np.abs(dp - dj).max() <= 0.05 * lr, (k, np.abs(dp - dj).max() / lr)


def _tree(root):
    files = set()
    for d, _, names in os.walk(root):
        files |= {os.path.relpath(os.path.join(d, n), root) for n in names}
    return files


def test_cli_without_fp32_runs_bf16(tmp_path):
    """`--tiny --random_init` without --fp32 runs the generator in bf16 and
    writes the float32 run's output tree, npz keys and metric log."""
    spec = importlib.util.spec_from_file_location(
        "make_smoke_data", os.path.join(_TOOLS, "make_smoke_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    data = str(tmp_path / "data")
    mod.make_identity(data, "synth0", seed=0)
    trees = {}
    for flag in ([], ["--fp32"]):
        out = str(tmp_path / ("fp32" if flag else "bf16"))
        results = run_inversion.main([
            "--data_root", data, "--output_root", out, "--device", "cpu", "--tiny",
            "--random_init", *flag, "--first_inv_steps", "1", "--G_1_type", "pti",
            "--G_1_step", "1", "--LPIPS_value_threshold", "-1"])
        assert len(results) == 1 and all(np.isfinite(v) for v in results[0]["metrics"].values())
        keys = {}
        for f in _tree(out):
            if f.endswith(".npz"):
                with np.load(os.path.join(out, f)) as z:
                    keys[f] = {k: (z[k].shape, z[k].dtype) for k in z.files}
        trees[bool(flag)] = (_tree(out), keys)
    assert trees[False] == trees[True]
    assert any(k.startswith("G.") for ks in trees[False][1].values() for k in ks)
