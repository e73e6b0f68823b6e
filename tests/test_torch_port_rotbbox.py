"""spi_tpu_torch's RotBbox stage 2 against spi_tpu, on the CPU: the camera
samplers, grid_sample, the depth warp, roi_align, the generator's
depth-only renders and free-point probe, the TV loss, and one RotBbox
tuning step with all four regularizers on (BoxCX and the perception
nets alone: tests/test_torch_port_perception_id.py).

Both sides get one set of weights (a JAX init carried over with
`load_flat_params`) and spi_tpu's own random draws, rebuilt with
jax.random from the key splits of spi_tpu's coach, as
tests/test_torch_port_stage2.py does.

Tolerances, float32 on both sides:
- camera samplers: 1e-6 (the same formulas);
- grid_sample, unproject / project, roi_align: 1e-5 (relative and
  absolute, on O(1) values; world points 3e-5 absolute on their O(3));
- rotate: the occlusion test `|depth - warped depth| < eps` and the
  in-bounds test are discontinuous, so a pixel at a threshold may land on
  either side in either framework: at most 0.1% of the mask's pixels may
  differ, and every other pixel of the mask and of the warped image is
  held to 1e-5 (relative and absolute);
- TV: 1e-4 relative;
- depth-only renders and the free-point probe: as
  tests/test_torch_port_generator.py holds synthesis, 1e-4 absolute;
- one tuning step: the weight-change rule of the stage-2 test. Adam's
  first step moves each weight by about lr times the sign of its
  gradient, so the change is held to 0.05 lr on all but 0.01% of the
  weights and to 2 lr everywhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.criteria.tv_loss import DENSITY_REG_P_DIST
from spi_tpu.criteria.tv_loss import monotonic_loss as j_monotonic_loss
from spi_tpu.criteria.tv_loss import tv_loss as j_tv_loss
from spi_tpu.criteria.bbox_cx import BoxCXLoss as JBoxCX
from spi_tpu.criteria.lpips import LPIPS as JLPIPS
from spi_tpu.models import triplane as JT
from spi_tpu.ops import roi_align as jroi
from spi_tpu.ops.grid_sample import grid_sample as j_grid_sample
from spi_tpu.training import coaches as JC
from spi_tpu.utils import camera as jcam
from spi_tpu.utils import rotate as jrot
from spi_tpu.utils.checkpoint import flatten_pytree
from spi_tpu.utils.params import extract_noise as j_extract_noise
from spi_tpu.utils.params import replace_noise as j_replace_noise
from spi_tpu_torch.criteria import tv_loss as ptv
from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.ops import roi_align as proi
from spi_tpu_torch.ops.grid_sample import grid_sample
from spi_tpu_torch.training import coaches as PC
from spi_tpu_torch.utils import camera as pcam
from spi_tpu_torch.utils import rotate as prot
from spi_tpu_torch.utils.checkpoint import load_flat_params
from spi_tpu_torch.utils.params import trainable_parameters
from torch_threads import few_torch_threads  # noqa: F401

SMALL_VGG = dict(cfg=(8, "M", 16, "M", 16), target_layers=(1, 4, 7))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def landmarks_128(seed=0):
    """68 points on an ellipse inside a 128^2 image, the layout
    tools/make_smoke_data.py writes at 256 scale, halved: the mouth and eye
    boxes lie in the image."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    lm = np.stack([64 + 30 * np.cos(t), 60 + 37 * np.sin(t)], -1) + rng.uniform(-2, 2, (68, 2))
    return lm[None].astype(np.float32)


def vgg19_params(seed=8):
    """BoxCX's VGG19 weights for both sides, He-normal from numpy (quicker
    than spi_tpu's jitted init of all 16 convolutions)."""
    from spi_tpu.models.perception.vgg import VGG19_CFG, VGGFeatures

    rng = np.random.RandomState(seed)
    flat = {}
    for idx, kind, cin, cout in VGGFeatures(cfg=VGG19_CFG).module_list():
        if kind == "conv":
            flat[f"features.{idx}.weight"] = (rng.randn(cout, cin, 3, 3)
                                              * np.sqrt(2.0 / (cin * 9))).astype(np.float32)
            flat[f"features.{idx}.bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
    return flat


class TestCameraSamplers:
    def test_sample_camera(self):
        kh, kv = jax.random.split(jax.random.PRNGKey(3))
        u = (jax.random.uniform(kh, (4, 1)), jax.random.uniform(kv, (4, 1)))
        want = jcam.sample_camera(jax.random.PRNGKey(3), batch_size=4, yaw_range=0.7,
                                  pitch_range=0.4)
        got = pcam.sample_camera(4, 0.7, 0.4, uniforms=tuple(_t(x) for x in u))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    def test_sample_camera_is_one_sided(self):
        """Yaw is drawn on one side of the canonical view, not around it."""
        cams = pcam.sample_camera(64, 0.7, 0.4, generator=torch.Generator().manual_seed(0))
        yaw = pcam.camera_yaw(cams)
        assert float(yaw.min()) >= 0 and float(yaw.max()) > 0.5

    @pytest.mark.parametrize("yaw", [0.0, 0.4, -0.6])
    def test_sample_surrounding_camera(self, yaw):
        middle = jcam.canonical_camera(yaw=yaw, pitch=0.05)
        ky, kp = jax.random.split(jax.random.PRNGKey(4))
        u = (jax.random.uniform(ky, (4,)), jax.random.uniform(kp, (4,)))
        want = jcam.sample_surrounding_camera(jax.random.PRNGKey(4), middle, batch_size=4,
                                              yaw_range=0.2, pitch_range=0.1)
        got = pcam.sample_surrounding_camera(_t(middle), 4, 0.2, 0.1,
                                             uniforms=tuple(_t(x) for x in u))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    def test_angle_to_rotation(self):
        y, p, r = (_rand(5, seed=s) for s in (1, 2, 3))
        want = jcam.angle_to_rotation(_j(y), _j(p), _j(r))
        got = pcam.angle_to_rotation(_t(y), _t(p), _t(r))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("yaw", [0.0, 0.05, 0.3, -0.8])
    def test_gauss_weight_and_front(self, yaw):
        c = jcam.canonical_camera(yaw=yaw, pitch=0.1, batch_size=2)
        np.testing.assert_allclose(pcam.cal_camera_gauss_weight(_t(c)).numpy(),
                                   np.asarray(jcam.cal_camera_gauss_weight(c)), rtol=1e-6)
        np.testing.assert_array_equal(pcam.check_front(_t(c)).numpy(),
                                      np.asarray(jcam.check_front(c)))


def test_grid_sample():
    """Inside, on and outside the edges; against spi_tpu and F.grid_sample."""
    x = _rand(2, 3, 9, 13, seed=5)
    grid = np.random.RandomState(6).uniform(-1.3, 1.3, (2, 7, 11, 2)).astype(np.float32)
    grid[0, 0, :4] = [[-1, -1], [1, 1], [-1, 1], [1.0, -1]]
    got = grid_sample(_t(x), _t(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_grid_sample(_j(x), _j(grid))),
                               rtol=1e-5, atol=1e-5)
    ref = torch.nn.functional.grid_sample(_t(x), _t(grid), mode="bilinear",
                                          padding_mode="zeros", align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def _smooth(seed, shape, coarse):
    """Noise of `coarse`^2 cells resized bilinearly to `shape`'s last two axes."""
    d = np.random.RandomState(seed).randn(*shape[:2], coarse, coarse).astype(np.float32)
    return np.asarray(jax.image.resize(_j(d), shape, "bilinear"))


def _warp_inputs(n=3, res=64, depth_res=16):
    """A target photo with the low-frequency content of a face crop, its
    camera and a smooth depth of about the render's 2.7, and target views
    around it with depths of their own. (A photo of pixel noise would not
    do: a float32 ulp of a sample position, 2.4e-7 of the image side,
    moves such a sample by up to 3e-5.) The source mask is soft for the
    same reason."""
    src_cam = np.asarray(jcam.canonical_camera(yaw=0.3))
    cams = np.asarray(jcam.sample_surrounding_camera(jax.random.PRNGKey(9), _j(src_cam), n,
                                                     yaw_range=0.2, pitch_range=0.1))

    def depth(seed):
        return (2.65 + 0.06 * _smooth(seed, (n, 1, depth_res, depth_res), 4)).astype(np.float32)

    return dict(
        target_camera=cams, target_depth=depth(10),
        src_image=np.tanh(_smooth(13, (n, 3, res, res), 8)).astype(np.float32),
        src_camera=np.repeat(src_cam, n, 0), src_depth=depth(11),
        src_mask=(1 / (1 + np.exp(-3 * _smooth(14, (n, 1, res, res), 8)))).astype(np.float32),
        depth_resolution=depth_res)


def test_unproject_project():
    a = _warp_inputs()
    ex, intr = jcam.unpack_camera(_j(a["target_camera"]))
    d = a["target_depth"].reshape(3, 16, 16)
    want = jrot.unproject(_j(d), ex, intr, 16)
    got = prot.unproject(_t(d), _t(ex), _t(intr), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=3e-5)
    sex, sin = jcam.unpack_camera(_j(a["src_camera"]))
    (juv, jz), (puv, pz) = jrot.project(want, sex, sin), prot.project(_t(want), _t(sex), _t(sin))
    np.testing.assert_allclose(puv.numpy(), np.asarray(juv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=1e-5, atol=3e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_rotate(masked):
    a = _warp_inputs()
    if not masked:
        a["src_mask"] = None
    jimg, jmask = jrot.rotate(**{k: _j(v) if isinstance(v, np.ndarray) else v
                                  for k, v in a.items()}, eps=5e-2)
    pimg, pmask = prot.rotate(**{k: _t(v) if isinstance(v, np.ndarray) else v
                                  for k, v in a.items()}, eps=5e-2)
    jimg, jmask, pimg, pmask = (np.asarray(x) for x in (jimg, jmask, pimg, pmask))
    assert pimg.shape == jimg.shape and pmask.shape == jmask.shape
    # The occlusion and in-bounds tests give 0 or 1 (times the sampled
    # source mask): a pixel across a threshold differs by far more than
    # the tolerance.
    flipped = np.abs(pmask - jmask) > 1e-5
    assert flipped.mean() <= 1e-3, f"{flipped.sum()} of {flipped.size} mask pixels differ"
    keep = ~np.broadcast_to(flipped, pimg.shape)
    np.testing.assert_allclose(pimg[keep], jimg[keep], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pmask[~flipped], jmask[~flipped], rtol=1e-5, atol=1e-5)
    # The inputs cross the occlusion test: some pixels pass it, some fail.
    assert 0.05 < float((jmask > 0).mean()) < 0.95


@pytest.mark.parametrize("sampling_ratio", [2, 3])
def test_roi_align(sampling_ratio):
    feats = _rand(3, 4, 40, 48, seed=12)
    boxes = np.array([[5.0, 7.0, 30.0, 25.0], [-6.0, 10.5, 20.0, 45.0],
                      [30.0, 2.0, 47.9, 39.0]], np.float32)  # the second and third cross edges
    want = jroi.roi_align(_j(feats), _j(boxes), 10, sampling_ratio)
    got = proi.roi_align(_t(feats), _t(boxes), 10, sampling_ratio)
    assert tuple(got.shape) == (3, 4, 10, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def gen_pair():
    """spi_tpu's tiny_test_config and its weights, with nonzero noise
    strengths (`_port_gen` makes the port's copy)."""
    jg = JT.tiny_test_config()
    params = jg.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, 0.1) if "noise_strength" in jax.tree_util.keystr(p) else v,
        params)
    return jg, params


def _port_gen(params):
    pg = TriPlaneGenerator(tiny_test_config(), device="cpu")
    load_flat_params(pg, flatten_pytree(params))
    return pg


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


def test_depth_only_render(gen_pair):
    """want_sr=False: the raw image and depth of four cameras, no 'image'."""
    jg, params = gen_pair
    pg = _port_gen(params)
    ws = _rand(1, jg.num_ws, jg.w_dim, seed=20, scale=0.5)
    cams = jcam.sample_camera(jax.random.PRNGKey(2), 4, 0.7, 0.4)
    key = jax.random.PRNGKey(21)
    want = jax.jit(lambda p, w, c: jg.synthesis_from_planes(
        p, key, jg._planes_nhwc(p, w), w, c, want_sr=False))(params, _j(ws), cams)
    with torch.no_grad():
        got = pg.synthesis_from_planes(pg.planes_nhwc(_t(ws)), _t(ws), _t(cams),
                                       draws=_render_draws(jg, key, 4), want_sr=False)
    assert set(got) == set(want) == {"image_raw", "image_depth"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-4)


def test_sample_mixed_and_tv(gen_pair):
    """The free-point probe and the TV loss with spi_tpu's draws
    (tv_loss.py:16-25); the planes' gradient through the splat's plain
    version against JAX's."""
    jg, params = gen_pair
    pg = _port_gen(params)
    ws = _rand(1, jg.num_ws, jg.w_dim, seed=22, scale=0.5)
    key = jax.random.PRNGKey(23)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = {"uniform": _t(jax.random.uniform(k1, (1, 1000, 3))),
             "perturb": _t(jax.random.normal(k2, (1, 1000, 3))),
             "directions": _t(jax.random.normal(k3, (1, 2000, 3)))}
    coords = _rand(1, 300, 3, seed=24, scale=0.6)
    dirs = _rand(1, 300, 3, seed=25)
    jrgb, jsigma = jax.jit(jg.sample_mixed)(params, _j(ws), _j(coords), _j(dirs))
    with torch.no_grad():
        prgb, psigma = pg.sample_mixed(_t(ws), _t(coords), _t(dirs))
    np.testing.assert_allclose(prgb.numpy(), np.asarray(jrgb), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(psigma.numpy(), np.asarray(jsigma), rtol=1e-4, atol=1e-4)

    draws_j = {k: _j(v) for k, v in draws.items()}
    initial = draws_j["uniform"] * 2 - 1
    points = jnp.concatenate(
        [initial, initial + draws_j["perturb"] * DENSITY_REG_P_DIST], axis=1)

    def jloss(planes):  # tv_loss as spi_tpu computes it, from given planes
        _, sigma = jg.renderer.run_model(
            planes, lambda f, d: jg.decoder(params["decoder"], f, d), points,
            draws_j["directions"])
        return jnp.mean(jnp.abs(sigma[:, :1000] - sigma[:, 1000:]))

    jplanes = jax.jit(jg._planes_nhwc)(params, _j(ws))
    jvalue, jgrad = jax.jit(jax.value_and_grad(jloss))(jplanes)
    j_tv = jax.jit(lambda p, w: j_tv_loss(key, jg, p, w))(params, _j(ws))
    np.testing.assert_allclose(float(j_tv), float(jvalue), rtol=1e-6)  # the draws rebuilt
    planes = pg.planes_nhwc(_t(ws)).detach().requires_grad_(True)
    value = ptv.tv_loss(pg, _t(ws), draws=draws, planes=planes)
    value.backward()
    value = value.detach()
    np.testing.assert_allclose(value.item(), float(jvalue), rtol=1e-4)
    err = np.abs(planes.grad.numpy() - np.asarray(jgrad)).max() / np.abs(np.asarray(jgrad)).max()
    assert err <= 1e-4, err


def test_monotonic_loss(gen_pair):
    """The depth prior with spi_tpu's draws (tv_loss.py:28-35), 1e-4."""
    jg, params = gen_pair
    pg = _port_gen(params)
    ws = _rand(1, jg.num_ws, jg.w_dim, seed=26, scale=0.5)
    key = jax.random.PRNGKey(27)
    k1, k2 = jax.random.split(key)
    draws = {"uniform": _t(jax.random.uniform(k1, (1, 500, 3))),
             "directions": _t(jax.random.normal(k2, (1, 1000, 3)))}
    want = jax.jit(lambda p, w: j_monotonic_loss(key, jg, p, w, n_points=500))(params, _j(ws))
    with torch.no_grad():
        got = ptv.monotonic_loss(pg, _t(ws), n_points=500, draws=draws)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-7)


def _coach_draws(jg, rng, step, rot_bs):
    """Step `step`'s draws as spi_tpu's coach makes them (coaches.py:139-143,
    :185-234, tv_loss.py:17-20): fold_in(rng, step) -> (k_recon, k_reg),
    k_reg -> 7 keys."""
    k_recon, k_reg = jax.random.split(jax.random.fold_in(rng, step))
    k_rot, k_rotm, k_depth, k_tv, k_r1, k_r2, k_r3 = jax.random.split(k_reg, 7)

    def uniforms(key, shape):
        a, b = jax.random.split(key)
        return _t(jax.random.uniform(a, shape)), _t(jax.random.uniform(b, shape))

    k1, k2, k3 = jax.random.split(k_tv, 3)
    return {
        "recon": _render_draws(jg, k_recon),
        "rot": {"cameras": uniforms(k_rot, (rot_bs,)), "render": _render_draws(jg, k_r1, rot_bs)},
        "mirror": {"cameras": uniforms(k_rotm, (rot_bs,)),
                   "render": _render_draws(jg, k_r2, rot_bs)},
        "depth": {"cameras": uniforms(k_depth, (4, 1)), "render": _render_draws(jg, k_r3, 4)},
        "tv": {"uniform": _t(jax.random.uniform(k1, (1, 1000, 3))),
               "perturb": _t(jax.random.normal(k2, (1, 1000, 3))),
               "directions": _t(jax.random.normal(k3, (1, 2000, 3)))},
    }


@pytest.fixture(scope="module")
def rotbbox_step(gen_pair):
    """One RotBbox step on both sides from a camera yawed by 0.4 (so that
    the mirror term counts) with all four regularizers on, stage-1 noise
    maps in the tuned generator and the pretrained ones in the depth
    anchor's frozen copy, as the pipeline passes them; and the port's
    recon-only step from the same start."""
    jg, params = gen_pair
    jl = JLPIPS(remat=False, **SMALL_VGG)
    jlp = jl.init(jax.random.PRNGKey(7))
    pl = LPIPS(device="cpu", **SMALL_VGG)
    load_flat_params(pl, flatten_pytree(jlp))
    vgg = vgg19_params()
    jbox = JBoxCX()
    jbox_params = {"vgg": {k: _j(v) for k, v in vgg.items()}}
    pbox = BoxCXLoss(device="cpu")
    load_flat_params(pbox, {f"vgg.{k}": v for k, v in vgg.items()})

    noise = {k: _rand(*v.shape, seed=60 + i) for i, (k, v) in
             enumerate(sorted(j_extract_noise(params).items()))}
    w_pivot = _rand(1, jg.num_ws, jg.w_dim, seed=61, scale=0.5)
    target = np.tanh(_rand(1, 3, 128, 128, seed=62))
    cam = np.asarray(jcam.canonical_camera(yaw=0.4))
    face_mask = np.zeros((1, 1, 128, 128), np.float32)
    face_mask[:, :, 16:112, 24:104] = 1.0
    lm = landmarks_128()
    rng = jax.random.PRNGKey(13)
    settings = JC.CoachSettings(num_steps=1, lpips_threshold=0.0, tv_lambda=0.1)

    g_params = j_replace_noise(params, {k: _j(v) for k, v in noise.items()})
    jtuned, (jsteps, jlp_value) = JC.tune_generator(
        jg, g_params, params, jl, jlp,
        JC.CoachInputs(target=_j(target), camera=_j(cam), w_pivot=_j(w_pivot),
                       face_mask=_j(face_mask), landmarks=_j(lm)),
        rng, settings, box_cx=jbox, box_cx_params=jbox_params)

    inputs = PC.CoachInputs(target=_t(target), camera=_t(cam), w_pivot=_t(w_pivot),
                            face_mask=_t(face_mask), landmarks=_t(lm))
    draws = [_coach_draws(jg, rng, 0, settings.rot_bs)]
    runs = {}
    for label, psettings in (("rotbbox", PC.CoachSettings(**settings.__dict__)),
                             ("recon", PC.pti_settings(1))):
        pg = _port_gen(params)
        before = {k: v.detach().clone() for k, v in pg.state_dict().items()}
        _, (psteps, plp) = PC.tune_generator(
            pg, pl, inputs, dataclasses.replace(psettings, lpips_threshold=0.0),
            noise={k: _t(v) for k, v in noise.items()}, draws=draws, device="cpu", box_cx=pbox)
        runs[label] = (pg, before, psteps, plp)
    return flatten_pytree(jtuned), int(jsteps), float(jlp_value), runs


def test_rotbbox_step_mirror_weight():
    assert float(jcam.cal_camera_weight(jcam.canonical_camera(yaw=0.4))[0]) > 0


def test_rotbbox_step(rotbbox_step):
    jflat, jsteps, jlp, runs = rotbbox_step
    pg, before, psteps, plp = runs["rotbbox"]
    assert psteps == jsteps == 1
    np.testing.assert_allclose(plp, jlp, rtol=1e-4)
    lr = PC.CoachSettings().learning_rate
    tuned = trainable_parameters(pg)
    dp, dj = [], []
    for k, v in pg.state_dict().items():
        d = (v - before[k]).numpy().ravel()
        if k not in tuned:  # the noise_const and w_avg buffers stay fixed
            assert not d.any(), k
            continue
        dp.append(d)
        dj.append((np.asarray(jflat[k]) - before[k].numpy()).ravel())
    dp, dj = np.concatenate(dp), np.concatenate(dj)
    assert np.abs(dj).max() > 0.5 * lr  # the weights moved
    diff = np.abs(dp - dj)
    assert diff.max() <= 2 * lr
    assert np.mean(diff > 0.05 * lr) <= 1e-4, f"{np.mean(diff > 0.05 * lr):.2e} of weights differ"


def test_rotbbox_step_differs_from_recon_only(rotbbox_step):
    """The regularizers move the weights: a recon-only step from the same
    start and the same recon draws ends elsewhere on more than ten times
    the share of weights that test_rotbbox_step lets differ from spi_tpu,
    so a port whose regularizers did nothing would fail there."""
    _, _, _, runs = rotbbox_step
    (reg, _, _, _), (recon, _, _, _) = runs["rotbbox"], runs["recon"]
    lr = PC.CoachSettings().learning_rate
    a, b = trainable_parameters(reg), trainable_parameters(recon)
    moved = np.concatenate([(a[k] - b[k]).detach().abs().numpy().ravel() > 0.5 * lr for k in a])
    assert moved.mean() > 1e-3, f"only {moved.mean():.2e} of the weights differ"


def test_rotate_with_confidence():
    """The cycle-consistency mask (rotate.py:119-151): each output by the
    mask rule of test_rotate; the thresholded confidence map itself may
    flip on at most 0.1% of its pixels."""
    a = _warp_inputs()
    a.pop("src_mask")
    mask = (np.asarray(_smooth(15, (3, 1, 64, 64), 8)) > -0.5).astype(np.float32)
    args = dict(a, src_mask=mask)
    want = jrot.rotate_with_confidence(**{k: _j(v) if isinstance(v, np.ndarray) else v
                                          for k, v in args.items()})
    got = prot.rotate_with_confidence(**{k: _t(v) if isinstance(v, np.ndarray) else v
                                         for k, v in args.items()})
    names = ("warp", "warp back", "confidence", "warped confidence", "confident warp")
    differ = {}
    for name, p, j in zip(names, got, want):
        p, j = p.numpy(), np.asarray(j)
        assert p.shape == j.shape, name
        differ[name] = np.abs(p - j) > 1e-5 + 1e-5 * np.abs(j)
    assert differ["confidence"].mean() <= 1e-3, differ["confidence"].mean()
    # A flipped occlusion or confidence pixel reaches the bilinear samples
    # around it, and the way back samples an image already warped once
    # (by up to 5e-5 where float32 moves its sample points): the outputs
    # differ beyond 1e-5 on at most 0.5% of their entries (0.34% for the
    # way back at these inputs, 0.2% for the warped confidence).
    for name in names:
        assert differ[name].mean() <= 5e-3, (name, differ[name].mean())
    assert 0.05 < float(np.asarray(want[2]).mean()) < 0.95  # the inputs cross the threshold
