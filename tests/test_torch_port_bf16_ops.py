"""spi_tpu_torch's bfloat16 ops against spi_tpu's, on the CPU.

The port runs with CPU tensors, so every kernel wrapper takes its plain
PyTorch version: `bias_act_plain` (forward) and `bias_act_grad_plain`
(the backward kernel's dx), the plain versions that the bf16 bias_act
kernels are held to on the card. Inputs are made with numpy from a seed,
rounded to bf16 and handed to both sides.

spi_tpu's Pallas bias_act kernel runs in interpret mode. Its program adds
x + b in bf16 and widens the sum to f32; XLA's CPU compiler, allowed
excess precision (its default), drops that rounding. The kernel is
therefore compiled here with `xla_allow_excess_precision=False`, so that
the CPU computes what the kernel states (as the port's kernel does).

Tolerances:
- plain bias_act against the Pallas kernel: linear and lrelu bitwise,
  forward and dx (the same f32 operations in the same order, one
  rounding); the other activations within 1 bf16 ulp (other f32 libm
  approximations before the rounding). Where act' is formed from y by a
  difference that cancels as the activation saturates (tanh 1 - y^2,
  sigmoid y(1 - y), elu y + 1, selu y + lambda alpha), dx is also taken
  within 1e-5 |g| gain: there a few f32 ulps of y become many bf16 ulps of
  a small dx. For relu and selu, where x + b is exactly 0, dx is held to
  act'(0) of `impl='xla'` (relu 0, selu lambda alpha), which the plain rule
  and the CUDA kernel take in place of the Pallas kernel's 1 and lambda.
- plain bias_act against `impl='xla'`, the chain spi_tpu's models run,
  jitted as they run it (XLA's default precision), forward only: 1 bf16
  ulp for each bf16 rounding of the chain after the sum, plus the plain
  version's own: 2 ulp where the chain rounds the activation and the gain,
  3 for swish, which also rounds sigmoid(x) before multiplying by x. Its
  dx is not compared: the chain's derivative is formed in bf16 from a
  bf16 y (sigmoid' = y(1 - y) from a y rounded to 8 bits), so it differs
  from the kernel rule by many ulps by construction, not by a fault of
  either.
- the dtype flow of the triplane gather and its splat, upfirdn2d and
  conv2d_resample in bf16: 2e-2 relative to the largest entry (a few bf16
  roundings of O(1) values, summed in other orders).
- one bf16 RotBbox step with all four regularizers (here rather than in
  tests/test_torch_port_bf16_model.py, so that `--dist loadfile` runs the
  two files' largest JAX compiles on two workers): the stage-2 tests' rule
  at bf16 tolerance. Adam's first step moves each weight by about lr times
  the sign of its gradient, so a weight whose bf16 gradient is at rounding
  noise may move another way: the change is held to 2 lr everywhere (a
  flipped sign, plus the float32 rounding of the weights: 2.002 lr) and to
  0.05 lr on all but 2% of the weights (measured on these inputs: 0.85%
  between the packages in bf16, and 0.84% between spi_tpu's own bf16 and
  float32 steps).
"""

import dataclasses


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu import ops as jops
from spi_tpu.criteria.bbox_cx import BoxCXLoss as JBoxCX
from spi_tpu.criteria.lpips import LPIPS as JLPIPS
from spi_tpu.models import triplane as JT
from spi_tpu.models.rendering import renderer as JR
from spi_tpu.ops.bias_act import bias_act as jbias_act
from spi_tpu.ops.bias_act_pallas import bias_act_pallas
from spi_tpu.training import coaches as JC
from spi_tpu.utils import camera as jcam
from spi_tpu.utils.checkpoint import flatten_pytree
from spi_tpu.utils.params import extract_noise as j_extract_noise
from spi_tpu.utils.params import replace_noise as j_replace_noise
from spi_tpu_torch import ops
from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.ops.bias_act import (
    activation_funcs,
    bias_act_fwd_cuda,
    bias_act_grad_plain,
    bias_act_plain,
)
from spi_tpu_torch.ops.plane_splat import sample_planes
from spi_tpu_torch.training import coaches as PC
from spi_tpu_torch.utils.checkpoint import load_flat_params
from spi_tpu_torch.utils.params import trainable_parameters
from torch_threads import few_torch_threads  # noqa: F401
from test_torch_port_rotbbox import _coach_draws, landmarks_128, vgg19_params

SMALL_VGG = dict(cfg=(8, "M", 16, "M", 16), target_layers=(1, 4, 7))
BF16 = "bfloat16"
ACTS = sorted(activation_funcs)
EXACT = ("linear", "lrelu")
SATURATING = ("tanh", "sigmoid", "elu", "selu")
GAIN = 1.7
BINOMIAL = [1.0, 3.0, 3.0, 1.0]
TOL_FLOW = 2e-2


def _bf16(*shape, seed=0, scale=1.0):
    """A bf16 tensor from a numpy seed, and the same values for JAX."""
    t = torch.from_numpy((np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32))
    t = t.bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _f32(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


def _ulp(t):
    """The spacing of bf16 values at each entry of `t`."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8).clamp_min(2.0 ** -133)


def _ulps(got, want):
    return float(((got.float() - want.float()).abs() / _ulp(want)).max())


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _strict(fn, *args):
    """Run `fn` compiled without XLA's CPU excess precision, so that each
    bf16 operation of the program rounds."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.fixture(scope="module")
def data():
    x, jx = _bf16(2, 16, 8, 8, seed=1, scale=3.0)
    b, jb = _bf16(16, seed=2)
    g, jg = _bf16(2, 16, 8, 8, seed=3)
    return (x, b, g), (jx, jb, jg)


def _pallas(jdata, act, clamp):
    def run(x, b, g):
        y, vjp = jax.vjp(lambda x, b: bias_act_pallas(x, b, act=act, gain=GAIN, clamp=clamp),
                         x, b)
        return y, vjp(g)[0]

    return [_f32(a) for a in _strict(run, *jdata)]


def _plain(tdata, act, clamp):
    x, b, g = tdata
    return (bias_act_plain(x, b, act=act, gain=GAIN, clamp=clamp),
            bias_act_grad_plain(g, x, b, act=act, gain=GAIN, clamp=clamp))


@pytest.mark.parametrize("clamp", [None, 2.5])
@pytest.mark.parametrize("act", EXACT)
def test_bias_act_bitwise_against_pallas(data, act, clamp):
    y, dx = _plain(data[0], act, clamp)
    jy, jdx = _pallas(data[1], act, clamp)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert torch.equal(y.float(), jy)
    assert torch.equal(dx.float(), jdx)


@pytest.mark.parametrize("clamp", [None, 2.5])
@pytest.mark.parametrize("act", [a for a in ACTS if a not in EXACT])
def test_bias_act_within_an_ulp_of_pallas(data, act, clamp):
    y, dx = _plain(data[0], act, clamp)
    jy, jdx = _pallas(data[1], act, clamp)
    assert _ulps(y, jy) <= 1.0
    x, b, g = data[0]
    kink = (x.float() + b.float()[None, :, None, None]) == 0
    if act in ("relu", "selu"):
        # At x + b = 0 the plain rule is impl='xla''s (relu'(0) = 0, selu'(0)
        # = lambda alpha), not the Pallas kernel's x >= 0 branch.
        at_zero = {"relu": 0.0, "selu": 1.0507009873554805 * 1.6732632423543772}[act]
        assert kink.any()
        assert torch.equal(dx[kink], (g.float()[kink] * at_zero * GAIN).bfloat16())
        jdx = torch.where(kink, dx.float(), jdx)
    err = (dx.float() - jdx).abs()
    ok = err <= _ulp(jdx)
    if act in SATURATING:
        ok |= err <= 1e-5 * g.float().abs() * GAIN
    assert bool(ok.all()), f"{int((~ok).sum())} elements, up to {_ulps(dx, jdx)} ulp"


@pytest.mark.parametrize("act", ACTS)
def test_bias_act_forward_within_two_ulp_of_xla(data, act):
    x, b, _ = data[0]
    jx, jb, _ = data[1]
    want = _f32(jax.jit(lambda x, b: jbias_act(x, b, act=act, gain=GAIN, clamp=2.5))(jx, jb))
    assert _ulps(bias_act_plain(x, b, act=act, gain=GAIN, clamp=2.5), want) <= (
        3.0 if act == "swish" else 2.0)


def test_bias_act_f32_unchanged_by_the_rounding_rule(data):
    """For float32 the plain version is the float32 chain it was: no
    rounding anywhere."""
    x, b, _ = (t.float() for t in data[0])
    spec = activation_funcs["lrelu"]
    want = (torch.where(x + b[:, None, None] >= 0, x + b[:, None, None],
                        (x + b[:, None, None]) * spec.def_alpha) * GAIN).clamp(-2.5, 2.5)
    assert torch.equal(bias_act_plain(x, b, act="lrelu", gain=GAIN, clamp=2.5), want)


def test_bias_act_cpu_autograd_keeps_dtypes(data):
    """On the CPU a bf16 layer runs the plain chain under autograd: a bf16
    output and input gradient, and a float32 bias (master weight) gets a
    float32 gradient through the cast."""
    x, _, g = data[0]
    x = x.clone().requires_grad_(True)
    b = torch.randn(16, generator=torch.Generator().manual_seed(4), requires_grad=True)
    y = ops.bias_act(x, b, act="lrelu", gain=GAIN, clamp=2.5)
    y.backward(g)
    assert y.dtype == x.grad.dtype == torch.bfloat16 and b.grad.dtype == torch.float32


def test_bias_act_kernel_takes_only_f32_and_bf16():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bias_act_fwd_cuda(torch.zeros(2, 3, dtype=torch.float16),
                          torch.zeros(3, dtype=torch.float16), 1, 0, 0.0, 1.0, None)


def test_sample_planes_dtype_flow():
    """bf16 planes: the gathered features are float32 (bf16 rows times
    float32 weights), as spi_tpu's `_sample_planes_math`; the splat gets a
    float32 cotangent and the plane gradient comes back in the planes'
    dtype, as spi_tpu's windowed backward casts it."""
    planes, jplanes = _bf16(1, 3, 16 * 16, 8, seed=5)
    coords = np.random.RandomState(6).uniform(-0.6, 0.6, (1, 200, 3)).astype(np.float32)
    ct = np.random.RandomState(7).randn(1, 3, 200, 8).astype(np.float32)

    jout, vjp = jax.vjp(lambda p: JR._sample_planes_math(p, jnp.asarray(coords), 1.0), jplanes)
    (jgrad,) = vjp(jnp.asarray(ct))
    assert jout.dtype == jnp.float32 and jgrad.dtype == jnp.bfloat16

    p = planes.clone().requires_grad_(True)
    out = sample_planes(p, torch.from_numpy(coords), 1.0)
    assert out.dtype == torch.float32
    (out * torch.from_numpy(ct)).sum().backward()
    assert p.grad.dtype == torch.bfloat16
    assert _rel(out.detach().numpy(), jout) <= 1e-6  # the same products, summed alike
    assert _rel(p.grad.float().numpy(), _f32(jgrad)) <= TOL_FLOW


@pytest.mark.parametrize("up,down,pad", [(2, 1, (2, 1, 2, 1)), (1, 2, (1, 1, 1, 1)),
                                         (1, 1, (1, 1, 1, 1))])
def test_upfirdn2d_bf16(up, down, pad):
    x, jx = _bf16(2, 3, 16, 16, seed=up * 10 + down)
    want = jops.upfirdn2d(jx, jops.setup_filter(BINOMIAL), up=up, down=down, padding=pad,
                          gain=up * up)
    got = ops.upfirdn2d(x, ops.setup_filter(BINOMIAL), up=up, down=down, padding=pad,
                        gain=up * up)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got.float().numpy(), _f32(want)) <= TOL_FLOW


@pytest.mark.parametrize("up,down,k", [(1, 1, 3), (2, 1, 3), (1, 2, 3), (2, 1, 1)])
def test_conv2d_resample_bf16(up, down, k):
    x, jx = _bf16(1, 4, 16, 16, seed=20 + up + down + k)
    w, jw = _bf16(6, 4, k, k, seed=30 + k, scale=0.3)
    f = BINOMIAL if up > 1 or down > 1 else None
    want = jops.conv2d_resample(jx, jw, f=jops.setup_filter(f) if f else None, up=up, down=down,
                                padding=k // 2)
    got = ops.conv2d_resample(x, w, f=ops.setup_filter(f) if f else None, up=up, down=down,
                              padding=k // 2)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got.float().numpy(), _f32(want)) <= TOL_FLOW


def test_rotbbox_step_bf16():
    """One bf16 RotBbox step with all four regularizers from a camera
    yawed by 0.4 (the mirror term counts), as
    tests/test_torch_port_rotbbox.py's float32 step; the weights stay
    float32 master weights."""
    params = JT.tiny_test_config().init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.full_like(v, 0.1) if "noise_strength" in jax.tree_util.keystr(p) else v,
        params)
    # No rematerialisation: the same function, a smaller program to compile.
    jg = JT.tiny_test_config(compute_dtype=BF16, remat_renderer=False, remat_sr=False)
    jl = JLPIPS(remat=False, **SMALL_VGG)
    jlp = jl.init(jax.random.PRNGKey(7))
    pl = LPIPS(device="cpu", **SMALL_VGG)
    load_flat_params(pl, flatten_pytree(jlp))
    vgg = vgg19_params()
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
    jtuned, (jsteps, jlp_value) = JC.tune_generator(
        jg, j_replace_noise(params, {k: _j(v) for k, v in noise.items()}), params, jl, jlp,
        JC.CoachInputs(target=_j(target), camera=_j(cam), w_pivot=_j(w_pivot),
                       face_mask=_j(face_mask), landmarks=_j(lm)),
        rng, settings, box_cx=JBoxCX(),
        box_cx_params={"vgg": {k: _j(v) for k, v in vgg.items()}})

    pg = TriPlaneGenerator(tiny_test_config(compute_dtype=BF16), device="cpu")
    load_flat_params(pg, flatten_pytree(params))
    before = {k: v.detach().clone() for k, v in trainable_parameters(pg).items()}
    _, (psteps, plp) = PC.tune_generator(
        pg, pl, PC.CoachInputs(target=_t(target), camera=_t(cam), w_pivot=_t(w_pivot),
                               face_mask=_t(face_mask), landmarks=_t(lm)),
        dataclasses.replace(PC.CoachSettings(**settings.__dict__), lpips_threshold=0.0),
        noise={k: _t(v) for k, v in noise.items()}, draws=[_coach_draws(jg, rng, 0, 4)],
        device="cpu", box_cx=pbox)
    assert psteps == int(jsteps) == 1
    np.testing.assert_allclose(plp, float(jlp_value), rtol=1e-2)
    jflat = flatten_pytree(jtuned)
    tuned = trainable_parameters(pg)
    assert all(p.dtype == torch.float32 for p in tuned.values())
    dp = np.concatenate([(tuned[k].detach() - before[k]).numpy().ravel() for k in before])
    dj = np.concatenate([(np.asarray(jflat[k]) - before[k].numpy()).ravel() for k in before])
    lr = PC.CoachSettings().learning_rate
    assert np.abs(dj).max() > 0.5 * lr  # the weights moved
    diff = np.abs(dp - dj)
    assert diff.max() <= 2.002 * lr  # a flipped sign moves 2 lr, plus the weights' f32 rounding
    assert np.mean(diff > 0.05 * lr) <= 2e-2, f"{np.mean(diff > 0.05 * lr):.2e} of weights differ"
