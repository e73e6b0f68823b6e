"""The modules of the port's GAN training, held to spi_tpu's on the CPU:

- bias_act's second order: `bias_act_grad2_plain` and the plain chain's
  double backward against jax.grad(jax.grad(...)) of spi_tpu's impl='xla'
  path, every activation, with and without clamp, with x + b exactly 0 on
  some elements (1e-5); the CUDA wrappers' autograd (`_BiasActCuda` ->
  `_BiasActCudaGrad` -> the second-order Function) on kernels emulated by
  the plain versions, against the plain chain, their launches counted, and
  `_BiasActCudaGrad`'s vmap rule;
- the moments, `Collector` and `cross_device_sum` in one process;
- `ImageFolderDataset` (folder, zip, xflip) and `batch_iterator`, bitwise;
- `Discriminator` and `DualDiscriminator` on spi_tpu's flattened init tree
  (1e-5 of the largest output), `minibatch_stddev`, the published-width
  state shapes against `jax.eval_shape` (the port on the meta device);
- `AugmentPipe`: exactly the identity at p = 0, and at p = 1 on spi_tpu's
  draws, each group alone and all together (1e-5), the filter bank;
- `ops/gradfix`: its convolution and the discriminator's resampling
  convolution against PyTorch's own, to second order (float64, 1e-9).
"""

import functools
import importlib
import json
import zipfile

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from spi_tpu.data import gan_dataset as JDS
from spi_tpu.models import discriminator as JD
from spi_tpu.ops.bias_act import activation_funcs as JACTS
from spi_tpu.ops.bias_act import bias_act as jbias_act
from spi_tpu.training import augment as JA
from spi_tpu.utils import stats as JST
from spi_tpu.utils.checkpoint import flatten_pytree
from spi_tpu_torch.data import gan_dataset as PDS
from spi_tpu_torch.models import discriminator as PD
from spi_tpu_torch.training import augment as PA
from spi_tpu_torch.utils import stats as PST
from spi_tpu_torch.utils.checkpoint import load_flat_params
from torch_threads import few_torch_threads  # noqa: F401

BA = importlib.import_module("spi_tpu_torch.ops.bias_act")
ACTS = sorted(JACTS)
TOL = 1e-5
D_SMALL = dict(c_dim=25, img_resolution=32, channel_base=1024, channel_max=64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30)


def _kink_inputs(seed=0):
    """x (3, 8, 4), b (8,), with x + b exactly 0 on half the elements, and
    two cotangents."""
    rng = np.random.RandomState(seed)
    b = rng.randn(8).astype(np.float32)
    x = (rng.randn(3, 8, 4) * 2).astype(np.float32)
    x[:, :, :2] = -b[None, :, None]
    g, gg = (rng.randn(3, 8, 4).astype(np.float32) for _ in range(2))
    return x, b, g, gg


# -- bias_act, second order ---------------------------------------------------


@pytest.mark.parametrize("clamp", [None, 0.9])
@pytest.mark.parametrize("act", ACTS)
def test_grad2_plain_matches_jax(act, clamp):
    """gg * g * act''(x + b) * gain, 0 where clamped: d/dx of the backward's
    dx = g * act'(x + b) * gain, applied to gg, as jax.grad(jax.grad)."""
    x, b, g, gg = _kink_inputs(1)

    def dx(x):
        return jax.grad(lambda x: jnp.sum(jbias_act(x, jnp.asarray(b), act=act, gain=1.3,
                                                    clamp=clamp) * g))(x)

    want = np.asarray(jax.grad(lambda x: jnp.sum(dx(x) * gg))(jnp.asarray(x)))
    got = BA.bias_act_grad2_plain(_t(gg), _t(g), _t(x), _t(b), act=act, gain=1.3, clamp=clamp)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if act in ("elu", "selu"):  # the expm1 branch at 0, as jax.nn's where(x > 0, ...)
        at_zero = np.zeros_like(x, bool)
        at_zero[:, :, :2] = True
        assert (np.asarray(want)[at_zero] != 0).all()


def _double_backward(fn, x, b, w, v, u):
    """d/d(x, b) of sum(v * dL/dx) + sum(u * dL/db), L = sum(w * fn(x, b)^2):
    the square makes the cotangent reaching fn's backward depend on x, as
    a layer's does inside a network."""
    x = x.detach().requires_grad_(True)
    b = b.detach().requires_grad_(True)
    gx, gb = torch.autograd.grad((fn(x, b).square() * w).sum(), (x, b), create_graph=True)
    outer = (gx * v).sum() + (gb * u).sum() + 0.0 * (x.sum() + b.sum())
    return torch.autograd.grad(outer, (x, b))


@pytest.mark.parametrize("clamp", [None, 0.9])
@pytest.mark.parametrize("act", ACTS)
def test_plain_double_backward_matches_jax(act, clamp):
    """The CPU path (the plain chain under autograd) differentiates twice as
    spi_tpu's impl='xla' does, at x + b = 0 too; b's second-order gradient
    is the x-term summed per channel."""
    x, b, w, v = _kink_inputs(2)
    u = np.random.RandomState(3).randn(8).astype(np.float32)

    def first(x, b):
        return jax.grad(lambda x, b: jnp.sum(
            jnp.square(jbias_act(x, b, act=act, gain=1.3, clamp=clamp)) * w),
            argnums=(0, 1))(x, b)

    def outer(x, b):
        gx, gb = first(x, b)
        return jnp.sum(gx * v) + jnp.sum(gb * u)

    want = jax.grad(outer, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    got = _double_backward(lambda x, b: BA.bias_act(x, b, act=act, gain=1.3, clamp=clamp),
                           _t(x), _t(b), _t(w), _t(v), _t(u))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=TOL, atol=TOL)


def _emulated_kernels(monkeypatch):
    """The three CUDA wrappers on the CPU, from the plain versions (a (C,)
    bias or a (B, C) one, one row an image); each call counted."""
    names = {spec.cuda_id: name for name, spec in BA.activation_funcs.items()}
    calls = []

    def per_image(fn, b, *xs):
        if b.ndim == 1:
            return fn(*xs, b)
        return torch.stack([fn(*(t[i] for t in xs), b[i]) for i in range(b.shape[0])])

    def make(kind, plain):
        def wrapper(*args):
            *tensors, b, dim, act_id, alpha, gain, clamp = args
            calls.append((kind, tuple(b.shape)))
            d = dim - (b.ndim == 2)
            return per_image(lambda *ts: plain(*ts, d, names[act_id], alpha, gain, clamp), b,
                             *tensors)
        return wrapper

    monkeypatch.setattr(BA, "bias_act_fwd_cuda", make("fwd", BA.bias_act_plain))
    monkeypatch.setattr(BA, "bias_act_bwd_cuda", make("bwd", BA.bias_act_grad_plain))
    monkeypatch.setattr(BA, "bias_act_grad2_cuda", make("grad2", BA.bias_act_grad2_plain))
    return calls


@pytest.mark.parametrize("clamp", [None, 0.9])
@pytest.mark.parametrize("act", ACTS)
def test_cuda_function_double_backward_emulated(monkeypatch, act, clamp):
    """The kernels' autograd on emulated kernels equals the plain chain's
    double backward. The backward kernel runs three times: as the backward
    in the first pass, as the backward of the backward (the cotangent of g)
    in the second, and there again as the backward of fn along the square's
    path; the second-order kernel once where act'' is not identically 0,
    and never elsewhere."""
    calls = _emulated_kernels(monkeypatch)
    x, b, w, v = (_t(a) for a in _kink_inputs(4))
    u = torch.randn(8, generator=torch.Generator().manual_seed(5))
    spec = BA.activation_funcs[act]

    def kernel(x, b):
        return BA._BiasActCuda.apply(x, b, 1, spec.cuda_id, spec.def_alpha, 1.3, clamp)

    got = _double_backward(kernel, x, b, w, v, u)
    want = _double_backward(lambda x, b: BA.bias_act_plain(x, b, act=act, gain=1.3, clamp=clamp),
                            x, b, w, v, u)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, rtol=TOL, atol=TOL)
    second = [("grad2", (8,))] if spec.grad2 is not None else []
    assert sorted(calls) == sorted([("fwd", (8,))] + [("bwd", (8,))] * 3 + second)


def test_third_order_raises(monkeypatch):
    _emulated_kernels(monkeypatch)
    spec = BA.activation_funcs["tanh"]
    x = torch.randn(2, 3, 4).requires_grad_(True)
    b = torch.randn(3)
    y = BA._BiasActCuda.apply(x, b, 1, spec.cuda_id, 0.0, 1.0, None)
    (gx,) = torch.autograd.grad(y.sum(), x, create_graph=True)
    (gxx,) = torch.autograd.grad(gx.sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="twice, not three times"):
        torch.autograd.grad(gxx.sum(), x)


@pytest.mark.parametrize("batched_bias", [False, True])
def test_cuda_grad_vmap_rule(monkeypatch, batched_bias):
    """`_BiasActCudaGrad` and the second-order Function under torch.func.vmap:
    one call of each for the batch (a shared bias folded, or the (B, C)
    batched-bias form), equal to the Functions called image by image."""
    calls = _emulated_kernels(monkeypatch)
    n, gen = 3, torch.Generator().manual_seed(7)
    spec = BA.activation_funcs["softplus"]
    cfg = (1, spec.cuda_id, spec.def_alpha, 1.7, 2.5)
    g, x, gg = (torch.randn(n, 2, 5, 3, generator=gen) for _ in range(3))
    bias = torch.randn(*((n,) if batched_bias else ()), 5, generator=gen)
    in_dims = (0, 0, 0 if batched_bias else None)
    dx = torch.func.vmap(lambda gi, xi, bi: BA._BiasActCudaGrad.apply(gi, xi, bi, *cfg),
                         in_dims=in_dims)(g, x, bias)
    ddx = torch.func.vmap(lambda a, gi, xi, bi: BA._BiasActCudaGrad2.apply(a, gi, xi, bi, *cfg),
                          in_dims=(0,) + in_dims)(gg, g, x, bias)
    shape = (n, 5) if batched_bias else (5,)
    assert calls == [("bwd", shape), ("grad2", shape)]
    for i in range(n):
        bi = bias[i] if batched_bias else bias
        torch.testing.assert_close(dx[i], BA._BiasActCudaGrad.apply(g[i], x[i], bi, *cfg),
                                   rtol=0, atol=0)
        torch.testing.assert_close(ddx[i], BA._BiasActCudaGrad2.apply(gg[i], g[i], x[i], bi, *cfg),
                                   rtol=0, atol=0)


# -- stats ----------------------------------------------------------------------


def test_moments_and_collector():
    rng = np.random.RandomState(0)
    values = [rng.randn(3).astype(np.float32), np.float32(4.0), rng.randn(2, 2).astype(np.float32)]
    np.testing.assert_allclose(PST.moments_of(_t(values[0])).numpy(),
                               np.asarray(JST.moments_of(jnp.asarray(values[0]))), rtol=1e-6)
    jc, pc = JST.Collector(), PST.Collector()
    for v in values:
        jc.report("loss", jnp.asarray(v))
        pc.report("loss", torch.as_tensor(v))
    pc.report("p", 0.25)
    jc.report("p", 0.25)
    jc.update_from_tree({"extra": np.array([2.0, 3.0, 5.0])})
    pc.update_from_tree({"extra": torch.tensor([2.0, 3.0, 5.0])})
    assert pc.as_dict().keys() == jc.as_dict().keys()
    for name, d in jc.as_dict().items():
        for k, v in d.items():
            assert pc.as_dict()[name][k] == pytest.approx(v, rel=1e-6), (name, k)
    assert pc.mean("loss") == pytest.approx(jc.mean("loss"), rel=1e-6)
    assert pc.std("loss") == pytest.approx(jc.std("loss"), rel=1e-6)
    assert np.isnan(pc.mean("missing"))
    moments = {"a": PST.moments_of(torch.arange(4.0))}
    assert torch.equal(PST.cross_device_sum(moments)["a"], moments["a"])  # one process
    np.testing.assert_array_equal(PST.accumulate(moments["a"], 1.0).numpy(), [5, 7, 15])
    pc.reset()
    assert pc.as_dict() == {}


def test_write_jsonl(tmp_path):
    c = PST.Collector()
    c.report("Loss/G", torch.tensor([1.0, 3.0]))
    c.write_jsonl(str(tmp_path / "stats.jsonl"), kimg=0.5)
    c.write_jsonl(str(tmp_path / "stats.jsonl"), kimg=1.0)
    lines = [json.loads(s) for s in (tmp_path / "stats.jsonl").read_text().splitlines()]
    assert [sorted(e) for e in lines] == [["Loss/G", "kimg", "timestamp"]] * 2
    assert lines[0]["Loss/G"] == {"num": 2.0, "mean": 2.0, "std": 1.0}


# -- the dataset ------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    """Five 24^2 images in two folders, with a dataset.json of 25-dim camera
    labels (one image without a label), and the same as a zip."""
    from PIL import Image

    from spi_tpu.preprocess import camera_math as cm

    root = tmp_path_factory.mktemp("gan_data")
    rng = np.random.default_rng(0)
    labels = []
    for i in range(5):
        name = f"{'sub/' if i % 2 else ''}img{i}.png"
        (root / name).parent.mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (24, 24, 3), np.uint8)).save(root / name)
        cam = cm.cal_camera(np.array([0.0, 0.2 * i - 0.4, 0.0]), np.zeros(3))
        if i != 3:
            labels.append([name, cm.process_camera(cam["pose"], cam["intrinsics"]).tolist()])
    (root / "dataset.json").write_text(json.dumps({"labels": labels}))
    zpath = root.parent / "gan_data.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for f in sorted(root.rglob("*")):
            if f.is_file():
                z.write(f, f.relative_to(root).as_posix())
    return str(root), str(zpath)


@pytest.mark.parametrize("kind", ["folder", "zip"])
@pytest.mark.parametrize("xflip", [False, True])
def test_dataset_items_bitwise(image_folder, kind, xflip):
    path = image_folder[kind == "zip"]
    jd = JDS.ImageFolderDataset(path, resolution=16, xflip=xflip)
    pd = PDS.ImageFolderDataset(path, resolution=16, xflip=xflip)
    assert len(pd) == len(jd) == 5 * (2 if xflip else 1) and pd.label_dim == jd.label_dim == 25
    for i in range(len(jd)):
        (ja, jl), (pa, pl) = jd[i], pd[i]
        assert pa.dtype == np.uint8 and pa.shape == (3, 16, 16)
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_array_equal(pl, jl)


@pytest.mark.parametrize("rank,replicas", [(0, 1), (1, 2), (2, 3)])
def test_batch_iterator_bitwise(image_folder, rank, replicas):
    jd = JDS.ImageFolderDataset(image_folder[0], xflip=True, max_size=4)
    pd = PDS.ImageFolderDataset(image_folder[0], xflip=True, max_size=4)
    ji = JDS.batch_iterator(jd, 3, rank=rank, num_replicas=replicas, seed=5)
    pi = PDS.batch_iterator(pd, 3, rank=rank, num_replicas=replicas, seed=5)
    for _ in range(4):
        (jx, jl), (px, pl) = next(ji), next(pi)
        assert px.dtype == np.float32 and px.shape == (3, 3, 24, 24)
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(pl, jl)
    it_j = JDS.infinite_indices(7, rank=rank, num_replicas=replicas, seed=1)
    it_p = PDS.infinite_indices(7, rank=rank, num_replicas=replicas, seed=1)
    assert [next(it_p) for _ in range(30)] == [next(it_j) for _ in range(30)]


# -- the discriminator --------------------------------------------------------------


@pytest.fixture(scope="module")
def dual_pair():
    """spi_tpu's small DualDiscriminator init, flattened, loaded into the port's."""
    jd = JD.DualDiscriminator(**D_SMALL)
    params = jd.init(jax.random.PRNGKey(0))
    pd = PD.DualDiscriminator(**D_SMALL, device="cpu", seed=9)
    load_flat_params(pd, flatten_pytree(params))
    return jd, params, pd


def _images(n, res, raw_res, seed):
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(n, 3, res, res).astype(np.float32),
            "image_raw": rng.randn(n, 3, raw_res, raw_res).astype(np.float32)}


@pytest.mark.parametrize("n", [2, 4, 6])
def test_dual_discriminator_forward(dual_pair, n):
    """The dual discriminator on spi_tpu's weights: the batch sizes give
    minibatch-stddev groups of 2, 4 and 3."""
    jd, params, pd = dual_pair
    img = _images(n, 32, 16, n)
    c = np.random.RandomState(10 + n).randn(n, 25).astype(np.float32)
    want = np.asarray(jax.jit(jd.__call__)(params, {k: jnp.asarray(v) for k, v in img.items()},
                                           jnp.asarray(c)))
    got = pd({k: _t(v) for k, v in img.items()}, _t(c)).detach().numpy()
    assert got.shape == (n, 1)
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("c_dim", [0, 25])
def test_single_discriminator_forward(c_dim):
    kw = dict(D_SMALL, c_dim=c_dim)
    jd = JD.Discriminator(**kw)
    params = jd.init(jax.random.PRNGKey(3))
    pd = PD.Discriminator(**kw, device="cpu")
    load_flat_params(pd, flatten_pytree(params))
    x = np.random.RandomState(4).randn(4, 3, 32, 32).astype(np.float32)
    c = np.random.RandomState(5).randn(4, c_dim).astype(np.float32)
    want = np.asarray(jax.jit(jd.__call__)(params, jnp.asarray(x), jnp.asarray(c)))
    got = pd(_t(x), _t(c)).detach().numpy()
    assert _rel_err(got, want) <= TOL


def test_minibatch_stddev():
    x = np.random.RandomState(6).randn(6, 8, 4, 4).astype(np.float32)
    for group in (1, 2, 4):
        want = np.asarray(JD.minibatch_stddev(jnp.asarray(x), group_size=group))
        np.testing.assert_allclose(PD.minibatch_stddev(_t(x), group_size=group).numpy(), want,
                                   rtol=1e-6, atol=1e-6)


def test_filtered_resizing():
    x = np.random.RandomState(7).randn(2, 3, 64, 64).astype(np.float32)
    for size in (16, 128):
        want = np.asarray(JD.filtered_resizing(jnp.asarray(x), size))
        np.testing.assert_allclose(PD.filtered_resizing(_t(x), size).numpy(), want,
                                   rtol=TOL, atol=TOL)


def test_published_width_shapes():
    """DualDiscriminator(c_dim=25, img_resolution=512): every key and shape of
    the port's state equals spi_tpu's init tree (jax.eval_shape: no weights
    allocated; the port on the meta device)."""
    shapes = jax.eval_shape(JD.DualDiscriminator(c_dim=25, img_resolution=512).init,
                            jax.random.PRNGKey(0))
    want = {".".join(str(getattr(p, "key", p)) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {k: tuple(v.shape) for k, v in
           PD.DualDiscriminator(c_dim=25, img_resolution=512, device="meta").state_dict().items()}
    assert got == want
    assert got["b512.fromrgb.weight"] == (64, 6, 1, 1) and got["b4.out.weight"] == (512, 512)


# -- the ADA pipe ---------------------------------------------------------------------

ALL_OFF = dict(xflip=0, rotate90=0, xint=0, scale=0, rotate=0, aniso=0, xfrac=0, brightness=0,
               contrast=0, lumaflip=0, hue=0, saturation=0)
GROUPS = {
    "blit": dict(ALL_OFF, xflip=1, rotate90=1, xint=1),
    "geom": dict(ALL_OFF, scale=1, rotate=1, aniso=1, xfrac=1),
    "color": dict(ALL_OFF, brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
    "imgfilter": dict(ALL_OFF, imgfilter=1.0),
    "noise": dict(ALL_OFF, noise=1.0),
    "cutout": dict(ALL_OFF, cutout=1.0),
    "default": {},
    "all": dict(imgfilter=1.0, noise=1.0, cutout=1.0),
}


def pipe_draws(pipe, key, n, shapes):
    """The draws spi_tpu's AugmentPipe makes from `key` (augment.py:150-335),
    in the port's layout; the noise field for each image shape of `shapes`."""
    k = jax.random.split(key, 16)
    fold = jax.random.fold_in

    def uni(kk, shape=(n,), **kw):
        return _t(jax.random.uniform(kk, shape, **kw))

    def nrm(kk, shape=(n,)):
        return _t(jax.random.normal(kk, shape))

    d = {}
    if pipe.xflip > 0:
        d["xflip"] = uni(k[0])
    if pipe.rotate90 > 0:
        d["rotate90"], d["rotate90_k"] = uni(k[1]), _t(jax.random.randint(k[2], (n,), 0, 4)).long()
    if pipe.xint > 0:
        d["xint"], d["xint_t"] = uni(k[3]), uni(k[4], (n, 2), minval=-1.0, maxval=1.0)
    if pipe.scale > 0:
        d["scale"], d["scale_s"] = uni(k[5]), nrm(k[6])
    if pipe.rotate > 0:
        d["rotate"], d["rotate_t"] = uni(k[7]), uni(k[8], minval=-1.0, maxval=1.0)
    if pipe.aniso > 0:
        d["aniso"], d["aniso_s"] = uni(k[9]), nrm(k[10])
    if pipe.xfrac > 0:
        d["xfrac"], d["xfrac_t"] = uni(k[11]), nrm(k[12], (n, 2))
    if pipe.brightness > 0:
        d["brightness"], d["brightness_s"] = uni(k[13]), nrm(fold(k[13], 1))
    if pipe.contrast > 0:
        d["contrast"], d["contrast_s"] = uni(k[14]), nrm(fold(k[14], 1))
    if pipe.lumaflip > 0:
        d["lumaflip"] = uni(k[15])
    k_hue, k_sat = fold(k[15], 1), fold(k[15], 3)
    if pipe.hue > 0:
        d["hue"], d["hue_t"] = uni(k_hue), uni(fold(k_hue, 2), minval=-1.0, maxval=1.0)
    if pipe.saturation > 0:
        d["saturation"], d["saturation_s"] = uni(k_sat), nrm(fold(k_sat, 4))
    if pipe.imgfilter > 0:
        kf = fold(key, 77)
        bands = range(len(pipe.imgfilter_bands))
        d["imgfilter"] = torch.stack([uni(fold(kf, i)) for i in bands], dim=1)
        d["imgfilter_t"] = torch.stack([nrm(fold(fold(kf, i), 1)) for i in bands], dim=1)
    if pipe.noise > 0:
        kn = fold(key, 88)
        d["noise_sigma"], d["noise"] = nrm(kn), uni(fold(kn, 1))
        d["noise_field"] = {s[-2]: nrm(fold(kn, 2), (n, *s[-3:])) for s in shapes}
    if pipe.cutout > 0:
        kc = fold(key, 99)
        d["cutout"], d["cutout_center"] = uni(kc), uni(fold(kc, 1), (n, 2))
    return d


def test_identity_at_p0():
    """Every gate shut: the input exactly, imgfilter aside."""
    x = torch.randn(3, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    pipe = PA.AugmentPipe(cutout=1.0, noise=1.0)
    for seed in range(3):
        y = pipe(x, 0.0, generator=torch.Generator().manual_seed(seed))
        assert torch.equal(y, x)


@functools.lru_cache(maxsize=None)
def _jax_pipe(group):
    """spi_tpu's pipe of `group`, jitted once for both p."""
    pipe = JA.AugmentPipe(**GROUPS[group])
    return pipe, jax.jit(lambda key, x, p: pipe(None, key, x, p))


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("p", [0.0, 1.0])
def test_pipe_on_spi_tpu_draws(group, p):
    """spi_tpu's pipe and the port's on spi_tpu's draws, at two resolutions
    (the dual discriminator's image and raw render) from one key: 1e-5 of
    the largest entry."""
    (jp, run), pp = _jax_pipe(group), PA.AugmentPipe(**GROUPS[group])
    key = jax.random.PRNGKey(11)
    rng = np.random.RandomState(12)
    xs = [np.tanh(rng.randn(4, 3, r, r)).astype(np.float32) for r in (32, 8)]
    draws = pipe_draws(jp, key, 4, [x.shape for x in xs])
    for x in xs:
        want = np.asarray(run(key, jnp.asarray(x), jnp.float32(p)))
        got = pp.apply(_t(x), p, draws).numpy()
        assert _rel_err(got, want) <= TOL, group
        assert (not np.allclose(got, x, atol=1e-3)) == (p > 0)


def test_pipe_draws_layout():
    """`draw` gives every key `apply` reads, for the noise field one per
    image height; a pipe with every group on runs on its own draws and is
    differentiable with respect to the images (R1 reaches through it)."""
    pipe = PA.AugmentPipe(imgfilter=1.0, noise=1.0, cutout=1.0)
    gen = torch.Generator().manual_seed(1)
    d = pipe.draw(2, gen, shapes=[(3, 16, 16), (3, 8, 8)])
    assert sorted(d) == sorted(pipe_draws(JA.AugmentPipe(imgfilter=1.0, noise=1.0, cutout=1.0),
                                          jax.random.PRNGKey(0), 2, [(3, 16, 16)]))
    assert sorted(d["noise_field"]) == [8, 16] and d["rotate90_k"].dtype == torch.int64
    x = torch.randn(2, 3, 16, 16).requires_grad_(True)
    y = pipe.apply(x, 0.7, d)
    (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    (gg,) = torch.autograd.grad(g.square().sum(), x)
    assert torch.isfinite(gg).all() and gg.abs().sum() > 0


def test_fbank_and_filter_images():
    np.testing.assert_array_equal(PA._HZ_FBANK, JA._HZ_FBANK)
    np.testing.assert_array_equal(PA._EXPECTED_POWER, JA._EXPECTED_POWER)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    hz = rng.randn(2, PA._HZ_FBANK.shape[1]).astype(np.float32)
    want = np.asarray(JA.filter_images(jnp.asarray(x), jnp.asarray(hz)))
    assert _rel_err(PA.filter_images(_t(x), _t(hz)).numpy(), want) <= TOL


# -- the discriminator's convolutions ---------------------------------------------


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("stride,padding", [(1, 0), (1, 1), (2, 0), (2, 1)])
def test_gradfix_conv_double_backward(stride, padding, groups):
    """`ops/gradfix.conv` (EG3D's conv2d_gradfix) gives PyTorch's own values
    for the output, both first-order gradients and both second-order ones,
    in float64 to 1e-9: it changes how the gradients are computed, not
    what."""
    from spi_tpu_torch.ops import gradfix

    def plain(x, w):
        return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)

    def run(op):
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(2, 4, 9, 9, dtype=torch.float64, generator=gen).requires_grad_(True)
        w = torch.randn(4, 4 // groups, 3, 3, dtype=torch.float64,
                        generator=gen).requires_grad_(True)
        y = op(x, w)
        v = torch.randn(y.shape, dtype=torch.float64, generator=gen)
        gx, gw = torch.autograd.grad((y * v).sum() + 0.1 * y.pow(3).sum(), (x, w),
                                     create_graph=True)
        return [y, gx, gw, *torch.autograd.grad(gx.square().sum() + gw.square().sum(), (x, w))]

    port = functools.partial(gradfix.conv, stride=stride, padding=padding, groups=groups)
    for got, want in zip(run(port), run(plain)):
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


def test_gradfix_conv2d_resample_matches():
    """The discriminator's resampling convolution (`ops/gradfix.
    conv2d_resample`) against `ops/conv.conv2d_resample` on PyTorch's own
    convolutions, down 1 and 2 with a 3x3 and a 1x1 kernel, and the
    R1-style second order through them (float64, 1e-9)."""
    from spi_tpu_torch.ops import conv2d_resample, gradfix, setup_filter

    f = setup_filter([1, 3, 3, 1]).double()

    def run(op, k, down):
        gen = torch.Generator().manual_seed(k)
        x = torch.randn(2, 4, 16, 16, dtype=torch.float64, generator=gen).requires_grad_(True)
        w = torch.randn(6, 4, k, k, dtype=torch.float64, generator=gen).requires_grad_(True)
        y = op(x, w, f=f, down=down, padding=k // 2)
        (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
        return [y, gx, *torch.autograd.grad(gx.square().sum(), (x, w))]

    for k in (3, 1):
        for down in (1, 2):
            for got, want in zip(run(gradfix.conv2d_resample, k, down),
                                 run(conv2d_resample, k, down)):
                torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)
