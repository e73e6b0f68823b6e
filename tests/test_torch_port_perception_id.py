"""spi_tpu_torch's perception modules of the RotBbox stage and of the
metrics against spi_tpu, on the CPU: VGG19 up to conv2_1, the landmark
boxes, the BoxCX and BoxSmoothL1 losses, ArcFace IR-SE50, the ID
similarity, `Metric` and the metric log's text.

Weights: one set for both sides, made with numpy (VGG19) or by spi_tpu's
init (IR-SE50, with its batch-norm statistics and affines moved off
their identity values so that they count) and carried over with
`load_flat_params`.

Tolerances, float32 on both sides: features 1e-5 relative to their
largest entry (convolutions sum in another order); the BoxCX and
BoxSmoothL1 values 1e-4 relative; IR-SE50 embeddings and the ID
similarity 1e-4; the metric log's text exactly. The box losses'
gradient is ill-conditioned in float32: the CX weights divide each
distance by the smallest one and exponentiate, and max / min pick among
near ties. spi_tpu's own float32 gradient lies up to 5.3e-3 (256^2
inputs) and 1.1e-2 (512^2) of its largest entry from a float64
evaluation. So each gradient is held to the float64 port's: the port's
float32 gradient may be no farther from it, in its worst entry, than 1.5
times spi_tpu's float32 gradient is, and spi_tpu's float32 gradient
lies within 2e-2 of it (the float64 port computes spi_tpu's function).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.criteria import bbox_cx as jbox
from spi_tpu.criteria.id_loss import IDLoss as JIDLoss
from spi_tpu.criteria.lpips import LPIPS as JLPIPS
from spi_tpu.models.perception.arcface import IRSE50 as JIRSE50
from spi_tpu.models.perception.vgg import VGG19_CFG as J_VGG19_CFG
from spi_tpu.models.perception.vgg import VGGFeatures as JVGG
from spi_tpu.utils import metrics as jmetrics
from spi_tpu.utils.checkpoint import flatten_pytree
from spi_tpu_torch.criteria import bbox_cx as pbox
from spi_tpu_torch.criteria.id_loss import IDLoss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.models.perception.arcface import IRSE50
from spi_tpu_torch.models.perception.vgg import VGG19_CFG, VGGFeatures
from spi_tpu_torch.utils import metrics as pmetrics
from spi_tpu_torch.utils.checkpoint import load_flat_params
from torch_threads import few_torch_threads  # noqa: F401

SMALL_VGG = dict(cfg=(8, "M", 16, "M", 16), target_layers=(1, 4, 7))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close_rel(got, want, tol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3e} relative to max |want| > {tol}"


def landmarks(n, scale=256.0, seed=0):
    """68 points on an ellipse about the middle of a face crop, at `scale`."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    base = np.stack([0.5 + 0.23 * np.cos(t), 0.47 + 0.29 * np.sin(t)], -1) * scale
    return (base[None] + rng.uniform(-3, 3, (n, 68, 2))).astype(np.float32)


@pytest.fixture(scope="module")
def vgg19():
    rng = np.random.RandomState(8)
    flat = {}
    for idx, kind, cin, cout in JVGG(cfg=J_VGG19_CFG).module_list():
        if kind == "conv":
            flat[f"features.{idx}.weight"] = (rng.randn(cout, cin, 3, 3)
                                              * np.sqrt(2.0 / (cin * 9))).astype(np.float32)
            flat[f"features.{idx}.bias"] = (rng.randn(cout) * 0.1).astype(np.float32)
    return flat


def test_vgg19_cfg():
    assert VGG19_CFG == J_VGG19_CFG


def test_vgg19_conv2_1(vgg19):
    x = _rand(2, 3, 40, 40, seed=1)
    want = JVGG(cfg=J_VGG19_CFG, target_layers=(5,))({k: _j(v) for k, v in vgg19.items()},
                                                      _j(x))[0]
    net = VGGFeatures(cfg=VGG19_CFG, target_layers=(5,), device="cpu")
    load_flat_params(net, vgg19)
    with torch.no_grad():
        got = net(_t(x))[0]
    assert tuple(got.shape) == (2, 128, 20, 20)
    _close_rel(got.numpy(), want, 1e-5)


def test_landmark_boxes():
    lm = landmarks(3)
    for got, want in zip(pbox.landmark_boxes(_t(lm)), jbox.landmark_boxes(_j(lm))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cosine_distance_and_cx():
    x, y = _rand(2, 16, 6, 6, seed=2), _rand(2, 16, 6, 6, seed=3)
    want = jbox._cosine_distance(_j(x), _j(y))
    got = pbox._cosine_distance(_t(x), _t(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pbox._cx(got, 0.5).numpy(), np.asarray(jbox._cx(want, 0.5)),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("loss", ["BoxCXLoss", "BoxLoss"])
@pytest.mark.parametrize("size", [256, 512])
def test_box_losses(vgg19, loss, size):
    """The value and its gradient with respect to x, at the coach's batch
    of 4 (512^2 inputs are resized to 256 first)."""
    rng = np.random.RandomState(size)
    x = np.tanh(rng.randn(4, 3, size, size)).astype(np.float32)
    y = np.tanh(x + 0.3 * rng.randn(4, 3, size, size)).astype(np.float32)
    lm = landmarks(4, seed=5)
    jl = getattr(jbox, loss)()
    jparams = {"vgg": {k: _j(v) for k, v in vgg19.items()}}
    jvalue, jgrad = jax.jit(jax.value_and_grad(lambda a: jl(jparams, a, _j(y), _j(lm))))(_j(x))
    pl = getattr(pbox, loss)(device="cpu")
    load_flat_params(pl, {f"vgg.{k}": v for k, v in vgg19.items()})
    grads = {}
    for dtype in (torch.float32, torch.float64):
        tx = _t(x).to(dtype).requires_grad_(True)
        value = pl.to(dtype)(tx, _t(y).to(dtype), _t(lm).to(dtype))
        value.backward()
        np.testing.assert_allclose(value.item(), float(jvalue), rtol=1e-4)
        grads[dtype] = tx.grad.numpy()
    ref = grads[torch.float64]
    scale = np.abs(ref).max()
    err_p = np.abs(grads[torch.float32] - ref) / scale
    err_j = np.abs(np.asarray(jgrad, np.float64) - ref) / scale
    assert err_j.max() <= 2e-2, err_j.max()
    assert err_p.max() <= 1.5 * err_j.max(), (err_p.max(), err_j.max())


@pytest.fixture(scope="module")
def irse50():
    """spi_tpu's IR-SE50 init, batch norms moved off the identity, and each
    unit's residual branch scaled down by its last batch norm (0.1 x), as
    a trained network keeps it: with He-normal branches at full scale the
    activations grow 10^4-fold over the 24 units and float32 rounding
    with them (on both sides: the units agree to 5e-7 of their size at
    the input and to 4e-2 at the output)."""
    params = JIRSE50().init(jax.random.PRNGKey(3))
    flat = flatten_pytree(params)
    rng = np.random.RandomState(4)
    for k, v in flat.items():
        if k.endswith("running_mean"):
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("running_var"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("res_layer.4.weight"):
            flat[k] = rng.uniform(0.05, 0.15, v.shape).astype(np.float32)
        elif k.endswith(".bias") and v.ndim == 1 and "output_layer.3" not in k:
            flat[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    net = IRSE50(device="cpu")
    load_flat_params(net, flat)  # one-to-one: the port's names are spi_tpu's
    return _unflatten_like(params, flat), net


def _unflatten_like(tree, flat):
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    leaves = []
    for path, _ in paths:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        leaves.append(_j(flat[key]))
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree), leaves)


def test_irse50_embeddings(irse50):
    jparams, net = irse50
    x = np.tanh(_rand(2, 3, 112, 112, seed=6))
    want = jax.jit(JIRSE50())(jparams, _j(x))
    with torch.no_grad():
        got = net(_t(x))
    assert tuple(got.shape) == (2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, rtol=1e-5)


def test_id_similarity_and_loss(irse50):
    """256^2 inputs: the face crop's 188 -> 112 resize, the similarity and
    1 - similarity."""
    jparams, net = irse50
    x = np.tanh(_rand(2, 3, 256, 256, seed=7))
    y = np.tanh(x + _rand(2, 3, 256, 256, seed=8, scale=0.5))
    jid = JIDLoss()
    jp = {"facenet": jparams}
    pid = IDLoss(device="cpu")
    pid.facenet.load_state_dict(net.state_dict())
    with torch.no_grad():
        sim = pid.similarity(_t(x), _t(y))
        loss = pid(_t(x), _t(y))
    np.testing.assert_allclose(sim.numpy(), np.asarray(jax.jit(jid.similarity)(jp, _j(x), _j(y))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(jax.jit(jid)(jp, _j(x), _j(y))),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size", [128, 512])
def test_metric_run(irse50, size):
    """l2, LPIPS and the ID similarity of a pair, the tiny config's 128^2
    (upsampled to 256) and the full 512^2 (pooled to 256)."""
    jparams, net = irse50
    jl = JLPIPS(remat=False, **SMALL_VGG)
    jlp = jl.init(jax.random.PRNGKey(7))
    jm = jmetrics.Metric(lpips=jl)
    gt = np.tanh(_rand(1, 3, size, size, seed=9))
    fake = np.tanh(gt + _rand(1, 3, size, size, seed=10, scale=0.4))
    want = jm.run({"lpips": jlp, "id": {"facenet": jparams}}, _j(gt), _j(fake))
    pl = LPIPS(device="cpu", **SMALL_VGG)
    load_flat_params(pl, flatten_pytree(jlp))
    pid = IDLoss(device="cpu")
    pid.facenet.load_state_dict(net.state_dict())
    metric = pmetrics.Metric(pl, pid)
    assert set(metric.state_dict()) == set(flatten_pytree(
        {"lpips": jlp, "id": {"facenet": jparams}}))
    got = metric.run(_t(gt), _t(fake))
    assert set(got) == set(want) == {"l2", "lpips", "id"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)


def test_metric_log_text():
    entries = [({"l2": 0.5, "lpips": 0.25, "id": 0.75}, {"l2": 0.125, "lpips": 0.5, "id": 0.1}),
               ({"l2": 1.5, "lpips": 0.05, "id": 0.6}, None)]
    jlog, plog = jmetrics.MetricLog(), pmetrics.MetricLog()
    for values, mirrored in entries:
        jlog.add("G1_inv", values, mirrored)
        plog.add("G1_inv", values, mirrored)
    plog.add("G2_inv", {"l2": 2.0}, None)
    jlog.add("G2_inv", {"l2": 2.0}, None)
    header = "Coach name: x\nfirst_inv_type: mir\n"
    assert plog.render(header) == jlog.render(header)
    assert plog.render() == jlog.render()
