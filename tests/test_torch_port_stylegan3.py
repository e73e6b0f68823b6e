"""spi_tpu_torch StyleGAN3, filtered_lrelu and downsample2d against
spi_tpu, on the CPU.

The networks start from spi_tpu's init with every leaf moved off its
initial value (biases, affines, the input's transform, each layer's
magnitude_ema), read into the port through `flatten_pytree` and
`load_flat_params`; spi_tpu runs under one `jax.jit` of the whole network
and its gradient, built once a module. Tolerances, float32 on both sides:
outputs 1e-5 of the largest entry; gradients of the port's parameters
2e-3 of each one's largest entry (the float32 bound the generator tests
use); the magnitude EMA 1e-6. spi_tpu also differentiates the leaves that
are buffers in the port (magnitude_ema, freqs, phases, transform); those
enter the comparison through the forward.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu.models import stylegan3 as J
from spi_tpu.ops.filtered_lrelu import filtered_lrelu as j_filtered_lrelu
from spi_tpu.ops.upfirdn2d import downsample2d as j_downsample2d
from spi_tpu.ops.upfirdn2d import setup_filter as j_setup_filter
from spi_tpu.utils.checkpoint import flatten_pytree, unflatten_to_nested
from spi_tpu.utils.params import count_params as j_count_params
from spi_tpu_torch.models import stylegan3 as P
from spi_tpu_torch.ops import downsample2d, filtered_lrelu, setup_filter
from spi_tpu_torch.utils.checkpoint import load_flat_params
from spi_tpu_torch.utils.params import count_params
from torch_threads import few_torch_threads  # noqa: F401

NET_KW = dict(w_dim=16, img_resolution=16, img_channels=3, channel_base=64, channel_max=8)
GEN_KW = dict(z_dim=16, c_dim=0, **NET_KW)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


def _perturb(flat, seed):
    """Every leaf off its initial value (the mapping's w_avg too), so that
    a leaf read wrongly shows."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if k.endswith("magnitude_ema"):
            v = rng.uniform(0.5, 2.0, v.shape)
        elif k.endswith("transform"):
            v = v + 0.05 * rng.standard_normal(v.shape)
        elif k.endswith("w_avg"):
            v = rng.standard_normal(v.shape)
        elif k.endswith(("bias", "affine.weight")) and not k.startswith("mapping"):
            v = v + 0.1 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _jax_params(flat):
    return jax.tree_util.tree_map(jnp.asarray, unflatten_to_nested(flat))


class TestFilters:
    @pytest.mark.parametrize("args", [
        dict(numtaps=12, cutoff=2.0, width=6.0, fs=32),
        dict(numtaps=12, cutoff=8.0, width=4.0, fs=64, radial=True),
        dict(numtaps=13, cutoff=6.0, width=5.0, fs=48, radial=True),
        dict(numtaps=1, cutoff=2.0, width=6.0, fs=32),
    ], ids=["separable", "radial", "odd_radial", "identity"])
    def test_design_lowpass_filter_bitwise(self, args):
        got, want = P.design_lowpass_filter(**args), J.design_lowpass_filter(**args)
        if want is None:
            assert got is None
            return
        assert got.dtype == want.dtype == np.float32
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


def _filter(rng, taps, dim):
    if taps == 1:
        return None
    f = rng.uniform(0.1, 1.0, (taps,) if dim == 1 else (taps, taps))
    return (f / f.sum()).astype(np.float32)


@pytest.mark.parametrize("up,down,dim,clamp", [
    (1, 1, 1, None), (2, 2, 1, 0.5), (4, 2, 2, None), (2, 4, 2, 0.5),
    (4, 4, 1, 0.5), (1, 2, 2, None), (2, 1, 1, 0.3),
])
def test_filtered_lrelu(up, down, dim, clamp):
    rng = np.random.default_rng(10 * up + down + dim)
    x = rng.standard_normal((2, 3, 10, 11)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    fu, fd = _filter(rng, 3 * up, dim), _filter(rng, 2 * down + 2, dim)
    padding = [3, 2, 4, 1]
    kw = dict(b=b, up=up, down=down, padding=padding, clamp=clamp, slope=0.25, gain=1.3)
    want = np.asarray(j_filtered_lrelu(jnp.asarray(x), fu=fu, fd=fd, **kw))
    as_t = (lambda f: None if f is None else torch.from_numpy(f))
    got = filtered_lrelu(torch.from_numpy(x), fu=as_t(fu), fd=as_t(fd),
                         **{**kw, "b": torch.from_numpy(b)})
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("f,down,padding", [
    ([1, 3, 3, 1], 2, 0), ("random2d", 4, 1), ([1, 2, 1], (2, 1), [1, 0, 2, 1]),
])
def test_downsample2d(f, down, padding):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 16, 12)).astype(np.float32)
    if isinstance(f, str):
        f = rng.uniform(0.1, 1.0, (3, 3))
    jf, pf = j_setup_filter(f), setup_filter(f)
    want = np.asarray(j_downsample2d(jnp.asarray(x), jf, down=down, padding=padding))
    got = downsample2d(torch.from_numpy(x), pf, down=down, padding=padding)
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.fixture(scope="module")
def network_leaves():
    """spi_tpu's init of the 4-layer network, perturbed; the filter kind
    changes no leaf, so both kinds share it."""
    jn = J.SG3SynthesisNetwork(**NET_KW, num_layers=4)
    return _perturb(flatten_pytree(jax.jit(jn.init)(jax.random.PRNGKey(0))), 1)


@pytest.fixture(scope="module", params=[False, True], ids=["separable", "radial"])
def network(request, network_leaves):
    """A 4-layer SG3SynthesisNetwork: spi_tpu's output and gradients (one
    jit), its layer-by-layer forward with each magnitude_ema renewed from
    the layer's input first, and the port's network on the same leaves."""
    kw = dict(NET_KW, num_layers=4, use_radial_filters=request.param)
    jn = J.SG3SynthesisNetwork(**kw)
    flat = network_leaves
    params = _jax_params(flat)
    rng = np.random.default_rng(2)
    ws = rng.standard_normal((2, jn.num_ws, NET_KW["w_dim"])).astype(np.float32)
    r = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)

    def loss(p, w):
        y = jn(p, w)
        return jnp.sum(y * r), y

    (_, y), (gp, gw) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(ws))

    def ema_forward(p, w):
        """EG3D's update_emas order from spi_tpu's pieces: each layer's
        updated_magnitude_ema on its input, then the layer with it."""
        x = jn.input(p["input"], w[:, 0])
        emas = {}
        for idx in range(jn.num_layers + 1):
            name, layer = jn.layer_name(idx), jn.layer(idx)
            lp = layer.updated_magnitude_ema(p[name], x)
            emas[name] = lp["magnitude_ema"]
            x = layer(lp, x, w[:, idx + 1])
        return x * jn.output_scale, emas

    y_ema, emas = jax.jit(ema_forward)(params, jnp.asarray(ws))

    pn = P.SG3SynthesisNetwork(**kw, device="cpu")
    load_flat_params(pn, flat)
    return dict(jn=jn, flat=flat, ws=ws, r=r, y=np.asarray(y), gp=flatten_pytree(gp),
                gw=np.asarray(gw), y_ema=np.asarray(y_ema),
                emas={k: float(v) for k, v in emas.items()}, pn=pn)


class TestSynthesisNetwork:
    def test_names_and_buffers(self, network):
        pn, flat = network["pn"], network["flat"]
        assert list(pn.layer_names) == [network["jn"].layer_name(i) for i in range(5)]
        state = pn.state_dict()
        assert set(state) == set(flat)
        buffers = {k for k, _ in pn.named_buffers() if k in state}
        assert buffers == {k for k in flat if k.endswith(
            ("magnitude_ema", "freqs", "phases", "transform"))}
        for k, v in flat.items():
            np.testing.assert_array_equal(state[k].numpy(), v, err_msg=k)
        assert not any(k.endswith(("up_filter", "down_filter")) for k in state)

    def test_forward_and_gradients(self, network):
        pn = copy.deepcopy(network["pn"])
        ws = torch.from_numpy(network["ws"]).requires_grad_(True)
        y = pn(ws)
        (y * torch.from_numpy(network["r"])).sum().backward()
        assert _rel(y.detach().numpy(), network["y"]) <= 1e-5
        assert _rel(ws.grad.numpy(), network["gw"]) <= 2e-3
        errs = {k: _rel(p.grad.numpy(), network["gp"][k]) for k, p in pn.named_parameters()}
        assert len(errs) == sum(1 for k in network["flat"] if not k.endswith(
            ("magnitude_ema", "freqs", "phases", "transform")))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 2e-3, (worst, errs[worst])

    def test_magnitude_ema_update(self, network):
        pn = copy.deepcopy(network["pn"])
        with torch.no_grad():
            y = pn(torch.from_numpy(network["ws"]), update_emas=True)
        for name, want in network["emas"].items():
            got = float(getattr(pn, name).magnitude_ema)
            assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (name, got, want)
        assert _rel(y.numpy(), network["y_ema"]) <= 1e-5
        # The flag is off by default: a plain forward leaves every EMA.
        before = {k: v.clone() for k, v in pn.state_dict().items()}
        with torch.no_grad():
            pn(torch.from_numpy(network["ws"]))
        assert all(torch.equal(v, before[k]) for k, v in pn.state_dict().items())


@pytest.fixture(scope="module")
def generator():
    """A tiny SG3Generator (14 layers, 16², 8 channels at most): spi_tpu's
    output and parameter gradients under one jit, and the port's."""
    jg = J.SG3Generator(**GEN_KW)
    flat = _perturb(flatten_pytree(jax.jit(jg.init)(jax.random.PRNGKey(3))), 4)
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, GEN_KW["z_dim"])).astype(np.float32)
    r = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)

    def loss(p):
        y = jg(p, jnp.asarray(z), None, truncation_psi=0.7)
        return jnp.sum(y * r), y

    (_, y), gp = jax.jit(jax.value_and_grad(loss, has_aux=True))(_jax_params(flat))
    pg = P.SG3Generator(**GEN_KW, device="cpu", seed=0)
    load_flat_params(pg, flat)
    return dict(flat=flat, z=z, r=r, y=np.asarray(y), gp=flatten_pytree(gp), pg=pg)


class TestGenerator:
    def test_forward_and_gradients(self, generator):
        pg = generator["pg"]
        y = pg(torch.from_numpy(generator["z"]), None, truncation_psi=0.7)
        (y * torch.from_numpy(generator["r"])).sum().backward()
        assert y.shape == (2, 3, 16, 16)
        assert _rel(y.detach().numpy(), generator["y"]) <= 1e-5
        errs = {k: _rel(p.grad.numpy(), generator["gp"][k]) for k, p in pg.named_parameters()}
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 2e-3, (worst, errs[worst])
        assert len(errs) == len(list(pg.parameters())) > 40

    def test_seeded_init(self, generator):
        """The port's own init: seeded, finite, each input affine the
        identity transform and each magnitude_ema 1."""
        a = P.SG3Generator(**GEN_KW, device="cpu", seed=1).state_dict()
        b = P.SG3Generator(**GEN_KW, device="cpu", seed=1).state_dict()
        assert set(a) == set(generator["flat"])
        assert all(torch.equal(a[k], b[k]) and bool(torch.isfinite(a[k]).all()) for k in a)
        assert a["synthesis.input.affine.bias"].tolist() == [1.0, 0.0, 0.0, 0.0]
        assert not a["synthesis.input.affine.weight"].any()
        assert all(float(v) == 1.0 for k, v in a.items() if k.endswith("magnitude_ema"))

    def test_no_gpu_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no GPU"):
            P.SG3Generator(**GEN_KW)


def test_published_width_shapes():
    """StyleGAN3-T FFHQ-1024 (spi_tpu's SG3Generator defaults): every flat
    key and shape of the port's state equals jax.eval_shape of spi_tpu's
    init, 22,315,239 entries, parameters plus persistent buffers."""
    jg = J.SG3Generator(z_dim=512, c_dim=0, w_dim=512, img_resolution=1024, img_channels=3)
    shapes = jax.eval_shape(jg.init, jax.random.PRNGKey(0))
    want = {".".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    pg = P.SG3Generator(512, 0, 512, 1024, 3, device="meta")
    state = pg.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    assert pg.synthesis.layer_names[0] == "L0_36_512"
    assert pg.synthesis.layer_names[-1] == "L14_1024_3"
    assert len(pg.synthesis.layer_names) == 15
    assert count_params(state) == j_count_params(shapes) == 22_315_239
    buffers = sum(v.numel() for k, v in pg.named_buffers() if k in state)
    assert count_params(pg) + buffers == 22_315_239
