"""spi_tpu_torch/convert.py against spi_tpu/convert.py, on the CPU.

No published checkpoint is in the repository, so each test writes its own
file in the published layout: an EG3D persistence pickle of a
tiny_test_config generator's state under EG3D's torch names (a
`_reconstruct_persistent_obj(meta)` reduce call per module, whose meta
carries the module __dict__), in both of its forms, `torch.save` and
EG3D's own `pickle.dump`; plain state dicts; scripted modules for CLIP and
NVIDIA's vgg16.pt. spi_tpu/convert.py imports only torch and numpy, so
one process runs both converters on the same file: their npz files and
json are held equal bitwise. spi_tpu cannot read the `pickle.dump` form;
there the port is held to the tensors the test pickled.

Also the helpers `fov_to_intrinsics`, `imagenet_normalize` and
`count_params` against spi_tpu's, to 1e-6.
"""

import json
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spi_tpu import convert as JC
from spi_tpu.models import triplane as JT
from spi_tpu.models.perception import vgg as JVGG
from spi_tpu.utils import camera as jcam
from spi_tpu.utils import params as JP
from spi_tpu.utils.checkpoint import unflatten_to_nested
from spi_tpu_torch import convert as PC
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.models.perception import vgg as PVGG
from spi_tpu_torch.utils import camera as pcam
from spi_tpu_torch.utils import params as PP
from spi_tpu_torch.utils.checkpoint import load_flat_params, load_npz
from torch_threads import few_torch_threads  # noqa: F401

INIT_KWARGS = {"z_dim": 16, "c_dim": 25, "w_dim": 16, "img_resolution": 64,
               "img_channels": 3, "sr_num_fp16_res": 4, "beta": np.float64(0.5)}
RENDERING_KWARGS = {"depth_resolution": 6, "box_warp": 1.0, "superresolution_module":
                    "training.superresolution.SuperresolutionHybrid8XDC"}


def _reconstruct_persistent_obj(meta):  # pragma: no cover - never called
    raise AssertionError("the converter must not rebuild the module")


class _Persistent:
    """Pickles as EG3D's persistence does (persistence.py:37): a reduce call
    to torch_utils.persistence._reconstruct_persistent_obj(meta)."""

    def __init__(self, meta):
        self.meta = meta

    def __reduce__(self):
        return (_reconstruct_persistent_obj, (self.meta,))


class _EasyDict(dict):
    pass


def _meta(module, class_name, init_kwargs=None):
    """A persistence meta for `module`: its raw __dict__ state, the
    constant `resample_filter` buffers included as EG3D pickles them."""
    state = {
        "training": False,
        "_parameters": {k: v.detach().clone() for k, v in module._parameters.items()},
        "_buffers": {k: v.clone() for k, v in module._buffers.items()
                     if v is not None and (k not in module._non_persistent_buffers_set
                                           or k == "resample_filter")},
        "_modules": {k: _Persistent(_meta(m, type(m).__name__))
                     for k, m in module._modules.items()},
    }
    if init_kwargs is not None:
        state["_init_args"] = ()
        state["_init_kwargs"] = init_kwargs
    return {"type": "class", "version": 6, "class_name": class_name, "state": state,
            "module_src": "raise RuntimeError('the embedded class source was run')"}


@pytest.fixture(scope="module")
def fake_eg3d_modules():
    """EG3D's torch_utils.persistence and dnnlib, registered so that the
    pickles can name them; the converters resolve both to stubs."""
    pers = types.ModuleType("torch_utils.persistence")
    pers._reconstruct_persistent_obj = _reconstruct_persistent_obj
    dnnlib = types.ModuleType("dnnlib")
    dnnlib.EasyDict = _EasyDict
    saved = {k: sys.modules.get(k) for k in ("torch_utils", "torch_utils.persistence", "dnnlib")}
    _reconstruct_persistent_obj.__module__ = "torch_utils.persistence"
    _EasyDict.__module__, _EasyDict.__qualname__ = "dnnlib", "EasyDict"
    sys.modules.update({"torch_utils": types.ModuleType("torch_utils"),
                        "torch_utils.persistence": pers, "dnnlib": dnnlib})
    yield
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v
    _reconstruct_persistent_obj.__module__ = __name__
    _EasyDict.__module__, _EasyDict.__qualname__ = __name__, "_EasyDict"


@pytest.fixture(scope="module")
def eg3d_pickles(tmp_path_factory, fake_eg3d_modules):
    """(source generator, {form: path}) for the torch.save and pickle.dump
    forms of one EG3D network pickle."""
    g = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=7)
    with torch.no_grad():
        for name, t in g.named_parameters():
            if name.endswith("noise_strength"):
                t.fill_(0.1)
    kwargs = {**INIT_KWARGS, "rendering_kwargs": _EasyDict(RENDERING_KWARGS)}
    payload = {"G_ema": _Persistent(_meta(g, "TriPlaneGenerator", kwargs)),
               "training_set_kwargs": _EasyDict(resolution=64)}
    root = tmp_path_factory.mktemp("eg3d")
    paths = {"torch.save": str(root / "saved.pkl"), "pickle.dump": str(root / "dumped.pkl")}
    torch.save(payload, paths["torch.save"])
    with open(paths["pickle.dump"], "wb") as f:
        pickle.dump(payload, f)
    return g, paths


def _assert_npz_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _both(tmp_path, name, port_fn, ref_fn):
    """Run the port's and spi_tpu's converter into two npz files; returns
    (port npz, spi_tpu npz, port's returned dict)."""
    dst_p, dst_j = str(tmp_path / f"{name}_port.npz"), str(tmp_path / f"{name}_ref.npz")
    out = port_fn(dst_p)
    ref_fn(dst_j)
    return load_npz(dst_p), load_npz(dst_j), out


class TestEG3DPickle:
    def test_torch_save_form_equals_spi_tpu(self, eg3d_pickles, tmp_path):
        g, paths = eg3d_pickles
        src = paths["torch.save"]
        got, want, _ = _both(tmp_path, "eg3d", lambda d: PC.convert_eg3d(src, d),
                             lambda d: JC.convert_eg3d(src, d))
        _assert_npz_equal(got, want)
        port_json = (tmp_path / "eg3d_port.npz.json").read_text()
        assert port_json == (tmp_path / "eg3d_ref.npz.json").read_text()
        assert json.loads(port_json)["rendering_kwargs"] == RENDERING_KWARGS
        assert set(got) == set(g.state_dict())

    def test_pickle_dump_form(self, eg3d_pickles, tmp_path):
        """EG3D's own form: spi_tpu's torch.load raises on it; the port
        reads it, and gives back the tensors pickled, bitwise."""
        g, paths = eg3d_pickles
        src = paths["pickle.dump"]
        with pytest.raises(RuntimeError, match="magic number"):
            JC.convert_eg3d(src, str(tmp_path / "ref.npz"))
        mapped, init_kwargs = PC.convert_eg3d(src, str(tmp_path / "port.npz"))
        want = {k: v.numpy() for k, v in g.state_dict().items()}
        _assert_npz_equal(load_npz(str(tmp_path / "port.npz")), want)
        assert sorted(mapped) == sorted(want)
        assert init_kwargs == {**INIT_KWARGS, "beta": 0.5, "rendering_kwargs": RENDERING_KWARGS}
        with open(tmp_path / "port.npz.json") as f:
            assert json.load(f) == init_kwargs

    def test_stub_classes_and_walk(self, eg3d_pickles):
        _, paths = eg3d_pickles
        for src in paths.values():
            data = PC.load_persistence_pickle(src)
            assert isinstance(data["G_ema"], PC._PersistentStub)
            assert data["G_ema"].class_name == "TriPlaneGenerator"
            assert isinstance(data["training_set_kwargs"], PC._EasyDict)
            assert data["training_set_kwargs"].resolution == 64
            flat = {}
            PC._walk_module_state(data["G_ema"].state, "", flat)
            assert any(k.endswith("resample_filter") for k in flat)
            assert not any(k.endswith("resample_filter")
                           for k in PC.map_generator_names(flat))

    def test_converted_weights_synthesize_alike(self, eg3d_pickles, tmp_path):
        """The npz into the port's TriPlaneGenerator (load_flat_params) and
        into spi_tpu's (unflatten_to_nested): one synthesis on the same
        draws agrees to 1e-5 of the largest entry."""
        _, paths = eg3d_pickles
        PC.convert_eg3d(paths["pickle.dump"], str(tmp_path / "g.npz"))
        flat = load_npz(str(tmp_path / "g.npz"))
        pg = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=0)
        load_flat_params(pg, flat)
        jg = JT.tiny_test_config()
        params = jax.tree_util.tree_map(jnp.asarray, unflatten_to_nested(flat))

        ws = (np.random.default_rng(3).standard_normal((1, jg.num_ws, jg.w_dim)) * 0.5
              ).astype(np.float32)
        cam = np.asarray(jcam.canonical_camera(yaw=0.2))
        rng = jax.random.PRNGKey(5)
        jout = jax.jit(lambda p, w: jg.synthesis(p, rng, w, jnp.asarray(cam)))(
            params, jnp.asarray(ws))
        rend = jg.rendering
        with torch.no_grad():
            pout = pg.synthesis(torch.from_numpy(ws), torch.tensor(cam),
                                draws=_render_draws(rng, jg.neural_rendering_resolution ** 2,
                                                    rend.depth_resolution,
                                                    rend.depth_resolution_importance))
        for key in ("image", "image_raw", "image_depth"):
            want = np.asarray(jout[key])
            err = np.abs(pout[key].numpy() - want).max() / np.abs(want).max()
            assert err <= 1e-5, (key, err)


def _render_draws(rng, m, s, n_imp):
    """The renderer's draws as spi_tpu's single-camera synthesis makes them
    from `rng` (triplane.py:221, :260, renderer.py:421)."""
    rng_rest, _ = jax.random.split(rng)
    rng_render, _ = jax.random.split(rng_rest)
    rc, rf, _ = jax.random.split(rng_render, 3)
    return {
        "stratified": torch.from_numpy(np.array(jax.random.uniform(rc, (1, m, s, 1)))),
        "exponential": torch.from_numpy(np.array(jax.random.exponential(rf, (m, n_imp + 1)))),
    }


def _small_net():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4),
                               torch.nn.Linear(4, 2))


class TestStateDicts:
    @pytest.mark.parametrize("layout", ["plain", "nested", "prefixed"])
    def test_convert_state_dict(self, tmp_path, layout):
        sd = _small_net().state_dict()
        prefix = ""
        if layout == "nested":
            sd = {"state_dict": sd, "epoch": 3}
        elif layout == "prefixed":
            prefix = "module."
            sd = {prefix + k: v for k, v in sd.items()}
        src = str(tmp_path / "net.pth")
        torch.save(sd, src)
        got, want, out = _both(
            tmp_path, "sd", lambda d: PC.convert_state_dict(src, d, strip_prefix=prefix),
            lambda d: JC.convert_state_dict(src, d, strip_prefix=prefix))
        _assert_npz_equal(got, want)
        assert "0.weight" in got and "1.running_mean" in got
        assert "1.num_batches_tracked" not in got
        _assert_npz_equal(got, out)

    def test_torchvision_vgg(self, tmp_path, monkeypatch):
        """With a weights path; spi_tpu's call imports torchvision first, so
        it runs with a stub module in its place."""
        g = torch.Generator().manual_seed(1)
        sd = {"features.0.weight": torch.randn(4, 3, 3, 3, generator=g),
              "features.0.bias": torch.randn(4, generator=g),
              "features.2.weight": torch.randn(4, 4, 3, 3, generator=g).double(),
              "classifier.0.weight": torch.randn(2, 4, generator=g)}
        src = str(tmp_path / "vgg16.pth")
        torch.save(sd, src)
        monkeypatch.setitem(sys.modules, "torchvision", types.ModuleType("torchvision"))
        got, want, _ = _both(tmp_path, "vgg", lambda d: PC.convert_torchvision_vgg("vgg16", d, src),
                             lambda d: JC.convert_torchvision_vgg("vgg16", d, src))
        _assert_npz_equal(got, want)
        assert sorted(got) == ["features.0.bias", "features.0.weight", "features.2.weight"]
        assert got["features.2.weight"].dtype == np.float32

    def test_torchvision_vgg_needs_weights(self, tmp_path):
        for call in (lambda: PC.convert_torchvision_vgg("vgg19", str(tmp_path / "v.npz")),
                     lambda: PC.main(["vgg19", "-", str(tmp_path / "v.npz")])):
            with pytest.raises(ValueError, match="must be supplied"):
                call()
        assert not list(tmp_path.iterdir())


class _ClipLike(torch.nn.Module):
    """OpenAI CLIP's torchscript layout in small: fp16 weights, an attention
    mask buffer and the JIT scalars the converter drops."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(2)
        self.visual = torch.nn.Module()
        self.visual.conv1 = torch.nn.Conv2d(3, 8, 4, bias=False)
        self.transformer = torch.nn.Linear(8, 8)
        self.logit_scale = torch.nn.Parameter(torch.tensor(2.6592))
        self.register_buffer("attn_mask", torch.full((4, 4), float("-inf")).triu(1))
        self.register_buffer("input_resolution", torch.tensor(224))
        self.register_buffer("context_length", torch.tensor(77))
        self.register_buffer("vocab_size", torch.tensor(49408))
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
        self.half()

    def forward(self, x):
        return self.transformer(self.visual.conv1(x).flatten(1)) * self.logit_scale


class TestScripted:
    def test_clip_torchscript(self, tmp_path):
        src = str(tmp_path / "ViT-tiny.pt")
        torch.jit.save(torch.jit.script(_ClipLike()), src)
        got, want, _ = _both(tmp_path, "clip", lambda d: PC.convert_clip(src, d),
                             lambda d: JC.convert_clip(src, d))
        _assert_npz_equal(got, want)
        assert sorted(got) == ["logit_scale", "transformer.bias", "transformer.weight",
                               "visual.conv1.weight"]
        assert all(v.dtype == np.float32 for v in got.values())

    def test_clip_plain_state_dict(self, tmp_path):
        src = str(tmp_path / "clip.pt")
        torch.save(_ClipLike().state_dict(), src)
        got, want, _ = _both(tmp_path, "clip", lambda d: PC.convert_clip(src, d),
                             lambda d: JC.convert_clip(src, d))
        _assert_npz_equal(got, want)
        assert "attn_mask" not in got and "input_resolution" not in got
        assert got["visual.conv1.weight"].dtype == np.float32

    def test_nvidia_vgg16(self, tmp_path):
        """NVIDIA's torchscript layout: conv{b}_{i} convolutions and five
        (1, C, 1, 1) LPIPS heads."""
        class NvVGG(torch.nn.Module):
            def __init__(self):
                super().__init__()
                for name in JC._NV_VGG16_INDEX:
                    self.add_module(name, torch.nn.Conv2d(3, 2, 3))
                self.lin = torch.nn.ModuleList(
                    torch.nn.Conv2d(c, 1, 1, bias=False) for c in JC._LPIPS_CHANNELS)

            def forward(self, x):
                return self.conv1_1(x)

        torch.manual_seed(3)
        src = str(tmp_path / "vgg16.pt")
        torch.jit.save(torch.jit.script(NvVGG()), src)
        got, want, _ = _both(tmp_path, "nv", lambda d: PC.convert_nvidia_vgg16(src, d),
                             lambda d: JC.convert_nvidia_vgg16(src, d))
        _assert_npz_equal(got, want)
        assert [got[f"lin.{i}"].shape for i in range(5)] == [(c,) for c in JC._LPIPS_CHANNELS]
        assert "features.28.weight" in got


def test_main_every_kind(eg3d_pickles, tmp_path, monkeypatch):
    """`python -m spi_tpu_torch.convert <kind> <src> <dst>` for each kind
    writes what spi_tpu's main writes (eg3d: from the torch.save form)."""
    _, paths = eg3d_pickles
    sd_src = str(tmp_path / "irse50.pth")
    torch.save(_small_net().state_dict(), sd_src)
    vgg_src = str(tmp_path / "vgg.pth")
    torch.save({"features.0.weight": torch.ones(2, 3, 3, 3)}, vgg_src)
    clip_src = str(tmp_path / "clip.pt")
    torch.jit.save(torch.jit.script(_ClipLike()), clip_src)
    monkeypatch.setitem(sys.modules, "torchvision", types.ModuleType("torchvision"))
    for kind, src in (("eg3d", paths["torch.save"]), ("irse50", sd_src), ("vgg16", vgg_src),
                      ("vgg19", vgg_src), ("clip", clip_src)):
        got, want, _ = _both(tmp_path, kind, lambda d: PC.main([kind, src, d]),
                             lambda d: JC.main([kind, src, d]))
        _assert_npz_equal(got, want)
        assert got, kind
    PC.main(["eg3d", paths["pickle.dump"], str(tmp_path / "dumped.npz")])
    assert (tmp_path / "dumped.npz.json").exists()
    with pytest.raises(SystemExit):
        PC.main(["eg3d", paths["torch.save"]])


class TestHelpers:
    @pytest.mark.parametrize("fov", [12.0, 18.837, 30.0])
    def test_fov_to_intrinsics(self, fov):
        np.testing.assert_allclose(pcam.fov_to_intrinsics(fov).numpy(),
                                   np.asarray(jcam.fov_to_intrinsics(fov)), rtol=1e-6, atol=1e-6)

    def test_imagenet_normalize(self):
        x = np.random.default_rng(4).uniform(size=(2, 3, 5, 7)).astype(np.float32)
        np.testing.assert_allclose(PVGG.imagenet_normalize(torch.from_numpy(x)).numpy(),
                                   np.asarray(JVGG.imagenet_normalize(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)

    def test_count_params(self):
        net = _small_net()
        flat = {k: v.numpy() for k, v in net.state_dict().items()}
        tree = unflatten_to_nested(flat)
        assert PP.count_params(tree) == JP.count_params(tree) == PP.count_params(net.state_dict())
        assert PP.count_params(net) == sum(p.numel() for p in net.parameters())
        assert PP.count_params([torch.zeros(2, 3), (np.zeros(4),)]) == 10
