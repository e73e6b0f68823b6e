"""spi_tpu_torch's preprocess networks and host math against spi_tpu, on the
CPU: camera_math, extras, FAN (one hourglass module, and the released
four-module stack once), the ResNet-50 3DMM regressor, BiSeNet,
`run_total` on one synthetic 640^2 photo (FAN with one module and the
ResNet-50 with small nonzero heads on both sides; parsing left out, as
spi_tpu's own run_total test leaves it out) and PTIDatasetM. The
preprocess CLI is in tests/test_torch_port_preprocess_run.py.

Both sides get the same weights: a numpy draw from a seed for every key
of spi_tpu's parameter tree (`numpy_weights`, which
tests/test_torch_port_preprocess_run.py imports):
He-normal convolutions, batch norms away from the identity, nonzero
ResNet-50 heads, which spi_tpu zero-initialises and which would make the
comparison vacuous; carried over with
`load_flat_params`. spi_tpu's networks run under one `jax.jit` each, at
small inputs where a network allows it (BiSeNet at 128^2), and
`run_total` through its own jitted networks: on the CPU a whole-network
compile takes 1.3 s for FAN-1 and 1.5 s for the ResNet-50 where eager
dispatch compiles each operation for 9 s and 7 s.

Tolerances: camera math, extras and datasets bitwise (the same numpy and
PIL code on the same inputs); FAN heatmaps, ResNet-50 coefficients and
BiSeNet logits within 1e-4 of the largest entry (float32 convolutions
summed in other orders); decode_heatmaps on identical heatmaps exact;
parsing maps equal wherever the top two logits lie more than 1e-4 apart;
`run_total` the same success or failure, and on success the 25-value
label within 1e-5, the crops bitwise and the landmarks within 1e-4 (they
are argmax positions, so equal heatmaps up to float32 rounding give equal
landmarks).
"""

import json
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from spi_tpu.data import dataset as jdata
from spi_tpu.models.perception import bisenet as JB
from spi_tpu.models.perception import face_recon as JR
from spi_tpu.models.perception import fan as JF
from spi_tpu.preprocess import camera_math as jcm
from spi_tpu.preprocess import extras as jextras
from spi_tpu.preprocess import pipeline as jpipe
from spi_tpu.utils.checkpoint import unflatten_to_nested
from spi_tpu_torch.data import dataset as pdata
from spi_tpu_torch.models.perception import bisenet as PB
from spi_tpu_torch.models.perception import face_recon as PR
from spi_tpu_torch.models.perception import fan as PF
from spi_tpu_torch.preprocess import camera_math as pcm
from spi_tpu_torch.preprocess import extras as pextras
from spi_tpu_torch.preprocess import pipeline as ppipe
from spi_tpu_torch.tools.workloads import write_photo
from spi_tpu_torch.utils.checkpoint import load_flat_params
from torch_threads import few_torch_threads  # noqa: F401


def numpy_weights(jmodel, seed):
    """{dotted key: array} for every leaf of `jmodel.init`'s tree, drawn
    with numpy: He-normal conv weights, small biases, batch norms with
    scales near 1, shifts, means near 0 and variances above 1/2."""
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    shapes = {".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    flat = {}
    for k, s in sorted(shapes.items()):
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "weight" and len(s.shape) == 4:
            v = rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[1:]))
        elif leaf == "running_var":
            v = 0.5 + rng.rand(*s.shape)
        elif leaf == "weight":
            v = 1.0 + 0.1 * rng.randn(*s.shape)
        else:  # bias, running_mean
            v = 0.1 * rng.randn(*s.shape)
        flat[k] = np.asarray(v, np.float32)
    return flat


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------- camera math


@pytest.mark.parametrize("seed", range(4))
def test_camera_labels_bitwise(seed):
    rng = np.random.RandomState(seed)
    angle, trans = rng.randn(3) * 0.3, rng.randn(3) * 0.2
    pc, jc = pcm.cal_camera(angle, trans), jcm.cal_camera(angle, trans)
    for k in ("pose", "intrinsics"):
        np.testing.assert_array_equal(pc[k], jc[k])
    assert pc["angle"] == jc["angle"]
    label = pcm.process_camera(pc["pose"], pc["intrinsics"])
    np.testing.assert_array_equal(label, jcm.process_camera(jc["pose"], jc["intrinsics"]))
    np.testing.assert_array_equal(pcm.mirror_label(label), jcm.mirror_label(label))
    np.testing.assert_array_equal(pcm.compute_rotation(angle), jcm.compute_rotation(angle))
    np.testing.assert_array_equal(pcm.LM3D_STD, jcm.LM3D_STD)


def _face_landmarks(seed, size=640):
    """68 landmarks scattered about an oval in a `size` frame."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 2 * np.pi, 68, endpoint=False)
    lm = np.stack([size / 2 + size * 0.2 * np.cos(t), size * 0.5 + size * 0.25 * np.sin(t)], 1)
    return (lm + rng.randn(68, 2) * size * 0.02).astype(np.float32)


@pytest.mark.parametrize("seed", range(2))
def test_alignment_and_crop_bitwise(seed):
    img = Image.fromarray(np.random.RandomState(seed).randint(0, 255, (640, 600, 3), np.uint8))
    lm = _face_landmarks(seed)
    np.testing.assert_array_equal(pcm.extract_5p(lm), jcm.extract_5p(lm))
    for a, b in zip(pcm.pos(pcm.extract_5p(lm).T, pcm.LM3D_STD.T),
                    jcm.pos(jcm.extract_5p(lm).T, jcm.LM3D_STD.T)):
        np.testing.assert_array_equal(a, b)
    got, want = pcm.align_img(img, lm, pcm.LM3D_STD), jcm.align_img(img, lm, jcm.LM3D_STD)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))
    np.testing.assert_array_equal(np.asarray(pcm.crop_for_eg3d(img, lm, pcm.LM3D_STD)),
                                  np.asarray(jcm.crop_for_eg3d(img, lm, jcm.LM3D_STD)))


# --------------------------------------------------------------------------- extras


def test_mirror_padding_bitwise():
    img = Image.fromarray(np.random.RandomState(3).randint(0, 255, (40, 48, 3), np.uint8))
    np.testing.assert_array_equal(np.asarray(pextras.mirror_padding(img, pad=12)),
                                  np.asarray(jextras.mirror_padding(img, pad=12)))


def test_goae_export_bitwise(tmp_path):
    for name in ("b", "a"):
        (tmp_path / "crop" / name).mkdir(parents=True)
        (tmp_path / "c" / name).mkdir(parents=True)
        Image.fromarray(np.full((8, 8, 3), ord(name), np.uint8)).save(
            tmp_path / "crop" / name / "target.jpg")
        np.save(tmp_path / "c" / name / "target.npy",
                np.random.RandomState(ord(name)).randn(25).astype(np.float32))
    assert pextras.export_goae_format(str(tmp_path), str(tmp_path / "p")) == 2
    assert jextras.export_goae_format(str(tmp_path), str(tmp_path / "j")) == 2
    for f in ("label.json", "a.jpg", "b.jpg"):
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    assert [n for n, _ in json.loads((tmp_path / "p" / "label.json").read_text())["labels"]] == [
        "a.jpg", "b.jpg"]


def test_video2frames_without_cv2_names_the_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        pextras.video2frames(str(tmp_path / "v.mp4"), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


# --------------------------------------------------------------------------- networks


@pytest.fixture(scope="module")
def fan1():
    jf = JF.FAN(num_modules=1)
    flat = numpy_weights(jf, 1)
    pf = PF.FAN(num_modules=1, device="cpu")
    load_flat_params(pf, flat)
    return jf, unflatten_to_nested(flat), pf


def test_fan_heatmaps(fan1):
    jf, params, pf = fan1
    x = np.random.RandomState(5).rand(1, 3, 256, 256).astype(np.float32)
    want = np.asarray(jax.jit(jf.__call__)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pf(_t(x)).numpy()
    assert got.shape == (1, 68, 64, 64)
    assert _rel(got, want) <= 1e-4


def test_fan_four_modules():
    """The released 2DFAN4 stack: every parameter name loads, and the
    heatmaps agree."""
    jf = JF.FAN()
    flat = numpy_weights(jf, 2)
    pf = PF.FAN(device="cpu")
    load_flat_params(pf, flat)
    x = np.random.RandomState(6).rand(1, 3, 256, 256).astype(np.float32)
    want = np.asarray(jax.jit(jf.__call__)(unflatten_to_nested(flat), jnp.asarray(x)))
    with torch.no_grad():
        got = pf(_t(x)).numpy()
    assert _rel(got, want) <= 1e-4


def test_decode_heatmaps_exact():
    hm = np.random.RandomState(7).randn(2, 68, 64, 64).astype(np.float32)
    hm[0, 0] = 0.0
    hm[0, 0, 0, 10] = 1.0  # a peak on the border: no nudge
    hm[0, 1, 30, 20], hm[0, 1, 30, 21] = 9.0, 8.0  # a nudge toward +x
    got = PF.decode_heatmaps(_t(hm)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JF.decode_heatmaps(jnp.asarray(hm))))
    assert tuple(got[0, 0]) == (10.0, 0.0) and got[0, 1, 0] == 20.25


def test_landmarks_from_image(fan1):
    """A 320^2 image, resized to 256 with half-pixel bilinear and no
    antialias, and the landmarks scaled to the image."""
    jf, params, pf = fan1
    landmarks = jax.jit(lambda p, x, box: JF.landmarks_from_image(jf, p, x, bbox=box))
    x = np.random.RandomState(8).rand(1, 3, 320, 320).astype(np.float32)
    got = PF.landmarks_from_image(pf, _t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(landmarks(params, jnp.asarray(x), None)))
    box = np.array([[10.0, 20.0, 300.0, 310.0]], np.float32)
    np.testing.assert_allclose(
        PF.landmarks_from_image(pf, _t(x), bbox=_t(box)).numpy(),
        np.asarray(landmarks(params, jnp.asarray(x), jnp.asarray(box))), rtol=1e-6)


def test_face_recon_coefficients():
    jr = JR.FaceReconNet()
    flat = numpy_weights(jr, 3)
    for k in flat:
        if k.startswith("final_layers") and k.endswith("weight"):
            flat[k] = flat[k] * 0.05
    assert all(np.abs(v).max() > 0 for k, v in flat.items() if k.startswith("final_layers"))
    pr = PR.FaceReconNet(device="cpu")
    load_flat_params(pr, flat)
    x = np.random.RandomState(9).rand(1, 3, 224, 224).astype(np.float32)
    want = np.asarray(jax.jit(jr.__call__)(unflatten_to_nested(flat), jnp.asarray(x)))
    with torch.no_grad():
        got = pr(_t(x))
    assert got.shape == (1, 257) and _rel(got.numpy(), want) <= 1e-4
    split, jsplit = PR.FaceReconNet.split_coeff(got), JR.FaceReconNet.split_coeff(jnp.asarray(
        got.numpy()))
    assert list(split) == list(jsplit) and PR.COEFF_SPLIT == JR.COEFF_SPLIT
    for k in split:
        np.testing.assert_array_equal(split[k].numpy(), np.asarray(jsplit[k]))


def test_face_recon_heads_start_at_zero():
    """As the reference (networks.py:94-96) and spi_tpu: zero coefficients."""
    pr = PR.FaceReconNet(device="cpu")
    with torch.no_grad():
        assert float(pr(torch.rand(1, 3, 64, 64)).abs().max()) == 0.0


def test_bisenet_logits_and_parsing():
    jb = JB.BiSeNet()
    flat = numpy_weights(jb, 4)
    pb = PB.BiSeNet(device="cpu")
    load_flat_params(pb, flat)
    params = unflatten_to_nested(flat)
    x = np.random.RandomState(10).rand(1, 3, 128, 128).astype(np.float32)

    @jax.jit
    def logits_and_parse(params, x):
        xn = (x - JB.PARSING_MEAN[None, :, None, None]) / JB.PARSING_STD[None, :, None, None]
        return jb(params, xn), JB.parse_faces(jb, params, x)

    want, jparse = map(np.asarray, logits_and_parse(params, jnp.asarray(x)))
    got = PB.parse_logits(pb, _t(x)).numpy()
    assert got.shape == (1, 19, 128, 128)
    assert _rel(got, want) <= 1e-4
    parse = PB.parse_faces(pb, _t(x)).numpy()
    assert parse.dtype == np.int32 and parse.shape == (1, 128, 128)
    top2 = np.sort(want, axis=1)[:, -2:]
    close = (top2[:, 1] - top2[:, 0]) <= 1e-4
    assert np.array_equal(parse[~close], jparse[~close])


# --------------------------------------------------------------------------- run_total


@pytest.fixture(scope="module")
def weights():
    fan = numpy_weights(JF.FAN(num_modules=1), 21)
    recon = numpy_weights(JR.FaceReconNet(), 22)
    # Heads scaled so that the pose is a portrait's (angles about 0.1 rad,
    # translations about 0.05): the random backbone's features are large,
    # and coefficients of hundreds would turn float32 rounding into label
    # changes of 1e-4.
    for k in recon:
        if k.startswith("final_layers") and k.endswith("weight"):
            recon[k] = recon[k] * 5e-5
    return fan, recon


def test_run_total_matches_spi_tpu(weights, tmp_path):
    fan, recon = weights
    raw = tmp_path / "raw"
    raw.mkdir()
    write_photo(raw / "face0.png", seed=0)

    jmodels = jpipe.PreprocessModels(fan=(JF.FAN(num_modules=1), unflatten_to_nested(fan)),
                                     face_recon=(JR.FaceReconNet(), unflatten_to_nested(recon)))
    pf, pr = PF.FAN(num_modules=1, device="cpu"), PR.FaceReconNet(device="cpu")
    load_flat_params(pf, fan)
    load_flat_params(pr, recon)
    pmodels = ppipe.PreprocessModels(fan=pf, face_recon=pr)

    jres = jpipe.run_total(str(raw), str(tmp_path / "j"), jmodels, mirror=True, verbose=False)
    pres = ppipe.run_total(str(raw), str(tmp_path / "p"), pmodels, mirror=True, verbose=False)
    assert pres[0] == jres[0] == ["face0"]
    assert pres[1] == jres[1] == []
    for sub in ("c/face0/target.npy", "c/face0/target_m.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "p" / sub), np.load(tmp_path / "j" / sub),
                                   atol=1e-5, rtol=0)
    for sub in ("crop/face0/target.jpg", "crop/face0/target_m.jpg", "input/face0.png"):
        assert (tmp_path / "p" / sub).read_bytes() == (tmp_path / "j" / sub).read_bytes()
    np.testing.assert_allclose(np.load(tmp_path / "p" / "lm/face0/target.npy"),
                               np.load(tmp_path / "j" / "lm/face0/target.npy"), atol=1e-4)
    assert not (tmp_path / "p" / "mask" / "face0" / "target.npy").exists()


# --------------------------------------------------------------------------- PTIDatasetM


@pytest.fixture(scope="module")
def mirror_tree(tmp_path_factory):
    """Two identities: `twin` with every `_m` file (as run_preprocess
    --mirror writes crop and camera, plus mask and landmarks), `flip` with
    none, so that its twin is flipped on the fly."""
    root = tmp_path_factory.mktemp("mirror_tree")
    rng = np.random.RandomState(11)
    label = pcm.process_camera(**dict(zip(("pose", "intrinsics"), (
        lambda c: (c["pose"], c["intrinsics"]))(pcm.cal_camera([0.1, 0.3, 0.0],
                                                               [0.0, 0.1, 0.2])))))
    for name, with_m in (("twin", True), ("flip", False)):
        for d in ("crop", "c", "mask", "lm"):
            (root / d / name).mkdir(parents=True)
        for suffix in ("", "_m") if with_m else ("",):
            Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
                root / "crop" / name / f"target{suffix}.png")
            np.save(root / "c" / name / f"target{suffix}.npy",
                    label if not suffix else pcm.mirror_label(label))
            np.save(root / "mask" / name / f"target{suffix}.npy",
                    rng.randint(0, 19, (64, 64)).astype(np.int64))
            np.save(root / "lm" / name / f"target{suffix}.npy",
                    (rng.rand(68, 2) * 256).astype(np.float32))
    return {k: str(root / d) for k, d in (("source_root", "crop"), ("c_root", "c"),
                                          ("mask_root", "mask"), ("lm_root", "lm"))}


@pytest.mark.parametrize("size", [64, 32])
def test_pti_dataset_m_matches_spi_tpu(mirror_tree, size):
    pd = pdata.PTIDatasetM(**mirror_tree, mode="png", size=size)
    jd = jdata.PTIDatasetM(**mirror_tree, mode="png", size=size)
    assert len(pd) == len(jd) == 4
    names = []
    for a, b in zip(pd, jd):
        names.append(a.name)
        assert a.name == b.name
        for f in ("image", "camera", "mask", "landmarks"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert names == ["flip", "flip_m", "twin", "twin_m"]
    flipped = pd[1]
    np.testing.assert_array_equal(flipped.image, pd[0].image[:, :, :, ::-1])
    np.testing.assert_array_equal(flipped.camera, pcm.mirror_label(pd[0].camera[0])[None])
