"""spi_tpu_torch's inference outputs against spi_tpu, on the CPU: the
orbit video (utils/video.py), the shape export (utils/shape.py) and
cli/run_video.py. The inversion CLI's --save_video is in
tests/test_torch_port_outputs_cli.py.

Both sides get one set of tiny_test_config weights (the port's seeded
init, read into spi_tpu's tree with `unflatten_to_nested`: spi_tpu's
eager init would compile each of its operations, some 8 s on the CPU),
and the port gets spi_tpu's renderer draws
where renders are compared: spi_tpu renders every orbit chunk with
PRNGKey(0).

Tolerances: orbit images in float32 within 1e-4 of the largest entry (the
synthesis in two frameworks, as tests/test_torch_port_generator.py), so
their uint8 frames within one level; density grids within 1e-4 of the
largest entry; orbit cameras within 1e-6 (the same formulas); marching
tetrahedra, the PLY text and the encoders' files bitwise (the same numpy
code on the same inputs).
"""

import math
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from spi_tpu.models import triplane as JT
from spi_tpu.utils import camera as jcam
from spi_tpu.utils import shape as jshape
from spi_tpu.utils import video as jvideo
from spi_tpu.utils.checkpoint import save_pytree, unflatten_to_nested
from spi_tpu_torch.cli import run_video
from spi_tpu_torch.models import TriPlaneGenerator, tiny_test_config
from spi_tpu_torch.utils import shape as pshape
from spi_tpu_torch.utils import video as pvideo
from spi_tpu_torch.utils.checkpoint import load_flat_params, module_flat
from torch_threads import few_torch_threads  # noqa: F401


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def gens():
    """spi_tpu's tiny generator with noise strengths 0.1 (so that the noise
    maps count), the port's with the same weights, and a random w."""
    pg = TriPlaneGenerator(tiny_test_config(), device="cpu", seed=0)
    flat = {k: np.full_like(v, 0.1) if k.endswith("noise_strength") else v
            for k, v in module_flat(pg).items()}
    assert sum(k.endswith("noise_strength") for k in flat) > 0
    load_flat_params(pg, flat)
    jg = JT.tiny_test_config()
    params = unflatten_to_nested(flat)
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(jax.eval_shape(jg.init, jax.random.PRNGKey(0))))
    w = (np.random.RandomState(4).randn(1, pg.num_ws, pg.w_dim) * 0.5).astype(np.float32)
    return jg, params, pg, w


def _chunk_draws(jg, batch=4):
    """The renderer's draws of spi_tpu's orbit chunk, synthesis with
    PRNGKey(0) (triplane.py:220, :260; renderer.py:421)."""
    rng_rest, _ = jax.random.split(jax.random.PRNGKey(0))
    rng_render, _ = jax.random.split(rng_rest)
    rc, rf, _ = jax.random.split(rng_render, 3)
    m = jg.neural_rendering_resolution ** 2
    rend = jg.rendering
    return {
        "stratified": torch.from_numpy(np.array(
            jax.random.uniform(rc, (batch, m, rend.depth_resolution, 1)))),
        "exponential": torch.from_numpy(np.array(
            jax.random.exponential(rf, (batch * m, rend.depth_resolution_importance + 1)))),
    }


def _jax_orbit_cameras(n, yaw=0.5, pitch=0.15):
    """spi_tpu's orbit (render_orbit_frames:42-47)."""
    return jnp.concatenate([
        jcam.canonical_camera(yaw=yaw * math.sin(2 * math.pi * t),
                              pitch=pitch * math.cos(2 * math.pi * t))
        for t in np.linspace(0, 1, n, endpoint=False)], axis=0)


def test_orbit_cameras():
    got = pvideo.orbit_cameras(7, 0.4, 0.2).numpy()
    np.testing.assert_allclose(got, np.asarray(_jax_orbit_cameras(7, 0.4, 0.2)), atol=1e-6)


def test_orbit_images_and_frames_match_spi_tpu(gens):
    """6 frames: one full chunk of 4 and one padded chunk of 2."""
    jg, params, pg, w = gens
    cams = _jax_orbit_cameras(6)
    render = jvideo._orbit_render_fn(jg)
    padded = jnp.concatenate([cams, jnp.tile(cams[-1:], (2, 1))])
    want = np.concatenate([np.asarray(render(params, jnp.asarray(w), padded[i:i + 4]))
                           for i in (0, 4)])[:6]
    got = pvideo.render_orbit_images(pg, torch.from_numpy(w), num_frames=6,
                                     draws=_chunk_draws(jg))
    assert got.shape == (6, 3, 128, 128)
    assert _rel(got.numpy(), want) <= 1e-4
    frames = pvideo.render_orbit_frames(pg, torch.from_numpy(w), num_frames=6,
                                        draws=_chunk_draws(jg))
    jframes = jvideo.render_orbit_frames(jg, params, jnp.asarray(w), num_frames=6)
    assert frames.dtype == np.uint8 and frames.shape == jframes.shape == (6, 128, 128, 3)
    assert np.abs(frames.astype(int) - jframes.astype(int)).max() <= 1


@pytest.mark.parametrize("imageio", ["present", "absent"])
def test_encoder_chain_writes_what_spi_tpu_writes(tmp_path, monkeypatch, imageio):
    """mp4 through imageio, else a GIF (here: imageio without ffmpeg), else
    `<path>.frames.npz` (imageio absent): the same file, byte for byte, as
    spi_tpu's render_orbit_video writes for the same frames."""
    frames = np.random.RandomState(0).randint(0, 255, (3, 16, 16, 3)).astype(np.uint8)
    if imageio == "absent":
        monkeypatch.setitem(sys.modules, "imageio", None)
        monkeypatch.setitem(sys.modules, "imageio.v2", None)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    written = pvideo.write_frames(frames, str(tmp_path / "p" / "v.mp4"), fps=10)
    monkeypatch.setattr(jvideo, "render_orbit_frames", lambda *a, **k: frames)
    jvideo.render_orbit_video(None, None, None, str(tmp_path / "j" / "v.mp4"), fps=10)
    assert os.listdir(tmp_path / "p") == os.listdir(tmp_path / "j") == [os.path.basename(written)]
    if imageio == "absent":
        assert written.endswith(".mp4.frames.npz")
    with open(written, "rb") as f, open(tmp_path / "j" / os.path.basename(written), "rb") as g:
        assert f.read() == g.read()


def test_density_grid_matches_spi_tpu(gens):
    """A 12^3 grid in chunks of 500 points (the last one short; spi_tpu
    pads it)."""
    jg, params, pg, w = gens
    want = jshape.sample_density_grid(jg, params, jnp.asarray(w), resolution=12, max_batch=500)
    got = pshape.sample_density_grid(pg, torch.from_numpy(w), resolution=12, max_batch=500)
    assert got.shape == want.shape == (12, 12, 12) and got.dtype == np.float32
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("level", [0.1, 10.0, -5.0])
def test_mesh_and_ply_bitwise(tmp_path, monkeypatch, level):
    """marching_tetrahedra, the level clamp, the world coordinates and the
    PLY text against spi_tpu's extract_shape on the same density grid (a
    sphere plus noise; at level -5 no surface crosses the grid range)."""
    r = 14
    ax = np.linspace(-1, 1, r)
    xx, yy, zz = np.meshgrid(ax, ax, ax, indexing="ij")
    sig = (1.0 - (xx ** 2 + yy ** 2 + zz ** 2)) * 3.0
    sig = (sig + np.random.RandomState(1).randn(r, r, r) * 0.2).astype(np.float32)
    vp, fp = pshape.marching_tetrahedra(sig, 0.1)
    vj, fj = jshape.marching_tetrahedra(sig, 0.1)
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_array_equal(fp, fj)
    assert len(fp) > 100 and vp.dtype == np.float32

    monkeypatch.setattr(jshape, "sample_density_grid", lambda *a, **k: sig)
    vj, fj = jshape.extract_shape(None, None, None, path=str(tmp_path / "j.ply"),
                                  resolution=r, level=level)
    vp, fp = pshape.mesh_from_grid(sig, level)
    pshape.write_ply(str(tmp_path / "p.ply"), vp, fp)
    np.testing.assert_array_equal(vp, vj)
    np.testing.assert_array_equal(fp, fj)
    assert (tmp_path / "p.ply").read_text() == (tmp_path / "j.ply").read_text()


def test_run_video_reads_a_spi_tpu_artifact(gens, tmp_path):
    """An artifact npz written by spi_tpu's `save_pytree` ({w, c, G}) through
    the port's run_video with a shape: 5 frames, a video file, a mesh whose
    PLY the port's extract_shape gives for the same weights."""
    jg, params, pg, w = gens
    ckpt = str(tmp_path / "face0.npz")
    save_pytree(ckpt, {"w": jnp.asarray(w), "c": jcam.canonical_camera(), "G": params})
    out = run_video.main(["--checkpoint", ckpt, "--output", str(tmp_path / "face0.mp4"),
                          "--frames", "5", "--shape", str(tmp_path / "face0.ply"),
                          "--shape_resolution", "16", "--tiny", "--fp32", "--device", "cpu"])
    assert out["frames"].shape == (5, 128, 128, 3) and out["frames"].dtype == np.uint8
    assert os.path.exists(out["video"])
    pshape.extract_shape(pg, torch.from_numpy(w), path=str(tmp_path / "want.ply"), resolution=16)
    assert (tmp_path / "face0.ply").read_text() == (tmp_path / "want.ply").read_text()
    assert len(out["verts"]) > 0 and len(out["faces"]) > 0
    with pytest.raises(ValueError, match="no inversion artifact"):
        np.savez(tmp_path / "bad.npz", x=np.zeros(2))
        run_video.main(["--checkpoint", str(tmp_path / "bad.npz"), "--output", "unused",
                        "--tiny", "--device", "cpu"])


def test_video_frames_are_images(tmp_path):
    """The GIF the chain writes here decodes to the frames it was given."""
    frames = np.random.RandomState(2).randint(0, 255, (2, 8, 8, 3)).astype(np.uint8)
    written = pvideo.write_frames(frames, str(tmp_path / "x.mp4"))
    if written.endswith(".gif"):
        im = Image.open(written)
        assert im.n_frames == 2 and im.size == (8, 8)
