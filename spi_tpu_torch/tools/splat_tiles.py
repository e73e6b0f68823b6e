"""The splat kernel's ray tile against its time, at full-width render passes.

    python -m spi_tpu_torch.tools.splat_tiles [--tiles 16,4,4 32,2,4 ...]

Builds ffhq512_128_config at its published widths with random seeded
weights (tools/step_time.py's model) and takes the points that
`sample_from_planes` receives in one render: the canonical camera's coarse
pass (`coarse_pass_points`) and fine pass, and the 'mir' two-camera coarse
pass (`render_points`); `rotbbox_points` gives the RotBbox regularizers'
four-camera coarse and fine passes and the TV loss's free points, which
chip_smoke.py phase 2 also checks. For each tile (rays down, rays across, samples) it
prints the reductions the kernel issues (distinct (tile, plane, texel) keys
x channel groups, counted by `splat_tiled` in plain PyTorch), the kernel's
device-only time and its error against `splat_plain`. `chip_smoke.py`
phase 2 uses the same points. Needs a CUDA device.
"""

from __future__ import annotations

import argparse

import torch

DEFAULT_TILES = ((16, 4, 4), (32, 2, 4), (16, 2, 8), (32, 4, 4), (32, 2, 8), (16, 8, 4))


def coarse_pass_points(dev, res=128, samples=48):
    """The coarse render pass's sample points: canonical camera, res^2
    rays, `samples` stratified depths -> (1, res^2 * samples, 3)."""
    from spi_tpu_torch.models.rendering import sample_rays
    from spi_tpu_torch.models.rendering.renderer import sample_stratified
    from spi_tpu_torch.utils import camera as cam

    c = cam.canonical_camera(device=dev)
    ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4), c[:, 16:].reshape(-1, 3, 3), res)
    gen = torch.Generator(device=dev).manual_seed(0)
    depths = sample_stratified(ro, 2.25, 3.3, samples, generator=gen)
    return (ro[:, :, None] + depths * rd[:, :, None]).reshape(1, -1, 3).contiguous()


def render_points(dev, model):
    """The points and ray geometry that the renderer hands `sample_from_planes`
    in one full-width render of step_time's model (canonical camera) and in
    one of the 'mir' projector's two cameras (one set of planes): {'fine':
    the single camera's importance pass, 'two-camera': the two cameras'
    coarse pass}, each ((1, P, 3) points, RayGeom)."""
    from spi_tpu_torch.models.rendering import renderer
    from spi_tpu_torch.tools.step_time import MIR_YAW
    from spi_tpu_torch.utils import camera as cam

    g, _, _, camera = model
    seen = []
    sample_from_planes = renderer.sample_from_planes

    def spy(planes, coordinates, box_warp, geom=None):
        seen.append((coordinates.detach().reshape(1, -1, 3).contiguous(), geom))
        return sample_from_planes(planes, coordinates, box_warp, geom)

    gen = torch.Generator(device=dev).manual_seed(14)
    renderer.sample_from_planes = spy
    try:
        with torch.no_grad():
            ws = g.mapping(torch.randn(1, g.z_dim, device=dev, generator=gen), camera)
            planes = g.planes_nhwc(ws)
            g.synthesis_from_planes(planes, ws, camera, generator=gen)
            yawed = cam.canonical_camera(yaw=MIR_YAW, device=dev)
            g.synthesis_from_planes(planes, ws, torch.cat([yawed, cam.mirror_camera(yawed)]),
                                    generator=gen)
    finally:
        renderer.sample_from_planes = sample_from_planes
    return {"fine": seen[1], "two-camera": seen[2]}


def rotbbox_points(dev, model, rot_bs=4):
    """The points the RotBbox regularizers hand `sample_from_planes` (TV
    at its default 1000 + 1000 points): {'four-camera' and 'four-camera
    fine': the rot term's coarse and importance passes over `rot_bs`
    cameras around step_time's camera (the mirror term and the tuned
    depth render make the same two), 'tv': the TV loss's free points},
    each ((1, P, 3) points, RayGeom or None)."""
    from spi_tpu_torch.criteria.tv_loss import tv_loss
    from spi_tpu_torch.models.rendering import renderer
    from spi_tpu_torch.utils import camera as cam

    g, _, _, camera = model
    seen = []
    sample_from_planes = renderer.sample_from_planes

    def spy(planes, coordinates, box_warp, geom=None):
        seen.append((coordinates.detach().reshape(1, -1, 3).contiguous(), geom))
        return sample_from_planes(planes, coordinates, box_warp, geom)

    gen = torch.Generator(device=dev).manual_seed(16)
    renderer.sample_from_planes = spy
    try:
        with torch.no_grad():
            ws = g.mapping(torch.randn(1, g.z_dim, device=dev, generator=gen), camera)
            planes = g.planes_nhwc(ws)
            cams = cam.sample_surrounding_camera(camera, rot_bs, 0.2, 0.1, generator=gen)
            g.synthesis_from_planes(planes, ws, cams, generator=gen, want_sr=False)
            tv_loss(g, ws, rng=gen, planes=planes)
    finally:
        renderer.sample_from_planes = sample_from_planes
    return {"four-camera": seen[0], "four-camera fine": seen[1], "tv": seen[2]}


def run(dev, tiles=DEFAULT_TILES, c=32, h=256, w=256):
    """{(pass, tile): (reductions, device ms, error relative to max |plain|)}."""
    from spi_tpu_torch.ops import plane_splat as ps
    from spi_tpu_torch.tools import step_time
    from spi_tpu_torch.tools.timing import device_ms

    model = step_time.build_model(dev)
    passes = {"coarse": (coarse_pass_points(dev), ps.RayGeom(1, 128, 128, 48)),
              **render_points(dev, model)}
    del model
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for label, (coords, geom) in passes.items():
        g = torch.randn(1, 3, coords.shape[1], c, device=dev, generator=gen)
        want = ps.splat_plain(coords, g, 1.0, h, w)
        for tile in tiles:
            got = ps.splat_cuda(coords, g, 1.0, h, w, geom, tile)
            err = float((got - want).abs().max() / want.abs().max())
            keys = ps.splat_tiled(coords, g, 1.0, h, w, geom, tile)[1]
            ms = device_ms(lambda: ps.splat_cuda(coords, g, 1.0, h, w, geom, tile))
            out[label, tile] = (keys * (c // 4), ms, err)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", nargs="+", default=[",".join(map(str, t)) for t in DEFAULT_TILES],
                    help="ray tiles as rows,columns,samples (at most 512 points)")
    args = ap.parse_args(argv)
    tiles = [tuple(int(v) for v in t.split(",")) for t in args.tiles]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for (label, tile), (reductions, ms, err) in run(dev, tiles).items():
        print(f"{label:10s} tile {tile}: {reductions} reductions, device-only {ms:.4f} ms, "
              f"error {err:.2e} ({torch.cuda.get_device_name(dev)})", flush=True)


if __name__ == "__main__":
    main()
