"""Scatter decision probes (counterpart of tools/probe_scatter_r5.py).

    python -m spi_tpu_torch.tools.probe_scatter

1. `dup_stats`: with the port's own ray sampler and stratified depths
   (canonical camera, 128^2 rays x 48 samples), how many distinct
   texels each plane's points land on, and how often neighbours along
   the sample, image-row and image-column axes share one.
2. The PyTorch analogue of each XLA operation the JAX tool timed, with
   CUDA events: `index_add_` of 786k rows of 128 (bf16 values held in
   f32, converted once outside the timed calls, into an f32 table), the
   same with 50% and 90% of the rows out of range (dropped: sent to a
   sink row past the table), `sort`, `argsort` and a key-value sort of
   4.7M int32 keys, and `cumsum` over (786k, 32) f32. The
   `row_scatter_add` kernel runs beside `index_add_` on the same rows and
   updates, where rows out of range are dropped by the kernel itself.
3. The `row_scatter_add` kernel where the JAX tool ran its serial Pallas
   read-modify-write: 786k rows of 32 f32 into 65,536, against
   `index_add_`.
Every kernel case is also held against the plain version (`check`).
"""

from __future__ import annotations

import numpy as np
import torch

from spi_tpu_torch.models.rendering import sample_rays
from spi_tpu_torch.models.rendering.renderer import project_onto_planes, sample_stratified
from spi_tpu_torch.ops.gather_scatter import row_scatter_add, row_scatter_add_plain
from spi_tpu_torch.ops.grid_sample import texel_coords
from spi_tpu_torch.tools.timing import card_label, time_ms
from spi_tpu_torch.utils import camera as cam
from spi_tpu_torch.utils.device import resolve_device

H = W = 256
C = 32
QUAD = 4 * C
N_ROWS = 16384 * 48


def realistic_texels(device, n_samples: int = 48, res: int = 128, yaw: float = 0.0):
    """(3, res^2, n_samples) texel ids y0 * W + x0 per plane for one
    coarse render pass (box_warp 1)."""
    c = cam.canonical_camera(yaw=yaw, device=device)
    ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4), c[:, 16:].reshape(-1, 3, 3), res)
    gen = torch.Generator(device=device).manual_seed(0)
    depths = sample_stratified(ro, 2.25, 3.3, n_samples, generator=gen)  # (1, M, S, 1)
    pts = (ro[:, :, None] + depths * rd[:, :, None]).reshape(1, -1, 3) * 2.0
    grids = project_onto_planes(pts)[0]  # (3, M * S, 2)
    fx, fy = texel_coords(grids[..., 0], grids[..., 1], H, W)
    x0 = fx.floor().long().clamp(0, W - 1)
    y0 = fy.floor().long().clamp(0, H - 1)
    return (y0 * W + x0).reshape(3, res * res, n_samples).cpu().numpy()


def dup_stats(device, n_samples: int = 48, res: int = 128) -> list[dict]:
    q = realistic_texels(device, n_samples, res)
    stats = []
    for p in range(3):
        qs = q[p]  # (M, S)
        qv = qs.reshape(res, res, n_samples)  # (v, u, s)
        uniq = np.unique(qs).size
        stats.append({
            "plane": p, "total": int(qs.size), "unique": int(uniq),
            "dup_factor": qs.size / uniq,
            "adj_same_s": float(np.mean(qs[:, 1:] == qs[:, :-1])),
            "adj_same_v": float(np.mean(qv[1:] == qv[:-1])),
            "adj_same_u": float(np.mean(qv[:, 1:] == qv[:, :-1])),
        })
    return stats


def run(device=None, n_rows: int = N_ROWS, res: int = 128, n_samples: int = 48,
        iters: int = 20, warmup: int = 3) -> dict:
    """Returns {'device', 'dup_stats', 'times': {name: ms}, 'check': {case:
    max abs err of the kernel against its plain version, relative to max
    |plain|}}. On a CPU device the kernel rows run the plain version, timed
    on the host."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    times, checks = {}, {}

    def bench(name, fn, n=iters):
        times[name] = time_ms(fn, n, warmup, dev)

    def check(case, rows, upd, n_out):
        want = row_scatter_add_plain(rows, upd, n_out)
        err = (row_scatter_add(rows, upd, n_out) - want).abs().max()
        checks[case] = float(err / want.abs().max().clamp_min(1e-30))

    # bf16 values, as the JAX tool's updates, held in f32 for both sides.
    upd32 = torch.randn(n_rows, QUAD, generator=gen, device=dev).bfloat16().float()
    rows = torch.randint(0, H * W, (n_rows,), generator=gen, device=dev)
    rows32 = rows.int()

    def index_add(r, n_out):
        return torch.zeros(n_out, QUAD, device=dev).index_add_(0, r, upd32)

    bench("index_add_ 786k x128 (all live)", lambda: index_add(rows, H * W))
    bench("row_scatter_add kernel 786k x128 (all live)",
          lambda: row_scatter_add(rows32, upd32, H * W))
    check("786k x128 all live", rows32, upd32, H * W)
    perm = torch.randperm(n_rows, generator=gen, device=dev)
    for frac in (0.5, 0.9):
        n_dead = int(n_rows * frac)
        dead = torch.cat([torch.full((n_dead,), H * W, device=dev, dtype=rows.dtype),
                          rows[n_dead:]])[perm]  # interleaved, not in one block
        bench(f"index_add_ {int(frac * 100)}% out of range (sink row)",
              lambda: index_add(dead, H * W + 1))
        dead32 = dead.int()
        bench(f"row_scatter_add kernel {int(frac * 100)}% out of range (dropped)",
              lambda: row_scatter_add(dead32, upd32, H * W))
        check(f"786k x128 {int(frac * 100)}% out of range", dead32, upd32, H * W)
    del upd32

    n = 3 * 2 * n_rows  # a camera's full backward volume
    big = torch.randint(0, H * W, (n,), generator=gen, device=dev, dtype=torch.int32)
    vals = torch.arange(n, device=dev, dtype=torch.int32)
    bench("torch.sort 4.7M int32", lambda: torch.sort(big), max(1, iters // 4))
    bench("torch.argsort 4.7M int32", lambda: torch.argsort(big), max(1, iters // 4))
    bench("key-value sort 4.7M (int32, int32)",
          lambda: vals.gather(0, torch.sort(big).indices), max(1, iters // 4))
    del big, vals
    v32 = torch.randn(n_rows, C, generator=gen, device=dev)
    bench("cumsum (786k, 32) f32 axis 0", lambda: torch.cumsum(v32, dim=0))

    upd_rmw = torch.randn(n_rows, C, generator=gen, device=dev)
    rows_rmw = torch.randint(0, H * W, (n_rows, 1), generator=gen, device=dev,
                             dtype=torch.int32)
    bench("row_scatter_add kernel 786k x32", lambda: row_scatter_add(rows_rmw, upd_rmw, H * W))
    bench("index_add_ 786k x32", lambda: row_scatter_add_plain(rows_rmw, upd_rmw, H * W))
    check("786k x32", rows_rmw, upd_rmw, H * W)
    return {"device": card_label(dev), "dup_stats": dup_stats(dev, n_samples, res),
            "times": times, "n_rows": n_rows, "check": checks}


def report(res):
    print(f"device: {res['device']}")
    for s in res["dup_stats"]:
        print(f"plane {s['plane']}: total={s['total']} unique={s['unique']} "
              f"dup_factor={s['dup_factor']:.1f} adj_same[s]={s['adj_same_s']:.3f} "
              f"adj_same[v]={s['adj_same_v']:.3f} adj_same[u]={s['adj_same_u']:.3f}")
    for name, ms in res["times"].items():
        per_row = f"  ({ms / res['n_rows'] * 1e6:.3f} ns/row)" if "786k x" in name else ""
        print(f"{name:58s} {ms:9.4f} ms{per_row}")
    for case, err in res["check"].items():
        print(f"row_scatter_add kernel vs plain {case}: max abs err relative to max |plain| "
              f"{err:.2e}")


def main():
    report(run())


if __name__ == "__main__":
    main()
