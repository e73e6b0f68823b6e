"""Gather-path microbenchmarks (counterpart of tools/profile_gather.py).

    python -m spi_tpu_torch.tools.profile_gather

Times, with CUDA events, the PyTorch analogue of each XLA operation that
the JAX tool timed on one render pass (786,432 points on one 256^2 x 32
plane), and the `row_gather` kernel where the JAX tool ran its Pallas
dynamic gather:

- the 4-corner bilinear sample forward (`ops.grid_sample.sample_flat`)
  and its autograd backward with respect to the table; the port has no
  quad-row table layout, so the JAX tool's `quad_sample` rows have no
  counterpart;
- raw row take (`index_select`) of 786k rows of 128 bf16, random and
  sorted;
- raw row scatter-add (`index_add_`) of 786k rows into 65,536, f32 and
  bf16 accumulation, random and sorted rows; the JAX tool's unsorted
  `segment_sum` is the same scatter-add;
- `row_gather` (65536 x 32 f32, one row index broadcast over the 32
  columns) against `torch.gather` with int64 indices, and at the render
  pass's shape (786,432 rows gathered from 65,536).
"""

from __future__ import annotations

import torch

from spi_tpu_torch.ops.gather_scatter import row_gather, row_gather_plain
from spi_tpu_torch.ops.grid_sample import sample_flat
from spi_tpu_torch.tools.timing import card_label, time_ms
from spi_tpu_torch.utils.device import resolve_device

H = W = 256
C = 32
N_POINTS = 16384 * 48  # one render pass


def run(device=None, n_points: int = N_POINTS, iters: int = 20, warmup: int = 3) -> dict:
    """Returns {'device', 'times': {name: ms}, 'check': {shape: max abs
    err of the kernel against torch.gather}}. On a CPU device the
    kernel rows run the plain version, timed on the host."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}

    def bench(name, fn):
        times[name] = time_ms(fn, iters, warmup, dev)

    table = torch.randn(1, H * W, C, generator=gen, device=dev)
    coords = torch.rand(1, n_points, 2, generator=gen, device=dev) * 2 - 1
    bench("4-corner sample fwd (786k pts, 1 plane)", lambda: sample_flat(table, coords, H, W))
    tab_g = table.clone().requires_grad_(True)

    def bwd_table():
        out = sample_flat(tab_g, coords, H, W)
        return torch.autograd.grad(out, tab_g, torch.ones_like(out))

    bench("4-corner fwd+bwd wrt table (index_add_)", bwd_table)

    quad = torch.randn(H * W, 4 * C, generator=gen, device=dev).bfloat16()
    rows = torch.randint(0, H * W, (n_points,), generator=gen, device=dev)
    rows_sorted = rows.sort().values
    upd = torch.randn(n_points, 4 * C, generator=gen, device=dev).bfloat16()
    bench("raw take 786k rows of 128 bf16 (index_select)", lambda: quad.index_select(0, rows))
    bench("raw take, sorted rows", lambda: quad.index_select(0, rows_sorted))

    def scatter(r, dtype):
        z = torch.zeros(H * W, 4 * C, dtype=dtype, device=dev)
        return z.index_add_(0, r, upd.to(dtype))

    bench("raw scatter-add 786k rows -> 65536 (index_add_ f32)",
          lambda: scatter(rows, torch.float32))
    bench("raw scatter-add bf16 accum", lambda: scatter(rows, torch.bfloat16))
    bench("raw scatter-add, sorted rows", lambda: scatter(rows_sorted, torch.float32))
    del quad, upd, tab_g

    checks = {}
    for label, n_rows in (("65536x32", H * W), ("786432x32", n_points)):
        tab32 = torch.randn(H * W, C, generator=gen, device=dev)
        idx = torch.randint(0, H * W, (n_rows, 1), generator=gen, device=dev,
                            dtype=torch.int32).expand(n_rows, C).contiguous()
        idx64 = idx.long()
        checks[label] = float((row_gather(tab32, idx) - row_gather_plain(tab32, idx)).abs().max())
        bench(f"row_gather kernel {label} f32", lambda: row_gather(tab32, idx))
        bench(f"torch.gather {label} f32 (int64 indices)", lambda: torch.gather(tab32, 0, idx64))
    return {"device": card_label(dev), "times": times, "check": checks}


def report(res):
    print(f"device: {res['device']}")
    for name, ms in res["times"].items():
        print(f"{name:54s} {ms:9.4f} ms")
    for label, err in res["check"].items():
        print(f"row_gather {label}: max abs err vs torch.gather {err:.1e}")


def main():
    report(run())


if __name__ == "__main__":
    main()
