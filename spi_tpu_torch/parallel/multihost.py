"""Scale-out over several processes (counterpart of
spi_tpu/parallel/multihost.py).

The reference scales past one GPU by hand: the user launches N
processes, each with `CUDA_VISIBLE_DEVICES=i` and `--dataset_block i/N`
(spi/data/images_dataset.py:149-158, README.md:52,61), and each works its
stripe of the image list with no communication. spi_tpu derives the
stripe from JAX's multi-process runtime; the port derives it from
`torch.distributed`, one process a card under `torchrun`:

- `initialize()` starts a gloo process group from torchrun's environment
  (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE), and does nothing in a
  single process.
- `host_work_stripe()` / `host_block()` give this process's stripe with
  the reference's block arithmetic (`work_stripe`).
- `aggregate_metrics()` combines each process's metric sums into global
  means with one all-gather of a fixed-layout float32 vector over gloo:
  host data, sent once a run, like spi_tpu's all-gather over DCN.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist


def initialize(backend: str = "gloo") -> bool:
    """Join the process group that `torchrun` describes in the environment
    (`env://`; gloo unless another backend is asked for). Returns True when
    several processes run; with WORLD_SIZE absent or 1 it changes nothing
    and returns False."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if not dist.is_initialized():
        dist.init_process_group(backend)
    return dist.get_world_size() > 1


def _topology() -> tuple[int, int]:
    """(this process's rank, the number of processes)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def work_stripe(n_items: int, index: int, total: int) -> list[int]:
    """Stripe index/total of range(n_items), 0-based, with the exact block
    arithmetic of the reference's `dataset_block` (images_dataset.py:
    149-158: block = n // total + 1, 1-based slicing [(i-1)*block :
    i*block]), so that several processes partition a worklist as the
    reference's multi-process recipe does. Trailing stripes may be empty."""
    assert 0 <= index < total, (index, total)
    block = n_items // total + 1
    start = min(index * block, n_items)
    end = min((index + 1) * block, n_items)
    return list(range(start, end))


def host_work_stripe(n_items: int) -> list[int]:
    """This process's stripe of an n_items worklist, from its rank and the
    number of processes."""
    index, total = _topology()
    return work_stripe(n_items, index, total)


def host_block(total: int | None = None, index: int | None = None) -> str:
    """This process's `dataset_block` string ("i/N", 1-based: the CLI
    argument of the reference's multi-process recipe), from its rank and
    the number of processes where not given."""
    rank, world = _topology()
    total = world if total is None else total
    index = rank if index is None else index
    assert 0 <= index < total, (index, total)
    return f"{index + 1}/{total}"


# The pipeline's per-image metric names (utils/metrics.py Metric.run and
# the mirrored ones the pipeline adds). A fixed list keeps the gathered
# vector's layout the same in every process, also in one that inverted no
# image and so holds no metric keys at all.
METRIC_NAMES = ("id", "id_m", "l2", "l2_m", "lpips", "lpips_m")


def aggregate_metrics(metrics: dict[str, float], counts_key: str = "n",
                      names: Sequence[str] = METRIC_NAMES) -> dict[str, float]:
    """Gather each process's metric sums and combine them into global means.

    `metrics` maps name -> this process's sum over its images, plus
    `counts_key` -> the number of its images. Returns name -> global mean;
    in a single process, the local means. Every process of the group must
    call it (it is a collective) with the same `names`: the layout comes
    from `names`, so a process with an empty stripe takes part with zeros.
    """
    names = tuple(names)
    local = torch.tensor([metrics.get(counts_key, 0.0)] + [metrics.get(k, 0.0) for k in names],
                         dtype=torch.float32)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        gathered = [torch.empty_like(local) for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, local)
        total = torch.stack(gathered).sum(dim=0)
    else:
        total = local
    n = max(float(total[0]), 1.0)
    return {k: float(total[1 + i] / n) for i, k in enumerate(names)}
