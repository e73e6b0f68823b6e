"""Scale-out of the inversion (counterpart of spi_tpu/parallel/).

On one card, several images go through one batched program (`mesh`):
`spmd_invert` runs stage 1 and stage 2 under torch.func.vmap, one launch
a layer for the whole batch. Across cards, one process a card under
`torchrun` works its stripe of the worklist, and the per-image metrics
meet in one all-gather at the end (`multihost`). GAN training runs one
process a card too, with `psum_metrics` and `check_replica_consistency`.
"""

from spi_tpu_torch.parallel.mesh import (
    check_replica_consistency,
    index_tree,
    psum_metrics,
    spmd_invert,
    stack_trees,
)
from spi_tpu_torch.parallel.multihost import (
    aggregate_metrics,
    host_block,
    host_work_stripe,
    initialize,
    work_stripe,
)

__all__ = [
    "spmd_invert",
    "stack_trees",
    "check_replica_consistency",
    "psum_metrics",
    "index_tree",
    "aggregate_metrics",
    "host_block",
    "host_work_stripe",
    "initialize",
    "work_stripe",
]
