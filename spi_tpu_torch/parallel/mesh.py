"""Several images in one batched inversion program on one card
(counterpart of spi_tpu/parallel/mesh.py).

spi_tpu batches B images with `jax.vmap` of its per-image program and
shards the image axis over a device mesh with `shard_map`. The port keeps
the batching: `spmd_invert` runs the projector (`project_batch`) and the
tuning loop (`tune_batch`) under torch.func.vmap on one device, every
image with its own noise maps and, in stage 2, its own copy of the
weights, so that each layer and each kernel (the splat, bias_act) runs
once a step for the whole batch. It has no mesh: several cards are used
as several processes, one card each (`torchrun`, `parallel/multihost.py`),
which is PyTorch's idiom for what spi_tpu's mesh does across chips. So
spi_tpu's `data_mesh`, `shard_batch`, `replicate` and `global_data_mesh`,
which place arrays on a JAX mesh, have no counterpart here.

GAN training (training/gan.py) runs one process a card in the same way;
`psum_metrics` and `check_replica_consistency` are spi_tpu's two helpers
for it, over `torch.distributed` in place of a mesh axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from spi_tpu_torch.criteria.bbox_cx import BoxCXLoss
from spi_tpu_torch.criteria.lpips import LPIPS
from spi_tpu_torch.models.triplane import TriPlaneGenerator
from spi_tpu_torch.training import coaches, projectors
from spi_tpu_torch.utils.params import index_tree, stack_trees

__all__ = ["check_replica_consistency", "index_tree", "psum_metrics", "spmd_invert",
           "stack_trees"]


def spmd_invert(generator: TriPlaneGenerator, lpips: LPIPS,
                proj_settings: projectors.ProjectorSettings,
                coach_settings: coaches.CoachSettings, box_cx: BoxCXLoss | None = None,
                device=None):
    """Build the batched inversion program: stage-1 projection, then stage-2
    tuning from each image's pivot with its stage-1 noise maps, B images at
    once (spi_tpu's `spmd_invert`). The generator module holds the starting
    weights and is not changed; the depth anchor's frozen copy is made from
    it. device: None means `cuda` (raises without a GPU).

    The returned run(targets (B, 1, 3, R, R), cameras (B, 1, 25), rngs=None,
    face_masks=None, landmarks=None, proj_draws=None, tune_draws=None) takes one `torch.Generator` per image (stage 1 draws
    from it first, stage 2 after, as the serial pipeline does) or injected
    per-image draws, and returns spi_tpu's six per-image outputs, each with
    a leading image axis: w (B, 1, num_ws, w_dim), the stage-1 noise maps
    by name (B, H, W), the tuned weights by name (B, ...), the steps run
    (B,), the last LPIPS (B,) and the stage-1 distances (B, num_steps).
    """

    def run(targets, cameras, rngs=None, face_masks=None, landmarks=None, proj_draws=None,
            tune_draws=None):
        w, noise, dists = projectors.project_batch(
            generator, lpips, targets, cameras, proj_settings, rngs=rngs, draws=proj_draws,
            device=device)
        inputs = coaches.CoachInputs(target=targets, camera=cameras, w_pivot=w,
                                     face_mask=face_masks, landmarks=landmarks)
        tuned, steps, lps = coaches.tune_batch(
            generator, lpips, inputs, coach_settings, noise=noise, rngs=rngs,
            draws=tune_draws, device=device, box_cx=box_cx)
        return w, noise, tuned, steps, lps, dists

    return run


def _group_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def psum_metrics(values: torch.Tensor) -> torch.Tensor:
    """The moment triples [1, v, v^2] of this process's `values`, stacked on a
    new first axis and summed over the processes (spi_tpu's `psum_metrics`,
    the analog of training_stats._sync, eg3d/torch_utils/training_stats.py:
    245-266); in a single process, this process's triples."""
    triple = torch.stack([torch.ones_like(values), values, values.square()])
    if _group_size() > 1:
        dist.all_reduce(triple)
    return triple


def check_replica_consistency(module: torch.nn.Module) -> list[str]:
    """The names of the parameters and buffers of `module` that differ,
    bitwise, in some process from rank 0's (spi_tpu's
    `check_replica_consistency`, eg3d/torch_utils/misc.py:181-192's
    check_ddp_consistency); [] in a single process. Every process calls it
    and gets the same list."""
    if _group_size() == 1:
        return []
    tensors = list(module.state_dict().items())
    differs = torch.zeros(len(tensors), device=tensors[0][1].device)
    for i, (_, t) in enumerate(tensors):
        ref = t.detach().clone()
        dist.broadcast(ref, src=0)
        differs[i] = float(not torch.equal(ref, t))
    dist.all_reduce(differs)
    return [name for (name, _), d in zip(tensors, differs.tolist()) if d]
