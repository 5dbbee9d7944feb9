"""The data-parallel layout (parallel/mesh.py of the JAX package).

The JAX package shards a batch over a ``jax.sharding.Mesh`` axis named
``DATA_AXIS`` inside one process. The port's counterpart is a process
group, one process per device: ``DataMesh`` is that group with this
process's rank. Rank r of W holds rows [r·b/W, (r+1)·b/W) of a global
batch of b, the rows ``P(DATA_AXIS)`` gives shard r; gradients, losses
and (with cross-replica BN) BN statistics are averaged over the ranks, as
``lax.pmean`` averages them over the axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The group the data-parallel steps reduce over (``dist.group.WORLD``
    for the default one), this rank and the world size."""
    group: object
    rank: int
    world: int

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not split over the {self.world}-rank data mesh")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


def make_data_mesh(batch_size: int, group=None) -> Optional[DataMesh]:
    """The data mesh of ``group`` (default: the default group) for global
    batches of ``batch_size``; None without a process group. Every rank
    takes the same share of every batch, so the world size must divide the
    batch: where the JAX package narrows its mesh to gcd(devices, batch),
    a process of the port cannot sit idle, and this raises instead."""
    if not dist.is_initialized():
        return None
    world = dist.get_world_size(group)
    if batch_size % world:
        raise ValueError(
            f"data parallelism over {world} ranks needs a global batch that {world} divides, "
            f"got {batch_size}: every rank takes batch/world rows of every batch"
        )
    group = group if group is not None else dist.group.WORLD
    return DataMesh(group, dist.get_rank(group), world)


def shard_batch(batch: dict, mesh: DataMesh) -> dict:
    """This rank's contiguous rows of every array of a global host batch."""
    return {k: v[mesh.rows(v.shape[0])] for k, v in batch.items()}


def replicate(module: torch.nn.Module, mesh: DataMesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's, in place
    (by ``copy_``, which bumps the versions the kernels' folded-weight
    caches key on)."""
    src = dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            received = t.detach().clone()
            dist.broadcast(received, src, group=mesh.group)
            t.copy_(received)
    return module
