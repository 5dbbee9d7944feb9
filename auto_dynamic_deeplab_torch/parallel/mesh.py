"""The device meshes (parallel/mesh.py of the JAX package).

The JAX package shards a batch over a ``jax.sharding.Mesh`` axis named
``DATA_AXIS`` inside one process. The port's counterpart is a process
group, one process per device: ``DataMesh`` is that group with this
process's rank. Rank r of W holds rows [r·b/W, (r+1)·b/W) of a global
batch of b, the rows ``P(DATA_AXIS)`` gives shard r; gradients, losses
and (with cross-replica BN) BN statistics are averaged over the ranks, as
``lax.pmean`` averages them over the axis.

``make_mesh(n_data, n_model)`` is the 2-D ``(data, model)`` mesh of the
tensor-parallel step: global rank d·n_model + m sits at (d, m), as the
JAX package lays its devices out row-major; the data group joins the
ranks of one m, the model group those of one d. A spec names the dim
of a tensor that is sharded over an axis, or None: ``batch_spec()`` the
batch's dim 0 over ``DATA_AXIS``, ``replicated_spec()`` None
(``parallel.tensor.channel_spec`` the channel dim over ``MODEL_AXIS``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, model) mesh of this rank: its place (d, m), the axes'
    sizes and their two groups (from ``make_mesh``)."""
    n_data: int
    n_model: int
    d: int
    m: int
    data_group: object
    model_group: object

    @property
    def rank(self) -> int:
        return self.d * self.n_model + self.m

    def axis_group(self, axis: str):
        """The group of ``axis`` (``DATA_AXIS`` or ``MODEL_AXIS``) this rank is in."""
        if axis not in (DATA_AXIS, MODEL_AXIS):
            raise ValueError(f"unknown mesh axis {axis!r}: {DATA_AXIS!r} or {MODEL_AXIS!r}")
        return self.data_group if axis == DATA_AXIS else self.model_group

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (its data index's)."""
        return DataMesh(self.data_group, self.d, self.n_data).rows(n)


def make_mesh(n_data: int, n_model: int = 1, group=None) -> Mesh:
    """The (n_data, n_model) mesh over the ranks of ``group`` (default:
    the default group), which must number n_data·n_model: rank
    d·n_model + m at (d, m). Every rank of the group must call it (it
    makes the axes' groups)."""
    if not dist.is_initialized():
        raise ValueError("make_mesh needs a process group: call parallel.initialize first")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_data * n_model != world:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks, the group has {world}")
    ranks = [dist.get_global_rank(group, r) if group is not None else r for r in range(world)]
    mine = {}
    for m in range(n_model):  # every rank makes every group, in one order
        g = dist.new_group([ranks[d * n_model + m] for d in range(n_data)])
        if rank % n_model == m:
            mine["data"] = g
    for d in range(n_data):
        g = dist.new_group([ranks[d * n_model + m] for m in range(n_model)])
        if rank // n_model == d:
            mine["model"] = g
    return Mesh(n_data, n_model, rank // n_model, rank % n_model, mine["data"], mine["model"])


def batch_spec() -> int:
    """A batch's spec: dim 0 over ``DATA_AXIS``."""
    return 0


def replicated_spec() -> None:
    """A whole tensor's spec: no dim sharded."""
    return None
