"""Process-group bootstrap (parallel/distributed.py of the JAX package; the
reference's ``torch.distributed.init_process_group("nccl", env://)``,
train.py:48-53).

The JAX package runs one process over a mesh of local devices; the port
runs one process per GPU, as the reference does. ``initialize`` starts the
group from its arguments or from the environment: the JAX package's names
(``COORDINATOR_ADDRESS`` = host:port, ``NUM_PROCESSES``, ``PROCESS_ID``) or
torchrun's (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``). Without either it does nothing and the program runs on one
device. ``session`` wraps a CLI's ``main``: it starts the group and ends it
again if it started it.

``spatial_shard_forward`` is the JAX package's H-sharded forward: each
rank of a mesh axis runs the model on its band of image rows
(``parallel/spatial.py``: the split and the row exchange; ``ops/band.py``:
each op's band rule) and returns its rows of every exit's logits.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, Mesh
from .spatial import RowBands

# every collective of a group fails after this long instead of hanging
TIMEOUT_S = 600.0


def _address(coordinator_address: Optional[str]) -> Optional[str]:
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address is None and "MASTER_ADDR" in os.environ:
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    return address


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    timeout_s: float = TIMEOUT_S,
) -> Tuple[int, int]:
    """Join the default process group; returns (rank, world). A no-op
    returning (0, 1) when no address is given or set; (rank, world) of the
    group already there when one is. ``device`` 'cuda' takes the NCCL
    backend and binds this process to ``cuda:LOCAL_RANK`` (rank modulo the
    visible GPUs when LOCAL_RANK is unset); 'cpu' takes gloo."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    address = _address(coordinator_address)
    if address is None:
        return 0, 1
    world = num_processes if num_processes is not None else _env_int("NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("PROCESS_ID", "RANK")
    if world is None or rank is None:
        raise ValueError(
            f"process group at {address}: the world size (NUM_PROCESSES or WORLD_SIZE) and the rank "
            "(PROCESS_ID or RANK) must be given too"
        )
    kind = torch.device(device).type
    if kind == "cuda":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None else rank % torch.cuda.device_count())
    elif kind != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo", init_method=f"tcp://{address}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return rank, world


def data_shard() -> Tuple[int, int]:
    """(rank, world) of the default group; (0, 1) without one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier():
    """Wait for every rank of the default group; nothing without one."""
    if dist.is_initialized():
        dist.barrier()


def destroy():
    """Leave the default group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def session(device="cuda"):
    """``initialize(device=device)`` for the block, which every rank leaves
    together (a barrier), so that no rank returns before rank 0 has
    written its files; the group it started is destroyed at the block's
    end. Yields (rank, world)."""
    started = not dist.is_initialized()
    rank_world = initialize(device=device)
    try:
        yield rank_world
        barrier()
    finally:
        if started:
            destroy()


class SpatialForward:
    """The callable ``spatial_shard_forward`` returns. ``exchanged_bytes``
    is what this rank received in its last call."""

    def __init__(self, model: torch.nn.Module, group):
        self.model, self.group = model, group
        self.exchanged_bytes = 0

    def bands(self, height: int) -> RowBands:
        return RowBands(height, self.group)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, height: Optional[int] = None) -> List[torch.Tensor]:
        """x: NHWC images on the model's device: the whole batch's global
        rows, or with ``height`` (the global H) this rank's band of them.
        Returns this rank's rows (N, hi - lo, W, classes) of each exit's
        logits, in eval mode."""
        from ..ops import band

        height = int(x.shape[1]) if height is None else int(height)
        bands = self.bands(height)
        lo, hi = bands.band(height)
        if x.shape[1] == height and hi - lo != height:
            x = x[:, lo:hi]
        self.model.eval()
        outs = self.model(band.wrap(x, height, bands, dim=1))
        self.exchanged_bytes = bands.exchanged_bytes
        for o in outs:
            if not band.is_band(o) or (o.rows, o.row_dim) != (height, 1):
                raise AssertionError(f"an exit's logits lost their band: {type(o).__name__}")
        return [band.local(o) for o in outs]

    def gather(self, outs: List[torch.Tensor], height: int) -> List[torch.Tensor]:
        """Every rank's rows of ``outs`` (from ``__call__`` on an input of
        ``height`` rows) put together: the whole NHWC logits on each rank."""
        bands = self.bands(height)
        return [bands.fetch(o, height, 1, lambda r: (0, height), 0.0) for o in outs]


def spatial_shard_forward(model: torch.nn.Module, mesh=None, axis: str = DATA_AXIS) -> SpatialForward:
    """The forward with the input's H sharded over ``axis`` of ``mesh`` (a
    ``DataMesh``, a ``Mesh`` from ``make_mesh``, or None: one process,
    one band); the parameters are every rank's own, whole. Each rank
    computes its band of every activation from global rows that the
    others send it (``RowBands.fetch``): the halo exchanges GSPMD inserts
    for the JAX package. Every cell execution: xla, flat (K3-K6 on a
    window of rows around the band, ``band.block_windows``), packed,
    flat-packed and dense-sep."""
    if mesh is None:
        return SpatialForward(model, None)
    if isinstance(mesh, Mesh):
        return SpatialForward(model, mesh.axis_group(axis))
    if axis != DATA_AXIS:
        raise ValueError(f"a DataMesh has the {DATA_AXIS!r} axis only, not {axis!r}")
    return SpatialForward(model, mesh.group)
