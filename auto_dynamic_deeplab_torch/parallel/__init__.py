"""The parallel modes (parallel/ of the JAX package): the process group
(``distributed``), the data-parallel layout (``mesh``) and the pipelined
early-exit inference (``pipeline``). The JAX package's tensor-parallel
step (``make_tp_train_step``, ``shard_train_state``, ``channel_spec``)
and ``spatial_shard_forward`` are not ported: see ROADMAP.md."""
from .distributed import barrier, data_shard, destroy, initialize, session
from .mesh import DATA_AXIS, DataMesh, make_data_mesh, replicate, shard_batch
from .pipeline import PipelinedDynamicInference

__all__ = [
    "DATA_AXIS",
    "DataMesh",
    "PipelinedDynamicInference",
    "barrier",
    "data_shard",
    "destroy",
    "initialize",
    "make_data_mesh",
    "replicate",
    "session",
    "shard_batch",
]
