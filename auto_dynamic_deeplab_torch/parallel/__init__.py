"""The parallel modes (parallel/ of the JAX package): the process group
(``distributed``), the meshes (``mesh``: the data-parallel ``DataMesh``
and the 2-D ``make_mesh``), spatial sharding (``spatial_shard_forward``
over ``spatial``'s row bands), channel tensor parallelism (``tensor``)
and the pipelined early-exit inference (``pipeline``)."""
from .distributed import barrier, data_shard, destroy, initialize, session, spatial_shard_forward
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    Mesh,
    batch_spec,
    make_data_mesh,
    make_mesh,
    replicate,
    replicated_spec,
    shard_batch,
)
from .pipeline import PipelinedDynamicInference
from .tensor import channel_spec, gather_train_state, make_tp_train_step, shard_train_state

__all__ = [
    "DATA_AXIS",
    "DataMesh",
    "MODEL_AXIS",
    "Mesh",
    "PipelinedDynamicInference",
    "barrier",
    "batch_spec",
    "channel_spec",
    "data_shard",
    "destroy",
    "gather_train_state",
    "initialize",
    "make_data_mesh",
    "make_mesh",
    "make_tp_train_step",
    "replicate",
    "replicated_spec",
    "session",
    "shard_batch",
    "shard_train_state",
    "spatial_shard_forward",
]
