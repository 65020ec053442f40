"""The mesh layer (port of the JAX package's ``parallel/``): the device mesh
and its process world, batch data parallelism, ZeRO-1/FSDP, channel tensor
parallelism, the FOV-sharded refocus (``fft_sharding``) and the GPipe
pipeline (``pp``)."""

from style_transfer_based_holographic_imaging_tpu_torch.parallel.mesh import (
    COLLECTIVE_TIMEOUT_S,
    DATA_AXIS,
    FFT_AXIS,
    Mesh,
    NamedSharding,
    batch_sharding,
    close_world,
    default_backend,
    init_world,
    launch,
    local_rows,
    make_mesh,
    replicated,
    shard_batch,
)
from style_transfer_based_holographic_imaging_tpu_torch.parallel.fft_sharding import (
    fov_sharding,
    sharded_propagate,
)
from style_transfer_based_holographic_imaging_tpu_torch.parallel.pp import (
    PIPE_AXIS,
    make_pipeline_finetune_fn,
    make_pipeline_retrieval_fn,
    make_pipeline_train_fn,
    pipeline_plan,
)
from style_transfer_based_holographic_imaging_tpu_torch.parallel.tp import (
    MODEL_AXIS,
    column_parallel,
    tp_shard_params,
    tp_shardings,
    tp_state_shardings,
)
from style_transfer_based_holographic_imaging_tpu_torch.parallel.zero import (
    PARTITION_PLANS,
    gather_state,
    merge_state_shardings,
    partition_state_shardings,
    shard_state,
    zero_state_shardings,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "local_rows",
    "DATA_AXIS",
    "FFT_AXIS",
    "Mesh",
    "NamedSharding",
    "default_backend",
    "COLLECTIVE_TIMEOUT_S",
    "init_world",
    "close_world",
    "launch",
    "MODEL_AXIS",
    "tp_shardings",
    "tp_shard_params",
    "tp_state_shardings",
    "column_parallel",
    "PIPE_AXIS",
    "make_pipeline_finetune_fn",
    "make_pipeline_retrieval_fn",
    "make_pipeline_train_fn",
    "pipeline_plan",
    "sharded_propagate",
    "fov_sharding",
    "zero_state_shardings",
    "merge_state_shardings",
    "partition_state_shardings",
    "PARTITION_PLANS",
    "shard_state",
    "gather_state",
]
