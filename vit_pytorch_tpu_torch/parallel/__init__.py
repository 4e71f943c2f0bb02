"""Training layer, port of ``vit_pytorch_tpu/parallel``: the train step on
one device (``train.py``), whose state ``utils/checkpoint.py`` saves and
restores, and the mesh (``mesh.py``): a ``('data', 'model')`` DeviceMesh of
one process a device, on which ``shard_train_state`` lays out data, tensor
and fully sharded parallelism and ``make_sharded_train_step`` trains."""

from .mesh import (
    Sharding,
    batch_sharding,
    global_array_from_process_local,
    infer_param_shardings,
    infer_param_shardings_fsdp,
    initialize_distributed,
    make_mesh,
    param_partition_spec,
    replicated,
)
from .train import (
    TrainState,
    create_train_state,
    cross_entropy_loss,
    make_sharded_train_step,
    make_train_step,
    shard_train_state,
)

__all__ = [
    "Sharding", "TrainState", "batch_sharding", "create_train_state", "cross_entropy_loss",
    "global_array_from_process_local", "infer_param_shardings", "infer_param_shardings_fsdp",
    "initialize_distributed", "make_mesh", "make_sharded_train_step", "make_train_step", "param_partition_spec",
    "replicated", "shard_train_state",
]
