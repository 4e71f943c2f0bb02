"""Training layer, port of ``vit_pytorch_tpu/parallel``: the train step on
one device (``train.py``), whose state ``utils/checkpoint.py`` saves and
restores.  The mesh (``parallel/mesh.py``: data, tensor and fully sharded
parallelism) and the sharded train step are ROADMAP item 11b; until then
``shard_train_state`` and ``make_sharded_train_step`` raise."""

from .train import TrainState, create_train_state, cross_entropy_loss, make_train_step

__all__ = ["TrainState", "create_train_state", "cross_entropy_loss", "make_train_step"]
