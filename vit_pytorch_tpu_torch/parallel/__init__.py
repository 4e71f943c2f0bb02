"""Training layer, port of ``vit_pytorch_tpu/parallel`` (the single-device
train step so far; the mesh comes with ROADMAP item 11)."""

from .train import TrainState, create_train_state, cross_entropy_loss, make_train_step

__all__ = ["TrainState", "create_train_state", "cross_entropy_loss", "make_train_step"]
