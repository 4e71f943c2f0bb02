"""Training layer, port of ``vit_pytorch_tpu/parallel/train.py:22-139``.

The JAX package jits a pure ``(state, batch) -> (state, metrics)`` step over
an optax transform.  PyTorch runs eagerly: the state holds the model and a
``torch.optim`` optimizer, and the step updates them in place and returns the
metrics.  On a CUDA device in bf16 the model's layers run the whole-layer
kernels forward and backward (``ops/fused_block.py``).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclass
class TrainState:
    """The model, its optimizer and the number of updates taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def cross_entropy_loss(logits, labels):
    """Mean softmax cross-entropy with integer labels, in f32 (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return F.cross_entropy(logits.float(), labels)


def create_train_state(model: nn.Module, tx: Optional[Callable] = None) -> TrainState:
    """``tx`` maps the parameters to an optimizer.  The default is optax's
    ``adam(3e-4)``: ``torch.optim.Adam`` with lr 3e-4, betas (0.9, 0.999),
    eps 1e-8, and its default implementation choice (``foreach=None``: the
    multi-tensor ``foreach`` kernels when every parameter is on a CUDA
    device, the per-parameter loop otherwise).  The moments take the
    parameters' dtype, as optax's do."""
    tx = tx if tx is not None else functools.partial(torch.optim.Adam, lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, optimizer=tx(model.parameters()))


@contextlib.contextmanager
def _seeded(generator: Optional[torch.Generator], device: torch.device):
    """Run the block with the global RNG seeded from ``generator`` (and
    restored after), so that ``nn.Dropout`` draws its masks from it; no-op
    without a generator."""
    if generator is None:
        yield
        return
    seed = int(torch.randint(0, 2**62, (), generator=generator, device=generator.device))
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        yield


def make_train_step(
    model: nn.Module,
    loss_fn: Callable = cross_entropy_loss,
    *,
    aux_loss_weight: float = 0.0,
    grad_accum: int = 1,
    donate: bool = True,
):
    """Build ``step(state, images, labels, generator=None) -> metrics``, one
    optimizer update of ``state`` with ``model``'s forward in training mode
    (``model.train()``, the JAX ``train=True``); metrics are ``loss`` and
    ``accuracy`` as 0-d tensors on the device.

    ``aux_loss_weight``: for models returning ``(logits, aux_loss)``.

    ``images``: a tensor batch, or a packed batch (NaViT's ``PackedImages``,
    the 3-D NaViT's ``PackedVolumes``) at ``grad_accum=1``, as the JAX step
    takes its pytree (train.py:72-103); the loss is then the caller's (for
    NaViT, a cross-entropy over the ``(b, max_images)`` slots masked where
    the label is -1).

    ``grad_accum``: the batch (whose leading dim must divide by it) runs as
    ``grad_accum`` sequential microbatches; their gradients are summed in
    f32, divided by ``grad_accum`` and cast to each parameter's dtype, then
    one optimizer update is taken (train.py:105-137).  After a step each
    parameter's ``.grad`` holds the gradient the update used.

    ``generator``: seeds the dropout masks, one draw per microbatch.

    ``donate`` is accepted for the JAX signature and has no meaning in eager
    PyTorch, which updates the parameters in place anyway.
    """
    del donate
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def loss_and_accuracy(images, labels, generator):
        with _seeded(generator, images.device):
            out = model(images)
        if isinstance(out, tuple):
            logits, aux = out
            loss = loss_fn(logits, labels) + aux_loss_weight * aux
        else:
            logits = out
            loss = loss_fn(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc

    def step(state: TrainState, images, labels, generator: Optional[torch.Generator] = None):
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss, acc = loss_and_accuracy(images, labels, generator)
            loss.backward()
            loss = loss.detach()
        elif not isinstance(images, torch.Tensor):
            raise ValueError(f"grad_accum > 1 takes a tensor batch; split a packed batch ({type(images).__name__}) "
                             f"into packs yourself")
        else:
            b = images.shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} does not divide into {grad_accum} microbatches")
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = acc = 0.0
            for im, lab in zip(images.chunk(grad_accum), labels.chunk(grad_accum)):
                mloss, macc = loss_and_accuracy(im, lab, generator)
                grads = torch.autograd.grad(mloss, params, allow_unused=True)
                for s, g in zip(gsum, grads):
                    if g is not None:
                        s.add_(g.float())
                loss, acc = loss + mloss.detach(), acc + macc
            for p, s in zip(params, gsum):
                p.grad = (s / grad_accum).to(p.dtype)
            loss, acc = loss / grad_accum, acc / grad_accum
        state.optimizer.step()
        state.step += 1
        return {"loss": loss, "accuracy": acc}

    return step


def shard_train_state(*args, **kwargs):
    raise NotImplementedError("sharded training waits for parallel/mesh.py (ROADMAP: modules to port, item 11b)")


def make_sharded_train_step(*args, **kwargs):
    raise NotImplementedError("sharded training waits for parallel/mesh.py (ROADMAP: modules to port, item 11b)")
