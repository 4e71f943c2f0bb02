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

from ..utils.helpers import is_dtensor
from .mesh import mesh_device


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


def _loss_and_accuracy(model: nn.Module, loss_fn: Callable, aux_loss_weight: float):
    """``(images, labels, generator) -> (loss, accuracy)`` of ``model``'s
    forward, the dropout masks drawn from ``generator``."""

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

    return loss_and_accuracy


def _fit_grads(params) -> None:
    """Each DTensor parameter's gradient on the parameter's own placements:
    DTensor's backward may leave it replicated where the parameter is
    sharded (a row-parallel weight's)."""
    for p in params:
        if p.grad is not None and is_dtensor(p) and p.grad.placements != p.placements:
            p.grad = p.grad.redistribute(p.device_mesh, p.placements)


def _forward_backward(params, loss_and_accuracy, images, labels, generator, grad_accum: int):
    """The forward and backward of a step, leaving in each parameter's
    ``.grad`` the gradient the update uses; returns ``(loss, accuracy)``.
    With ``grad_accum`` > 1 the batch runs as that many microbatches whose
    gradients are summed in f32, divided and cast to each parameter's
    dtype (train.py:105-137)."""
    if grad_accum == 1:
        loss, acc = loss_and_accuracy(images, labels, generator)
        loss.backward()
        _fit_grads(params)
        return loss.detach(), acc
    if not isinstance(images, torch.Tensor):
        raise ValueError(f"grad_accum > 1 takes a tensor batch; split a packed batch ({type(images).__name__}) "
                         f"into packs yourself")
    b = images.shape[0]
    if b % grad_accum:
        raise ValueError(f"batch {b} does not divide into {grad_accum} microbatches")
    gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    loss = acc = 0.0
    for im, lab in zip(images.chunk(grad_accum), labels.chunk(grad_accum)):
        mloss, macc = loss_and_accuracy(im, lab, generator)
        mloss.backward()
        _fit_grads(params)
        for s, p in zip(gsum, params):
            if p.grad is not None:
                s.add_(p.grad.float())
                p.grad = None
        loss, acc = loss + mloss.detach(), acc + macc
    for p, s in zip(params, gsum):
        p.grad = (s / grad_accum).to(p.dtype)
    return loss / grad_accum, acc / grad_accum


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

    loss_and_accuracy = _loss_and_accuracy(model, loss_fn, aux_loss_weight)

    def step(state: TrainState, images, labels, generator: Optional[torch.Generator] = None):
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        state.optimizer.zero_grad(set_to_none=True)
        loss, acc = _forward_backward(params, loss_and_accuracy, images, labels, generator, grad_accum)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss, "accuracy": acc}

    return step


def _distribute_over_model(model: nn.Module, mesh, shardings: dict) -> None:
    """Make every parameter and buffer of ``model`` a DTensor on ``mesh``
    (the 'model' axis): the parameters by their spec's 'model' placement,
    the buffers replicated.  A row-parallel module (its weight sharded on
    its input dim) gets a forward hook that all-reduces its output, a
    partial sum on each rank, before what follows it (dropout, the
    residual), as XLA does after the row-parallel product."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    placements = {name: (sharding.placements[1],) for name, sharding in shardings.items()}
    done: dict = {}
    for prefix, module in model.named_modules():
        for name, p in list(module.named_parameters(recurse=False)):
            if p not in done:
                full = f"{prefix}.{name}" if prefix else name
                done[p] = nn.Parameter(distribute_tensor(p.detach(), mesh, placements[full]),
                                       requires_grad=p.requires_grad)
            module.register_parameter(name, done[p])
        for name, b in list(module.named_buffers(recurse=False)):
            if b is not None and not is_dtensor(b):
                module._buffers[name] = distribute_tensor(b, mesh, [Replicate()])
        weight = module._parameters.get("weight")
        if weight is not None and weight.ndim >= 2 and weight.placements == (Shard(1),):
            module.register_forward_hook(_all_reduced)


def _all_reduced(module, args, out):
    from torch.distributed.tensor import Replicate

    return out.redistribute(placements=[Replicate()])


def _laid_out_like(value, param):
    """An optimizer state entry laid out like its parameter: a tensor of the
    parameter's shape takes its placements; others (Adam's step count) stay
    as they are, whole on every rank."""
    if isinstance(value, torch.Tensor) and is_dtensor(param) and not is_dtensor(value) \
            and value.shape == param.shape:
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(value.to(param.device), param.device_mesh, param.placements)
    return value


def shard_train_state(state: TrainState, mesh, *, fsdp: bool = False, fsdp_min_size: int = 2**14) -> TrainState:
    """Lay out ``state``'s parameters over ``mesh`` (TP specs where they
    divide; replicated otherwise) and rebuild its optimizer on them; the
    state is changed in place and returned.

    Where the 'model' axis is larger than 1, every parameter and buffer
    becomes a DTensor on it (``mesh["model"]``), the TP weights sharded, the
    rest replicated, so that the forward keeps the single-device meaning
    (GSPMD's): a column-parallel product's output stays a DTensor sharded on
    its last dim, and the fused qkv's ``chunk(3)`` sees the whole product.
    On a 'model' axis of 1 the parameters stay plain tensors along it.

    ``fsdp=True`` additionally shards each parameter of ``fsdp_min_size``
    elements or more over the 'data' axis (ZeRO-3) through ``fully_shard``
    on ``mesh["data"]``, with the whole model as its one unit: inside the
    forward every parameter is whole again, so the whole-layer kernels take
    plain tensors.  The smaller parameters are ``ignored_params`` of
    ``fully_shard``, replicated, their gradients averaged over 'data' by the
    sharded step as data parallelism's are.  ``fully_shard`` takes the dim
    JAX picks (``infer_param_shardings_fsdp``).

    The optimizer is rebuilt with the same class and hyperparameters, each
    group split in two (DTensor parameters, plain ones: a ``foreach`` update
    takes one kind).  Its moments follow their parameter's placements (they
    are made ``zeros_like`` the parameter, and moments already taken are
    distributed like it); scalars (Adam's step counts) are whole on every
    rank.
    """
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from .mesh import infer_param_shardings, infer_param_shardings_fsdp

    model, optimizer = state.model, state.optimizer
    shardings = (infer_param_shardings_fsdp(model, mesh, min_size=fsdp_min_size) if fsdp
                 else infer_param_shardings(model, mesh))
    names = {p: name for name, p in model.named_parameters()}
    groups = [({k: v for k, v in g.items() if k != "params"}, [names[p] for p in g["params"]])
              for g in optimizer.param_groups]
    moments = {names[p]: moment for p, moment in optimizer.state.items()}
    if mesh["model"].size() > 1:
        _distribute_over_model(model, mesh["model"], shardings)
    if fsdp:
        params = dict(model.named_parameters())
        data_dim = {params[name]: sharding.spec.index("data") for name, sharding in shardings.items()
                    if "data" in sharding.spec}
        fully_shard(model, mesh=mesh["data"], shard_placement_fn=lambda p: Shard(data_dim[p]),
                    ignored_params={p for p in params.values() if p not in data_dim})
    params = dict(model.named_parameters())
    split = []
    for hyper, members in groups:
        for sharded in (True, False):
            kind = [params[name] for name in members if is_dtensor(params[name]) == sharded]
            if kind:
                split.append({**hyper, "params": kind})
    state.optimizer = type(optimizer)(split, **optimizer.defaults)
    for name, moment in moments.items():
        p = params[name]
        state.optimizer.state[p] = {k: _laid_out_like(v, p) for k, v in moment.items()}
    return state


def make_sharded_train_step(model: nn.Module, mesh, loss_fn: Callable = cross_entropy_loss, *,
                            aux_loss_weight: float = 0.0, grad_accum: int = 1, donate: bool = True):
    """Train step over ``mesh`` for a state laid out by
    :func:`shard_train_state`: ``step(state, images, labels, generator=None)
    -> metrics``, as :func:`make_train_step`'s.

    The batch goes on 'data': a DTensor batch (``prefetch_to_device(...,
    mesh=mesh)``) gives this rank its local rows; a plain tensor is the
    global batch, of which this rank takes the rows of its 'data'
    coordinate, so that ranks differing only in 'model' see the same rows.
    Each rank runs the forward and backward on its rows; gradients of the
    parameters replicated over 'data' are averaged over it (those that
    ``fully_shard`` holds are reduce-scattered by it).  ``loss`` and
    ``accuracy`` are the global batch's: the means of the ranks' means,
    whose rows are as many.

    ``grad_accum``: this rank's rows run as ``grad_accum`` microbatches; the
    gradients are summed in f32, divided and cast to each parameter's dtype,
    then one update is taken.  ``generator`` seeds the dropout masks: give
    every rank the same seed, or none on a 'model' axis larger than 1, where
    the step then shares one draw within each 'model' group, whose ranks
    hold the same activations.  The ranks of the 'data' axis draw for their
    own rows, so the masks are not a single device's."""
    del donate
    from torch.distributed.tensor import DTensor, Replicate

    from ..utils.data import process_local_slice

    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    loss_and_accuracy = _loss_and_accuracy(model, loss_fn, aux_loss_weight)
    data_group, ndata = mesh.get_group("data"), mesh["data"].size()
    model_mesh = mesh["model"] if mesh["model"].size() > 1 else None

    def local_rows(t):
        t = t.to_local() if isinstance(t, DTensor) else process_local_slice(t, mesh=mesh)
        if model_mesh is not None:
            t = DTensor.from_local(t, model_mesh, [Replicate()], run_check=False)
        return t

    def on_data(p) -> bool:
        return isinstance(p, DTensor) and "data" in (p.device_mesh.mesh_dim_names or ())

    def global_mean(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        t = torch.as_tensor(t, dtype=torch.float32, device=mesh_device(mesh)).detach().clone()
        torch.distributed.all_reduce(t, group=data_group)
        return t / ndata

    def shared(generator):
        # the ranks of a 'model' group hold replicated activations, so they
        # must draw the same dropout masks: without a generator, one seeded
        # by a draw of the group's first rank
        if model_mesh is None or generator is not None:
            return generator
        group = model_mesh.get_group()
        seed = torch.randint(0, 2**62, (), dtype=torch.int64).to(mesh_device(mesh))
        torch.distributed.broadcast(seed, src=torch.distributed.get_global_rank(group, 0), group=group)
        return torch.Generator().manual_seed(int(seed))

    def step(state: TrainState, images, labels, generator: Optional[torch.Generator] = None):
        model.train()
        generator = shared(generator)
        images, labels = local_rows(images), local_rows(labels)
        params = [p for p in model.parameters() if p.requires_grad]
        state.optimizer.zero_grad(set_to_none=True)
        loss, acc = _forward_backward(params, loss_and_accuracy, images, labels, generator, grad_accum)
        if ndata > 1:
            with torch.no_grad():
                for p in params:
                    if p.grad is not None and not on_data(p):
                        local = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
                        torch.distributed.all_reduce(local, group=data_group)
                        local.div_(ndata)
        state.optimizer.step()
        state.step += 1
        return {"loss": global_mean(loss), "accuracy": global_mean(acc)}

    return step

