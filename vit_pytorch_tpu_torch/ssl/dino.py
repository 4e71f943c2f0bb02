"""Dino, self-distillation with no labels (reference dino.py:184-303), port of
``vit_pytorch_tpu/ssl/dino.py``.

The student is ``student_encoder`` (a :class:`NetWrapper` over ``net`` and
its projector).  The teacher, ``teacher_encoder``, is a deep copy of it made
at construction, as the JAX ``Dino.create_state`` copies the params; its
parameters take no gradient, and :meth:`Dino.update_moving_average` moves
them toward the student's.  The centres are the buffers
``teacher_centers`` and ``last_teacher_centers``, (1, num_classes_K), float32
whatever dtype the module is cast to, as the JAX ``create_state`` makes them.

The hidden layer is caught by a forward hook (:func:`capture_hidden`) on the
submodule named ``hidden_layer``: with the port's ``ViT`` that is the
``Transformer``, whose layers run the whole-layer kernels on the card in
bf16.  The projector's input width comes from one forward of a zero image
at construction (the reference's mock forward, dino.py:249).

Views come from :meth:`Dino.make_views` (``ssl/augment.py`` from a CPU
``torch.Generator``) or are given (``views``).  The projectors, losses and
the EMA are plain PyTorch, as the JAX package leaves them to XLA.

``state_dict()``: ``student_encoder.net.*``, ``student_encoder.projector.
net.{0, 2, ..., 2L-2, 2L-1}``, ``teacher_encoder.*``, ``teacher_centers``,
``last_teacher_centers``: the layout the JAX package's
``utils/convert.py::convert_dino`` reads, and ``utils/from_jax.py::
dino_state_dict_from_jax`` writes.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Optional

import torch
from torch import nn

from ..models.vit import init_modules_like_jax
from ..nn.blocks import GELU
from ..utils.helpers import default, default_device, pair
from .augment import byol_augment, random_resized_crop


def dino_loss_fn(teacher_logits, student_logits, teacher_temp, student_temp, centers, eps=1e-20):
    """reference dino.py:42-53: the student's softmax in the logits' dtype,
    the teacher's in the promotion of its logits and the (float32) centres,
    as in JAX."""
    teacher_logits = teacher_logits.detach()
    student_probs = (student_logits / student_temp).softmax(dim=-1)
    teacher_probs = ((teacher_logits - centers) / teacher_temp).softmax(dim=-1)
    return -(teacher_probs * torch.log(student_probs + eps)).sum(dim=-1).mean()


class L2Norm(nn.Module):
    """x over its L2 norm along ``dim``, the norm clamped at 1e-6."""

    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        return x / torch.linalg.vector_norm(x, dim=self.dim, keepdim=True).clamp_min(1e-6)


class MLP(nn.Module):
    """Projector (reference dino.py:92-114): (Linear, GELU) x (num_layers -
    1), L2Norm, Linear, in ``net``.  ``l2norm_axis``: the reference's
    L2Norm normalises over dim 1, the feature axis of a 2-D input but the
    region axis of EsViT's 3-D region tensor (es_vit.py:214-218); -1 is the
    2-D case, EsViT's region projector passes 1."""

    def __init__(self, dim: int, dim_out: int, num_layers: int, hidden_size: int = 256, l2norm_axis: int = -1, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        layers, width = [], dim
        for _ in range(num_layers - 1):
            layers += [nn.Linear(width, hidden_size, **kw), GELU()]
            width = hidden_size
        self.net = nn.Sequential(*layers, L2Norm(l2norm_axis), nn.Linear(width, dim_out, **kw))

    def forward(self, x):
        return self.net(x)


def capture_hidden(net: nn.Module, x, layer):
    """``net(x)``, returning the output of the first call of the first
    submodule whose own name is ``layer`` (its first element if a tuple):
    a forward hook, removed however the forward ends."""
    if not isinstance(layer, str):
        raise ValueError(
            f"hidden_layer must be a submodule NAME (e.g. 'transformer'), got {layer!r} -- -1 (the net's final "
            f"output) is handled by the wrapper; other integer indices from the torch reference have no "
            f"equivalent in the JAX package"
        )
    captured = {}

    def hook(module, args, out):
        captured.setdefault("value", out)

    module = next((m for name, m in net.named_modules() if name.rpartition(".")[2] == layer), None)
    handle = module.register_forward_hook(hook) if module is not None else None
    try:
        net(x)
    finally:
        if handle is not None:
            handle.remove()
    if "value" not in captured:
        # reference dino.py:141: 'hidden layer ... never emitted an output'
        raise ValueError(f"hidden layer {layer!r} never emitted an output")
    value = captured["value"]
    return value[0] if isinstance(value, tuple) else value


def net_hidden(net: nn.Module, x, layer):
    """The wrapped net's hidden output: ``net(x)`` for ``layer == -1`` (its
    first element if a tuple), else :func:`capture_hidden`."""
    if layer == -1:
        hidden = net(x)
        return hidden[0] if isinstance(hidden, tuple) else hidden
    return capture_hidden(net, x, layer)


@torch.no_grad()
def probe_hidden(net: nn.Module, layer, input_shape) -> torch.Tensor:
    """The hidden output of one zero image of ``input_shape`` (c, h, w), the
    net in eval mode, on its parameters' device and dtype: what the
    projectors' widths are read from."""
    p = next(net.parameters())
    was_training = net.training
    net.eval()
    try:
        return net_hidden(net, torch.zeros((1, *input_shape), device=p.device, dtype=p.dtype), layer)
    finally:
        net.train(was_training)


class NetWrapper(nn.Module):
    """reference dino.py:120-180: the hidden layer of ``net``, flattened per
    image, and its projection.  ``layer``: a submodule name, or -1 for the
    net's output.  ``input_shape`` (c, h, w) sizes the projector."""

    def __init__(self, net: nn.Module, output_dim: int, projection_hidden_size: int, projection_num_layers: int,
                 layer="transformer", *, input_shape, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net, self.layer = net, layer
        width = probe_hidden(net, layer, input_shape)[0].numel()
        self.projector = MLP(width, output_dim, projection_num_layers, projection_hidden_size,
                             device=default_device(device), dtype=dtype)
        init_modules_like_jax(self.projector, generator)

    def forward(self, x, return_projection: bool = True):
        hidden = net_hidden(self.net, x, self.layer)
        hidden = hidden.reshape(hidden.shape[0], -1)
        if not return_projection:
            return hidden
        return self.projector(hidden), hidden


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a Python scalar
    against an array of that dtype (0.9 -> 0.8984375 in bf16)."""
    return torch.tensor(value, dtype=dtype).item()


def ema_(old: torch.Tensor, new: torch.Tensor, beta: float, dtype: torch.dtype) -> None:
    """``old = old * beta + (1 - beta) * new`` in place, with JAX's roundings,
    ``new`` held in ``dtype`` as JAX holds it (the float32 last-centre
    buffers hold the bf16 centres JAX's forward returns in the projections'
    dtype): each constant rounded to the dtype of the array it multiplies,
    each product rounded to that dtype, the sum to ``old``'s."""
    old.copy_(old * _rounded(beta, old.dtype) + _rounded(1 - beta, dtype) * new.to(dtype))


@torch.no_grad()
def update_teacher(teacher: nn.Module, student: nn.Module, beta: float) -> None:
    """Every teacher parameter moved toward its student's (JAX
    ``jax.tree.map(lambda old, new: old * beta + (1 - beta) * new, ...)``),
    with :func:`ema_`'s roundings, one foreach op a step for each dtype."""
    groups = {}
    for (tn, t), (sn, s) in zip(teacher.named_parameters(), student.named_parameters(), strict=True):
        assert tn == sn, (tn, sn)
        olds, news = groups.setdefault(t.dtype, ([], []))
        olds.append(t)
        news.append(s)
    for dtype, (olds, news) in groups.items():
        torch._foreach_mul_(olds, _rounded(beta, dtype))
        torch._foreach_add_(olds, torch._foreach_mul(news, _rounded(1 - beta, dtype)))


class SelfDistiller(nn.Module):
    """What Dino and EsViT share: the constructor (temperatures, crop
    scales, augmentations, the student ``wrapper`` over ``net`` and its
    frozen deep copy as the teacher), :meth:`make_views`, the teacher's EMA,
    and the float32 centre buffers named by ``centres``: the JAX package's
    ``create_state`` makes them float32 (``jnp.zeros``) whatever dtype the
    parameters take, so they stay float32 through ``.to(dtype)`` and follow
    only the module's device; bf16 logits less a float32 centre promote the
    teacher's softmax, the loss and the centres' EMA to float32, as in JAX.
    Each pair of names is (centres, last centres)."""

    wrapper: type = nn.Module
    centres: tuple = ()

    def __init__(
        self, net: nn.Module, image_size, hidden_layer="transformer", projection_hidden_size: int = 256,
        num_classes_K: int = 65336, projection_layers: int = 4, student_temp: float = 0.9,
        teacher_temp: float = 0.04, local_upper_crop_scale: float = 0.4, global_lower_crop_scale: float = 0.5,
        moving_average_decay: float = 0.9, center_moving_average_decay: float = 0.9,
        augment_fn: Optional[Callable] = None, augment_fn2: Optional[Callable] = None, *,
        device=None, dtype=None, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.image_size = image_size
        self.student_temp, self.teacher_temp = student_temp, teacher_temp
        self.local_upper_crop_scale, self.global_lower_crop_scale = local_upper_crop_scale, global_lower_crop_scale
        self.moving_average_decay, self.center_moving_average_decay = moving_average_decay, center_moving_average_decay
        self.augment_fn, self.augment_fn2 = augment_fn, augment_fn2
        device = default_device(device)
        self.student_encoder = self.wrapper(
            net, num_classes_K, projection_hidden_size, projection_layers, layer=hidden_layer,
            input_shape=(getattr(net, "channels", 3), *pair(image_size)), device=device, dtype=dtype,
            generator=generator,
        )
        self.teacher_encoder = copy.deepcopy(self.student_encoder).requires_grad_(False)
        for centres, last in self.centres:
            for name in (centres, last):
                self.register_buffer(name, torch.zeros(1, num_classes_K, device=device, dtype=torch.float32))

    def _apply(self, fn, recurse=True):
        kept = {name: self._buffers[name] for pair_ in self.centres for name in pair_}
        super()._apply(fn, recurse)
        for name, old in kept.items():
            if self._buffers[name].dtype != torch.float32:
                self._buffers[name] = old.to(self._buffers[name].device)
        return self

    def make_views(self, x, generator: Optional[torch.Generator] = None):
        """Two augmentations of ``x``, then a local and a global crop of each
        (JAX dino.py:196-219), in the student's parameter dtype (the port's
        modules take one dtype)."""
        return make_views(self, x, generator)

    @torch.no_grad()
    def update_moving_average(self):
        """The teacher's EMA toward the student and each centre's toward its
        last centres (JAX dino.py:232-245, es_vit.py:162-175), in place, with
        JAX's roundings: the teacher in the parameters' dtype; the centres in
        float32, the last centres' product with ``1 - decay`` rounded to the
        projections' dtype, in which JAX's forward returns them."""
        update_teacher(self.teacher_encoder, self.student_encoder, self.moving_average_decay)
        dtype = next(self.student_encoder.parameters()).dtype
        for centres, last in self.centres:
            ema_(getattr(self, centres), getattr(self, last), self.center_moving_average_decay, dtype)


class Dino(SelfDistiller):
    """reference dino.py:184 — same constructor.  ``augment_fn`` and
    ``augment_fn2`` are called ``fn(img, generator=generator)``.  ``device``
    (the CUDA card unless it names another), ``dtype`` and ``generator``
    place and seed the projector (the JAX package's Dense init) and the
    centres (float32 on that device); the teacher copies the student.

        dino = Dino(vit, image_size=256, device=dev)
        opt = torch.optim.Adam(dino.parameters(), lr=3e-4)
        loss = dino(images, generator=cpu_gen)   # writes last_teacher_centers
        opt.zero_grad(); loss.backward(); opt.step()
        dino.update_moving_average()
    """

    wrapper = NetWrapper
    centres = (("teacher_centers", "last_teacher_centers"),)

    def forward(self, x, *, generator: Optional[torch.Generator] = None, views=None,
                student_temp: Optional[float] = None, teacher_temp: Optional[float] = None):
        """One Dino training forward (JAX ``dino_forward``, :248-304): the
        loss; ``last_teacher_centers`` takes the teacher projections' mean.
        ``views``: (local_one, local_two, global_one, global_two), else
        :meth:`make_views` of ``x`` from ``generator``."""
        if views is None:
            views = self.make_views(x, generator)
        local_one, local_two, global_one, global_two = views
        student_one, _ = self.student_encoder(local_one)
        student_two, _ = self.student_encoder(local_two)
        with torch.no_grad():
            teacher_one, _ = self.teacher_encoder(global_one)
            teacher_two, _ = self.teacher_encoder(global_two)
            self.last_teacher_centers.copy_(torch.cat([teacher_one, teacher_two]).mean(dim=0, keepdim=True))
        st, tt = default(student_temp, self.student_temp), default(teacher_temp, self.teacher_temp)
        return (dino_loss_fn(teacher_one, student_two, tt, st, self.teacher_centers)
                + dino_loss_fn(teacher_two, student_one, tt, st, self.teacher_centers)) / 2


def make_views(trainer: nn.Module, x, generator: Optional[torch.Generator] = None):
    """The views of Dino, EsViT and LeJEPA (JAX dino.py:196-219): ``x``
    augmented twice (``trainer.augment_fn`` / ``augment_fn2``, by default
    :func:`~.augment.byol_augment`), a local crop (scale 0.05 to
    ``local_upper_crop_scale``) and a global crop (``global_lower_crop_scale``
    to 1) of each, cast to the trainer's parameter dtype."""
    aug1 = default(trainer.augment_fn, byol_augment)
    aug2 = default(trainer.augment_fn2, byol_augment)
    image_one, image_two = aug1(x, generator=generator), aug2(x, generator=generator)
    size = pair(trainer.image_size)
    local = (0.05, trainer.local_upper_crop_scale)
    glob = (trainer.global_lower_crop_scale, 1.0)
    views = (
        random_resized_crop(image_one, size, scale=local, generator=generator),
        random_resized_crop(image_two, size, scale=local, generator=generator),
        random_resized_crop(image_one, size, scale=glob, generator=generator),
        random_resized_crop(image_two, size, scale=glob, generator=generator),
    )
    dtype = next(trainer.parameters()).dtype
    return tuple(v.to(dtype) for v in views)
