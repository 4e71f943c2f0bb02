"""EsViT, Dino plus a region-level loss (reference es_vit.py:223-367), port of
``vit_pytorch_tpu/ssl/es_vit.py``.

Region pairs are matched by the argmax of the student-teacher latent
similarity and cross-entropied per region (es_vit.py:61-80), with view and
region projectors and centres of their own.  Teacher and EMA as in
``ssl/dino.py``.  The hidden layer may be token-shaped (b, n, d) or
CNN-shaped (b, h, w, c): the region latents are its flattened spatial axes.

``state_dict()``: ``student_encoder.net.*``, ``student_encoder.
view_projector.net.*``, ``student_encoder.region_projector.net.*``,
``teacher_encoder.*`` and the four centre buffers; the JAX package has no
converter for it, and ``utils/from_jax.py::esvit_state_dict_from_jax`` maps
the JAX tree onto these names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.vit import init_modules_like_jax
from ..utils.helpers import default, default_device
from .dino import MLP, SelfDistiller, net_hidden, probe_hidden


def _log(t, eps=1e-20):
    return torch.log(t + eps)


def view_loss_fn(teacher_logits, student_logits, teacher_temp, student_temp, centers, eps=1e-20):
    """reference es_vit.py:48-59."""
    teacher_logits = teacher_logits.detach()
    student_probs = (student_logits / student_temp).softmax(dim=-1)
    teacher_probs = ((teacher_logits - centers) / teacher_temp).softmax(dim=-1)
    return -(teacher_probs * _log(student_probs, eps)).sum(dim=-1).mean()


def region_pairs(student_latent, teacher_latent):
    """(b, n): for each student region, the teacher region of highest latent
    similarity (reference es_vit.py:61-80)."""
    return torch.einsum("bid,bjd->bij", student_latent, teacher_latent).argmax(dim=-1)


def region_loss_fn(teacher_logits, student_logits, teacher_latent, student_latent, teacher_temp, student_temp,
                   centers, eps=1e-20):
    """reference es_vit.py:61-80: each student region against the teacher
    region of highest latent similarity."""
    teacher_logits = teacher_logits.detach()
    student_probs = (student_logits / student_temp).softmax(dim=-1)
    teacher_probs = ((teacher_logits - centers) / teacher_temp).softmax(dim=-1)
    index = region_pairs(student_latent, teacher_latent)
    matched = torch.gather(teacher_probs, 1, index[..., None].expand(-1, -1, teacher_probs.shape[-1]))
    return -(matched * _log(student_probs, eps)).sum(dim=-1).mean()


class EsViTNetWrapper(nn.Module):
    """reference es_vit.py:146-219: the view and region projections of a
    hidden layer's region latents.  The region projector's L2Norm is over
    axis 1, the region axis, as the reference's (mirrored, not fixed)."""

    def __init__(self, net: nn.Module, output_dim: int, projection_hidden_size: int, projection_num_layers: int,
                 layer="transformer", *, input_shape, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net, self.layer = net, layer
        width = probe_hidden(net, layer, input_shape).shape[-1]
        kw = dict(device=default_device(device), dtype=dtype)
        self.view_projector = MLP(width, output_dim, projection_num_layers, projection_hidden_size, **kw)
        self.region_projector = MLP(width, output_dim, projection_num_layers, projection_hidden_size,
                                    l2norm_axis=1, **kw)
        init_modules_like_jax(self.view_projector, generator)
        init_modules_like_jax(self.region_projector, generator)

    def forward(self, x, return_projection: bool = True):
        hidden = net_hidden(self.net, x, self.layer)
        region_latents = hidden.reshape(hidden.shape[0], -1, hidden.shape[-1])
        global_latent = region_latents.mean(dim=1)
        if not return_projection:
            return global_latent, region_latents
        return self.view_projector(global_latent), self.region_projector(region_latents), region_latents


class EsViTTrainer(SelfDistiller):
    """reference es_vit.py:223 — same constructor; ``device``, ``dtype`` and
    ``generator`` as :class:`~.dino.Dino`'s, the four centre buffers float32
    as Dino's two.  Use as Dino: the forward returns the loss and writes
    ``last_teacher_view_centers`` and ``last_teacher_region_centers``;
    :meth:`update_moving_average` after each optimizer step."""

    wrapper = EsViTNetWrapper
    centres = (("teacher_view_centers", "last_teacher_view_centers"),
               ("teacher_region_centers", "last_teacher_region_centers"))

    def forward(self, x, *, generator: Optional[torch.Generator] = None, views=None,
                student_temp: Optional[float] = None, teacher_temp: Optional[float] = None):
        """One EsViT forward (JAX ``esvit_forward``, :178-243): the loss; the
        last view and region centres take the teacher's means."""
        if views is None:
            views = self.make_views(x, generator)
        local_one, local_two, global_one, global_two = views
        s_view_1, s_region_1, s_latent_1 = self.student_encoder(local_one)
        s_view_2, s_region_2, s_latent_2 = self.student_encoder(local_two)
        with torch.no_grad():
            t_view_1, t_region_1, t_latent_1 = self.teacher_encoder(global_one)
            t_view_2, t_region_2, t_latent_2 = self.teacher_encoder(global_two)
            self.last_teacher_view_centers.copy_(torch.cat([t_view_1, t_view_2]).mean(dim=0, keepdim=True))
            self.last_teacher_region_centers.copy_(torch.cat([t_region_1, t_region_2]).mean(dim=(0, 1))[None])
        st, tt = default(student_temp, self.student_temp), default(teacher_temp, self.teacher_temp)
        view_loss = (view_loss_fn(t_view_1, s_view_2, tt, st, self.teacher_view_centers)
                     + view_loss_fn(t_view_2, s_view_1, tt, st, self.teacher_view_centers)) / 2
        region_loss = (
            region_loss_fn(t_region_1, s_region_2, t_latent_1, s_latent_2, tt, st, self.teacher_region_centers)
            + region_loss_fn(t_region_2, s_region_1, t_latent_2, s_latent_1, tt, st, self.teacher_region_centers)
        ) / 2
        return (view_loss + region_loss) / 2
