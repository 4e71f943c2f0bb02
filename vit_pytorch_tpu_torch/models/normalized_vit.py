"""nViT: the nGPT-style fully normalised ViT (reference normalized_vit.py:
148-246), port of ``vit_pytorch_tpu/models/normalized_vit.py``.

Every token lives on the unit sphere: each attention and FF output is
l2-normalised and the residual is a learned interpolation towards it, then
normalised again.  :class:`NormLinear` l2-normalises its weight at every
call (over its inputs, or with ``norm_dim_in=False`` over its outputs), with
the 1e-12 floor of :func:`l2norm`, so the gradients pass through the norm,
as in the JAX package (which mirrors the reference's parametrized
forward).  :func:`normalize_weights` is the reference's post-optimizer hook
(``norm_weights_()``, :212-221) as in the JAX package: it re-projects, in
place and without gradient, every NormLinear weight (the position embedding
too) onto the unit sphere along the axis its forward normalises; call it
after each optimizer step.

The attention l2-normalises q and k per head and scales them by learned
(heads, 1, dim_head) scales, logits at scale 1, through
``ops/attention.py::dot_product_attention`` (the composite below 1,024
keys, as in JAX); no kernel of the port runs here.

The state_dict is the reference's, whose NormLinear weights sit behind
``torch.nn.utils.parametrize`` (``<name>.linear.parametrizations.weight.
original``, the raw (out, in) weight): the port keeps that key without
parametrize, the raw weight held by a plain module at that path:
``utils/convert.py::convert_normalized_vit``,
``utils/from_jax.py::normalized_vit_state_dict_from_jax``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from einops.layers.torch import Rearrange
from torch import nn

from ..ops.attention import dot_product_attention
from ..utils.helpers import default, default_device, pair
from .vit import _TRUNC_STD


def l2norm(t, dim: int = -1):
    """``t`` over its l2 norm along ``dim``, the norm floored at 1e-12 (the
    JAX package's ``l2norm``)."""
    return t / t.norm(dim=dim, keepdim=True).clamp_min(1e-12)


class _Weight(nn.Module):
    """The raw weight where the reference's parametrization keeps it
    (``parametrizations.weight.original``)."""

    def __init__(self, dim_out: int, dim_in: int, *, device=None, dtype=None):
        super().__init__()
        self.original = nn.Parameter(torch.empty(dim_out, dim_in, device=device, dtype=dtype))


class NormLinear(nn.Module):
    """reference normalized_vit.py:37-58: a bias-free Linear whose (out, in)
    weight is l2-normalised at every call, over ``in`` (``norm_dim_in``) or
    over ``out``."""

    def __init__(self, dim: int, dim_out: int, norm_dim_in: bool = True, *, device=None, dtype=None):
        super().__init__()
        self.norm_dim = -1 if norm_dim_in else 0
        self.linear = nn.Module()
        self.linear.parametrizations = nn.ModuleDict({"weight": _Weight(dim_out, dim, device=device, dtype=dtype)})

    @property
    def raw_weight(self) -> nn.Parameter:
        return self.linear.parametrizations.weight.original

    @property
    def weight(self) -> torch.Tensor:
        return l2norm(self.raw_weight, self.norm_dim)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype))


class Attention(nn.Module):
    """reference normalized_vit.py:62-111."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, dropout: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.to_q, self.to_k, self.to_v = (NormLinear(dim, inner, **kw) for _ in range(3))
        self.q_scale = nn.Parameter(torch.empty(heads, 1, dim_head, **kw))
        self.k_scale = nn.Parameter(torch.empty(heads, 1, dim_head, **kw))
        self.to_out = NormLinear(inner, dim, norm_dim_in=False, **kw)

    def forward(self, x):
        b, n, _ = x.shape
        split = lambda t: t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        q = l2norm(q) * self.q_scale.to(q.dtype)
        k = l2norm(k) * self.k_scale.to(k.dtype)
        out = dot_product_attention(q, k, v, scale=1.0, dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Module):
    """reference normalized_vit.py:113-144: the gated SiLU of width
    ``int(dim_inner * 2 / 3)`` with learned hidden and gate scales, the gate
    scaled by sqrt(dim)."""

    def __init__(self, dim: int, dim_inner: int, dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dim_inner = int(dim_inner * 2 / 3)
        self.dim = dim
        self.to_hidden = NormLinear(dim, dim_inner, **kw)
        self.to_gate = NormLinear(dim, dim_inner, **kw)
        self.hidden_scale = nn.Parameter(torch.empty(dim_inner, **kw))
        self.gate_scale = nn.Parameter(torch.empty(dim_inner, **kw))
        self.dropout = nn.Dropout(dropout)
        self.to_out = NormLinear(dim_inner, dim, norm_dim_in=False, **kw)

    def forward(self, x):
        hidden = self.to_hidden(x) * self.hidden_scale.to(x.dtype)
        gate = self.to_gate(x) * self.gate_scale.to(x.dtype) * (self.dim**0.5)
        return self.to_out(self.dropout(F.silu(gate) * hidden))


class nViT(nn.Module):
    """reference normalized_vit.py:148 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` (the JAX init: NormLinear
    weights and the position embedding truncated lecun-normal, the
    residual interpolation scales at ``residual_lerp_scale_init / sqrt(dim)``,
    the q and k scales at ``dim_head ** 0.25``, the other scales one)."""

    def __init__(self, *, image_size, patch_size: int, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, dropout: float = 0.0, channels: int = 3, dim_head: int = 64,
                 residual_lerp_scale_init: Optional[float] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        if image_height % patch_size or image_width % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_height // patch_size) * (image_width // patch_size)
        self.dim, self.dim_head = dim, dim_head
        self.scale = dim**0.5
        self.lerp_init = default(residual_lerp_scale_init, 1.0 / depth)
        # channel-first patch flattening '(c p1 p2)' (normalized_vit.py:181)
        self.to_patch_embedding = nn.Sequential(
            Rearrange("b c (h p1) (w p2) -> b (h w) (c p1 p2)", p1=patch_size, p2=patch_size),
            NormLinear(channels * patch_size * patch_size, dim, norm_dim_in=False, **kw),
        )
        # the absolute position embedding: the rows of a NormLinear's weight (:185, :229)
        self.abs_pos_emb = NormLinear(dim, num_patches, **kw)
        self.residual_lerp_scales = nn.ModuleList(
            nn.ParameterList([nn.Parameter(torch.empty(dim, **kw)), nn.Parameter(torch.empty(dim, **kw))])
            for _ in range(depth)
        )
        self.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, dim_head, heads, dropout, **kw), FeedForward(dim, mlp_dim, dropout, **kw)])
            for _ in range(depth)
        )
        self.to_pred = NormLinear(dim, num_classes, **kw)
        self.logit_scale = nn.Parameter(torch.empty(num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, NormLinear):  # flax's lecun_normal: fan-in the input axis
                w = m.raw_weight
                std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            elif isinstance(m, Attention):
                m.q_scale.fill_(self.dim_head**0.25)
                m.k_scale.fill_(self.dim_head**0.25)
            elif isinstance(m, FeedForward):
                m.hidden_scale.fill_(1.0)
                m.gate_scale.fill_(1.0)
        for scales in self.residual_lerp_scales:
            for p in scales:
                p.fill_(self.lerp_init / self.scale)
        self.logit_scale.fill_(1.0)

    def forward(self, images):
        tokens = self.to_patch_embedding(images)
        pos = self.abs_pos_emb.weight[: tokens.shape[1]]
        tokens = l2norm(tokens + pos.to(tokens.dtype))
        for (attn, ff), (attn_alpha, ff_alpha) in zip(self.layers, self.residual_lerp_scales):
            # tokens.lerp(out, alpha * scale) = tokens + alpha * scale * (out - tokens)
            attn_out = l2norm(attn(tokens))
            tokens = l2norm(tokens + (attn_alpha * self.scale).to(tokens.dtype) * (attn_out - tokens))
            ff_out = l2norm(ff(tokens))
            tokens = l2norm(tokens + (ff_alpha * self.scale).to(tokens.dtype) * (ff_out - tokens))
        logits = self.to_pred(tokens.mean(dim=1))
        return logits * self.logit_scale.to(logits.dtype) * self.scale


@torch.no_grad()
def normalize_weights(model: nn.Module) -> None:
    """The reference's ``norm_weights_()`` (normalized_vit.py:212-221), the
    JAX ``normalize_weights``: every NormLinear weight of ``model`` (the q,
    k, v and out projections, the FF's hidden, gate and out, the patch
    embedding, the prediction head, and the position embedding) replaced
    in place by its l2-normalised self, along the axis its forward
    normalises, computed in float32 (a bf16 norm would leave the rows
    up to 0.4% off the sphere).  Call it after each optimizer step."""
    for m in model.modules():
        if isinstance(m, NormLinear):
            m.raw_weight.copy_(l2norm(m.raw_weight.float(), m.norm_dim))
