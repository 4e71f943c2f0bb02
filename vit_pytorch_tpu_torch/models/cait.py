"""CaiT, class-attention in image transformers (reference cait.py:124-178),
port of ``vit_pytorch_tpu/models/cait.py``.

Talking-heads attention mixes the heads before and after the softmax with
learned (heads, heads) matrices (cait.py:94-99) on the materialized
attention matrix, plain PyTorch here as it is plain XLA in the JAX package;
k and v read the normed x followed by a context (cait.py:87), the patch
tokens for the class tokens' transformer.  Each layer is LayerScale'd from
:func:`layerscale_init` by its depth (cait.py:31-45).  Layer dropout
(cait.py:14-27) draws one uniform a layer from ``generator`` (or the global
CPU generator, which ``parallel/train.py::make_train_step`` seeds each step)
and drops the layers under the rate, keeping one drawn layer when all would
drop, as the JAX model's keep mask does; a dropped layer adds exactly zero,
so the port skips it.

The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``pos_embedding``, ``cls_token``, ``{patch,cls}_transformer.layers.N.0|1``
as ``scale`` and ``fn.*``, ``mlp_head.0|1``): ``utils/convert.py::
convert_cait``, ``utils/from_jax.py::cait_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import FeedForward, LayerNorm
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device
from .vit import init_modules_like_jax


def layerscale_init(depth: int) -> float:
    """LayerScale's initial value by the layer's depth, 1-indexed
    (reference cait.py:34-39)."""
    if depth <= 18:
        return 0.1
    if depth <= 24:
        return 1e-5
    return 1e-6


class LayerScale(nn.Module):
    """``fn``'s output times a learned (1, 1, dim) scale (reference
    cait.py:31-45)."""

    def __init__(self, dim: int, fn: nn.Module, depth: int, *, device=None, dtype=None):
        super().__init__()
        self.init_value = layerscale_init(depth)
        self.scale = nn.Parameter(torch.full((1, 1, dim), self.init_value, device=device, dtype=dtype))
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(x, **kwargs) * self.scale.to(x.dtype)


class TalkingHeadsAttention(nn.Module):
    """reference cait.py:61-103: LN on x, q from it, k and v from it
    followed by ``context``; f32 logits mixed across heads, softmax cast to
    x's dtype, dropout, the second mix, the product with v, ``to_out`` with
    its dropout."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = LayerNorm(dim, **kw)
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False, **kw)
        self.dropout = nn.Dropout(dropout)
        self.mix_heads_pre_attn = nn.Parameter(torch.empty(heads, heads, **kw))
        self.mix_heads_post_attn = nn.Parameter(torch.empty(heads, heads, **kw))
        self.to_out = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))

    def split(self, t):
        b, n, _ = t.shape
        return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

    def forward(self, x, context=None):
        x = self.norm(x)
        ctx = x if context is None else torch.cat([x, context], dim=1)
        q = self.split(self.to_q(x))
        k, v = map(self.split, self.to_kv(ctx).chunk(2, dim=-1))
        dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.dim_head**-0.5
        dots = torch.einsum("bhij,hg->bgij", dots, self.mix_heads_pre_attn.float())
        attn = self.dropout(dots.softmax(dim=-1).to(x.dtype))
        attn = torch.einsum("bhij,hg->bgij", attn, self.mix_heads_post_attn.to(attn.dtype))
        out = torch.matmul(attn, v)
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class CaiTTransformer(nn.Module):
    """reference cait.py:105-122: LayerScale'd attention and feed-forward
    layers with layer dropout."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0,
                 layer_dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layer_dropout = layer_dropout
        self.layers = nn.ModuleList(
            nn.ModuleList([
                LayerScale(dim, TalkingHeadsAttention(dim, heads, dim_head, dropout, **kw), i + 1, **kw),
                LayerScale(dim, FeedForward(dim, mlp_dim, dropout, **kw), i + 1, **kw),
            ])
            for i in range(depth)
        )

    def keep(self, generator: Optional[torch.Generator] = None) -> list:
        """Which layers run: all but in training at a positive rate, where a
        layer drops when its uniform falls under the rate, and one layer
        drawn from ``generator`` too stays when all would drop (the JAX
        cait.py:91-99)."""
        depth = len(self.layers)
        if not self.training or self.layer_dropout <= 0.0 or depth == 0:
            return [True] * depth
        drop = (torch.rand(depth, generator=generator) < self.layer_dropout).tolist()
        forced = int(torch.randint(0, depth, (), generator=generator))
        return [not d or (all(drop) and i == forced) for i, d in enumerate(drop)]

    def forward(self, x, context=None, generator: Optional[torch.Generator] = None):
        for (attn, ff), keep in zip(self.layers, self.keep(generator)):
            if keep:
                x = attn(x, context=context) + x
                x = ff(x) + x
        return x


class CaiT(nn.Module):
    """reference cait.py:124 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py``.  ``forward(img,
    generator=None)``: ``generator`` draws the layer dropout's uniforms (a
    CPU generator)."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int, depth: int, cls_depth: int,
                 heads: int, mlp_dim: int, dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 layer_dropout: float = 0.0, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_size // patch_size) ** 2
        self.to_patch_embedding = PatchEmbedding((patch_size, patch_size), 3 * patch_size**2, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.patch_transformer = CaiTTransformer(dim, depth, heads, dim_head, mlp_dim, dropout, layer_dropout, **kw)
        self.cls_transformer = CaiTTransformer(dim, cls_depth, heads, dim_head, mlp_dim, dropout, layer_dropout, **kw)
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        for p in (self.pos_embedding, self.cls_token):
            p.normal_(generator=generator)
        for tr in (self.patch_transformer, self.cls_transformer):
            for attn, ff in tr.layers:
                attn.fn.mix_heads_pre_attn.normal_(generator=generator)
                attn.fn.mix_heads_post_attn.normal_(generator=generator)
                attn.scale.fill_(attn.init_value)
                ff.scale.fill_(ff.init_value)

    def forward(self, img, generator: Optional[torch.Generator] = None):
        x = self.to_patch_embedding(img)
        n = x.shape[1]
        x = self.patch_transformer(self.dropout(x + self.pos_embedding[:, :n].to(x.dtype)), generator=generator)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        cls = self.cls_transformer(cls, context=x, generator=generator)
        return self.mlp_head(cls[:, 0])
