"""ViT with a PatchMerger (reference vit_with_patch_merger.py:20-144), port
of ``vit_pytorch_tpu/models/vit_with_patch_merger.py``.

No class token: the patches' tokens go through the layers, and after layer
``patch_merge_layer`` (half the depth by default) a :class:`PatchMerger`
shrinks them to ``patch_merge_num_tokens``: learned queries attend the
normed tokens, which are also the values (one head of width ``dim``,
through ``ops/attention.py::dot_product_attention``, whose composite takes a
dim over 256).  Each layer is ``Attention(x) + x`` and ``FeedForward(x) + x``
with the shared modules of ``nn/blocks.py``, the residual added outside the
attention call as the JAX loop adds it: on the card, in bf16, a layer whose
tokens the attention-block kernels take (n <= 208, dim_head 64) runs them,
the output's residual added after their last launch, as the JAX ``Attention``
calls ``fused_attention_block`` with no residual.  At the README's width
(256 tokens merged to 8 after layer 6 of 12) layers 7-12 take the kernels
and layers 1-6 the composite; in training with dropout the kernels drop
the attention and its output themselves.

The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``pos_embedding`` (1, num_patches + 1, dim), ``transformer.layers.N.0|1``,
``transformer.patch_merger.queries|norm``, ``transformer.norm``,
``mlp_head.1``): ``utils/convert.py::convert_vit_with_patch_merger``,
``utils/from_jax.py::vit_with_patch_merger_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from einops.layers.torch import Reduce
from torch import nn

from ..nn.blocks import LN_EPS, Attention, FeedForward
from ..nn.patch import PatchEmbedding
from ..ops.attention import dot_product_attention
from ..utils.helpers import default, default_device, pair
from .vit import init_modules_like_jax


class PatchMerger(nn.Module):
    """reference vit_with_patch_merger.py:20-32: softmax(Q LN(x)^T / sqrt(dim))
    LN(x) with learned queries Q (``num_tokens_out``, dim)."""

    def __init__(self, dim: int, num_tokens_out: int, *, device=None, dtype=None):
        super().__init__()
        self.scale = dim**-0.5
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device, dtype=dtype)
        self.queries = nn.Parameter(torch.empty(num_tokens_out, dim, device=device, dtype=dtype))

    def forward(self, x):
        normed = self.norm(x)[:, None]
        q = self.queries.to(x.dtype)[None, None].expand(x.shape[0], 1, -1, -1)
        return dot_product_attention(q, normed, normed, scale=self.scale)[:, 0]


class Transformer(nn.Module):
    """reference vit_with_patch_merger.py:74-105: the layers, the
    PatchMerger after layer ``patch_merge_layer`` (1-based), a final
    LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0,
                 patch_merge_layer: Optional[int] = None, patch_merge_num_tokens: int = 8,
                 flash: Optional[bool] = None, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.patch_merge_layer_index = default(patch_merge_layer, depth // 2) - 1
        self.patch_merger = PatchMerger(dim, patch_merge_num_tokens, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, flash=flash, **kw),
                           FeedForward(dim, mlp_dim, dropout=dropout, **kw)])
            for _ in range(depth)
        )

    def forward(self, x):
        for index, (attn, ff) in enumerate(self.layers):
            x = attn(x) + x
            x = ff(x) + x
            if index == self.patch_merge_layer_index:
                x = self.patch_merger(x)
        return self.norm(x)


class ViT(nn.Module):
    """reference vit_with_patch_merger.py:107 — same keyword constructor,
    with ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/vit.py`` (the position embedding and the merger's queries unit
    normal, as the JAX init)."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 patch_merge_layer: Optional[int] = None, patch_merge_num_tokens: int = 8, channels: int = 3,
                 dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0, flash: Optional[bool] = None,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_height // patch_height) * (image_width // patch_width)
        patch_dim = channels * patch_height * patch_width
        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), patch_dim, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, dropout, patch_merge_layer,
                                       patch_merge_num_tokens, flash, **kw)
        self.mlp_head = nn.Sequential(Reduce("b n d -> b d", "mean"), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.transformer.patch_merger.queries.normal_(generator=generator)

    def forward(self, img):
        x = self.to_patch_embedding(img)
        x = self.dropout(x + self.pos_embedding[:, : x.shape[1]].to(x.dtype))
        return self.mlp_head(self.transformer(x))
