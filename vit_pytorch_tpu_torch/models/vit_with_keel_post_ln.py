"""ViT with KEEL post-LN (reference vit_with_keel_post_ln.py:121-217), port of
``vit_pytorch_tpu/models/vit_with_keel_post_ln.py``.

Post-LN layers whose residual is scaled by ``keel_residual_scale`` (the
number of attention and FF calls, 2 x depth, by default) before the norm;
the first call is a plain residual, ``out + x`` (reference :101-119).  Every
LayerNorm is bias-free.  Each attention call is the port's
:class:`~..nn.blocks.Attention` with ``norm_bias=False`` and no residual: on
the card, in bf16, the attention-block kernels, whose LayerNorm runs with a
zero bias (the JAX package passes ``jnp.zeros``), the projection out
through ``gemm_bf16[block_out]`` without ``+x``; the residual scale and the
post-LNs run outside the kernels, as in JAX.

The state_dict is the reference's: ``transformer.layers`` one flat list,
``2i`` layer i's attention and ``2i + 1`` its FF, the bias-free
``transformer.post_norms.j`` (one fewer than the calls), ``cls_token``
(num_cls, dim) and ``pos_embedding`` (num_patches + num_cls, dim) in the
JAX shapes, a bare ``mlp_head``:
``utils/convert.py::convert_vit_with_keel_post_ln``,
``utils/from_jax.py::vit_with_keel_post_ln_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import Attention, FeedForward, LayerNorm
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default, default_device, pair
from .vit import init_modules_like_jax


class ViT(nn.Module):
    """reference vit_with_keel_post_ln.py:121 — same keyword constructor, with
    ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/vit.py``."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 pool: str = "cls", channels: int = 3, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, keel_residual_scale: Optional[float] = None, flash: Optional[bool] = None,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_height // patch_height) * (image_width // patch_width)
        num_cls = 1 if pool == "cls" else 0
        self.pool, self.num_classes = pool, num_classes
        self.residual_scale = default(keel_residual_scale, depth * 2)
        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), channels * patch_height * patch_width,
                                                 dim, **kw)
        self.cls_token = nn.Parameter(torch.empty(num_cls, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(num_patches + num_cls, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList()
        for _ in range(depth):
            self.transformer.layers.append(Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout,
                                                     norm_bias=False, project_out=True, flash=flash, **kw))
            self.transformer.layers.append(FeedForward(dim, mlp_dim, dropout=dropout, norm_bias=False, **kw))
        self.transformer.post_norms = nn.ModuleList(LayerNorm(dim, use_bias=False, **kw)
                                                    for _ in range(depth * 2 - 1))
        self.mlp_head = nn.Linear(dim, num_classes, **kw) if num_classes > 0 else None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.cls_token.normal_(generator=generator)
        self.pos_embedding.normal_(generator=generator)

    def forward(self, img):
        x = self.to_patch_embedding(img)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        x = self.dropout(x + self.pos_embedding[: x.shape[1]].to(x.dtype))
        for index, layer in enumerate(self.transformer.layers):
            out = layer(x)
            x = out + x if index == 0 else self.transformer.post_norms[index - 1](out + x * self.residual_scale)
        if self.mlp_head is None:
            return x
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return self.mlp_head(x)
