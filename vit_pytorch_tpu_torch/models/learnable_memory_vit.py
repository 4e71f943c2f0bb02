"""ViT with a learnable-memory adapter (reference learnable_memory_vit.py:
107-218), port of ``vit_pytorch_tpu/models/learnable_memory_vit.py``.

The :class:`ViT`'s attention takes its keys and values over the normed
tokens followed by the layer's memories when it is given some (the shared
``nn/blocks.py::Attention`` with ``kv_include_self=True`` and split q and
kv projections, so that the plain and the adapted calls use the same
weights).  The :class:`Adapter` wraps a ViT and shares its modules: a
memory class token goes in front of the ViT's tokens, each layer's
memories extend its keys and values, and a static (n + 1, n + 1 + m) mask
keeps the ViT's tokens from attending the memory class token and the
memories (learnable_memory_vit.py:193-196), so that the ViT's own outputs
stay as they were; a new head reads the memory class token.  A mask and
the split projections refuse the attention-block kernels, so every
attention takes ``ops/attention.py::dot_product_attention``'s composite, as
in the JAX package.  :func:`freeze_all_layers_` is the reference's freezing
of the wrapped ViT (the JAX package labels its parameters for optax
instead, ``adapter_param_labels``).

The ViT's state_dict is the reference's (``to_patch_embedding.1|2|3``,
``pos_embedding``, ``cls_token``, ``transformer.layers.N.0`` with ``norm``,
``to_q``, ``to_kv``, ``to_out.0``, ``transformer.layers.N.1.net.0|1|4``,
``mlp_head.0|1``): ``utils/convert.py::convert_learnable_memory_vit``; the
Adapter's the ViT's under ``vit.``, ``memory_cls_token``,
``memories_per_layer`` and ``mlp_head.0|1``: ``convert_adapter``;
``utils/from_jax.py::learnable_memory_vit_state_dict_from_jax`` and
``adapter_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn.blocks import LN_EPS, Attention, FeedForward
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device, pair, table_device
from .vit import init_modules_like_jax


def freeze_all_layers_(module: nn.Module) -> None:
    """reference learnable_memory_vit.py:18-26: no gradient for any parameter
    of ``module``."""
    for param in module.parameters():
        param.requires_grad = False


class Transformer(nn.Module):
    """reference learnable_memory_vit.py:90-106, the JAX
    ``MemoryTransformer``: each layer's attention over [x, its memories]
    (with ``memories``, (depth, m, dim) or (depth, b, m, dim)) under
    ``attn_mask``, and the feed-forward, each residual."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, project_out=True,
                                     kv_include_self=True, force_split_qkv=True, **kw),
                           FeedForward(dim, mlp_dim, dropout=dropout, **kw)])
            for _ in range(depth)
        )

    def forward(self, x, attn_mask=None, memories=None):
        for i, (attn, ff) in enumerate(self.layers):
            context = None
            if memories is not None:
                context = memories[i].to(x.dtype)
                if context.dim() == 2:
                    context = context.expand(x.shape[0], -1, -1)
            x = attn(x, context, mask=attn_mask) + x
            x = ff(x) + x
        return x


class ViT(nn.Module):
    """reference learnable_memory_vit.py:107 — same keyword constructor,
    with ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``
    (the class token and the position embedding unit normal, as the JAX
    init)."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 pool: str = "cls", channels: int = 3, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls (cls token) or mean (mean pooling)")
        kw = {"device": default_device(device), "dtype": dtype}
        self.dim, self.depth = dim, depth
        self.num_patches = (image_height // patch_height) * (image_width // patch_width)
        patch_dim = channels * patch_height * patch_width
        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), patch_dim, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, self.num_patches + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, dropout, **kw)
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim, eps=LN_EPS, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)

    def img_to_tokens(self, img):
        """The class token and the patches' embeddings, plus the position
        embedding, through the embedding dropout."""
        x = self.to_patch_embedding(img)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(x.dtype)
        return self.dropout(x)

    def forward(self, img):
        x = self.transformer(self.img_to_tokens(img))
        return self.mlp_head(x[:, 0])


class Adapter(nn.Module):
    """reference learnable_memory_vit.py:157 — same keyword constructor
    (``vit``, ``num_memories_per_layer``, ``num_classes``), with ``generator``
    seeding the new parameters (the memory class token and the memories unit
    normal, the head as ``models/vit.py``); they take the ViT's device and
    dtype.  The wrapped ViT stays trainable unless the caller freezes it
    (:func:`freeze_all_layers_`)."""

    def __init__(self, *, vit: ViT, num_memories_per_layer: int = 10, num_classes: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ref = vit.pos_embedding
        kw = {"device": ref.device, "dtype": ref.dtype}
        dim, m = vit.dim, num_memories_per_layer
        self.vit = vit
        self.memory_cls_token = nn.Parameter(torch.empty(dim, **kw))
        self.memories_per_layer = nn.Parameter(torch.empty(vit.depth, m, dim, **kw))
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim, eps=LN_EPS, **kw), nn.Linear(dim, num_classes, **kw))
        # queries [memory cls, cls + patches], keys [memory cls, cls + patches, memories]
        n = vit.num_patches + 1
        mask = np.pad(np.ones((n, n), dtype=bool), ((0, 0), (1, m)), constant_values=False)
        mask = np.pad(mask, ((1, 0), (0, 0)), constant_values=True)
        self.register_buffer("attn_mask", torch.from_numpy(mask)[None, None].to(table_device(kw["device"])),
                             persistent=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self.mlp_head, generator)
        self.memory_cls_token.normal_(generator=generator)
        self.memories_per_layer.normal_(generator=generator)

    def forward(self, img):
        tokens = self.vit.img_to_tokens(img)
        mem_cls = self.memory_cls_token.to(tokens.dtype).expand(tokens.shape[0], 1, -1)
        out = self.vit.transformer(torch.cat([mem_cls, tokens], dim=1), attn_mask=self.attn_mask,
                                   memories=self.memories_per_layer)
        return self.mlp_head(out[:, 0])
