"""ViT for 1-D sequences (reference vit_1d.py:72-113), port of
``vit_pytorch_tpu/models/vit_1d.py``: patches of ``patch_size`` steps, the
LN -> Linear -> LN embedding, a cls token, a learned position table, the
``Transformer`` without its final norm and an LN -> Linear head.

The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``cls_token`` (dim,), ``pos_embedding`` (1, n + 1, dim), ``transformer.*``,
``mlp_head.0|1``), which ``utils/convert.py::convert_vit_1d`` maps onto the
JAX params and ``utils/from_jax.py::vit_1d_state_dict_from_jax`` back.  On
the card in bf16 the transformer runs the whole-layer kernels, or the
attention-block kernels in training with dropout.  :class:`PatchViT` is the
body that ``models/vit_3d.py`` shares.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn.blocks import LayerNorm, Transformer
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device
from .vit import init_modules_like_jax


class PatchViT(nn.Module):
    """The ViT-1D / ViT-3D body on ``patch`` ((p,) or (pf, p1, p2)) and
    ``num_patches``: embedding, cls token of shape ``cls_shape``, position
    table, a ``Transformer`` without final norm, ``pool`` ("cls" or "mean")
    and the LN -> Linear head; parameters initialised as the JAX package
    does from ``generator`` (unit normal cls token and table), on the card
    unless ``device`` names another."""

    def __init__(self, patch, num_patches: int, *, cls_shape, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, pool: str, channels: int, dim_head: int, dropout: float, emb_dropout: float,
                 flash: Optional[bool], device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        self.pool, self.dim = pool, dim
        self.to_patch_embedding = PatchEmbedding(patch, channels * math.prod(patch), dim, **kw)
        self.cls_token = nn.Parameter(torch.empty(*cls_shape, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, dropout, final_norm=False, flash=flash,
                                       **kw)
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.cls_token.normal_(generator=generator)
        self.pos_embedding.normal_(generator=generator)

    def forward(self, x):
        x = self.to_patch_embedding(x)
        b, n, _ = x.shape
        cls = self.cls_token.to(x.dtype).reshape(1, 1, -1).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding[:, : n + 1].to(x.dtype)
        x = self.transformer(self.dropout(x))
        return self.mlp_head(x.mean(dim=1) if self.pool == "mean" else x[:, 0])


class ViT(PatchViT):
    """reference vit_1d.py:72 — same keyword constructor, with ``flash``,
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``.  Input
    (b, channels, seq_len)."""

    def __init__(self, *, seq_len: int, patch_size: int, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, channels: int = 3, dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 flash: Optional[bool] = None, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        if seq_len % patch_size:
            raise ValueError("seq_len must be divisible by the patch size.")
        super().__init__((patch_size,), seq_len // patch_size, cls_shape=(dim,), num_classes=num_classes, dim=dim,
                         depth=depth, heads=heads, mlp_dim=mlp_dim, pool="cls", channels=channels, dim_head=dim_head,
                         dropout=dropout, emb_dropout=emb_dropout, flash=flash, device=device, dtype=dtype,
                         generator=generator)
