"""ViT for small datasets, shifted patch tokens and locality self-attention
(reference vit_for_small_dataset.py:98-140), port of
``vit_pytorch_tpu/models/vit_for_small_dataset.py``.

SPT (vit_for_small_dataset.py:81-96) stacks the image and its four
diagonal one-pixel shifts on the channels (``F.pad``'s negative pads crop,
as the JAX ``_pad_shift`` does) before the patchify, a LayerNorm and a
Linear.  LSA (:30-64) learns its logits' log-scale and masks each token's
own key: the scale goes to ``ops/attention.py::dot_product_attention`` as a
0-d tensor, ``exp(temperature)``, never a Python number (no host sync, and
the temperature keeps its gradient), with the boolean mask ``~eye(n)``; a
tensor scale and a mask take the composite, as the JAX dispatcher keeps a
traced scale and a mask on XLA (JAX ops/attention.py:200-211).

The state_dict is the reference's (``to_patch_embedding.to_patch_tokens.1|2``,
``pos_embedding``, ``cls_token``, ``transformer.layers.N.0`` the LSA with
its ``temperature``, ``transformer.layers.N.1.net.0|1|4``, ``mlp_head.0|1``):
``utils/convert.py::convert_small_dataset_vit``,
``utils/from_jax.py::small_dataset_vit_state_dict_from_jax``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import FeedForward, LayerNorm
from ..nn.patch import Patchify
from ..ops.attention import dot_product_attention
from ..utils.helpers import default_device, pair
from .vit import init_modules_like_jax

# (left, right, top, bottom) pads of the four shifted copies (reference :88)
SHIFTS = ((1, -1, 0, 0), (-1, 1, 0, 0), (0, 0, 1, -1), (0, 0, -1, 1))


class SPT(nn.Module):
    """reference vit_for_small_dataset.py:81-96: the image and its four
    shifts, patchified (``to_patch_tokens.0``), normed and projected."""

    def __init__(self, *, dim: int, patch_size: int, channels: int = 3, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        patch_dim = patch_size * patch_size * 5 * channels
        self.to_patch_tokens = nn.Sequential(
            Patchify(patch_size, patch_size), LayerNorm(patch_dim, **kw), nn.Linear(patch_dim, dim, **kw))

    def forward(self, x):
        x = torch.cat([x, *(F.pad(x, shift) for shift in SHIFTS)], dim=1)
        return self.to_patch_tokens(x)


class LSA(nn.Module):
    """reference vit_for_small_dataset.py:30-64: LayerNorm, a bias-free
    qkv projection, the attention at scale ``exp(temperature)`` with each
    query's own key masked, the projection out and its dropout."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.temperature = nn.Parameter(torch.full((), math.log(dim_head**-0.5), **kw))
        self.norm = LayerNorm(dim, **kw)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = self.to_qkv(self.norm(x)).reshape(b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        mask = ~torch.eye(n, dtype=torch.bool, device=x.device)
        out = dot_product_attention(q, k, v, scale=self.temperature.exp(), mask=mask,
                                    dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class ViT(nn.Module):
    """reference vit_for_small_dataset.py:98 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, image_size, patch_size: int, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, pool: str = "cls", channels: int = 3, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, flash: Optional[bool] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        if image_height % patch_size or image_width % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls (cls token) or mean (mean pooling)")
        del flash  # the LSA's traced scale and mask keep every call on the composite
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_height // patch_size) * (image_width // patch_size)
        self.pool = pool
        self.to_patch_embedding = SPT(dim=dim, patch_size=patch_size, channels=channels, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            nn.ModuleList([LSA(dim, heads, dim_head, dropout, **kw), FeedForward(dim, mlp_dim, dropout, **kw)])
            for _ in range(depth)
        )
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)
        for attn, _ in self.transformer.layers:
            attn.temperature.fill_(math.log(attn.dim_head**-0.5))

    def forward(self, img):
        x = self.to_patch_embedding(img)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = self.dropout(x + self.pos_embedding[:, : n + 1].to(x.dtype))
        for attn, ff in self.transformer.layers:
            x = attn(x) + x
            x = ff(x) + x
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return self.mlp_head(x)
