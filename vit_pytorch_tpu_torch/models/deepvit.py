"""DeepViT, re-attention (reference deepvit.py:87-130), port of
``vit_pytorch_tpu/models/deepvit.py``.

``ReAttention`` mixes the post-softmax maps across heads with a learned
(heads, heads) matrix, then LayerNorms over the head axis
(deepvit.py:34-63).  It needs the materialized attention matrix, so it is
plain PyTorch here as it is plain XLA in the JAX package: no kernel.

The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``pos_embedding``, ``cls_token``, ``transformer.layers.N.0.norm|to_qkv|
reattn_weights|reattn_norm.1|to_out.0``, ``transformer.layers.N.1.net.*``,
``mlp_head.0|1``): ``utils/convert.py::convert_deepvit``,
``utils/from_jax.py::deepvit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import FeedForward, LayerNorm
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device
from .vit import init_modules_like_jax


class HeadsLast(nn.Module):
    """(b, h, i, j) <-> (b, i, j, h): the reference's Rearranges around the
    re-attention's LayerNorm."""

    def __init__(self, to_last: bool):
        super().__init__()
        self.to_last = to_last

    def forward(self, x):
        return x.permute(0, 2, 3, 1) if self.to_last else x.permute(0, 3, 1, 2)


class ReAttention(nn.Module):
    """reference deepvit.py:17-70: LN, bias-free ``to_qkv``, softmax of the
    f32 logits cast to x's dtype, dropout, the head mix, a LayerNorm over
    heads, the product with v, ``to_out`` with its dropout."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = LayerNorm(dim, **kw)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, **kw)
        self.dropout = nn.Dropout(dropout)
        self.reattn_weights = nn.Parameter(torch.empty(heads, heads, **kw))
        self.reattn_norm = nn.Sequential(HeadsLast(True), LayerNorm(heads, **kw), HeadsLast(False))
        self.to_out = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = self.to_qkv(self.norm(x)).reshape(b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.dim_head**-0.5
        attn = self.dropout(dots.softmax(dim=-1).to(x.dtype))
        attn = torch.einsum("bhij,hg->bgij", attn, self.reattn_weights.to(attn.dtype))
        out = torch.matmul(self.reattn_norm(attn), v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class DeepViT(nn.Module):
    """reference deepvit.py:87 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, pool: str = "cls", channels: int = 3, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        self.pool = pool
        num_patches = (image_size // patch_size) ** 2
        self.to_patch_embedding = PatchEmbedding((patch_size, patch_size), channels * patch_size**2, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            nn.ModuleList([ReAttention(dim, heads, dim_head, dropout, **kw), FeedForward(dim, mlp_dim, dropout, **kw)])
            for _ in range(depth)
        )
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        for p in (self.pos_embedding, self.cls_token):
            p.normal_(generator=generator)
        for attn, _ in self.transformer.layers:
            attn.reattn_weights.normal_(generator=generator)

    def forward(self, img):
        x = self.to_patch_embedding(img)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = self.dropout(x + self.pos_embedding[:, : n + 1].to(x.dtype))
        for attn, ff in self.transformer.layers:
            x = attn(x) + x
            x = ff(x) + x
        return self.mlp_head(x.mean(dim=1) if self.pool == "mean" else x[:, 0])
