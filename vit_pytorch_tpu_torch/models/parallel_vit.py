"""Parallel ViT, N parallel attention and feed-forward branches summed in
each layer (reference parallel_vit.py:14-20, 70-135), port of
``vit_pytorch_tpu/models/parallel_vit.py``.

The patch embedding is a bare Linear (reference :101-104), the transformer
has no final norm, the head is LN -> Linear.  Each branch is the shared
``Attention`` and ``FeedForward``, called as the JAX model calls them
(without a residual): on the card in bf16 each attention branch runs the
attention-block kernels (4 launches forward; with dropout in training, 11
a step), the feed-forward plain PyTorch.

The state_dict is the reference's (``to_patch_embedding.1``,
``transformer.layers.N.0.fns.J.*``, ``transformer.layers.N.1.fns.J.*``,
``mlp_head.0|1``): ``utils/convert.py::convert_parallel_vit``,
``utils/from_jax.py::parallel_vit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import Attention, FeedForward, LayerNorm
from ..nn.patch import Patchify
from ..utils.helpers import default_device, pair
from .vit import init_modules_like_jax


class Parallel(nn.Module):
    """The sum of the branches' outputs (reference parallel_vit.py:14-20)."""

    def __init__(self, *fns: nn.Module):
        super().__init__()
        self.fns = nn.ModuleList(fns)

    def forward(self, x):
        return sum(fn(x) for fn in self.fns)


class ViT(nn.Module):
    """reference parallel_vit.py:90 — same keyword constructor, with
    ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/vit.py``."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 pool: str = "cls", num_parallel_branches: int = 2, channels: int = 3, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, flash: Optional[bool] = None, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        (image_height, image_width), (patch_height, patch_width) = pair(image_size), pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        self.pool = pool
        num_patches = (image_height // patch_height) * (image_width // patch_width)
        self.to_patch_embedding = nn.Sequential(Patchify(patch_height, patch_width), nn.Linear(
            channels * patch_height * patch_width, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        attn = lambda: Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, flash=flash, **kw)
        ff = lambda: FeedForward(dim, mlp_dim, dropout, **kw)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            nn.ModuleList([Parallel(*(attn() for _ in range(num_parallel_branches))),
                           Parallel(*(ff() for _ in range(num_parallel_branches)))])
            for _ in range(depth)
        )
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)

    def forward(self, img):
        x = self.to_patch_embedding(img)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = self.dropout(x + self.pos_embedding[:, : n + 1].to(x.dtype))
        for attns, ffs in self.transformer.layers:
            x = attns(x) + x
            x = ffs(x) + x
        return self.mlp_head(x.mean(dim=1) if self.pool == "mean" else x[:, 0])
