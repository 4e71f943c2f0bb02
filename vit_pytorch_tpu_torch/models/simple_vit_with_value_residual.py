"""SimpleViT with value residual learning (reference
simple_vit_with_value_residual.py:102-159), port of
``vit_pytorch_tpu/models/simple_vit_with_value_residual.py``: the first
layer's values are mixed into every later layer's values by a learned
per-head sigmoid gate of the normed input (:41-67).

The state_dict keeps the reference's layout (``transformer.layers.N.0.
norm|to_qkv|to_out``, ``.to_residual_mix.0`` past layer 0, the FF a bare
``Sequential`` at ``transformer.layers.N.1.0|1|3``), which
``utils/convert.py::convert_simple_vit_with_value_residual`` maps.  The
attention calls ``ops/attention.py::dot_product_attention`` itself, as the
JAX model does; at SimpleViT's token counts it takes the composite on the
card (the dispatcher's kernel routes start at 1,024 keys).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import FeedForward, LayerNorm
from ..ops.attention import dot_product_attention
from ..utils.helpers import default_device
from .simple_vit import SimpleViTBase, image_grid


class ValueResidualAttention(nn.Module):
    """reference :40-76: returns the output and this layer's (mixed) values
    (b, heads, n, dim_head)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, learned_value_residual_mix: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = LayerNorm(dim, **kw)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, **kw)
        self.to_residual_mix = (nn.Sequential(nn.Linear(dim, heads, **kw), nn.Sigmoid())
                                if learned_value_residual_mix else None)
        self.to_out = nn.Linear(inner, dim, bias=False, **kw)

    def forward(self, x, value_residual=None):
        b, n, _ = x.shape
        x = self.norm(x)
        q, k, v = self.to_qkv(x).reshape(b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        if value_residual is not None:
            mix = 0.5 if self.to_residual_mix is None else self.to_residual_mix(x).transpose(1, 2)[..., None]
            v = v * mix + value_residual * (1.0 - mix)
        out = dot_product_attention(q, k, v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)), v


class ValueResidualTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([ValueResidualAttention(dim, heads, dim_head, learned_value_residual_mix=i > 0, **kw),
                           FeedForward(dim, mlp_dim, simple=True, **kw).net])
            for i in range(depth)
        )
        self.norm = LayerNorm(dim, **kw)

    def forward(self, x):
        value_residual = None
        for attn, ff in self.layers:
            attn_out, values = attn(x, value_residual)
            if value_residual is None:
                value_residual = values
            x = attn_out + x
            x = ff(x) + x
        return self.norm(x)


class SimpleViT(SimpleViTBase):
    """reference simple_vit_with_value_residual.py:102 — same keyword
    constructor, with ``device``, ``dtype`` and ``generator`` as in
    ``models/simple_vit.py``."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 channels: int = 3, dim_head: int = 64, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        device = default_device(device)
        transformer = ValueResidualTransformer(dim, depth, heads, dim_head, mlp_dim, device=device, dtype=dtype)
        super().__init__(*image_grid(image_size, patch_size), channels=channels, num_classes=num_classes, dim=dim,
                         depth=depth, heads=heads, mlp_dim=mlp_dim, dim_head=dim_head, flash=None,
                         transformer=transformer, device=device, dtype=dtype, generator=generator)
