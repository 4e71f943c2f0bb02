"""SimpleViT with specialized cls-token parameters (reference
simple_vit_with_specialized_cls.py:140-205), port of
``vit_pytorch_tpu/models/simple_vit_with_specialized_cls.py``: a cls token
is prepended to the patches, and every LayerNorm (and, in the first
``specialize_qkv_depth`` layers, the qkv projection) has one parameter set
for the cls token and one for the patches; the head reads the cls token.

The state_dict keeps the reference's layout (``cls_token``,
``transformer.layers.N.0.norm.fns.0|1``, ``.to_qkv`` or, specialized,
``.to_qkv.fns.0|1``, ``.to_out``; ``transformer.layers.N.1.norm.fns.0|1``,
``.net.0|2``; ``transformer.norm.fns.0|1``), which ``utils/convert.py::
convert_simple_vit_with_specialized_cls`` maps where no qkv is specialized.
The attention calls ``ops/attention.py::dot_product_attention`` itself, as
the JAX model does: the composite on the card at SimpleViT's token counts.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import GELU, LayerNorm
from ..ops.attention import dot_product_attention
from ..utils.helpers import default_device
from .simple_vit import SimpleViTBase, image_grid


class Specialized(nn.Module):
    """``fns.0`` on the first ``n_cls`` tokens, ``fns.1`` on the rest
    (reference :36-57)."""

    def __init__(self, cls_fn: nn.Module, patch_fn: nn.Module):
        super().__init__()
        self.fns = nn.ModuleList([cls_fn, patch_fn])

    def forward(self, x, n_cls: int):
        return torch.cat([self.fns[0](x[:, :n_cls]), self.fns[1](x[:, n_cls:])], dim=1)


class SpecializedAttention(nn.Module):
    """reference :75-116."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, specialize_qkv: bool = False, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm = Specialized(LayerNorm(dim, **kw), LayerNorm(dim, **kw))
        qkv = lambda: nn.Linear(dim, inner * 3, bias=False, **kw)
        self.to_qkv = Specialized(qkv(), qkv()) if specialize_qkv else qkv()
        self.to_out = nn.Linear(inner, dim, bias=False, **kw)

    def forward(self, x, n_cls: int):
        b, n, _ = x.shape
        x = self.norm(x, n_cls)
        qkv = self.to_qkv(x, n_cls) if isinstance(self.to_qkv, Specialized) else self.to_qkv(x)
        q, k, v = qkv.reshape(b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        out = dot_product_attention(q, k, v)
        return self.to_out(out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head))


class SpecializedFeedForward(nn.Module):
    """reference :59-73: specialized LayerNorms, a shared MLP."""

    def __init__(self, dim: int, hidden_dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm = Specialized(LayerNorm(dim, **kw), LayerNorm(dim, **kw))
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim, **kw), GELU(), nn.Linear(hidden_dim, dim, **kw))

    def forward(self, x, n_cls: int):
        return self.net(self.norm(x, n_cls))


class SpecializedTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, specialize_qkv_depth: int, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([SpecializedAttention(dim, heads, dim_head, specialize_qkv=i < specialize_qkv_depth, **kw),
                           SpecializedFeedForward(dim, mlp_dim, **kw)])
            for i in range(depth)
        )
        self.norm = Specialized(LayerNorm(dim, **kw), LayerNorm(dim, **kw))

    def forward(self, x, n_cls: int = 1):
        for attn, ff in self.layers:
            x = attn(x, n_cls) + x
            x = ff(x, n_cls) + x
        return self.norm(x, n_cls)


class SimpleViT(SimpleViTBase):
    """reference simple_vit_with_specialized_cls.py:140 — same keyword
    constructor (``specialize_qkv_depth`` defaults to ``depth // 3``), with
    ``device``, ``dtype`` and ``generator`` as in ``models/simple_vit.py``;
    the cls token drawn from a normal of std 1e-2."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 channels: int = 3, dim_head: int = 64, specialize_qkv_depth: Optional[int] = None, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        device = default_device(device)
        specialize = depth // 3 if specialize_qkv_depth is None else specialize_qkv_depth
        transformer = SpecializedTransformer(dim, depth, heads, dim_head, mlp_dim, specialize, device=device,
                                             dtype=dtype)
        super().__init__(*image_grid(image_size, patch_size), channels=channels, num_classes=num_classes, dim=dim,
                         depth=depth, heads=heads, mlp_dim=mlp_dim, dim_head=dim_head, flash=None,
                         transformer=transformer, device=device, dtype=dtype, generator=generator)
        self.cls_token = nn.Parameter(torch.empty(dim, device=device, dtype=dtype))
        self.cls_token.data.normal_(std=1e-2, generator=generator)

    def forward(self, img):
        x = self.embed(img)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], 1, -1)
        x = self.transformer(torch.cat([cls, x], dim=1))
        return self.linear_head(x[:, 0])
