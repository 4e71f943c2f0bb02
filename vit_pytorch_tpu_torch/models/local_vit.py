"""LocalViT, the depthwise-convolution feed-forward (reference
local_vit.py:114-150), port of ``vit_pytorch_tpu/models/local_vit.py``.

Each layer is the shared pre-norm ``Attention`` with its residual, then a
convolutional feed-forward on the patch tokens alone, the cls token left
out and put back (local_vit.py:19-27): LayerNorm over the channels of the
(b, n, c) tokens, the tokens as an NCHW image, a 1x1 convolution,
hard-swish, a 3x3 depthwise and a 1x1 convolution, hard-swish, dropout, a
1x1 convolution back to ``dim``, dropout.  That is the JAX module's intended
order (its note: the reference normalises the rearranged image and cannot
run); the convolutions are cuDNN's, as XLA computes them there.  At 257
tokens the attention-block kernels refuse the ``Attention`` (n > 208) and
the dispatcher takes its composite, as in the JAX package.

The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``pos_embedding``, ``cls_token``, ``transformer.layers.N.0.fn`` the
attention, ``transformer.layers.N.1.fn.fn.net.0|1|3.net.0|3.net.1|6`` the
feed-forward, ``mlp_head.0|1``): ``utils/convert.py::convert_local_vit``,
``utils/from_jax.py::local_vit_state_dict_from_jax``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn.blocks import Attention, LayerNorm
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device
from .vit import init_modules_like_jax


class Residual(nn.Module):
    """``fn(x) + x``, the module at ``fn`` (the reference's ``Residual``;
    Twins-SVT's too)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


class ExcludeCLS(nn.Module):
    """``fn`` on the tokens after the first, the first put back in front
    (reference local_vit.py:19-27)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return torch.cat([x[:, :1], self.fn(x[:, 1:])], dim=1)


class DepthWiseConv2d(nn.Module):
    """A depthwise k x k convolution then a 1x1 one (reference
    local_vit.py:31-39, ``net.0|1``; RvT's too, bias-free)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, padding: int, bias: bool = True, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.net = nn.Sequential(
            nn.Conv2d(dim_in, dim_in, kernel_size, padding=padding, groups=dim_in, bias=bias, **kw),
            nn.Conv2d(dim_in, dim_out, 1, bias=bias, **kw),
        )

    def forward(self, x):
        return self.net(x)


class ConvFeedForward(nn.Module):
    """The JAX ``ConvFeedForward`` (local_vit.py:24-51) on (b, n, c) tokens
    of a square grid; ``net`` indexed as the reference's (0 LayerNorm, 1 the
    1x1 convolution in, 3 the depthwise pair, 6 the 1x1 convolution out)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.net = nn.Sequential(
            LayerNorm(dim, **kw),
            nn.Conv2d(dim, hidden_dim, 1, **kw),
            nn.Hardswish(),
            DepthWiseConv2d(hidden_dim, hidden_dim, 3, 1, **kw),
            nn.Hardswish(),
            nn.Dropout(dropout),
            nn.Conv2d(hidden_dim, dim, 1, **kw),
            nn.Dropout(dropout),
        )

    def forward(self, x):
        b, n, c = x.shape
        side = int(math.sqrt(n))
        x = self.net[0](x).transpose(1, 2).reshape(b, c, side, side)
        x = self.net[1:](x)
        return x.flatten(2).transpose(1, 2)


class LocalViT(nn.Module):
    """reference local_vit.py:114 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, channels: int = 3, dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 flash: Optional[bool] = None, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_size // patch_size) ** 2
        self.to_patch_embedding = PatchEmbedding((patch_size, patch_size), channels * patch_size**2, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            nn.ModuleList([
                Residual(Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, project_out=True,
                                   flash=flash, **kw)),
                ExcludeCLS(Residual(ConvFeedForward(dim, mlp_dim, dropout, **kw))),
            ])
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
        for attn, ff in self.transformer.layers:
            x = ff(attn(x))
        return self.mlp_head(x[:, 0])

