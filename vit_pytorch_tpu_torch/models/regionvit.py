"""RegionViT, regional-to-local attention (reference regionvit.py:194-281),
port of ``vit_pytorch_tpu/models/regionvit.py``.

Two token streams on NCHW maps (the JAX package's are NHWC): local tokens
from a convolution of stride 4 (or three 3 x 3 convolutions with
``tokenize_local_3_conv``) and one region token a ``window_size`` x
``window_size`` window of them (a 1x1 convolution of the region's pixels).
A layer's one :class:`RegionAttention` runs twice with the same weights:
the region tokens attend each other, then each window's region token and
its local tokens attend together with a learned relative-position bias,
padded with zeros for the region token (regionvit.py:139-190); a
feed-forward follows on the window.  Each stage after the first starts with
a 3 x 3 convolution of stride 2 shared by both streams (and, with
``use_peg``, the position generator on the local tokens).  The attention
goes through ``ops/attention.py::dot_product_attention``, the composite at
these sizes (dim_head 32), as in the JAX package.

The state_dict is the reference's (``local_encoder`` or
``local_encoder.0|1|3|4|6``, ``region_encoder.1``, ``layers.s.0.conv`` the
downsampling, ``layers.s.1.proj`` the position generator,
``layers.s.2.local_rel_pos_bias`` and ``layers.s.2.layers.N.0|1`` the
transformer, ``to_logits.1|2``): ``utils/convert.py::convert_regionvit``,
``utils/from_jax.py::regionvit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from einops import rearrange
from einops.layers.torch import Rearrange, Reduce
from torch import nn

from ..nn.blocks import GELU, LN_EPS
from ..ops.attention import dot_product_attention
from ..utils.helpers import cast_tuple, default_device
from .cvt import ChanLayerNorm, reset_chan_norms
from .sep_vit import PEG
from .vit import init_modules_like_jax


def region_rel_pos_indices(wh: int, ww: int, window_size: int) -> np.ndarray:
    """(wh ww, wh ww) rows of the (2w - 1)^2 bias table between the local
    tokens of one window, with the index formula of the JAX module
    (regionvit.py:152-154): ``rel[0] * 1 + rel[1] * (2w - 1)``."""
    gx, gy = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel()])
    rel = grid[:, :, None] - grid[:, None, :] + (window_size - 1)
    return rel[0] * 1 + rel[1] * (window_size * 2 - 1)


class Downsample(nn.Module):
    """reference regionvit.py:28-35: a 3 x 3 convolution of stride 2."""

    def __init__(self, dim_in: int, dim_out: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv2d(dim_in, dim_out, 3, stride=2, padding=1, device=device, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class RegionAttention(nn.Module):
    """reference regionvit.py:62-112, the JAX ``RegionAttention``: LayerNorm,
    a bias-free qkv projection, the dispatcher with the bias it is given, a
    projection out and dropout (``to_out.0``)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32, dropout: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))

    def forward(self, x, rel_pos_bias=None):
        b, n, _ = x.shape
        q, k, v = self.to_qkv(self.norm(x)).reshape(b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        out = dot_product_attention(q, k, v, scale=self.dim_head**-0.5, bias=rel_pos_bias,
                                    dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Sequential):
    """reference regionvit.py:53-60, the JAX ``RegionFeedForward``:
    LayerNorm, Linear to ``dim * mult``, GELU, dropout, Linear back
    (``0|1|4``)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, *, device=None, dtype=None):
        kw = {"device": device, "dtype": dtype}
        super().__init__(nn.LayerNorm(dim, eps=LN_EPS, **kw), nn.Linear(dim, dim * mult, **kw), GELU(),
                         nn.Dropout(dropout), nn.Linear(dim * mult, dim, **kw))


class R2LTransformer(nn.Module):
    """reference regionvit.py:114-190, the JAX ``R2LTransformer``: the
    learned ((2w - 1)^2, heads) table ``local_rel_pos_bias`` and the layers
    of region and window attention (one module a layer) and
    feed-forward."""

    def __init__(self, dim: int, *, window_size: int, depth: int = 4, heads: int = 4, dim_head: int = 32,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.window_size = window_size
        self.local_rel_pos_bias = nn.Embedding((2 * window_size - 1) ** 2, heads, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList([RegionAttention(dim, heads, dim_head, attn_dropout, **kw),
                           FeedForward(dim, dropout=ff_dropout, **kw)])
            for _ in range(depth)
        )

    def attention_bias(self, wh: int, ww: int) -> torch.Tensor:
        """The (heads, 1 + wh ww, 1 + wh ww) bias of a window's attention: the
        table's rows at :func:`region_rel_pos_indices`, zeros in the region
        token's row and column."""
        table = self.local_rel_pos_bias.weight
        idx = torch.from_numpy(region_rel_pos_indices(wh, ww, self.window_size)).to(table.device)
        return F.pad(table[idx].permute(2, 0, 1), (1, 0, 1, 0))

    def forward(self, local_tokens, region_tokens):
        b, d, lh, lw = local_tokens.shape
        rh, rw = region_tokens.shape[-2:]
        wh, ww = lh // rh, lw // rw
        bias = self.attention_bias(wh, ww)
        local = rearrange(local_tokens, "b d (h p1) (w p2) -> (b h w) (p1 p2) d", p1=wh, p2=ww)
        region = rearrange(region_tokens, "b d h w -> b (h w) d")
        for attn, ff in self.layers:
            region = attn(region) + region
            both = torch.cat([region.reshape(b * rh * rw, 1, d), local], dim=1)
            both = attn(both, rel_pos_bias=bias) + both
            both = ff(both) + both
            region, local = both[:, 0].reshape(b, rh * rw, d), both[:, 1:]
        local = rearrange(local, "(b h w) (p1 p2) d -> b d (h p1) (w p2)", h=rh, w=rw, p1=wh, p2=ww)
        return local, rearrange(region, "b (h w) d -> b d h w", h=rh, w=rw)


class RegionViT(nn.Module):
    """reference regionvit.py:194 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py`` (the bias
    tables unit normal, as the JAX init)."""

    def __init__(self, *, dim=(64, 128, 256, 512), depth=(2, 2, 8, 2), window_size: int = 7,
                 num_classes: int = 1000, tokenize_local_3_conv: bool = False, local_patch_size: int = 4,
                 use_peg: bool = False, attn_dropout: float = 0.0, ff_dropout: float = 0.0, channels: int = 3,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        dim, depth = cast_tuple(dim, 4), cast_tuple(depth, 4)
        if len(dim) != 4 or len(depth) != 4:
            raise ValueError("dim and depth need to be 4 entries, one a stage")
        self.region_patch_size = region_patch_size = local_patch_size * window_size
        init_dim, last_dim = dim[0], dim[-1]
        if tokenize_local_3_conv:
            self.local_encoder = nn.Sequential(
                nn.Conv2d(channels, init_dim, 3, stride=2, padding=1, **kw), ChanLayerNorm(init_dim, **kw), GELU(),
                nn.Conv2d(init_dim, init_dim, 3, stride=2, padding=1, **kw), ChanLayerNorm(init_dim, **kw), GELU(),
                nn.Conv2d(init_dim, init_dim, 3, stride=1, padding=1, **kw))
        else:
            self.local_encoder = nn.Conv2d(channels, init_dim, 8, stride=4, padding=3, **kw)
        self.region_encoder = nn.Sequential(
            Rearrange("b c (h p1) (w p2) -> b (c p1 p2) h w", p1=region_patch_size, p2=region_patch_size),
            nn.Conv2d(region_patch_size**2 * channels, init_dim, 1, **kw))
        dims = (init_dim, *dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Downsample(dims[s], dims[s + 1], **kw) if s else nn.Identity(),
                PEG(dims[s + 1], **kw) if use_peg and s else nn.Identity(),
                R2LTransformer(dims[s + 1], window_size=window_size, depth=depth[s], attn_dropout=attn_dropout,
                               ff_dropout=ff_dropout, **kw),
            ])
            for s in range(4)
        )
        self.to_logits = nn.Sequential(Reduce("b c h w -> b c", "mean"), nn.LayerNorm(last_dim, eps=LN_EPS, **kw),
                                       nn.Linear(last_dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        reset_chan_norms(self)
        for m in self.modules():
            if isinstance(m, R2LTransformer):
                m.local_rel_pos_bias.weight.normal_(generator=generator)

    def forward(self, x):
        H, W = x.shape[-2:]
        if H % self.region_patch_size or W % self.region_patch_size:
            raise ValueError(f"height and width must be divisible by the region patch size {self.region_patch_size}")
        local_tokens, region_tokens = self.local_encoder(x), self.region_encoder(x)
        for down, peg, transformer in self.layers:
            local_tokens, region_tokens = down(local_tokens), down(region_tokens)
            local_tokens, region_tokens = transformer(peg(local_tokens), region_tokens)
        return self.to_logits(region_tokens)
