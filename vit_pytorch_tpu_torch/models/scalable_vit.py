"""ScalableViT (reference scalable_vit.py:240-304), port of
``vit_pytorch_tpu/models/scalable_vit.py``.

A 7 x 7 convolution of stride 4, then stages on NCHW maps (the JAX
package's are NHWC), a channel LayerNorm and a 3 x 3 convolution of stride
2 between them.  A block is scalable self-attention (keys and values from
r x r convolutions of stride r, scalable_vit.py:89-90), a feed-forward, on
a stage's first block the position generator, a feed-forward and
interactive windowed self-attention (attention within windows, plus a 3 x 3
convolution of v added to its output, scalable_vit.py:144-192): the
reference names its second feed-forward and the windowed attention the
other way round (scalable_vit.py:228-237), and the order here is the one
they run in, as in the JAX package.  Every attention goes through
``ops/attention.py::dot_product_attention``.  At the README's 256 x 256 the
first stage's windows hold 64 x 64 = 4,096 tokens of dim_key 32, which the
dispatcher sends to the flash route and the kernels' 64-wide gate refuses:
the composite, which materialises the (windows, heads, 4,096, 4,096) f32
logits, as the JAX package does.

The state_dict is the reference's (``to_patches``, ``layers.s.0`` the
transformer with ``layers.N.0-4`` and ``norm``, ``layers.s.1.conv`` the
downsampling, ``mlp_head.1|2``): ``utils/convert.py::convert_scalable_vit``,
``utils/from_jax.py::scalable_vit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from einops import rearrange
from einops.layers.torch import Reduce
from torch import nn

from ..nn.blocks import LN_EPS
from ..ops.attention import dot_product_attention
from ..utils.helpers import cast_tuple, default, default_device
from .cvt import ChanLayerNorm, from_heads, reset_chan_norms, to_heads
from .regionvit import Downsample
from .sep_vit import PEG, FeedForward
from .vit import init_modules_like_jax


class ScalableSelfAttention(nn.Module):
    """reference scalable_vit.py:71-124: the channel norm, a bias-free 1x1
    convolution to q, bias-free r x r convolutions of stride r to k and v,
    the dispatcher, a 1x1 convolution out and dropout (``to_out.0``)."""

    def __init__(self, dim: int, heads: int = 8, dim_key: int = 32, dim_value: int = 32, dropout: float = 0.0,
                 reduction_factor: int = 1, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        r = reduction_factor
        self.heads, self.dim_key, self.dropout = heads, dim_key, dropout
        self.norm = ChanLayerNorm(dim, **kw)
        self.to_q = nn.Conv2d(dim, dim_key * heads, 1, bias=False, **kw)
        self.to_k = nn.Conv2d(dim, dim_key * heads, r, stride=r, bias=False, **kw)
        self.to_v = nn.Conv2d(dim, dim_value * heads, r, stride=r, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Conv2d(dim_value * heads, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, x):
        H, W = x.shape[-2:]
        x = self.norm(x)
        q, k, v = (to_heads(proj(x), self.heads) for proj in (self.to_q, self.to_k, self.to_v))
        out = dot_product_attention(q, k, v, scale=self.dim_key**-0.5,
                                    dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(from_heads(out, H, W))


class InteractiveWindowedSelfAttention(nn.Module):
    """reference scalable_vit.py:126-192: the channel norm, bias-free 1x1
    convolutions to q, k and v, attention within windows of ``window_size``
    (the whole map without one), the local interactive module (a 3 x 3
    convolution of v) added to its output, a 1x1 convolution out and
    dropout (``to_out.0``)."""

    def __init__(self, dim: int, window_size: Optional[int], heads: int = 8, dim_key: int = 32, dim_value: int = 32,
                 dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads, self.dim_key, self.window_size, self.dropout = heads, dim_key, window_size, dropout
        self.norm = ChanLayerNorm(dim, **kw)
        self.to_q = nn.Conv2d(dim, dim_key * heads, 1, bias=False, **kw)
        self.to_k = nn.Conv2d(dim, dim_key * heads, 1, bias=False, **kw)
        self.to_v = nn.Conv2d(dim, dim_value * heads, 1, bias=False, **kw)
        self.local_interactive_module = nn.Conv2d(dim_value * heads, dim_value * heads, 3, padding=1, **kw)
        self.to_out = nn.Sequential(nn.Conv2d(dim_value * heads, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, x):
        H, W = x.shape[-2:]
        wh, ww = default(self.window_size, H), default(self.window_size, W)
        if H % wh or W % ww:
            raise ValueError(f"height {H} and width {W} must be divisible by the window size {self.window_size}")
        x = self.norm(x)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        local_out = self.local_interactive_module(v)
        windows = lambda t: rearrange(t, "b (h d) (x w1) (y w2) -> (b x y) h (w1 w2) d", h=self.heads, w1=wh, w2=ww)
        out = dot_product_attention(windows(q), windows(k), windows(v), scale=self.dim_key**-0.5,
                                    dropout_rate=self.dropout if self.training else 0.0)
        out = rearrange(out, "(b x y) h (w1 w2) d -> b (h d) (x w1) (y w2)", x=H // wh, y=W // ww, w1=wh, w2=ww)
        return self.to_out(out + local_out)


class Transformer(nn.Module):
    """reference scalable_vit.py:196-238: a block is ``[ssa, ff1, peg, ff2,
    iwsa]`` (the position generator only in the first block, an identity
    elsewhere), each residual; the channel norm after the last block unless
    ``norm_output=False``."""

    def __init__(self, dim: int, depth: int, heads: int = 8, ff_expansion_factor: int = 4, dropout: float = 0.0,
                 ssa_dim_key: int = 32, ssa_dim_value: int = 32, ssa_reduction_factor: int = 1,
                 iwsa_dim_key: int = 32, iwsa_dim_value: int = 32, iwsa_window_size: Optional[int] = None,
                 norm_output: bool = True, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([
                ScalableSelfAttention(dim, heads, ssa_dim_key, ssa_dim_value, dropout, ssa_reduction_factor, **kw),
                FeedForward(dim, ff_expansion_factor, dropout, **kw),
                PEG(dim, **kw) if i == 0 else nn.Identity(),
                FeedForward(dim, ff_expansion_factor, dropout, **kw),
                InteractiveWindowedSelfAttention(dim, iwsa_window_size, heads, iwsa_dim_key, iwsa_dim_value, dropout,
                                                 **kw),
            ])
            for i in range(depth)
        )
        self.norm = ChanLayerNorm(dim, **kw) if norm_output else nn.Identity()

    def forward(self, x):
        for ssa, ff1, peg, ff2, iwsa in self.layers:
            x = ssa(x) + x
            x = ff1(x) + x
            x = peg(x)
            x = ff2(x) + x
            x = iwsa(x) + x
        return self.norm(x)


class ScalableViT(nn.Module):
    """reference scalable_vit.py:240 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, num_classes: int, dim: int, depth, heads, reduction_factor, window_size=None,
                 iwsa_dim_key=32, iwsa_dim_value=32, ssa_dim_key=32, ssa_dim_value=32, ff_expansion_factor: int = 4,
                 channels: int = 3, dropout: float = 0.0, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not isinstance(depth, (tuple, list)):
            raise ValueError("depth needs to be tuple if integers indicating number of transformer blocks at that "
                             "stage")
        kw = {"device": default_device(device), "dtype": dtype}
        stages = len(depth)
        dims = tuple((2**i) * dim for i in range(stages))
        heads, reduction_factor, window_size, ssa_dim_key, ssa_dim_value, iwsa_dim_key, iwsa_dim_value = (
            cast_tuple(t, stages) for t in (heads, reduction_factor, window_size, ssa_dim_key, ssa_dim_value,
                                            iwsa_dim_key, iwsa_dim_value))
        self.to_patches = nn.Conv2d(channels, dim, 7, stride=4, padding=3, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Transformer(dims[i], depth[i], heads[i], ff_expansion_factor, dropout, ssa_dim_key[i],
                            ssa_dim_value[i], reduction_factor[i], iwsa_dim_key[i], iwsa_dim_value[i],
                            window_size[i], norm_output=i != stages - 1, **kw),
                Downsample(dims[i], dims[i] * 2, **kw) if i != stages - 1 else nn.Identity(),
            ])
            for i in range(stages)
        )
        self.mlp_head = nn.Sequential(Reduce("b d h w -> b d", "mean"), nn.LayerNorm(dims[-1], eps=LN_EPS, **kw),
                                      nn.Linear(dims[-1], num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        reset_chan_norms(self)

    def forward(self, img):
        x = self.to_patches(img)
        for transformer, downsample in self.layers:
            x = downsample(transformer(x))
        return self.mlp_head(x)
