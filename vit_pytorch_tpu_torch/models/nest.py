"""NesT, the nested hierarchical transformer (reference nest.py:106-180),
port of ``vit_pytorch_tpu/models/nest.py``.

A space-to-depth patch embedding (LayerNorm, a 1x1 convolution, LayerNorm
over the channels), then levels of transformers on blocks of the map
folded into the batch, 4^level blocks at a level, so the sequence is the
same length at every level (nest.py:129, 174-177), between them an
aggregation: a 3x3 convolution, a channel LayerNorm and a max-pool of
stride 2 (-inf padding).  Each level adds one learned scalar a position,
broadcast over the channels (JAX nest.py:89-90).  Attention takes q, k and
v from a 1x1 convolution, ``dim // heads`` a head (32 at the README's
widths), and goes through ``ops/attention.py::dot_product_attention``,
whose composite it takes, as in the JAX package.  The maps are NCHW (the
JAX package's NHWC), the channel norms ``models/cvt.py::ChanLayerNorm``.

The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``layers.l.0`` level l's transformer with ``pos_emb``,
``layers.N.0.norm|to_qkv|to_out.0`` and ``layers.N.1.net.0|1|4``,
``layers.l.1.0|1`` the aggregation's convolution and norm but at the last
level, ``mlp_head.0|2``): ``utils/convert.py::convert_nest``,
``utils/from_jax.py::nest_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from einops.layers.torch import Rearrange, Reduce
from torch import nn

from ..ops.attention import dot_product_attention
from ..utils.helpers import cast_tuple, default_device
from .cvt import ChanLayerNorm, FeedForward, from_heads, reset_chan_norms, to_heads
from .vit import init_modules_like_jax


class Attention(nn.Module):
    """reference nest.py:41-73, the JAX ``NestAttention``: the channel norm,
    a bias-free 1x1 convolution to q, k and v, the dispatcher, a 1x1
    convolution out and its dropout."""

    def __init__(self, dim: int, heads: int = 8, dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads, self.dim_head, self.dropout = heads, dim // heads, dropout
        inner = self.dim_head * heads
        self.norm = ChanLayerNorm(dim, **kw)
        self.to_qkv = nn.Conv2d(dim, inner * 3, 1, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Conv2d(inner, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, x):
        y, w = x.shape[-2:]
        q, k, v = (to_heads(t, self.heads) for t in self.to_qkv(self.norm(x)).chunk(3, dim=1))
        out = dot_product_attention(q, k, v, scale=self.dim_head**-0.5,
                                    dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(from_heads(out, y, w))


class Transformer(nn.Module):
    """reference nest.py:83-104, the JAX ``NestTransformer``: the learned
    scalar a position added once, then residual attention and feed-forward
    a layer."""

    def __init__(self, dim: int, seq_len: int, depth: int, heads: int, mlp_mult: int, dropout: float = 0.0, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.pos_emb = nn.Parameter(torch.empty(seq_len, **kw))
        self.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, heads, dropout, **kw), FeedForward(dim, mlp_mult, dropout, **kw)])
            for _ in range(depth)
        )

    def forward(self, x):
        h, w = x.shape[-2:]
        x = x + self.pos_emb[: h * w].reshape(1, 1, h, w).to(x.dtype)
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return x


class Aggregate(nn.Sequential):
    """The aggregation between levels (JAX nest.py:166-169): a 3x3
    convolution, the channel norm, a 3x3 max-pool of stride 2 padded with
    -inf (``nn.MaxPool2d``'s padding, as flax's ``max_pool``)."""

    def __init__(self, dim: int, dim_out: int, *, device=None, dtype=None):
        kw = {"device": device, "dtype": dtype}
        super().__init__(nn.Conv2d(dim, dim_out, 3, padding=1, **kw), ChanLayerNorm(dim_out, **kw),
                         nn.MaxPool2d(3, stride=2, padding=1))


class NesT(nn.Module):
    """reference nest.py:106 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int, heads: int,
                 num_hierarchies: int, block_repeats: Union[int, Sequence[int]], mlp_mult: int = 4, channels: int = 3,
                 dim_head: int = 64, dropout: float = 0.0, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        del dim_head  # the JAX model's (and the reference's): unused, a head is dim // heads wide
        kw = {"device": default_device(device), "dtype": dtype}
        fmap_size = image_size // patch_size
        blocks = 2 ** (num_hierarchies - 1)
        seq_len = (fmap_size // blocks) ** 2
        hierarchies = list(reversed(range(num_hierarchies)))
        mults = [2**i for i in reversed(hierarchies)]
        layer_heads = [m * heads for m in mults]
        layer_dims = [m * dim for m in mults]
        layer_dims = [*layer_dims, layer_dims[-1]]
        block_repeats = cast_tuple(block_repeats, num_hierarchies)
        self.block_sizes = [2**level for level in hierarchies]
        patch_dim = channels * patch_size**2
        self.to_patch_embedding = nn.Sequential(
            Rearrange("b c (h p1) (w p2) -> b (p1 p2 c) h w", p1=patch_size, p2=patch_size),
            ChanLayerNorm(patch_dim, **kw),
            nn.Conv2d(patch_dim, layer_dims[0], 1, **kw),
            ChanLayerNorm(layer_dims[0], **kw),
        )
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Transformer(layer_dims[i], seq_len, depth, layer_heads[i], mlp_mult, dropout, **kw),
                nn.Identity() if level == 0 else Aggregate(layer_dims[i], layer_dims[i + 1], **kw),
            ])
            for i, (level, depth) in enumerate(zip(hierarchies, block_repeats))
        )
        self.mlp_head = nn.Sequential(ChanLayerNorm(layer_dims[-1], **kw), Reduce("b c h w -> b c", "mean"),
                                      nn.Linear(layer_dims[-1], num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        reset_chan_norms(self)
        for transformer, _ in self.layers:
            transformer.pos_emb.normal_(generator=generator)

    def forward(self, img):
        x = self.to_patch_embedding(img)
        for (transformer, aggregate), block_size in zip(self.layers, self.block_sizes):
            b, c, h, w = x.shape
            bh, bw = h // block_size, w // block_size
            # (b, c, (b1 h), (b2 w)) -> ((b b1 b2), c, h, w)
            x = x.reshape(b, c, block_size, bh, block_size, bw).permute(0, 2, 4, 1, 3, 5).reshape(-1, c, bh, bw)
            x = transformer(x)
            x = x.reshape(b, block_size, block_size, c, bh, bw).permute(0, 3, 1, 4, 2, 5).reshape(b, c, h, w)
            x = aggregate(x)
        return self.mlp_head(x)

