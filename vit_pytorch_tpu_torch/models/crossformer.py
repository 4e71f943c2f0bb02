"""CrossFormer (reference crossformer.py:208-267), port of
``vit_pytorch_tpu/models/crossformer.py``.

Four stages on NCHW maps (the JAX package's are NHWC), each a cross-scale
embedding (convolutions of several kernel sizes at one stride, their maps
concatenated, crossformer.py:14-36) and layers of short-distance attention
(within contiguous w x w windows), a feed-forward, long-distance attention
(within windows dilated across the map) and a feed-forward.  Each
attention adds a dynamic position bias: an MLP (Linear, LayerNorm, ReLU
three times, then a Linear to one value) of the (2w + 1)^2 relative offsets,
one scalar an offset, gathered at ``models/max_vit.py::rel_pos_indices``
and broadcast over the heads to (heads, w^2, w^2) (the JAX :105-113), which
``ops/attention.py::dot_product_attention`` adds to the logits: the
composite at these window sizes, as in the JAX package.  The MLP runs in
the parameters' dtype.

The state_dict is the reference's (``layers.s.0.convs.i``,
``layers.s.1.layers.N.0|1|2|3`` the short attention, its feed-forward, the
long attention and its feed-forward; each attention's ``norm`` a channel
norm, ``to_qkv``, ``dpb.0-9`` and ``to_out``; each feed-forward's
``0|1|4``; ``to_logits.1``): ``utils/convert.py::convert_crossformer``,
``utils/from_jax.py::crossformer_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from einops import rearrange
from einops.layers.torch import Reduce
from torch import nn

from ..nn.blocks import GELU, LN_EPS
from ..ops.attention import dot_product_attention
from ..utils.helpers import cast_tuple, default_device, table_device
from .cvt import ChanLayerNorm, from_heads, reset_chan_norms, to_heads
from .max_vit import rel_pos_indices
from .vit import init_modules_like_jax


class CrossEmbedLayer(nn.Module):
    """reference crossformer.py:14-36: one convolution a kernel size (sorted,
    padding (k - stride) // 2), the widths halving from the smallest kernel,
    the last taking the remainder; the maps concatenated."""

    def __init__(self, dim_in: int, dim_out: int, kernel_sizes, stride: int = 2, *, device=None, dtype=None):
        super().__init__()
        kernel_sizes = sorted(kernel_sizes)
        dim_scales = [int(dim_out / (2**i)) for i in range(1, len(kernel_sizes))]
        dim_scales = [*dim_scales, dim_out - sum(dim_scales)]
        self.convs = nn.ModuleList(
            nn.Conv2d(dim_in, d, k, stride=stride, padding=(k - stride) // 2, device=device, dtype=dtype)
            for k, d in zip(kernel_sizes, dim_scales)
        )

    def forward(self, x):
        return torch.cat([conv(x) for conv in self.convs], dim=1)


def dynamic_position_bias(dim: int, *, device=None, dtype=None) -> nn.Sequential:
    """reference crossformer.py:40-53, the JAX ``DynamicPositionBias``: (Linear,
    LayerNorm, ReLU) three times, then a Linear to one value (``dpb.0-9``)."""
    kw = {"device": device, "dtype": dtype}
    layers = [nn.Linear(2, dim, **kw)]
    for i in range(3):
        layers += [nn.LayerNorm(dim, eps=LN_EPS, **kw), nn.ReLU(), nn.Linear(dim, 1 if i == 2 else dim, **kw)]
    return nn.Sequential(*layers)


def broadcast_position_bias(biases: torch.Tensor, indices: torch.Tensor, heads: int) -> torch.Tensor:
    """The ((2w + 1)^2,) values of the dynamic position bias at the (w^2,
    w^2) ``indices``, broadcast over ``heads`` to (heads, w^2, w^2) (the JAX
    :111-113)."""
    return biases[indices].expand(heads, -1, -1)


class Attention(nn.Module):
    """reference crossformer.py:78-172, the JAX ``CrossFormerAttention``:
    the channel norm, a bias-free 1x1 convolution to q, k and v within each
    window (``attn_type`` "short": contiguous windows; "long": windows of
    every (H / w)-th position), the dispatcher with the dynamic position
    bias, a 1x1 convolution out."""

    def __init__(self, dim: int, attn_type: str, window_size: int, dim_head: int = 32, dropout: float = 0.0, *,
                 device=None, dtype=None):
        super().__init__()
        if attn_type not in ("short", "long"):
            raise ValueError("attention type must be one of local or distant")
        kw = {"device": device, "dtype": dtype}
        heads = dim // dim_head
        inner = dim_head * heads
        self.attn_type, self.window_size, self.heads, self.dim_head, self.dropout = (attn_type, window_size, heads,
                                                                                     dim_head, dropout)
        self.norm = ChanLayerNorm(dim, **kw)
        self.to_qkv = nn.Conv2d(dim, inner * 3, 1, bias=False, **kw)
        self.dpb = dynamic_position_bias(dim // 4, **kw)
        pos = np.arange(-window_size, window_size + 1)
        rel = np.stack(np.meshgrid(pos, pos, indexing="ij"), axis=-1).reshape(-1, 2)
        self.register_buffer("rel_pos", torch.from_numpy(rel.astype(np.float32)).to(table_device(kw["device"])),
                             persistent=False)
        idx = torch.from_numpy(rel_pos_indices(window_size)).to(table_device(kw["device"]))
        self.register_buffer("rel_pos_indices", idx, persistent=False)
        self.to_out = nn.Conv2d(inner, dim, 1, **kw)

    def attention_bias(self) -> torch.Tensor:
        """The (heads, w^2, w^2) bias: one MLP value an offset, gathered and
        broadcast over the heads."""
        biases = self.dpb(self.rel_pos.to(self.dpb[0].weight.dtype))[..., 0]
        return broadcast_position_bias(biases, self.rel_pos_indices, self.heads)

    def forward(self, x):
        H, W = x.shape[-2:]
        w = self.window_size
        if self.attn_type == "short":
            to_windows, from_windows = "b d (x s1) (y s2) -> (b x y) d s1 s2", "(b x y) d s1 s2 -> b d (x s1) (y s2)"
        else:
            to_windows, from_windows = "b d (s1 x) (s2 y) -> (b x y) d s1 s2", "(b x y) d s1 s2 -> b d (s1 x) (s2 y)"
        xw = rearrange(self.norm(x), to_windows, s1=w, s2=w)
        q, k, v = (to_heads(t, self.heads) for t in self.to_qkv(xw).chunk(3, dim=1))
        out = dot_product_attention(q, k, v, scale=self.dim_head**-0.5, bias=self.attention_bias(),
                                    dropout_rate=self.dropout if self.training else 0.0)
        out = self.to_out(from_heads(out, w, w))
        return rearrange(out, from_windows, x=H // w, y=W // w)


class FeedForward(nn.Sequential):
    """reference crossformer.py:69-76, the JAX ``CrossFormerFeedForward``:
    the channel norm, a 1x1 convolution to ``dim * mult``, GELU, dropout, a
    1x1 convolution back (``0|1|4``: the reference's is a bare
    ``nn.Sequential``)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, *, device=None, dtype=None):
        kw = {"device": device, "dtype": dtype}
        super().__init__(ChanLayerNorm(dim, **kw), nn.Conv2d(dim, dim * mult, 1, **kw), GELU(), nn.Dropout(dropout),
                         nn.Conv2d(dim * mult, dim, 1, **kw))


class Transformer(nn.Module):
    """reference crossformer.py:176-206: short attention, feed-forward, long
    attention, feed-forward, each residual, a layer."""

    def __init__(self, dim: int, *, local_window_size: int, global_window_size: int, depth: int = 4,
                 dim_head: int = 32, attn_dropout: float = 0.0, ff_dropout: float = 0.0, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Attention(dim, "short", local_window_size, dim_head, attn_dropout, **kw),
                FeedForward(dim, dropout=ff_dropout, **kw),
                Attention(dim, "long", global_window_size, dim_head, attn_dropout, **kw),
                FeedForward(dim, dropout=ff_dropout, **kw),
            ])
            for _ in range(depth)
        )

    def forward(self, x):
        for short_attn, short_ff, long_attn, long_ff in self.layers:
            x = short_attn(x) + x
            x = short_ff(x) + x
            x = long_attn(x) + x
            x = long_ff(x) + x
        return x


class CrossFormer(nn.Module):
    """reference crossformer.py:208 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, dim=(64, 128, 256, 512), depth=(2, 2, 8, 2), global_window_size=(8, 4, 2, 1),
                 local_window_size=7, cross_embed_kernel_sizes=((4, 8, 16, 32), (2, 4), (2, 4), (2, 4)),
                 cross_embed_strides=(4, 2, 2, 2), num_classes: int = 1000, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, channels: int = 3, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        dim, depth, global_window_size, local_window_size, cross_embed_kernel_sizes, cross_embed_strides = (
            cast_tuple(t, 4) for t in (dim, depth, global_window_size, local_window_size, cross_embed_kernel_sizes,
                                       cross_embed_strides))
        dims = (channels, *dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                CrossEmbedLayer(dims[s], dims[s + 1], cross_embed_kernel_sizes[s], cross_embed_strides[s], **kw),
                Transformer(dims[s + 1], local_window_size=local_window_size[s],
                            global_window_size=global_window_size[s], depth=depth[s], attn_dropout=attn_dropout,
                            ff_dropout=ff_dropout, **kw),
            ])
            for s in range(4)
        )
        self.to_logits = nn.Sequential(Reduce("b c h w -> b c", "mean"), nn.Linear(dims[-1], num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        reset_chan_norms(self)

    def forward(self, x):
        for cel, transformer in self.layers:
            x = transformer(cel(x))
        return self.to_logits(x)
