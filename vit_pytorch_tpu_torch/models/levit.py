"""LeViT (reference levit.py:129-195), port of
``vit_pytorch_tpu/models/levit.py``.

A stem of four 3 x 3 convolutions of stride 2, then stages of attention and
a hard-swish 1x1 convolution feed-forward on NCHW maps (the JAX package's
are NHWC), a downsampling stage between them.  q, k and v are bias-free 1x1
convolutions each followed by flax's BatchNorm (``models/max_vit.py::
BatchNorm``), q's of stride 2 on a downsampling stage; the output is GELU, a
1x1 convolution and a BatchNorm whose scale starts at zero (levit.py:124).
The learned positional bias is one row of ``pos_bias`` (fmap^2 rows, a
column a head) for each |dy|, |dx| between a query and a key
(:func:`levit_pos_indices`), divided by the logits' scale so that the
dispatcher's ``q.k * scale + bias`` adds it after the scaling, as the
reference does (levit.py:85-88; the JAX :100-107).  The attention goes
through ``ops/attention.py::dot_product_attention`` with that per-head bias:
at 224 x 224 its 196, 49 and 16 keys take the composite, as in the JAX
package.  With ``num_distill_classes`` the model returns ``(logits,
distill_logits)``.

The state_dict is the reference's (``conv_embedding.0-3``, ``backbone.i``
the stage and downsampling transformers in turn, each with
``layers.N.0.to_q|to_k|to_v.0|1``, ``pos_bias``, ``to_out.1|2`` and
``layers.N.1.net.0|3``, ``mlp_head``): ``utils/convert.py::convert_levit``,
``utils/from_jax.py::levit_state_dict_from_jax``, the BatchNorms'
statistics with the JAX ``batch_stats``.
"""

from __future__ import annotations

from math import ceil
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn.blocks import GELU
from ..ops.attention import dot_product_attention
from ..utils.helpers import default, default_device, table_device
from .cvt import from_heads, to_heads
from .max_vit import BatchNorm
from .vit import init_modules_like_jax


def cast_tuple_l(val, length: int = 3) -> tuple:
    """``val`` as a tuple of ``length``, its last item repeated (reference
    levit.py:19-21)."""
    val = tuple(val) if isinstance(val, (tuple, list)) else (val,)
    return (*val, *((val[-1],) * max(length - len(val), 0)))


def levit_pos_indices(fmap_size: int, downsample: bool) -> np.ndarray:
    """(queries, keys) rows of ``pos_bias``: |dy| * fmap + |dx| between the
    query (every second position when downsampling) and the key (reference
    levit.py:71-82)."""
    q_range = np.arange(0, fmap_size, 2 if downsample else 1)
    k_range = np.arange(fmap_size)
    q_pos = np.stack(np.meshgrid(q_range, q_range, indexing="ij"), axis=-1).reshape(-1, 2)
    k_pos = np.stack(np.meshgrid(k_range, k_range, indexing="ij"), axis=-1).reshape(-1, 2)
    rel = np.abs(q_pos[:, None, :] - k_pos[None, :, :])
    return rel[..., 0] * fmap_size + rel[..., 1]


class FeedForward(nn.Module):
    """reference levit.py:27-38, the JAX ``ConvFeedForward``: a 1x1
    convolution, hard-swish, dropout, a 1x1 convolution, dropout
    (``net.0|3``)."""

    def __init__(self, dim: int, mult: int, dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.net = nn.Sequential(nn.Conv2d(dim, dim * mult, 1, **kw), nn.Hardswish(), nn.Dropout(dropout),
                                 nn.Conv2d(dim * mult, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class Attention(nn.Module):
    """reference levit.py:40-108, the JAX ``LeViTAttention``."""

    def __init__(self, dim: int, fmap_size: int, heads: int = 8, dim_key: int = 32, dim_value: int = 64,
                 dropout: float = 0.0, dim_out: Optional[int] = None, downsample: bool = False, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dim_out = default(dim_out, dim)
        inner_k, inner_v = dim_key * heads, dim_value * heads
        self.heads, self.dim_key, self.dropout = heads, dim_key, dropout
        proj = lambda inner, stride=1: nn.Sequential(nn.Conv2d(dim, inner, 1, stride=stride, bias=False, **kw),
                                                     BatchNorm(inner, **kw))
        self.to_q = proj(inner_k, 2 if downsample else 1)
        self.to_k = proj(inner_k)
        self.to_v = proj(inner_v)
        self.pos_bias = nn.Embedding(fmap_size * fmap_size, heads, **kw)
        idx = torch.from_numpy(levit_pos_indices(fmap_size, downsample))
        self.register_buffer("pos_indices", idx.to(table_device(kw["device"])), persistent=False)
        self.to_out = nn.Sequential(GELU(), nn.Conv2d(inner_v, dim_out, 1, **kw), BatchNorm(dim_out, **kw),
                                    nn.Dropout(dropout))

    def attention_bias(self) -> torch.Tensor:
        """The (heads, queries, keys) table handed to the dispatcher: the
        gathered rows divided by the scale (the JAX :104)."""
        return self.pos_bias.weight[self.pos_indices].permute(2, 0, 1) / self.dim_key**-0.5

    def forward(self, x):
        q = self.to_q(x)
        qy, qx = q.shape[-2:]
        out = dot_product_attention(
            to_heads(q, self.heads), to_heads(self.to_k(x), self.heads), to_heads(self.to_v(x), self.heads),
            scale=self.dim_key**-0.5, bias=self.attention_bias(), dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(from_heads(out, qy, qx))


class Transformer(nn.Module):
    """reference levit.py:110-127, the JAX ``LeViTTransformer``: attention
    (residual unless it downsamples or changes the width) and the
    feed-forward with its residual, a layer."""

    def __init__(self, dim: int, fmap_size: int, depth: int, heads: int, dim_key: int, dim_value: int,
                 mlp_mult: int = 2, dropout: float = 0.0, dim_out: Optional[int] = None, downsample: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        dim_out = default(dim_out, dim)
        self.attn_residual = not downsample and dim == dim_out
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Attention(dim, fmap_size, heads, dim_key, dim_value, dropout, dim_out, downsample, **kw),
                FeedForward(dim_out, mlp_mult, dropout, **kw),
            ])
            for _ in range(depth)
        )

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x) + x if self.attn_residual else attn(x)
            x = ff(x) + x
        return x


class LeViT(nn.Module):
    """reference levit.py:129 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py`` (the position biases
    unit normal, the BatchNorms at ones and zeros, every ``to_out`` BatchNorm's
    scale at zero, as the JAX init)."""

    def __init__(self, *, image_size: int, num_classes: int, dim, depth, heads, mlp_mult: int, stages: int = 3,
                 dim_key: int = 32, dim_value: int = 64, dropout: float = 0.0,
                 num_distill_classes: Optional[int] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        dims, depths, layer_heads = (cast_tuple_l(t, stages) for t in (dim, depth, heads))
        if not all(len(t) == stages for t in (dims, depths, layer_heads)):
            raise ValueError("dimensions, depths and heads must be a tuple that is less than the designated number "
                             "of stages")
        channels = (3, 32, 64, 128, dims[0])
        self.conv_embedding = nn.Sequential(*(nn.Conv2d(channels[i], channels[i + 1], 3, stride=2, padding=1, **kw)
                                              for i in range(4)))
        fmap_size = image_size // 16
        backbone = []
        for ind in range(stages):
            backbone.append(Transformer(dims[ind], fmap_size, depths[ind], layer_heads[ind], dim_key, dim_value,
                                        mlp_mult, dropout, **kw))
            if ind != stages - 1:
                backbone.append(Transformer(dims[ind], fmap_size, 1, layer_heads[ind] * 2, dim_key, dim_value,
                                            mlp_mult, dropout, dim_out=dims[ind + 1], downsample=True, **kw))
                fmap_size = ceil(fmap_size / 2)
        self.backbone = nn.Sequential(*backbone)
        self.mlp_head = nn.Linear(dims[-1], num_classes, **kw)
        self.distill_head = nn.Linear(dims[-1], num_distill_classes, **kw) if num_distill_classes is not None else None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.reset_parameters()
        for m in self.modules():
            if isinstance(m, Attention):
                m.pos_bias.weight.normal_(generator=generator)
                m.to_out[2].weight.zero_()

    def forward(self, img):
        x = self.backbone(self.conv_embedding(img)).mean(dim=(2, 3))
        out = self.mlp_head(x)
        return out if self.distill_head is None else (out, self.distill_head(x))
