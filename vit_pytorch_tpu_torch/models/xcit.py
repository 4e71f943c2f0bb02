"""XCiT, the cross-covariance image transformer (reference xcit.py:215-285),
port of ``vit_pytorch_tpu/models/xcit.py``.

Cross-covariance attention (xcit.py:109-148) attends channel to channel: q
and k, (b, h, d, n), are L2-normalised over the tokens, their (d, d)
similarity taken in f32 and scaled by ``exp(temperature)`` a head, softmaxed
in f32 and cast back; no kernel takes it, as no Pallas kernel does in the
JAX package.  The local patch interaction (:150-167) runs on the token grid
as an NCHW image: LayerNorm, a depthwise convolution, flax's BatchNorm
(``models/max_vit.py::BatchNorm``, its running statistics as buffers), the
GELU, a second depthwise convolution.  Every branch is LayerScale'd
(``models/cait.py::layerscale_init`` by its depth, a (dim,) scale), and a
class-attention stage (``Attention(kv_include_self=True)`` on the cls token
with the normed patches as context, the composite) ends it.

Layer dropout (xcit.py:25-38) draws, in training at a positive rate, one
uniform a layer from ``generator`` (or the global CPU generator, which
``parallel/train.py::make_train_step`` seeds each step), drops the layers
under the rate and keeps one drawn layer when all would drop, for the patch
layers and then the class layers, as the JAX ``layer_keep_mask``.  A dropped
layer adds exactly zero, so its attention and feed-forward are skipped; its
local patch interaction still runs, without gradient, because the JAX
model's BatchNorm updates its statistics there too.

The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``pos_embedding``, ``cls_token``, ``xcit_transformer.layers.N.0|1|2`` and
``cls_transformer.layers.N.0|1`` as ``scale`` and ``fn.*``, ``final_norm``,
``mlp_head.0|1``): ``utils/convert.py::convert_xcit``,
``utils/from_jax.py::xcit_state_dict_from_jax``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import Attention, FeedForward, LayerNorm, gelu
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device
from .cait import layerscale_init
from .max_vit import BatchNorm
from .vit import init_modules_like_jax


def layer_keep_mask(depth: int, dropout: float, generator: Optional[torch.Generator] = None) -> list:
    """Which of ``depth`` layers run under layer dropout at rate
    ``dropout``: a layer drops when its uniform from ``generator`` falls
    under the rate, and one layer drawn from it too stays when all would
    drop (the JAX ``layer_keep_mask``, xcit.py:24-31)."""
    if depth == 0:
        return []
    drop = (torch.rand(depth, generator=generator) < dropout).tolist()
    forced = int(torch.randint(0, depth, (), generator=generator))
    return [not d or (all(drop) and i == forced) for i, d in enumerate(drop)]


class LayerScale(nn.Module):
    """``fn``'s output times a learned (dim,) scale from
    :func:`~.cait.layerscale_init` (the JAX xcit.py:154-156)."""

    def __init__(self, dim: int, fn: nn.Module, depth: int, *, device=None, dtype=None):
        super().__init__()
        self.init_value = layerscale_init(depth)
        self.scale = nn.Parameter(torch.full((dim,), self.init_value, device=device, dtype=dtype))
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(x, **kwargs) * self.scale.to(x.dtype)


class XCAttention(nn.Module):
    """reference xcit.py:109-148 on (b, n, c) tokens: LayerNorm, a bias-free
    qkv projection, channel-by-channel attention at a learned temperature a
    head, the projection out and its dropout."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = LayerNorm(dim, **kw)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, **kw)
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1, **kw))
        self.dropout = nn.Dropout(dropout)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))

    def forward(self, x):
        b, n, _ = x.shape
        # (b, n, 3, h, d) -> 3 x (b, h, d, n)
        q, k, v = self.to_qkv(self.norm(x)).reshape(b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 4, 1)
        q, k = F.normalize(q, dim=-1, eps=1e-12), F.normalize(k, dim=-1, eps=1e-12)
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.temperature.exp()
        attn = self.dropout(sim.softmax(dim=-1).to(v.dtype))
        out = torch.matmul(attn, v)  # (b, h, d, n)
        return self.to_out(out.permute(0, 3, 1, 2).reshape(b, n, -1))


class LocalPatchInteraction(nn.Module):
    """reference xcit.py:150-167 on the (b, n, c) tokens of a square grid:
    LayerNorm, the depthwise convolution, BatchNorm, GELU, the depthwise
    convolution (``net.0|2|3|5``; 1 and 6 the layout changes)."""

    def __init__(self, dim: int, kernel_size: int = 3, *, device=None, dtype=None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError("the local patch interaction's kernel size must be odd")
        kw = {"device": device, "dtype": dtype}
        pad = kernel_size // 2
        self.net = nn.Sequential(
            LayerNorm(dim, **kw),
            nn.Identity(),
            nn.Conv2d(dim, dim, kernel_size, padding=pad, groups=dim, **kw),
            BatchNorm(dim, **kw),
            nn.Identity(),
            nn.Conv2d(dim, dim, kernel_size, padding=pad, groups=dim, **kw),
        )

    def forward(self, x):
        b, n, c = x.shape
        side = int(math.sqrt(n))
        x = self.net[0](x).transpose(1, 2).reshape(b, c, side, side)
        x = self.net[5](gelu(self.net[3](self.net[2](x))))
        return x.flatten(2).transpose(1, 2)


class XCiTTransformer(nn.Module):
    """The JAX xcit.py:153-183: LayerScale'd cross-covariance attention,
    local patch interaction and feed-forward a layer."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0,
                 local_patch_kernel_size: int = 3, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([
                LayerScale(dim, XCAttention(dim, heads, dim_head, dropout, **kw), i + 1, **kw),
                LayerScale(dim, LocalPatchInteraction(dim, local_patch_kernel_size, **kw), i + 1, **kw),
                LayerScale(dim, FeedForward(dim, mlp_dim, dropout, **kw), i + 1, **kw),
            ])
            for i in range(depth)
        )

    def forward(self, x, keep):
        for (attn, lpi, ff), kept in zip(self.layers, keep):
            if not kept:
                with torch.no_grad():
                    lpi.fn(x)  # the BatchNorm's statistics move as in the JAX model
                continue
            x = attn(x) + x
            x = lpi(x) + x
            x = ff(x) + x
        return x


class ClassTransformer(nn.Module):
    """The JAX xcit.py:197-221: LayerScale'd class attention over the cls
    token and the context, and feed-forward, a layer."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([
                LayerScale(dim, Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, kv_include_self=True,
                                          project_out=True, **kw), i + 1, **kw),
                LayerScale(dim, FeedForward(dim, mlp_dim, dropout, **kw), i + 1, **kw),
            ])
            for i in range(depth)
        )

    def forward(self, cls, context, keep):
        for (attn, ff), kept in zip(self.layers, keep):
            if kept:
                cls = attn(cls, context=context) + cls
                cls = ff(cls) + cls
        return cls


class XCiT(nn.Module):
    """reference xcit.py:215 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py``.  ``forward(img,
    generator=None)``: ``generator`` draws the layer dropout's uniforms (a
    CPU generator)."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int, depth: int, cls_depth: int,
                 heads: int, mlp_dim: int, dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 local_patch_kernel_size: int = 3, layer_dropout: float = 0.0, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_size // patch_size) ** 2
        self.layer_dropout = layer_dropout
        self.to_patch_embedding = PatchEmbedding((patch_size, patch_size), 3 * patch_size**2, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.xcit_transformer = XCiTTransformer(dim, depth, heads, dim_head, mlp_dim, dropout,
                                                local_patch_kernel_size, **kw)
        self.final_norm = LayerNorm(dim, **kw)
        self.cls_transformer = ClassTransformer(dim, cls_depth, heads, dim_head, mlp_dim, dropout, **kw)
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)
        for m in self.modules():
            if isinstance(m, LayerScale):
                m.scale.fill_(m.init_value)
            elif isinstance(m, XCAttention):
                m.temperature.fill_(1.0)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()

    def keep(self, generator: Optional[torch.Generator] = None):
        """Which patch layers and which class layers run: all but in training
        at a positive rate (:func:`layer_keep_mask`, the patch layers'
        first)."""
        depths = len(self.xcit_transformer.layers), len(self.cls_transformer.layers)
        if not self.training or self.layer_dropout <= 0.0:
            return tuple([True] * d for d in depths)
        return tuple(layer_keep_mask(d, self.layer_dropout, generator) for d in depths)

    def forward(self, img, generator: Optional[torch.Generator] = None):
        keep, keep_cls = self.keep(generator)
        x = self.to_patch_embedding(img)
        b, n, _ = x.shape
        x = self.dropout(x + self.pos_embedding[:, :n].to(x.dtype))
        x = self.final_norm(self.xcit_transformer(x, keep))
        cls = self.cls_transformer(self.cls_token.to(x.dtype).expand(b, 1, -1), x, keep_cls)
        return self.mlp_head(cls[:, 0])
