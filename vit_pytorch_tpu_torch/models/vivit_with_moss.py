"""ViViT with MOSS, multi-order spatio-temporal self-similarity (reference
vivit_with_moss.py:278-452), port of
``vit_pytorch_tpu/models/vivit_with_moss.py``.

A factorised ViViT whose patch tokens pass through :class:`MOSS` between the
spatial and the temporal transformer.  MOSS l2-normalises the features and
takes each token's cosine similarity to the tokens of its local (lt, lh,
lw) space-time window, built as a static stack of shifted slices as in the
JAX package (the reference unfolds, :223-249); :class:`STSSEncoder` turns
the similarities into features (a projection, two 3 x 3 convolutions with
bias-free channel LayerNorms, a projection), each order reading the
previous order's features.  In causal mode the windows look only back in
time and MOSS, like :class:`CausalTransformer` and :class:`CausalAttention`,
takes and returns explicit caches, so a clip can be run frame by frame.
The causal mask is ``tril(ones(n, m))``, top-left aligned, as the JAX
dispatcher builds it: with a KV cache and n < m new queries, query i sees
keys 0..i; a single new query sees every key.

Every attention goes through ``ops/attention.py::dot_product_attention``
(the composite below 1,024 keys, as in JAX): no kernel of the port runs in
this model.

The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``pos_embedding`` (1, frame patches, image patches, dim), the cls tokens,
``spatial_transformer`` and ``temporal_transformer`` in the ViT layout,
``moss.to_out``, ``moss.encoders.N`` (``conv.1.gamma`` and ``conv.4.gamma``
of shape (1, c, 1, 1)), ``moss.to_order_out.N``, ``mlp_head.0|1``):
``utils/convert.py::convert_vivit_moss``,
``utils/from_jax.py::vivit_moss_state_dict_from_jax``.
"""

from __future__ import annotations

from itertools import product
from typing import Optional

import torch
import torch.nn.functional as F
from einops import rearrange
from einops.layers.torch import Rearrange
from torch import nn

from ..nn.blocks import LN_EPS, Activation, FeedForward, LayerNorm
from ..ops.attention import dot_product_attention
from ..utils.helpers import default, default_device, exists, pair
from .normalized_vit import l2norm
from .vit import init_modules_like_jax


class CausalAttention(nn.Module):
    """reference vivit_with_moss.py:63-137: pre-LN attention, optionally
    causal, with an optional KV cache ``(k, v)`` put before this call's keys
    and values."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, causal: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads, self.dropout, self.causal = heads, dropout, causal
        self.norm = LayerNorm(dim, **kw)
        self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim, **kw), nn.Dropout(dropout))

    def forward(self, x, mask=None, cache=None, return_cache: bool = False):
        b, n, _ = x.shape
        is_causal = self.causal and n > 1
        if is_causal and exists(mask):
            raise ValueError("CausalAttention: a key mask with the causal mask is not supported")
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2) for t in self.to_qkv(self.norm(x)).chunk(3, -1))
        if exists(cache):
            k, v = torch.cat([cache[0], k], dim=-2), torch.cat([cache[1], v], dim=-2)
        out = dot_product_attention(q, k, v, mask=mask[:, None, None, :] if exists(mask) else None, causal=is_causal,
                                    dropout_rate=self.dropout if self.training else 0.0)
        out = self.to_out(out.transpose(1, 2).reshape(b, n, -1))
        return (out, (k, v)) if return_cache else out


class CausalTransformer(nn.Module):
    """reference vivit_with_moss.py:139-167: the ViT's layers on
    :class:`CausalAttention` and a final LayerNorm; ``cache`` one ``(k, v)``
    (or None) a layer."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0,
                 causal: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([CausalAttention(dim, heads, dim_head, dropout, causal, **kw),
                           FeedForward(dim, mlp_dim, dropout, **kw)])
            for _ in range(depth)
        )
        self.norm = LayerNorm(dim, **kw)

    def forward(self, x, mask=None, cache=None, return_cache: bool = False):
        cache = default(cache, (None,) * len(self.layers))
        new_caches = []
        for (attn, ff), layer_cache in zip(self.layers, cache):
            out, next_cache = attn(x, mask=mask, cache=layer_cache, return_cache=True)
            new_caches.append(next_cache)
            x = out + x
            x = ff(x) + x
        x = self.norm(x)
        return (x, tuple(new_caches)) if return_cache else x


class ChanLayerNorm(nn.Module):
    """A bias-free LayerNorm over the channels of an NCHW map, its gain
    ``gamma`` of shape (1, c, 1, 1) (the reference's layout)."""

    def __init__(self, dim: int, eps: float = LN_EPS, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(1, dim, 1, 1, device=device, dtype=dtype))

    def forward(self, x):
        x = F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], self.gamma.reshape(-1).to(x.dtype), eps=self.eps)
        return x.permute(0, 3, 1, 2)


class STSSEncoder(nn.Module):
    """reference vivit_with_moss.py:171-198: the similarities of each
    temporal offset projected to ``hidden_dim``, two 3 x 3 convolutions over
    (h, w), the offsets' features projected to ``dim``."""

    def __init__(self, dim: int, local_time: int = 3, local_height: int = 3, local_width: int = 3,
                 hidden_dim: int = 64, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.hidden_dim = hidden_dim
        self.spatial_to_hidden = nn.Linear(local_height * local_width, hidden_dim, **kw)
        self.conv = nn.Sequential(
            nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1, **kw), ChanLayerNorm(hidden_dim, **kw), Activation(),
            nn.Conv2d(hidden_dim, hidden_dim, 3, padding=1, **kw), ChanLayerNorm(hidden_dim, **kw), Activation(),
        )
        self.time_to_out = nn.Linear(local_time * hidden_dim, dim, **kw)

    def forward(self, sim):
        b, t, h, w, lt, lh, lw = sim.shape
        x = self.spatial_to_hidden(sim.reshape(b, t, h, w, lt, lh * lw))
        x = rearrange(x, "b t h w l d -> (b t l) d h w")
        x = rearrange(self.conv(x), "(b t l) d h w -> b t h w (l d)", b=b, t=t)
        return self.time_to_out(x)


class MOSS(nn.Module):
    """reference vivit_with_moss.py:200-274: the stack of ``orders``
    self-similarity encoders over (b, t, h, w, dim) tokens, each order's
    output projected and summed onto ``to_out(x)``; causal windows with
    ``causal``, whose call takes and returns one cache an order (the last
    ``local_time - 1`` normalised frames, (b, c, lt - 1, h, w))."""

    def __init__(self, dim: int, local_time: int = 3, local_height: int = 3, local_width: int = 3,
                 hidden_dim: int = 64, orders: int = 2, causal: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.local = (local_time, local_height, local_width)
        self.causal = causal
        self.to_out = nn.Linear(dim, dim, **kw)
        self.encoders = nn.ModuleList(STSSEncoder(dim, local_time, local_height, local_width, hidden_dim, **kw)
                                      for _ in range(orders))
        self.to_order_out = nn.ModuleList(nn.Linear(dim, dim, **kw) for _ in range(orders))

    def stss_transform(self, x, cache=None):
        """The (b, t, h, w, lt, lh, lw) similarities of each token to its
        window, and the next cache (causal only)."""
        lt, lh, lw = self.local
        b, t, h, w, c = x.shape
        xc = l2norm(x).permute(0, 4, 1, 2, 3)  # b c t h w
        pad_h, pad_w = lh // 2, lw // 2
        has_cache = self.causal and exists(cache)
        pad_past, pad_future = (lt - 1, 0) if self.causal else (lt // 2, lt // 2)
        x_temporal = torch.cat([cache, xc], dim=2) if has_cache else xc
        padded = F.pad(x_temporal, (pad_w, pad_w, pad_h, pad_h, 0 if has_cache else pad_past, pad_future))
        sims = [(xc * padded[:, :, i: i + t, u: u + h, v: v + w]).sum(dim=1)
                for i, u, v in product(range(lt), range(lh), range(lw))]
        sim = torch.stack(sims, dim=-1).reshape(b, t, h, w, lt, lh, lw)
        new_cache = padded[:, :, -(lt - 1):, pad_h: pad_h + h, pad_w: pad_w + w] if self.causal else None
        return sim, new_cache

    def forward(self, x, cache=None, return_cache: bool = False):
        if exists(cache) and not self.causal:
            raise ValueError("MOSS: a cache needs causal=True")
        out = self.to_out(x)
        cache = default(cache, (None,) * len(self.encoders))
        new_caches = []
        for encoder, to_order_out, order_cache in zip(self.encoders, self.to_order_out, cache):
            sim, next_cache = self.stss_transform(x, order_cache)
            new_caches.append(next_cache)
            x = encoder(sim)
            out = out + to_order_out(x)
        return (out, tuple(new_caches)) if return_cache else out


class ViViT(nn.Module):
    """reference vivit_with_moss.py:278 — same keyword constructor
    (``use_flash_attn`` taken and unused, as in the JAX package), with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py`` (the
    position embedding and the cls tokens unit normal)."""

    def __init__(self, *, image_size, image_patch_size, frames: int, frame_patch_size: int, num_classes: int,
                 dim: int, spatial_depth: int, temporal_depth: int, heads: int, mlp_dim: int, pool: str = "cls",
                 channels: int = 3, dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 use_flash_attn: bool = True, moss_local_time: int = 3, moss_local_height: int = 3,
                 moss_local_width: int = 3, moss_hidden_dim: int = 64, moss_orders: int = 2,
                 moss_causal: bool = True, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(image_patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if frames % frame_patch_size:
            raise ValueError("Frames must be divisible by the frame patch size")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        self.grid = (image_height // patch_height, image_width // patch_width)
        self.frame_patch_size, self.moss_causal, self.has_cls = frame_patch_size, moss_causal, pool == "cls"
        patch_dim = channels * patch_height * patch_width * frame_patch_size
        self.to_patch_embedding = nn.Sequential(
            Rearrange("b c (f pf) (h p1) (w p2) -> b f (h w) (pf p1 p2 c)", p1=patch_height, p2=patch_width,
                      pf=frame_patch_size),
            LayerNorm(patch_dim, **kw), nn.Linear(patch_dim, dim, **kw), LayerNorm(dim, **kw),
        )
        self.pos_embedding = nn.Parameter(torch.empty(1, frames // frame_patch_size, self.grid[0] * self.grid[1], dim,
                                                      **kw))
        if self.has_cls:
            self.spatial_cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
            self.temporal_cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.spatial_transformer = CausalTransformer(dim, spatial_depth, heads, dim_head, mlp_dim, dropout, **kw)
        self.moss = MOSS(dim, moss_local_time, moss_local_height, moss_local_width, moss_hidden_dim, moss_orders,
                         moss_causal, **kw)
        self.temporal_transformer = CausalTransformer(dim, temporal_depth, heads, dim_head, mlp_dim, dropout,
                                                      moss_causal, **kw)
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        if self.has_cls:
            self.spatial_cls_token.normal_(generator=generator)
            self.temporal_cls_token.normal_(generator=generator)

    def forward(self, video, mask=None):
        """``video`` (b, c, frames, h, w); ``mask`` (b, frames) True where a
        frame is present (not with ``moss_causal``)."""
        if exists(mask) and self.moss_causal:
            raise ValueError("ViViT: a frame mask is not supported with moss_causal")
        x = self.to_patch_embedding(video)
        b, f, n, _ = x.shape
        x = x + self.pos_embedding[:, :f, :n].to(x.dtype)
        if self.has_cls:
            x = torch.cat([self.spatial_cls_token.to(x.dtype).expand(b, f, 1, -1), x], dim=2)
        x = self.dropout(x)
        temporal_mask = mask.reshape(b, f, self.frame_patch_size).all(dim=-1) if exists(mask) else None

        x = self.spatial_transformer(x.reshape(b * f, *x.shape[2:])).reshape(b, f, *x.shape[2:])
        spatial_cls, patch_tokens = (x[:, :, 0], x[:, :, 1:]) if self.has_cls else (None, x)
        patch_tokens = rearrange(patch_tokens, "b f (h w) d -> b f h w d", h=self.grid[0], w=self.grid[1])
        moss_pooled = self.moss(patch_tokens).mean(dim=(2, 3))
        x = spatial_cls + moss_pooled if self.has_cls else moss_pooled
        if self.has_cls:
            x = torch.cat([self.temporal_cls_token.to(x.dtype).expand(b, 1, -1), x], dim=1)
            if exists(temporal_mask):
                temporal_mask = F.pad(temporal_mask, (1, 0), value=True)
        x = self.temporal_transformer(x, mask=temporal_mask)
        x = x[:, 0] if self.has_cls else x.mean(dim=1)
        return self.mlp_head(x)
