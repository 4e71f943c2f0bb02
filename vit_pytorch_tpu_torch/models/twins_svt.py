"""Twins-SVT (reference twins_svt.py:178-235), port of
``vit_pytorch_tpu/models/twins_svt.py``.

Four stages, each a space-to-depth patch embedding (channel slowest, a
channel LayerNorm, a 1x1 convolution, a channel LayerNorm), a transformer
layer, the position generator (a depthwise convolution on the residual,
twins_svt.py:77-83) and the stage's transformer layers; a layer is local
attention within p x p windows, a feed-forward, global attention against
keys and values subsampled by a k x k convolution of stride k, and a
feed-forward (the last stage has only the global half).  The maps are NCHW
(the JAX package's NHWC), the channel norms ``models/cvt.py::ChanLayerNorm``.
Both attentions go through ``ops/attention.py::dot_product_attention``
(the local one without dropout, as in the JAX module), whose composite takes
their 49-token windows and 1 to 64 keys, as in the JAX package.

The state_dict is the reference's (``layers.s.0`` the embedding with
``proj.0|1|2``, ``layers.s.1|3`` the transformers with
``layers.N.0|1|2|3.fn``, ``layers.s.2.proj.fn`` the position generator,
``layers.6`` the head): ``utils/convert.py::convert_twins_svt``,
``utils/from_jax.py::twins_svt_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from einops import rearrange
from torch import nn

from ..ops.attention import dot_product_attention
from ..utils.helpers import default_device
from .cvt import ChanLayerNorm, FeedForward, from_heads, reset_chan_norms, to_heads
from .local_vit import Residual
from .vit import init_modules_like_jax


class PatchEmbedding(nn.Module):
    """reference twins_svt.py:59-75: (b, c, (h p1), (w p2)) -> (b, c p1 p2,
    h, w), the channel norm, a 1x1 convolution, the channel norm."""

    def __init__(self, *, dim: int, dim_out: int, patch_size: int, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.patch_size = patch_size
        patch_dim = patch_size**2 * dim
        self.proj = nn.Sequential(ChanLayerNorm(patch_dim, **kw), nn.Conv2d(patch_dim, dim_out, 1, **kw),
                                  ChanLayerNorm(dim_out, **kw))

    def forward(self, fmap):
        p = self.patch_size
        return self.proj(rearrange(fmap, "b c (h p1) (w p2) -> b (c p1 p2) h w", p1=p, p2=p))


class PEG(nn.Module):
    """reference twins_svt.py:77-83: a depthwise convolution on the
    residual."""

    def __init__(self, dim: int, kernel_size: int = 3, *, device=None, dtype=None):
        super().__init__()
        self.proj = Residual(nn.Conv2d(dim, dim, kernel_size, padding=kernel_size // 2, groups=dim, device=device,
                                       dtype=dtype))

    def forward(self, x):
        return self.proj(x)


class LocalAttention(nn.Module):
    """reference twins_svt.py:85-120: the channel norm, bias-free 1x1
    convolutions to q and to k, v, attention within each p x p window, a
    1x1 convolution out and its dropout."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, patch_size: int = 7, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.patch_size = heads, dim_head, patch_size
        self.norm = ChanLayerNorm(dim, **kw)
        self.to_q = nn.Conv2d(dim, inner, 1, bias=False, **kw)
        self.to_kv = nn.Conv2d(dim, inner * 2, 1, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Conv2d(inner, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, fmap):
        fmap = self.norm(fmap)
        _, _, H, W = fmap.shape
        p, h = self.patch_size, self.heads
        windows = lambda t: rearrange(t, "b (h d) (x p1) (y p2) -> (b x y) h (p1 p2) d", h=h, p1=p, p2=p)
        q = windows(self.to_q(fmap))
        k, v = map(windows, self.to_kv(fmap).chunk(2, dim=1))
        out = dot_product_attention(q, k, v, scale=self.dim_head**-0.5)
        out = rearrange(out, "(b x y) h (p1 p2) d -> b (h d) (x p1) (y p2)", x=H // p, y=W // p, p1=p, p2=p)
        return self.to_out(out)


class GlobalAttention(nn.Module):
    """reference twins_svt.py:122-157: the channel norm, a bias-free 1x1
    convolution to q, k and v from a bias-free k x k convolution of stride k
    (no padding), the dispatcher, a 1x1 convolution out and its dropout."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, k: int = 7, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.norm = ChanLayerNorm(dim, **kw)
        self.to_q = nn.Conv2d(dim, inner, 1, bias=False, **kw)
        self.to_kv = nn.Conv2d(dim, inner * 2, k, stride=k, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Conv2d(inner, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, x):
        x = self.norm(x)
        H, W = x.shape[-2:]
        q = to_heads(self.to_q(x), self.heads)
        k, v = (to_heads(t, self.heads) for t in self.to_kv(x).chunk(2, dim=1))
        out = dot_product_attention(q, k, v, scale=self.dim_head**-0.5,
                                    dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(from_heads(out, H, W))


class Transformer(nn.Module):
    """reference twins_svt.py:159-176: a layer is residual local attention
    and feed-forward (identities without ``has_local``), then residual
    global attention and feed-forward."""

    def __init__(self, dim: int, depth: int, heads: int = 8, dim_head: int = 64, mlp_mult: int = 4,
                 local_patch_size: int = 7, global_k: int = 7, dropout: float = 0.0, has_local: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        ff = lambda: Residual(FeedForward(dim, mlp_mult, dropout, **kw))
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Residual(LocalAttention(dim, heads, dim_head, dropout, local_patch_size, **kw)) if has_local
                else nn.Identity(),
                ff() if has_local else nn.Identity(),
                Residual(GlobalAttention(dim, heads, dim_head, dropout, global_k, **kw)),
                ff(),
            ])
            for _ in range(depth)
        )

    def forward(self, x):
        for local_attn, ff1, global_attn, ff2 in self.layers:
            x = ff2(global_attn(ff1(local_attn(x))))
        return x


_STAGE_KEYS = ("emb_dim", "patch_size", "local_patch_size", "global_k", "depth")


class TwinsSVT(nn.Module):
    """reference twins_svt.py:178 — same keyword constructor (the ``s1_`` to
    ``s4_`` stage options), with ``device``, ``dtype`` and ``generator`` as
    in ``models/vit.py``."""

    def __init__(self, *, num_classes: int, s1_emb_dim: int = 64, s1_patch_size: int = 4,
                 s1_local_patch_size: int = 7, s1_global_k: int = 7, s1_depth: int = 1, s2_emb_dim: int = 128,
                 s2_patch_size: int = 2, s2_local_patch_size: int = 7, s2_global_k: int = 7, s2_depth: int = 1,
                 s3_emb_dim: int = 256, s3_patch_size: int = 2, s3_local_patch_size: int = 7, s3_global_k: int = 7,
                 s3_depth: int = 5, s4_emb_dim: int = 512, s4_patch_size: int = 2, s4_local_patch_size: int = 7,
                 s4_global_k: int = 7, s4_depth: int = 4, peg_kernel_size: int = 3, dropout: float = 0.0,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        options = locals()
        dim, layers = 3, []
        for prefix in ("s1", "s2", "s3", "s4"):
            c = {k: options[f"{prefix}_{k}"] for k in _STAGE_KEYS}
            has_local = prefix != "s4"
            stage = lambda depth: Transformer(c["emb_dim"], depth, local_patch_size=c["local_patch_size"],
                                              global_k=c["global_k"], dropout=dropout, has_local=has_local, **kw)
            layers.append(nn.Sequential(
                PatchEmbedding(dim=dim, dim_out=c["emb_dim"], patch_size=c["patch_size"], **kw),
                stage(1),
                PEG(c["emb_dim"], peg_kernel_size, **kw),
                stage(c["depth"]),
            ))
            dim = c["emb_dim"]
        self.layers = nn.Sequential(*layers, nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        reset_chan_norms(self)

    def forward(self, x):
        return self.layers(x)
