"""SepViT, depthwise-pointwise separable attention (reference sep_vit.py:
237-291), port of ``vit_pytorch_tpu/models/sep_vit.py``.

Four stages on NCHW maps (the JAX package's are NHWC), each an overlapping
patch embedding (a k x k convolution of stride s, k = 2s - 1), the position
generator (a depthwise 3 x 3 convolution on the residual) and layers of
:class:`DSSA` and a 1x1 convolution feed-forward, a channel LayerNorm
(``models/cvt.py::ChanLayerNorm``) closing every stage but the last.  In
:class:`DSSA` a learned window token goes in front of each window's tokens
for the windowed ("depthwise") attention; then the window tokens attend
each other and their attention mixes whole window feature maps
("pointwise", sep_vit.py:143-205).  The windowed attention goes through
``ops/attention.py::dot_product_attention`` without a bias: 50 tokens of
dim_head 32, the composite, as in the JAX package.

The state_dict is the reference's (``layers.s.0.conv``, ``layers.s.1.proj``,
``layers.s.2.layers.N.0|1`` and ``layers.s.2.norm``, ``mlp_head.1|2``; the
qkv projection and the window tokens' q, k projection are 1x1
``nn.Conv1d``s, weights (out, in, 1)): ``utils/convert.py::convert_sep_vit``,
``utils/from_jax.py::sep_vit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from einops import rearrange
from einops.layers.torch import Rearrange, Reduce
from torch import nn

from ..nn.blocks import GELU, LN_EPS
from ..ops.attention import dot_product_attention
from ..utils.helpers import cast_tuple, default_device
from .cvt import ChanLayerNorm, reset_chan_norms
from .vit import init_modules_like_jax


class OverlappingPatchEmbed(nn.Module):
    """reference sep_vit.py:28-36: a k x k convolution of stride s, padding
    k // 2."""

    def __init__(self, dim_in: int, dim_out: int, stride: int = 2, *, device=None, dtype=None):
        super().__init__()
        kernel_size = stride * 2 - 1
        self.conv = nn.Conv2d(dim_in, dim_out, kernel_size, stride=stride, padding=kernel_size // 2, device=device,
                              dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class PEG(nn.Module):
    """The position generator (reference sep_vit.py:38-44): a depthwise
    convolution on the residual, ``proj`` the convolution."""

    def __init__(self, dim: int, kernel_size: int = 3, *, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Conv2d(dim, dim, kernel_size, padding=kernel_size // 2, groups=dim, device=device, dtype=dtype)

    def forward(self, x):
        return self.proj(x) + x


class FeedForward(nn.Module):
    """reference sep_vit.py:48-61, the JAX ``SepFeedForward``: the channel
    norm, a 1x1 convolution to ``dim * mult``, GELU, dropout, a 1x1
    convolution back, dropout (``net.0|1|4``).  ScalableViT's is the same
    (scalable_vit.py:54-67)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = int(dim * mult)
        self.net = nn.Sequential(ChanLayerNorm(dim, **kw), nn.Conv2d(dim, inner, 1, **kw), GELU(), nn.Dropout(dropout),
                                 nn.Conv2d(inner, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class DSSA(nn.Module):
    """reference sep_vit.py:65-205, the JAX ``DSSA``: the channel norm; per
    window of w x w tokens the learned window token in front, a bias-free
    qkv projection and attention over the w^2 + 1 tokens; then, with more
    than one window, the window tokens through a LayerNorm over dim_head,
    GELU and a q, k projection, whose softmax (f32 logits) mixes the
    windows' outputs; a 1x1 convolution out and dropout.  With one window
    the windowed attention's output goes out directly (sep_vit.py:95-102)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, dropout: float = 0.0, window_size: int = 7, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.window_size, self.dropout = heads, dim_head, window_size, dropout
        self.norm = ChanLayerNorm(dim, **kw)
        self.window_tokens = nn.Parameter(torch.empty(dim, **kw))
        self.to_qkv = nn.Conv1d(dim, inner * 3, 1, bias=False, **kw)
        self.window_tokens_to_qk = nn.Sequential(
            nn.LayerNorm(dim_head, eps=LN_EPS, **kw), GELU(), Rearrange("b h n c -> b (h c) n"),
            nn.Conv1d(inner, inner * 2, 1, **kw), Rearrange("b (h c) n -> b h n c", h=heads))
        self.window_attend = nn.Dropout(dropout)
        self.to_out = nn.Sequential(nn.Conv2d(inner, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, x):
        H, W = x.shape[-2:]
        w, h = self.window_size, self.heads
        if H % w or W % w:
            raise ValueError(f"feature map {H} x {W} is not divisible by the window size {w}")
        gx, gy = H // w, W // w
        scale = self.dim_head**-0.5
        x = self.norm(x)
        xw = rearrange(x, "b c (x w1) (y w2) -> (b x y) c (w1 w2)", w1=w, w2=w)
        tokens = self.window_tokens.to(xw.dtype)[None, :, None].expand(xw.shape[0], -1, 1)
        qkv = self.to_qkv(torch.cat([tokens, xw], dim=-1))  # (b x y, 3 h d, 1 + w^2)
        q, k, v = rearrange(qkv, "n (t h d) s -> t n h s d", t=3, h=h)
        out = dot_product_attention(q, k, v, scale=scale, dropout_rate=self.dropout if self.training else 0.0)
        fmaps = rearrange(out[:, :, 1:], "(b x y) h n d -> b h (x y) n d", x=gx, y=gy)
        if gx * gy > 1:
            wtok = rearrange(out[:, :, 0], "(b x y) h d -> b h (x y) d", x=gx, y=gy)
            w_q, w_k = self.window_tokens_to_qk(wtok).chunk(2, dim=-1)
            w_dots = torch.matmul((w_q * scale).float(), w_k.float().transpose(-1, -2))
            w_attn = self.window_attend(torch.softmax(w_dots, dim=-1).to(fmaps.dtype))
            fmaps = torch.einsum("bhij,bhjwd->bhiwd", w_attn, fmaps)
        return self.to_out(rearrange(fmaps, "b h (x y) (w1 w2) d -> b (h d) (x w1) (y w2)", x=gx, y=gy, w1=w, w2=w))


class Transformer(nn.Module):
    """reference sep_vit.py:207-235: residual :class:`DSSA` and feed-forward
    a layer, then the channel norm unless ``norm_output=False``."""

    def __init__(self, dim: int, depth: int, dim_head: int = 32, heads: int = 8, ff_mult: int = 4,
                 dropout: float = 0.0, norm_output: bool = True, window_size: int = 7, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([DSSA(dim, heads, dim_head, dropout, window_size, **kw),
                           FeedForward(dim, ff_mult, dropout, **kw)])
            for _ in range(depth)
        )
        self.norm = ChanLayerNorm(dim, **kw) if norm_output else nn.Identity()

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return self.norm(x)


class SepViT(nn.Module):
    """reference sep_vit.py:237 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py`` (the window tokens
    unit normal, as the JAX init)."""

    def __init__(self, *, num_classes: int, dim: int, depth, heads, window_size=7, dim_head: int = 32,
                 ff_mult: int = 4, channels: int = 3, dropout: float = 0.0, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not isinstance(depth, (tuple, list)):
            raise ValueError("depth needs to be tuple of integers indicating number of transformer blocks per stage")
        kw = {"device": default_device(device), "dtype": dtype}
        stages = len(depth)
        dims = tuple((2**i) * dim for i in range(stages))
        all_dims = (channels, *dims)
        strides = (4, *((2,) * (stages - 1)))
        heads, window_size = cast_tuple(heads, stages), cast_tuple(window_size, stages)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                OverlappingPatchEmbed(all_dims[i], all_dims[i + 1], stride=strides[i], **kw),
                PEG(all_dims[i + 1], **kw),
                Transformer(all_dims[i + 1], depth[i], dim_head, heads[i], ff_mult, dropout,
                            norm_output=i != stages - 1, window_size=window_size[i], **kw),
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
        for m in self.modules():
            if isinstance(m, DSSA):
                m.window_tokens.normal_(generator=generator)

    def forward(self, x):
        for ope, peg, transformer in self.layers:
            x = transformer(peg(ope(x)))
        return self.mlp_head(x)
