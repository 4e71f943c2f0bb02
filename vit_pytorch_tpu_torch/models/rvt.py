"""RvT, the rotary vision transformer (reference rvt.py:178-211), port of
``vit_pytorch_tpu/models/rvt.py``.

Each attention takes q from a depthwise 5x5 and a 1x1 convolution on the
token grid, bias-free (``SpatialConv``, rvt.py:61-73; the cls token through
a Linear where the widths differ), k and v from a bias-free Linear, and
rotates q and k but the cls token by 2-D axial angles (rvt.py:20-47,
131-147) in an f32 island, whatever the dtype of the parameters: the sine
and cosine tables are f32 constants built with numpy as the JAX module
builds them (``max_freq = image_size``), outside the module's buffers, so
that a cast of the model cannot round them.  The feed-forward is a GEGLU
(``FeedForward(glu=True)``).  The attention goes through
``ops/attention.py::dot_product_attention``, which at 65 tokens takes the
composite, as the JAX dispatcher does.

The state_dict is the reference's but its ``pos_emb.scales`` buffer, which
``convert_rvt`` drops (``cls_token``, ``to_patch_embedding.1``,
``transformer.layers.N.0`` with ``norm``, ``to_q.conv.net.0|1``,
``to_kv``, ``to_out.0``, ``transformer.layers.N.1.net.0|1|4``,
``mlp_head.0|1``): ``utils/convert.py::convert_rvt``,
``utils/from_jax.py::rvt_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from einops import rearrange, repeat
from torch import nn

from ..nn.blocks import FeedForward, LayerNorm
from ..nn.patch import Patchify
from ..ops.attention import dot_product_attention
from ..utils.helpers import default_device
from .local_vit import DepthWiseConv2d
from .vit import init_modules_like_jax


def rotate_every_two(x):
    """(..., 2k) -> each pair (x1, x2) as (-x2, x1) (reference rvt.py:14-18)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x.unbind(-1)
    return torch.stack([-x2, x1], dim=-1).flatten(-2)


def axial_rotary_embedding(dim_head: int, n: int, max_freq: float):
    """The (1, n^2, dim) float32 sine and cosine tables of an n x n grid, as
    numpy arrays (reference rvt.py:20-47, the JAX ``axial_rotary_embedding``)."""
    scales = np.linspace(1.0, max_freq / 2, dim_head // 4, dtype=np.float32)
    seq = np.linspace(-1.0, 1.0, n, dtype=np.float32)[:, None]
    seq = seq * scales[None, :] * np.pi
    x_sinu = repeat(seq, "i d -> i j d", j=n)
    y_sinu = repeat(seq, "j d -> i j d", i=n)
    sin = np.concatenate([np.sin(x_sinu), np.sin(y_sinu)], axis=-1)
    cos = np.concatenate([np.cos(x_sinu), np.cos(y_sinu)], axis=-1)
    sin = np.repeat(rearrange(sin, "i j d -> (i j) d"), 2, axis=-1)[None]
    cos = np.repeat(rearrange(cos, "i j d -> (i j) d"), 2, axis=-1)[None]
    return sin, cos


class SpatialConv(nn.Module):
    """reference rvt.py:61-73: the grid's tokens through the bias-free
    depthwise pair, the cls token through ``cls_proj`` where the widths
    differ."""

    def __init__(self, dim_in: int, dim_out: int, kernel: int, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.conv = DepthWiseConv2d(dim_in, dim_out, kernel, kernel // 2, bias=False, **kw)
        self.cls_proj = nn.Linear(dim_in, dim_out, **kw) if dim_in != dim_out else nn.Identity()

    def forward(self, x, fmap_h: int, fmap_w: int):
        cls_token, tokens = x[:, :1], x[:, 1:]
        b, _, c = tokens.shape
        fmap = self.conv(tokens.transpose(1, 2).reshape(b, c, fmap_h, fmap_w))
        return torch.cat([self.cls_proj(cls_token), fmap.flatten(2).transpose(1, 2)], dim=1)


class RvTAttention(nn.Module):
    """reference rvt.py:94-156, the JAX ``RvTAttention``: LayerNorm, q from
    :class:`SpatialConv` (or a bias-free Linear without ``use_ds_conv``), k
    and v from a bias-free Linear, the rotary on q and k but the cls token,
    the dispatcher, the projection out and its dropout."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *, use_rotary: bool = True,
                 use_ds_conv: bool = True, conv_query_kernel: int = 5, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout, self.use_rotary = heads, dim_head, dropout, use_rotary
        self.use_ds_conv = use_ds_conv
        self.norm = LayerNorm(dim, **kw)
        self.to_q = (SpatialConv(dim, inner, conv_query_kernel, **kw) if use_ds_conv
                     else nn.Linear(dim, inner, bias=False, **kw))
        self.to_kv = nn.Linear(dim, inner * 2, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))

    def forward(self, x, sin, cos, fmap_h: int, fmap_w: int):
        b, n, _ = x.shape
        x = self.norm(x)
        q = self.to_q(x, fmap_h, fmap_w) if self.use_ds_conv else self.to_q(x)
        split = lambda t: t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
        q, k, v = split(q), *map(split, self.to_kv(x).chunk(2, dim=-1))
        if self.use_rotary:
            dim_rotary = sin.shape[-1]

            def rotate(t):  # the f32 island (JAX rvt.py:110-119)
                tt = t[:, :, 1:].float()
                tr, tp = tt[..., :dim_rotary], tt[..., dim_rotary:]
                tt = torch.cat([tr * cos + rotate_every_two(tr) * sin, tp], dim=-1).to(t.dtype)
                return torch.cat([t[:, :, :1], tt], dim=2)

            q, k = rotate(q), rotate(k)
        out = dot_product_attention(q, k, v, scale=self.dim_head**-0.5,
                                    dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class RvT(nn.Module):
    """reference rvt.py:178 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, channels: int = 3, dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 use_rotary: bool = True, use_ds_conv: bool = True, use_glu: bool = True, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        del emb_dropout  # the JAX model (and the reference) apply none
        kw = {"device": default_device(device), "dtype": dtype}
        self.image_size, self.dim_head, self.fmap = image_size, dim_head, image_size // patch_size
        self.to_patch_embedding = nn.Sequential(Patchify(patch_size, patch_size),
                                                nn.Linear(channels * patch_size**2, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            nn.ModuleList([
                RvTAttention(dim, heads, dim_head, dropout, use_rotary=use_rotary, use_ds_conv=use_ds_conv, **kw),
                FeedForward(dim, mlp_dim, dropout, glu=use_glu, **kw),
            ])
            for _ in range(depth)
        )
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self._tables = {}
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.cls_token.normal_(generator=generator)

    def tables(self, device):
        """The rotary's float32 sine and cosine tables on ``device``, made
        once a device: constants, not buffers."""
        if device not in self._tables:
            sin, cos = axial_rotary_embedding(self.dim_head, self.fmap, self.image_size)
            self._tables[device] = (torch.from_numpy(sin).to(device), torch.from_numpy(cos).to(device))
        return self._tables[device]

    def forward(self, img):
        x = self.to_patch_embedding(img)
        b = x.shape[0]
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        sin, cos = self.tables(x.device)
        for attn, ff in self.transformer.layers:
            x = attn(x, sin, cos, self.fmap, self.fmap) + x
            x = ff(x) + x
        return self.mlp_head(x[:, 0])
