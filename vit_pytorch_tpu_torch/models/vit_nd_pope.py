"""ViT-ND with Golden-Gate PoPE, the polar positional embedding (reference
vit_nd_pope.py:51-353), port of ``vit_pytorch_tpu/models/vit_nd_pope.py``.

q and k map through a softplus magnitude times (cos theta, sin theta), the
keys' phase shifted by a learned bias clamped to [-2 pi, 0]
(:func:`apply_polar_pos_emb`, in float32, cast back), which doubles their
width to 2 x ``dim_head``; v keeps ``dim_head`` and the logits' scale stays
``dim_head**-0.5``.  The frequencies are :func:`pope_freqs`, on the
directions of ``models/vit_nd_rotary.py``.

The state_dict is the reference's: the rotary model's layers and
``polar_emb.learned_bias`` (``utils/convert.py::convert_vit_nd_pope``,
``utils/from_jax.py::vit_nd_pope_state_dict_from_jax``).  Each attention
goes through ``ops/attention.py::dot_product_attention``; the kernels'
gates refuse q and k wider than v (at ``dim_head`` 64 they are 128 wide),
so on the card the attention takes the composite, as the JAX package's
kernels refuse them too.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from ..nn.blocks import LayerNorm
from ..ops.attention import dot_product_attention
from ..utils.helpers import default_device
from .vit import init_modules_like_jax
from .vit_nd_rotary import NDBase, log_freqs, make_directions


def pope_freqs(dim_pos: int, heads: int, dim_head: int, min_freq: float = 1.0, max_freq: float = 10000.0,
               p_zero_freqs: float = 0.0) -> torch.Tensor:
    """The (heads, dim_head, dim_pos) float32 frequency table (reference
    vit_nd_pope.py:51-78)."""
    omega = log_freqs(dim_head, min_freq, max_freq, p_zero_freqs)
    directions = rearrange(make_directions(heads * dim_head, dim_pos), "(h f) p -> h f p", h=heads)
    return torch.from_numpy(np.ascontiguousarray(directions * omega[None, :, None]))


def apply_polar_pos_emb(t: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """(b, h, n, d) ``t`` -> (b, h, n, 2d): softplus(t) * cos(freqs) beside
    softplus(t) * sin(freqs), in float32, cast back to t's dtype (reference
    vit_nd_pope.py:101-109)."""
    dtype = t.dtype
    t = F.softplus(t.float())
    return torch.cat([t * freqs.cos(), t * freqs.sin()], dim=-1).to(dtype)


class PoPEAttention(nn.Module):
    """reference vit_nd_pope.py:129-168: the rotary model's projections, the
    polar map on q (angles theta) and k (theta + the clamped bias)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.norm = LayerNorm(dim, **kw)
        self.to_qk = nn.Linear(dim, inner * 2, bias=False, **kw)
        self.to_v = nn.Linear(dim, inner, bias=False, **kw)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout)) if project_out else nn.Identity()

    def split(self, t):
        b, n, _ = t.shape
        return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

    def forward(self, x, polar_pos_emb=None):
        x = self.norm(x)
        q, k = map(self.split, self.to_qk(x).chunk(2, dim=-1))
        v = self.split(self.to_v(x))
        if polar_pos_emb is not None:
            theta, bias = polar_pos_emb
            q, k = apply_polar_pos_emb(q, theta), apply_polar_pos_emb(k, theta + bias)
        out = dot_product_attention(q, k, v, scale=self.dim_head**-0.5,
                                    dropout_rate=self.dropout if self.training else 0.0)
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class PolarEmbedding(nn.Module):
    """The keys' learned phase bias (heads, dim_head), zeros or, with
    ``init_uniform``, uniform in [0, 2 pi) and read 2 pi lower, as the JAX
    model reads its parameter (vit_nd_pope.py:95-98)."""

    def __init__(self, heads: int, dim_head: int, init_uniform: bool, *, device=None, dtype=None):
        super().__init__()
        self.init_uniform = init_uniform
        self.learned_bias = nn.Parameter(torch.zeros(heads, dim_head, device=device, dtype=dtype))

    def bias(self) -> torch.Tensor:
        """(heads, 1, dim_head) in float32, clamped to [-2 pi, 0]."""
        b = self.learned_bias.float()
        if self.init_uniform:
            b = b - 2 * math.pi
        return b.clamp(-2 * math.pi, 0.0)[:, None, :]


class ViTND(NDBase):
    """reference vit_nd_pope.py:200 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, ndim: int, input_shape: Union[int, Tuple[int, ...]], patch_size: Union[int, Tuple[int, ...]],
                 num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int, channels: int = 3,
                 dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0, pope_min_freq: float = 1.0,
                 pope_max_freq: float = 10000.0, pope_p_zero_freqs: float = 0.0,
                 init_learned_bias_uniform: bool = False, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        kw = {"device": default_device(device), "dtype": dtype}
        super().__init__(PoPEAttention, ndim=ndim, input_shape=input_shape, patch_size=patch_size,
                         num_classes=num_classes, dim=dim, depth=depth, heads=heads, mlp_dim=mlp_dim,
                         channels=channels, dim_head=dim_head, dropout=dropout, emb_dropout=emb_dropout, kw=kw)
        self.freqs = pope_freqs(ndim, heads, dim_head, pope_min_freq, pope_max_freq, pope_p_zero_freqs).numpy()
        self.polar_emb = PolarEmbedding(heads, dim_head, init_learned_bias_uniform, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        if self.polar_emb.init_uniform:
            self.polar_emb.learned_bias.uniform_(0.0, 2 * math.pi, generator=generator)
        else:
            self.polar_emb.learned_bias.zero_()

    def pos_emb(self, device):
        """(theta (heads, n, dim_head), the keys' bias (heads, 1,
        dim_head)), both float32."""
        return self.angles(self.freqs, device), self.polar_emb.bias()
