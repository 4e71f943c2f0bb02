"""ViT-ND with Golden-Gate N-D rotary embeddings (reference
vit_nd_rotary.py:46-300), port of ``vit_pytorch_tpu/models/vit_nd_rotary.py``.

The rotary's directions are golden-ratio quasi-random vectors gaussianized
with ``erfinv`` and l2-normalised in float64, then cast to float32
(:func:`make_directions`); the frequencies are log-spaced, with an optional
share at zero (:func:`golden_gate_freqs`).  The rotation runs in float32 on
q and k and casts back to their dtype before the attention
(:func:`apply_golden_gate_rope`).  No cls token: the head reads the mean of
the tokens, or ``return_embed`` gives them on their grid.

The state_dict is the reference's (``to_patch_embedding.1|2``,
``transformer.layers.N.0.norm|to_qk|to_v|to_out.0``,
``transformer.layers.N.1.net.0|1|4``, ``transformer.norm``,
``mlp_head``; the frequency table is a buffer outside it):
``utils/convert.py::convert_vit_nd_rotary``,
``utils/from_jax.py::vit_nd_rotary_state_dict_from_jax``.  Each attention
goes through ``ops/attention.py::dot_product_attention``, as the JAX
``RotaryAttention`` does: on the card in bf16, at 1,024 tokens, the short
kernel serves and the flash kernels train with attention dropout.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
from einops import rearrange
from torch import nn

from ..nn.blocks import FeedForward, LayerNorm
from ..ops.attention import dot_product_attention
from ..utils.helpers import default_device
from .vit import init_modules_like_jax
from .vit_nd import NDPatchify, nd_grid


def _phi(d: int) -> float:
    """The d-dimensional golden ratio (reference vit_nd_rotary.py:27-35)."""
    x = 1.0
    for _ in range(30):
        x = (1 + x) ** (1.0 / (d + 1))
    return x


def make_directions(n: int, d: int) -> np.ndarray:
    """``n`` unit directions in ``d`` dimensions (reference
    vit_nd_rotary.py:37-44), float64 inside, float32 out."""
    from scipy.special import erfinv

    alpha = (1.0 / _phi(d)) ** np.arange(1, d + 1, dtype=np.float64)
    i = np.arange(1, n + 1, dtype=np.float64)[:, None]
    directions = erfinv(2.0 * np.fmod(i * alpha, 1.0) - 1.0)
    directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    return directions.astype(np.float32)


def log_freqs(n_freqs: int, min_freq: float, max_freq: float, p_zero_freqs: float) -> np.ndarray:
    """``n_freqs`` float32 frequencies: round(p_zero_freqs * n_freqs) zeros,
    then log-spaced from ``min_freq`` to ``max_freq``."""
    n_zero = round(p_zero_freqs * n_freqs)
    return np.concatenate([
        np.zeros(n_zero, dtype=np.float32),
        min_freq * (max_freq / min_freq) ** np.linspace(0, 1, n_freqs - n_zero, dtype=np.float32),
    ])


def golden_gate_freqs(dim_pos: int, heads: int, dim_head: int, rope_min_freq: float = 1.0,
                      rope_max_freq: float = 10000.0, rope_p_zero_freqs: float = 0.0) -> torch.Tensor:
    """The (heads, dim_head // 2, dim_pos) float32 frequency table
    (reference vit_nd_rotary.py:46-73)."""
    n_freqs = dim_head // 2
    omega = log_freqs(n_freqs, rope_min_freq, rope_max_freq, rope_p_zero_freqs)
    directions = rearrange(make_directions(heads * n_freqs, dim_pos), "(h f) p -> h f p", h=heads)
    return torch.from_numpy(np.ascontiguousarray(directions * omega[None, :, None]))


def grid_positions(grid, device=None) -> torch.Tensor:
    """The (n, len(grid)) float32 coordinates of a grid's cells, in the
    tokens' order (the JAX ``meshgrid(..., indexing="ij")``)."""
    axes = [torch.arange(d, dtype=torch.float32, device=device) for d in grid]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, len(grid))


def rope_angles(freqs: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """theta (heads, n, f) = freqs (heads, f, p) . pos (n, p), in float32
    (the JAX einsum "hfp,bnp->bhnf", the same for every image)."""
    return torch.einsum("hfp,np->hnf", freqs.float(), pos.float())


def apply_golden_gate_rope(theta: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Rotate (b, h, n, d) ``t`` by ``theta`` ((h, n, d / 2) or broadcast to
    it) in float32, halves (x, y) -> (x cos - y sin, x sin + y cos), cast
    back to t's dtype (reference vit_nd_rotary.py:74-96)."""
    dtype = t.dtype
    x, y = t.float().chunk(2, dim=-1)
    cos, sin = theta.cos(), theta.sin()
    return torch.cat([x * cos - y * sin, x * sin + y * cos], dim=-1).to(dtype)


class RotaryAttention(nn.Module):
    """reference vit_nd_rotary.py:117-155: LN, bias-free ``to_qk`` and
    ``to_v``, the rotary on q and k, the dispatcher, ``to_out`` with its
    dropout (unless one head of ``dim``)."""

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

    def forward(self, x, theta: Optional[torch.Tensor] = None):
        x = self.norm(x)
        q, k = map(self.split, self.to_qk(x).chunk(2, dim=-1))
        v = self.split(self.to_v(x))
        if theta is not None:
            q, k = apply_golden_gate_rope(theta, q), apply_golden_gate_rope(theta, k)
        out = dot_product_attention(q, k, v, dropout_rate=self.dropout if self.training else 0.0)
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class NDTransformer(nn.Module):
    """The pre-norm layers of the rotary and PoPE ViT-NDs: ``attention``
    (a class of ``dim``, ``heads``, ``dim_head``, ``dropout``) and a
    ``FeedForward`` a layer, each with its residual, and a final LayerNorm;
    ``pos_emb`` rides into every attention call."""

    def __init__(self, attention, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, dropout: float, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([attention(dim, heads, dim_head, dropout, **kw), FeedForward(dim, mlp_dim, dropout, **kw)])
            for _ in range(depth)
        )
        self.norm = LayerNorm(dim, **kw)

    def forward(self, x, pos_emb):
        for attn, ff in self.layers:
            x = attn(x, pos_emb) + x
            x = ff(x) + x
        return self.norm(x)


class NDBase(nn.Module):
    """The shell of the rotary and PoPE ViT-NDs: Linear -> LN embedding of
    the ND patches, embedding dropout, an :class:`NDTransformer`, mean pool
    and a bare head; ``return_embed`` gives the normed tokens on their grid
    (b, *grid, dim)."""

    def __init__(self, attention, *, ndim: int, input_shape, patch_size, num_classes: int, dim: int, depth: int,
                 heads: int, mlp_dim: int, channels: int, dim_head: int, dropout: float, emb_dropout: float, kw):
        super().__init__()
        patch, self.grid = nd_grid(ndim, input_shape, patch_size)
        self.dim = dim
        self.to_patch_embedding = nn.Sequential(
            NDPatchify(patch), nn.Linear(channels * math.prod(patch), dim, **kw), LayerNorm(dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = NDTransformer(attention, dim, depth, heads, dim_head, mlp_dim, dropout, **kw)
        self.mlp_head = nn.Linear(dim, num_classes, **kw)

    def pos_emb(self, device):
        raise NotImplementedError

    def angles(self, freqs: np.ndarray, device) -> torch.Tensor:
        """theta (heads, n, f) of the (heads, f, p) float32 ``freqs`` on the
        grid, on ``device``, computed once a device.  The table stays a
        float32 constant outside the module's buffers, as the JAX model's
        numpy table stays one whatever the dtype of the parameters."""
        cache = self.__dict__.setdefault("_angles", {})
        if device not in cache:
            cache[device] = rope_angles(torch.from_numpy(freqs).to(device), grid_positions(self.grid, device))
        return cache[device]

    def forward(self, x, return_embed: bool = False):
        x = self.to_patch_embedding(x)
        x = self.transformer(self.dropout(x), self.pos_emb(x.device))
        if return_embed:
            return x.reshape(x.shape[0], *self.grid, self.dim)
        return self.mlp_head(x.mean(dim=1))


class ViTND(NDBase):
    """reference vit_nd_rotary.py:175 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, ndim: int, input_shape: Union[int, Tuple[int, ...]], patch_size: Union[int, Tuple[int, ...]],
                 num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int, channels: int = 3,
                 dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0, rope_min_freq: float = 1.0,
                 rope_max_freq: float = 10000.0, rope_p_zero_freqs: float = 0.0, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        kw = {"device": default_device(device), "dtype": dtype}
        super().__init__(RotaryAttention, ndim=ndim, input_shape=input_shape, patch_size=patch_size,
                         num_classes=num_classes, dim=dim, depth=depth, heads=heads, mlp_dim=mlp_dim,
                         channels=channels, dim_head=dim_head, dropout=dropout, emb_dropout=emb_dropout, kw=kw)
        self.freqs = golden_gate_freqs(ndim, heads, dim_head, rope_min_freq, rope_max_freq, rope_p_zero_freqs).numpy()
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)

    def pos_emb(self, device):
        """The rotary's angles (heads, n, dim_head / 2) on the grid."""
        return self.angles(self.freqs, device)
