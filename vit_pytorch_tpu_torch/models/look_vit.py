"""LookViT, a two-resolution ViT that reuses its attention (reference
look_vit.py:140-255), port of ``vit_pytorch_tpu/models/look_vit.py``.

The image's highres tokens come from a space-to-depth patching at
``highres_patch_size``, a convolution and a bias-free unit-offset
LayerNorm, plus the 2-D sincos table (an f32 buffer built once, cast to the
input's dtype at each call); the main tokens are their bilinear
resize to the ``patch_size`` grid (``F.interpolate(..., mode="bilinear",
align_corners=False, antialias=False)``, the JAX ``jax.image.resize(...,
"bilinear", antialias=False)``: half-pixel centres, no low-pass filter on
the way down, as the reference's ``F.interpolate``).  A layer: the main
tokens look up the highres ones (cross-attention that also returns its f32
q.k similarity), self-attend and pass an MLP; then the highres tokens
attend the main ones with the lookup's similarity transposed (no q or k of
their own, look_vit.py:228-245), a norm and an MLP.  Attention is
materialised (the similarity is reused), as in the JAX package: no kernel.
Norms are ``nn/blocks.py::UnitOffsetLayerNorm``.

The state_dict is the reference's (``to_patches.1`` the convolution,
``to_patches.3.gamma``, ``layers.N.0-5`` the attention, the MLP, the lookup,
the highres attention, the highres norm and MLP; each attention's
``norm``, ``norm_context``, ``to_q``, ``to_k``, ``to_v`` and ``to_out.1``;
each MLP's ``0.gamma`` and ``1|4``; ``norm``, ``highres_norm``,
``to_logits``): ``utils/convert.py::convert_look_vit``,
``utils/from_jax.py::look_vit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from einops import rearrange
from einops.layers.torch import Rearrange
from torch import nn

from ..nn.blocks import GELU, UnitOffsetLayerNorm
from ..nn.posemb import posemb_sincos_2d
from ..utils.helpers import default_device, table_device
from .vit import init_modules_like_jax


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(b, d, h, w) -> (b, d, size, size): the JAX model's
    ``jax.image.resize(..., "bilinear", antialias=False)`` (half-pixel
    centres, no antialiasing)."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False, antialias=False)


class MLP(nn.Sequential):
    """reference look_vit.py:49-58, the JAX ``LookMLP``: the unit-offset
    norm, Linear to ``dim * factor``, GELU, dropout, Linear back, dropout
    (``0|1|4``)."""

    def __init__(self, dim: int, factor: float = 4, dropout: float = 0.0, *, device=None, dtype=None):
        kw = {"device": device, "dtype": dtype}
        hidden = int(dim * factor)
        super().__init__(UnitOffsetLayerNorm(dim, **kw), nn.Linear(dim, hidden, **kw), GELU(), nn.Dropout(dropout),
                         nn.Linear(hidden, dim, **kw), nn.Dropout(dropout))


class Attention(nn.Module):
    """reference look_vit.py:62-136, the JAX ``LookAttention``: optional
    cross-attention (``norm_context`` on the context), optional reuse of a
    similarity given at call (``reuse_attention``: no norm on x, no q or k),
    the f32 similarity's softmax, dropout, the bias-free projection out and
    dropout (``to_out.1``)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 cross_attend: bool = False, reuse_attention: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.scale = heads, dim_head**-0.5
        self.cross_attend, self.reuse_attention = cross_attend, reuse_attention
        self.norm = UnitOffsetLayerNorm(dim, **kw) if not reuse_attention else nn.Identity()
        self.norm_context = UnitOffsetLayerNorm(dim, **kw) if cross_attend else nn.Identity()
        self.attend = nn.Dropout(dropout)
        if not reuse_attention:
            self.to_q = nn.Linear(dim, inner, bias=False, **kw)
            self.to_k = nn.Linear(dim, inner, bias=False, **kw)
        self.to_v = nn.Linear(dim, inner, bias=False, **kw)
        self.to_out = nn.Sequential(Rearrange("b h n d -> b n (h d)"), nn.Linear(inner, dim, bias=False, **kw),
                                    nn.Dropout(dropout))

    def forward(self, x, context=None, *, qk_sim=None, return_qk_sim: bool = False):
        if (context is not None) != self.cross_attend:
            raise ValueError("a context is given exactly when the attention cross-attends")
        x = self.norm(x)
        context = self.norm_context(context) if self.cross_attend else x
        heads = lambda t: rearrange(t, "b n (h d) -> b h n d", h=self.heads)
        v = heads(self.to_v(context))
        if not self.reuse_attention:
            q, k = heads(self.to_q(x)) * self.scale, heads(self.to_k(context))
            qk_sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        elif qk_sim is None:
            raise ValueError("qk sim matrix must be passed in for reusing previous attention")
        attn = self.attend(torch.softmax(qk_sim, dim=-1).to(v.dtype))
        out = self.to_out(torch.matmul(attn, v))
        return (out, qk_sim) if return_qk_sim else out


class LookViT(nn.Module):
    """reference look_vit.py:140 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py`` (the norms' gammas at
    zero, as the JAX init)."""

    def __init__(self, *, dim: int, image_size: int, num_classes: int, depth: int = 3, patch_size: int = 16,
                 heads: int = 8, mlp_factor: float = 4, dim_head: int = 64, highres_patch_size: int = 12,
                 highres_mlp_factor: float = 4, cross_attn_heads: int = 8, cross_attn_dim_head: int = 64,
                 patch_conv_kernel_size: int = 7, dropout: float = 0.1, channels: int = 3, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % highres_patch_size or image_size % patch_size:
            raise ValueError("image size must be divisible by the patch size and the highres patch size")
        if patch_size <= highres_patch_size:
            raise ValueError("patch size must be greater than the highres patch size")
        if patch_conv_kernel_size % 2 != 1:
            raise ValueError("the patch convolution's kernel size must be odd")
        kw = {"device": default_device(device), "dtype": dtype}
        self.image_size, self.dim = image_size, dim
        self.main_size = image_size // patch_size
        size = image_size // highres_patch_size
        pe = posemb_sincos_2d(size, size, dim, device=table_device(kw["device"])).reshape(size, size, dim)
        self.register_buffer("pos_embedding", pe, persistent=False)
        p, k = highres_patch_size, patch_conv_kernel_size
        self.to_patches = nn.Sequential(
            Rearrange("b c (h p1) (w p2) -> b (p1 p2 c) h w", p1=p, p2=p),
            nn.Conv2d(channels * p * p, dim, k, padding=k // 2, **kw),
            Rearrange("b c h w -> b h w c"),
            UnitOffsetLayerNorm(dim, **kw))
        cross = dict(heads=cross_attn_heads, dim_head=cross_attn_dim_head, dropout=dropout, cross_attend=True, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, **kw),
                MLP(dim, mlp_factor, dropout, **kw),
                Attention(dim, **cross),
                Attention(dim, **cross, reuse_attention=True),
                UnitOffsetLayerNorm(dim, **kw),
                MLP(dim, highres_mlp_factor, dropout, **kw),
            ])
            for _ in range(depth)
        )
        self.norm = UnitOffsetLayerNorm(dim, **kw)
        self.highres_norm = UnitOffsetLayerNorm(dim, **kw)
        self.to_logits = nn.Linear(dim, num_classes, bias=False, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        for m in self.modules():
            if isinstance(m, UnitOffsetLayerNorm):
                m.gamma.zero_()

    def forward(self, img):
        if tuple(img.shape[-2:]) != (self.image_size, self.image_size):
            raise ValueError(f"input must be {self.image_size} x {self.image_size}, got {tuple(img.shape[-2:])}")
        highres = self.to_patches(img) + self.pos_embedding.to(img.dtype)
        tokens = resize_bilinear(highres.permute(0, 3, 1, 2), self.main_size)
        tokens = rearrange(tokens, "b d h w -> b (h w) d")
        highres = rearrange(highres, "b h w d -> b (h w) d")
        for attn, mlp, lookup_cross_attn, highres_attn, highres_norm, highres_mlp in self.layers:
            lookup_out, qk_sim = lookup_cross_attn(tokens, highres, return_qk_sim=True)
            tokens = lookup_out + tokens
            tokens = attn(tokens) + tokens
            tokens = mlp(tokens) + tokens
            highres = highres_attn(highres, tokens, qk_sim=qk_sim.transpose(-1, -2)) + highres
            highres = highres_norm(highres)
            highres = highres_mlp(highres) + highres
        pooled = self.norm(tokens).mean(dim=1) + self.highres_norm(highres).mean(dim=1)
        return self.to_logits(pooled)
