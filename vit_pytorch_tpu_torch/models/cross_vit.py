"""CrossViT, the two-branch multi-scale ViT (reference cross_vit.py:204-270),
port of ``vit_pytorch_tpu/models/cross_vit.py``.

A small-patch and a large-patch branch each embed the image (a
``PatchEmbedding``, a cls token and a learned table) and run the shared
``Transformer`` a round; then each branch's cls token attends the other
branch's patch tokens, itself included (``Attention(kv_include_self=True)``
with a context, the split projections), through a Linear into and out of
the other branch's width where the widths differ (``ProjectInOut``,
cross_vit.py:94-130).  The logits are the sum of the two heads.  On the card
in bf16 each branch's ``Transformer`` takes the kernels its predicates
admit: at the upstream README's widths the large branch's 17 tokens the
whole-layer chain when served and the attention-block kernels in training
with dropout, the small branch's 257 tokens the composite; the cls-only
cross-attention calls take the composite, as in the JAX package.

The state_dict is the reference's (``{sm,lg}_image_embedder.*``,
``multi_scale_encoder.layers.i.0|1`` the branches' transformers (the fused
``to_qkv``, which ``convert_cross_vit`` reads beside the reference's split
one), ``multi_scale_encoder.layers.i.2.layers.N.0|1`` the cross-attention
with ``project_in``, ``project_out`` and ``fn``, ``{sm,lg}_mlp_head.0|1``):
``utils/convert.py::convert_cross_vit``,
``utils/from_jax.py::cross_vit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import Attention, LayerNorm, Transformer
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device
from .vit import init_modules_like_jax


class ImageEmbedder(nn.Module):
    """reference cross_vit.py:166-200: patch embedding, cls token, table,
    dropout."""

    def __init__(self, *, dim: int, image_size: int, patch_size: int, dropout: float = 0.0, channels: int = 3,
                 device=None, dtype=None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": device, "dtype": dtype}
        num_patches = (image_size // patch_size) ** 2
        self.to_patch_embedding = PatchEmbedding((patch_size, patch_size), channels * patch_size**2, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(dropout)

    def forward(self, img):
        x = self.to_patch_embedding(img)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        return self.dropout(x + self.pos_embedding[:, : n + 1].to(x.dtype))


class ProjectInOut(nn.Module):
    """reference cross_vit.py:94-107: ``fn`` at ``dim_out``, entered and
    left through Linears when ``dim_in != dim_out`` (identities else)."""

    def __init__(self, dim_in: int, dim_out: int, fn: nn.Module, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.fn = fn
        need_projection = dim_in != dim_out
        self.project_in = nn.Linear(dim_in, dim_out, **kw) if need_projection else nn.Identity()
        self.project_out = nn.Linear(dim_out, dim_in, **kw) if need_projection else nn.Identity()

    def forward(self, x, context):
        return self.project_out(self.fn(self.project_in(x), context=context))


class CrossTransformer(nn.Module):
    """reference cross_vit.py:111-130: a layer is the small branch's cls
    token attending the large branch's patches, then the large's attending
    the small's, each added to its cls token."""

    def __init__(self, sm_dim: int, lg_dim: int, depth: int, heads: int, dim_head: int, dropout: float, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        attend = lambda dim: Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, kv_include_self=True,
                                       project_out=True, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList([ProjectInOut(sm_dim, lg_dim, attend(lg_dim), **kw),
                           ProjectInOut(lg_dim, sm_dim, attend(sm_dim), **kw)])
            for _ in range(depth)
        )

    def forward(self, sm_tokens, lg_tokens):
        (sm_cls, sm_patch), (lg_cls, lg_patch) = ((t[:, :1], t[:, 1:]) for t in (sm_tokens, lg_tokens))
        for sm_attend_lg, lg_attend_sm in self.layers:
            sm_cls = sm_attend_lg(sm_cls, context=lg_patch) + sm_cls
            lg_cls = lg_attend_sm(lg_cls, context=sm_patch) + lg_cls
        return torch.cat([sm_cls, sm_patch], dim=1), torch.cat([lg_cls, lg_patch], dim=1)


class MultiScaleEncoder(nn.Module):
    """The reference's ``MultiScaleEncoder`` (the JAX cross_vit.py:154-172):
    ``depth`` rounds of the two branches' transformers and the cross
    transformer (``layers.i.0|1|2``)."""

    def __init__(self, *, depth: int, sm_dim: int, lg_dim: int, sm_enc_params: dict, lg_enc_params: dict,
                 cross_attn_heads: int, cross_attn_depth: int, cross_attn_dim_head: int, dropout: float, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        branch = lambda dim, p: Transformer(dim, p["depth"], p["heads"], p["dim_head"], p["mlp_dim"], dropout, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                branch(sm_dim, sm_enc_params),
                branch(lg_dim, lg_enc_params),
                CrossTransformer(sm_dim, lg_dim, cross_attn_depth, cross_attn_heads, cross_attn_dim_head, dropout,
                                 **kw),
            ])
            for _ in range(depth)
        )

    def forward(self, sm_tokens, lg_tokens):
        for sm_enc, lg_enc, cross in self.layers:
            sm_tokens, lg_tokens = sm_enc(sm_tokens), lg_enc(lg_tokens)
            sm_tokens, lg_tokens = cross(sm_tokens, lg_tokens)
        return sm_tokens, lg_tokens


class CrossViT(nn.Module):
    """reference cross_vit.py:204 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, image_size: int, num_classes: int, sm_dim: int, lg_dim: int, sm_patch_size: int = 12,
                 sm_enc_depth: int = 1, sm_enc_heads: int = 8, sm_enc_mlp_dim: int = 2048, sm_enc_dim_head: int = 64,
                 lg_patch_size: int = 16, lg_enc_depth: int = 4, lg_enc_heads: int = 8, lg_enc_mlp_dim: int = 2048,
                 lg_enc_dim_head: int = 64, cross_attn_depth: int = 2, cross_attn_heads: int = 8,
                 cross_attn_dim_head: int = 64, depth: int = 3, dropout: float = 0.1, emb_dropout: float = 0.1,
                 channels: int = 3, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        embed = lambda dim, p: ImageEmbedder(dim=dim, image_size=image_size, patch_size=p, dropout=emb_dropout,
                                             channels=channels, **kw)
        self.sm_image_embedder = embed(sm_dim, sm_patch_size)
        self.lg_image_embedder = embed(lg_dim, lg_patch_size)
        self.multi_scale_encoder = MultiScaleEncoder(
            depth=depth, sm_dim=sm_dim, lg_dim=lg_dim, cross_attn_heads=cross_attn_heads,
            cross_attn_dim_head=cross_attn_dim_head, cross_attn_depth=cross_attn_depth, dropout=dropout,
            sm_enc_params=dict(depth=sm_enc_depth, heads=sm_enc_heads, mlp_dim=sm_enc_mlp_dim, dim_head=sm_enc_dim_head),
            lg_enc_params=dict(depth=lg_enc_depth, heads=lg_enc_heads, mlp_dim=lg_enc_mlp_dim, dim_head=lg_enc_dim_head),
            **kw)
        self.sm_mlp_head = nn.Sequential(LayerNorm(sm_dim, **kw), nn.Linear(sm_dim, num_classes, **kw))
        self.lg_mlp_head = nn.Sequential(LayerNorm(lg_dim, **kw), nn.Linear(lg_dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        for emb in (self.sm_image_embedder, self.lg_image_embedder):
            emb.pos_embedding.normal_(generator=generator)
            emb.cls_token.normal_(generator=generator)

    def forward(self, img):
        sm_tokens, lg_tokens = self.multi_scale_encoder(self.sm_image_embedder(img), self.lg_image_embedder(img))
        return self.sm_mlp_head(sm_tokens[:, 0]) + self.lg_mlp_head(lg_tokens[:, 0])
