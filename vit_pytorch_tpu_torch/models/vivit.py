"""ViViT, the video vision transformer (reference vivit.py:154-281), port of
``vit_pytorch_tpu/models/vivit.py``.

Variants: ``factorized_encoder`` (a spatial transformer over each frame's
patches, then a temporal transformer over the frames, vivit.py:244-272) and
``factorized_self_attention`` (each layer a spatial attention, a temporal
attention and a feed-forward, vivit.py:123-152).  An optional frame mask
(b, frames) becomes the temporal attention's key mask (vivit.py:239-240).

Parameters keep the reference's ``state_dict`` layout
(``to_patch_embedding.1/2/3``, ``pos_embedding``, ``spatial_cls_token``,
``temporal_cls_token``, ``spatial_transformer.*``, ``temporal_transformer.*``
or ``factorized_transformer.layers.N.0|1|2`` and ``factorized_transformer.
norm``, ``mlp_head``), so the JAX package's ``utils/convert.py::
convert_vivit`` maps the ``factorized_encoder`` one onto the JAX params and
``utils/from_jax.py::vivit_state_dict_from_jax`` maps both back.

On the card in bf16 each :class:`~..nn.blocks.Transformer` runs the
whole-layer kernels (7 launches a layer forward) and each attention call of
the factorized self-attention the attention-block kernels (4 launches); a
frame mask takes the temporal attention to the module composite, as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from einops.layers.torch import Rearrange
from torch import nn

from ..nn.blocks import LN_EPS, Attention, FeedForward, Transformer
from ..utils.helpers import default_device, pair
from .vit import init_modules_like_jax


class FactorizedTransformer(nn.Module):
    """reference vivit.py:123-152, the JAX ``FactorizedTransformer``: each
    layer attends over the patches of a frame, then over the frames of a
    patch position, then runs the feed-forward; a closing LayerNorm.  Each
    attention's output is added to its input outside the call, as the JAX
    loop adds it."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0, *,
                 flash: Optional[bool] = None, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        attn = lambda: Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, flash=flash, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList([attn(), attn(), FeedForward(dim, mlp_dim, dropout=dropout, **kw)]) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)

    def forward(self, x, *, mask=None):
        """``x`` (b, f, n, d); ``mask`` (b, f) bool, True where a frame is
        attended, repeated for each of the n positions (JAX :38-42)."""
        b, f, n, d = x.shape
        kp = None if mask is None else mask.repeat_interleave(n, dim=0)[:, None, None, :]
        for spatial, temporal, ff in self.layers:
            x = x.reshape(b * f, n, d)
            x = spatial(x) + x
            x = x.reshape(b, f, n, d).transpose(1, 2).reshape(b * n, f, d)
            x = temporal(x, mask=kp) + x
            x = ff(x) + x
            x = x.reshape(b, n, f, d).transpose(1, 2)
        return self.norm(x)


class ViViT(nn.Module):
    """reference vivit.py:154 — same keyword constructor.  ``flash`` is the
    JAX model's (``flash=False`` opts out of every kernel); ``use_flash_attn``
    is accepted for the reference's signature and has no effect, as in the
    JAX package (its dispatcher picks the route per shape).  ``device`` (the
    CUDA card unless it names another) and ``dtype`` place the parameters,
    ``generator`` seeds their initialisation (the JAX package's: unit
    LayerNorms, truncated lecun-normal Linear weights, zero biases, unit
    normal position table and cls tokens).  ``model.train()`` stands for the
    JAX ``train=True``."""

    def __init__(
        self,
        *,
        image_size,
        image_patch_size,
        frames: int,
        frame_patch_size: int,
        num_classes: int,
        dim: int,
        spatial_depth: int,
        temporal_depth: int,
        heads: int,
        mlp_dim: int,
        pool: str = "cls",
        channels: int = 3,
        dim_head: int = 64,
        dropout: float = 0.0,
        emb_dropout: float = 0.0,
        variant: str = "factorized_encoder",
        use_flash_attn: bool = True,
        flash: Optional[bool] = None,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del use_flash_attn
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(image_patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if frames % frame_patch_size:
            raise ValueError("Frames must be divisible by the frame patch size")
        if variant not in ("factorized_encoder", "factorized_self_attention"):
            raise ValueError(f"variant = {variant} is not implemented")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls (cls token) or mean (mean pooling)")
        if variant == "factorized_self_attention" and spatial_depth != temporal_depth:
            raise ValueError("Spatial and temporal depth must be the same for factorized self-attention")
        kw = {"device": default_device(device), "dtype": dtype}
        num_image_patches = (image_height // patch_height) * (image_width // patch_width)
        num_frame_patches = frames // frame_patch_size
        patch_dim = channels * patch_height * patch_width * frame_patch_size
        self.frames, self.frame_patch_size, self.pool, self.variant = frames, frame_patch_size, pool, variant
        self.global_average_pool = pool == "mean"

        self.to_patch_embedding = nn.Sequential(
            Rearrange("b c (f pf) (h p1) (w p2) -> b f (h w) (pf p1 p2 c)", p1=patch_height, p2=patch_width,
                      pf=frame_patch_size),
            nn.LayerNorm(patch_dim, eps=LN_EPS, **kw),
            nn.Linear(patch_dim, dim, **kw),
            nn.LayerNorm(dim, eps=LN_EPS, **kw),
        )
        self.pos_embedding = nn.Parameter(torch.empty(1, num_frame_patches, num_image_patches, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        if not self.global_average_pool:
            self.spatial_cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        if variant == "factorized_encoder":
            if not self.global_average_pool:
                self.temporal_cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
            self.spatial_transformer = Transformer(dim, spatial_depth, heads, dim_head, mlp_dim, dropout, flash=flash,
                                                   **kw)
            self.temporal_transformer = Transformer(dim, temporal_depth, heads, dim_head, mlp_dim, dropout,
                                                    flash=flash, **kw)
        else:
            self.factorized_transformer = FactorizedTransformer(dim, spatial_depth, heads, dim_head, mlp_dim, dropout,
                                                                flash=flash, **kw)
        self.mlp_head = nn.Linear(dim, num_classes, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        for name in ("pos_embedding", "spatial_cls_token", "temporal_cls_token"):
            if hasattr(self, name):
                getattr(self, name).normal_(generator=generator)

    def forward(self, video, *, mask=None):
        """``video`` (b, c, frames, h, w); ``mask`` (b, frames) bool, True
        where a frame is real: a frame patch is attended when all its frames
        are (JAX :154-161)."""
        x = self.to_patch_embedding(video)
        b, f, n, d = x.shape
        x = x + self.pos_embedding[:, :f, :n].to(x.dtype)
        if not self.global_average_pool:
            x = torch.cat([self.spatial_cls_token.to(x.dtype)[None].expand(b, f, 1, d), x], dim=2)
        x = self.dropout(x)

        temporal_mask = None
        if mask is not None:
            if mask.shape[-1] != self.frames:
                raise ValueError(f"frame mask must have shape (batch, {self.frames})")
            temporal_mask = mask.reshape(b, -1, self.frame_patch_size).all(dim=-1)

        if self.variant == "factorized_encoder":
            x = self.spatial_transformer(x.reshape(b * f, -1, d)).reshape(b, f, -1, d)
            x = x.mean(dim=2) if self.global_average_pool else x[:, :, 0]
            if not self.global_average_pool:
                x = torch.cat([self.temporal_cls_token.to(x.dtype).expand(b, 1, d), x], dim=1)
                if temporal_mask is not None:
                    temporal_mask = F.pad(temporal_mask, (1, 0), value=True)
            kp = None if temporal_mask is None else temporal_mask[:, None, None, :]
            x = self.temporal_transformer(x, mask=kp)
            x = x.mean(dim=1) if self.global_average_pool else x[:, 0]
        else:
            x = self.factorized_transformer(x, mask=temporal_mask)
            x = x.mean(dim=(1, 2)) if self.global_average_pool else x[:, 0, 0]
        return self.mlp_head(x)
