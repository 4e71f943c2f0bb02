"""ViTDetPool: a ViT that pools over an object mask (reference vit_detpool.py:
107-209), port of ``vit_pytorch_tpu/models/vit_detpool.py``.

A (b, H, W) pixel object mask is max-pooled to a (b, num_patches) token
mask (a mask of any other shape is taken as one row of token flags a
sample), which masks the keys of every attention call and the final mean
over the tokens (vit_detpool.py:22-29, 121, 174-187).  Without a mask a
frozen ``mask_generator`` (a callable, e.g. a module, images -> mask) may
make one; it runs under ``torch.no_grad()``, where the JAX package uses
``stop_gradient``, and it stays out of this module's parameters, as the
JAX model keeps its variables apart (``mask_generator_variables``).

Each layer is ``Attention(x) + x`` and ``FeedForward(x) + x`` with the
shared modules of ``nn/blocks.py``: on the card, in bf16, without a mask
every attention call takes the attention-block kernels (its residual added
after them, as the JAX loop adds it); a mask refuses them, and the
attention runs the dispatcher's composite, as in JAX.

The state_dict is the reference's (``cls_token`` (dim,), ``pos_embedding``
(num_patches, dim), ``to_patch_embedding.1|2|3``, ``transformer.layers.N.0|1``,
``transformer.norm``, ``mlp_head``): ``utils/convert.py::convert_vit_detpool``,
``utils/from_jax.py::vit_detpool_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from einops import reduce
from torch import nn

from ..nn.blocks import Attention, FeedForward, LayerNorm
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device, exists, pair
from .vit import init_modules_like_jax


def masked_mean(t, mask, eps: float = 1e-5):
    """The mean over axis 1 of the rows of ``t`` where ``mask`` is true
    (reference vit_detpool.py:22-29); the plain mean without a mask."""
    if not exists(mask):
        return t.mean(dim=1)
    m = mask.bool()[..., None]
    return torch.where(m, t, 0.0).sum(dim=1) / m.sum(dim=1).to(t.dtype).clamp_min(eps)


class ViTDetPool(nn.Module):
    """reference vit_detpool.py:107 — same keyword constructor (the JAX
    ``mask_generator_variables`` aside: a port generator holds its own
    weights), with ``device``, ``dtype`` and ``generator`` as in
    ``models/vit.py`` (the class token and the position embedding normal
    with std 1e-2, as the JAX init)."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 use_cls_token: bool = True, channels: int = 3, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, mask_generator: Optional[Callable] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        self.patch_height, self.patch_width = pair(patch_size)
        if image_height % self.patch_height or image_width % self.patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_height // self.patch_height) * (image_width // self.patch_width)
        self.num_classes, self.use_cls_token = num_classes, use_cls_token
        # a tuple keeps a generator module out of this module's parameters and state_dict
        self._mask_generator = (mask_generator,)
        self.to_patch_embedding = PatchEmbedding((self.patch_height, self.patch_width),
                                                 channels * self.patch_height * self.patch_width, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(num_patches, dim, **kw))
        if use_cls_token:
            self.cls_token = nn.Parameter(torch.empty(dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, **kw),
                           FeedForward(dim, mlp_dim, dropout=dropout, **kw)])
            for _ in range(depth)
        )
        self.transformer.norm = LayerNorm(dim, **kw)
        self.mlp_head = nn.Linear(dim, num_classes, **kw) if num_classes > 0 else None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(std=1e-2, generator=generator)
        if self.use_cls_token:
            self.cls_token.normal_(std=1e-2, generator=generator)

    def token_mask(self, object_mask, height: int, width: int):
        """The (b, num_patches) boolean token mask of ``object_mask``: a (b,
        height, width) pixel mask max-pooled over each patch, else its rows
        flattened."""
        b = object_mask.shape[0]
        if tuple(object_mask.shape) == (b, height, width):
            if object_mask.dtype == torch.bool:
                object_mask = object_mask.to(torch.uint8)
            mask = reduce(object_mask, "b (h p1) (w p2) -> b (h w)", "max", p1=self.patch_height,
                          p2=self.patch_width)
        else:
            mask = object_mask.reshape(b, -1)
        return mask.bool()

    def forward(self, img, object_mask=None):
        batch, _, height, width = img.shape
        mask_generator = self._mask_generator[0]
        if object_mask is None and exists(mask_generator):
            with torch.no_grad():
                object_mask = mask_generator(img)
        tokens = self.to_patch_embedding(img)
        seq = tokens.shape[1]
        tokens = tokens + self.pos_embedding[:seq].to(tokens.dtype)
        if self.use_cls_token:
            tokens = torch.cat([self.cls_token.to(tokens.dtype).expand(batch, 1, -1), tokens], dim=1)
        tokens = self.dropout(tokens)

        mask = None
        if exists(object_mask):
            if object_mask.ndim not in (2, 3):
                raise ValueError(f"ViTDetPool: an object mask of {object_mask.ndim} dimensions, not 2 or 3")
            mask = self.token_mask(object_mask, height, width)
            if mask.shape != (batch, seq):
                raise ValueError(f"ViTDetPool: the object mask gives {tuple(mask.shape)} token flags for "
                                 f"{(batch, seq)} tokens")
            if self.use_cls_token:
                mask = F.pad(mask, (1, 0), value=True)
        key_mask = mask[:, None, None, :] if exists(mask) else None
        for attn, ff in self.transformer.layers:
            tokens = attn(tokens, mask=key_mask) + tokens
            tokens = ff(tokens) + tokens
        tokens = self.transformer.norm(tokens)
        if self.mlp_head is None:
            return tokens
        if self.use_cls_token:
            tokens = tokens[:, 1:]
            mask = mask[:, 1:] if exists(mask) else None
        return self.mlp_head(masked_mean(tokens, mask))
