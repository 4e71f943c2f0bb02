"""JumboViT: a jumbo class token split into k tokens for the attention and
fused again for a wide FF of its own every layer (reference jumbo_vit.py:
70-184), port of ``vit_pytorch_tpu/models/jumbo_vit.py``.

Two faithful quirks of the reference, which the JAX package keeps so that
converted weights line up: its FeedForward factory takes a multiplier, and
the model hands it ``mlp_dim`` for the patches (jumbo_vit.py:150, the
signature at :34), so the patch FF's hidden width is ``dim * mlp_dim``; and
``int(jumbo_cls_dim * jumbo_ff_mult)`` for the jumbo FF (:120-124), whose
hidden width is ``jumbo_cls_dim * int(jumbo_cls_dim * jumbo_ff_mult)``, one
module shared by every layer.  Both grow with the square of the width: at
dim 1024 and mlp_dim 2048 the patch FF alone holds 2 x 1024 x 2,097,152
weights a layer, so the model has no full-width configuration, here or in
the reference.

On the card, in bf16, each attention call (the jumbo tokens and the patches,
``num_jumbo_cls * jumbo_cls_k + num_patches`` tokens) takes the
attention-block kernels, its projection out bias-free and the residual
added outside, as the JAX loop adds it; the FFs are plain modules.  The
sincos table is a buffer outside the state_dict.

The state_dict is the reference's (``jumbo_cls_token``,
``to_patch_embedding.1|2|3``, ``layers.N.0`` (a bare ``to_out``), the FF
Sequential ``layers.N.1.0|1|3``, ``jumbo_ff.1.0|1|3``, ``norm``,
``linear_head``): ``utils/convert.py::convert_jumbo_vit``,
``utils/from_jax.py::jumbo_vit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import Attention, FeedForward, LayerNorm
from ..nn.patch import PatchEmbedding
from ..nn.posemb import posemb_sincos_2d
from ..utils.helpers import default_device, pair, table_device
from .vit import init_modules_like_jax


class JumboViT(nn.Module):
    """reference jumbo_vit.py:70 — same keyword constructor, with ``flash``,
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py`` (the
    jumbo class token at zero, as the JAX init)."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 num_jumbo_cls: int = 1, jumbo_cls_k: int = 6, jumbo_ff_mult: int = 2, channels: int = 3,
                 dim_head: int = 64, flash: Optional[bool] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        self.num_jumbo_cls, self.jumbo_cls_dim = num_jumbo_cls, dim * jumbo_cls_k
        self.num_jumbo_tokens = num_jumbo_cls * jumbo_cls_k
        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), channels * patch_height * patch_width,
                                                 dim, **kw)
        pos = posemb_sincos_2d(image_height // patch_height, image_width // patch_width, dim,
                               device=table_device(kw["device"]))
        self.register_buffer("pos_embedding", pos, persistent=False)
        self.jumbo_cls_token = nn.Parameter(torch.empty(num_jumbo_cls, self.jumbo_cls_dim, **kw))
        self.layers = nn.ModuleList(
            nn.ModuleList([
                Attention(dim, heads=heads, dim_head=dim_head, out_bias=False, project_out=True, simple=True,
                          flash=flash, **kw),
                FeedForward(dim, int(dim * mlp_dim), simple=True, **kw).net,
            ])
            for _ in range(depth)
        )
        jumbo_hidden = self.jumbo_cls_dim * int(self.jumbo_cls_dim * jumbo_ff_mult)
        # the reference's Residual keeps the FF at index 1 (jumbo_vit.py:119-124)
        self.jumbo_ff = nn.Sequential(nn.Identity(), FeedForward(self.jumbo_cls_dim, jumbo_hidden, simple=True,
                                                                 **kw).net)
        self.norm = LayerNorm(dim, **kw)
        self.linear_head = nn.Linear(dim, num_classes, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.jumbo_cls_token.zero_()

    def forward(self, img):
        x = self.to_patch_embedding(img)
        b, nj = x.shape[0], self.num_jumbo_tokens
        x = x + self.pos_embedding.to(x.dtype)
        jumbo = self.jumbo_cls_token.to(x.dtype).expand(b, -1, -1).reshape(b, nj, -1)
        x = torch.cat([jumbo, x], dim=1)
        for index, (attn, ff) in enumerate(self.layers):
            x = attn(x) + x
            jumbo, patches = x[:, :nj], x[:, nj:]
            patches = ff(patches) + patches
            fused = self.jumbo_ff[1](jumbo.reshape(b, self.num_jumbo_cls, self.jumbo_cls_dim))
            jumbo = jumbo + fused.reshape(b, nj, -1)
            if index < len(self.layers) - 1:
                x = torch.cat([jumbo, patches], dim=1)
        return self.linear_head(self.norm(jumbo.mean(dim=1)))
