"""SimpleUViT: U-Net-style skips and register tokens (reference
simple_uvit.py:106-158), port of ``vit_pytorch_tpu/models/simple_uvit.py``.

The input of each layer of the first half is kept on a stack; each layer of
the second half pops one, concatenates it before its own input and projects
back to ``dim`` (``combine_skip``, reference :74-97), then runs its attention
and FF with the residual added outside each call, as the JAX loop adds it.
On the card, in bf16, every attention call takes the attention-block kernels
(the patches and the registers, n = num_patches + num_register_tokens <=
208), its projection out bias-free.  The sincos table is a buffer outside
the state_dict, cast at use.

The state_dict is the reference's: ``transformer.layers.N`` =
[``combine_skip`` Linear (second half only, else None), Attention (a bare
``to_out``), the FF Sequential ``0|1|3``], ``transformer.norm``,
``register_tokens``, ``linear_head``:
``utils/convert.py::convert_simple_uvit``,
``utils/from_jax.py::simple_uvit_state_dict_from_jax``.
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


class SimpleUViT(nn.Module):
    """reference simple_uvit.py:106 — same keyword constructor, with
    ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/vit.py`` (the register tokens unit normal)."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 num_register_tokens: int = 4, channels: int = 3, dim_head: int = 64, flash: Optional[bool] = None,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        self.depth = depth
        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), channels * patch_height * patch_width,
                                                 dim, **kw)
        pos = posemb_sincos_2d(image_height // patch_height, image_width // patch_width, dim,
                               device=table_device(kw["device"]))
        self.register_buffer("pos_embedding", pos, persistent=False)
        self.register_tokens = nn.Parameter(torch.empty(num_register_tokens, dim, **kw))
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            nn.ModuleList([
                nn.Linear(dim * 2, dim, **kw) if ind + 1 >= depth / 2 + 1 else None,
                Attention(dim, heads=heads, dim_head=dim_head, out_bias=False, project_out=True, simple=True,
                          flash=flash, **kw),
                FeedForward(dim, mlp_dim, simple=True, **kw).net,
            ])
            for ind in range(depth)
        )
        self.transformer.norm = LayerNorm(dim, **kw)
        self.linear_head = nn.Linear(dim, num_classes, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.register_tokens.normal_(generator=generator)

    def forward(self, img):
        x = self.to_patch_embedding(img)
        x = x + self.pos_embedding.to(x.dtype)
        n = x.shape[1]
        regs = self.register_tokens.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([x, regs], dim=1)
        skips = []
        for ind, (combine_skip, attn, ff) in enumerate(self.transformer.layers):
            if ind + 1 <= self.depth / 2:
                skips.append(x)
            if combine_skip is not None:
                x = combine_skip(torch.cat([skips.pop(), x], dim=-1))
            x = attn(x) + x
            x = ff(x) + x
        assert not skips
        x = self.transformer.norm(x)[:, :n]  # the registers left out
        return self.linear_head(x.mean(dim=1))
