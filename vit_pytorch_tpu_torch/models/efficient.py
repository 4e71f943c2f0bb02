"""The efficient-ViT shell, a ViT around a caller's transformer (reference
efficient.py:9-49), port of ``vit_pytorch_tpu/models/efficient.py``: the
LN -> Linear -> LN patch embedding, a cls token, a learned table, the
caller's ``transformer`` (any module ``x -> x`` on (b, n + 1, dim), for
example the port's ``nn/blocks.py::Transformer``, whose kernels it then
runs), and an LN -> Linear head.

The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``pos_embedding``, ``cls_token``, ``transformer.*`` the caller's,
``mlp_head.0|1``): ``utils/convert.py::convert_efficient_vit``,
``utils/from_jax.py::efficient_vit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import LayerNorm
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device, pair
from .vit import init_modules_like_jax


class ViT(nn.Module):
    """reference efficient.py:9 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py``; ``generator``
    initialises the shell's own parameters (the caller's transformer keeps
    its own)."""

    def __init__(self, *, image_size, patch_size: int, num_classes: int, dim: int, transformer: nn.Module,
                 pool: str = "cls", channels: int = 3, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        if image_height % patch_size or image_width % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        self.pool, self.dim, self.num_classes = pool, dim, num_classes
        num_patches = (image_height // patch_size) * (image_width // patch_size)
        self.to_patch_embedding = PatchEmbedding((patch_size, patch_size), channels * patch_size**2, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)
        self.transformer = transformer

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in (self.to_patch_embedding, self.mlp_head):
            init_modules_like_jax(m, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)

    def embed(self, img):
        """Patchify, embed, the cls token and the table (efficient.py:39-44)."""
        x = self.to_patch_embedding(img)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        return x + self.pos_embedding[:, : n + 1].to(x.dtype)

    def head(self, x):
        return self.mlp_head(x.mean(dim=1) if self.pool == "mean" else x[:, 0])

    def forward(self, img):
        return self.head(self.transformer(self.embed(img)))
