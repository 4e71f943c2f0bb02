"""SimpleViT with register tokens (reference
simple_vit_with_register_tokens.py:85-134, "Vision Transformers Need
Registers"), port of ``vit_pytorch_tpu/models/simple_vit_with_register_tokens.py``.

The registers, a learned (num_register_tokens, dim) table initialised from a
unit normal, are appended after the patch tokens and stripped before the mean
pool; everything else is ``models/simple_vit.py``, so on the card every
attention call runs the attention-block kernels at n = patches + registers.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .simple_vit import SimpleViT as _SimpleViT


class SimpleViT(_SimpleViT):
    """reference simple_vit_with_register_tokens.py:85 — same constructor,
    with ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/simple_vit.py``."""

    def __init__(self, *, dim: int, num_register_tokens: int = 4, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__(dim=dim, device=device, dtype=dtype, generator=generator, **kwargs)
        self.register_tokens = nn.Parameter(
            torch.empty(num_register_tokens, dim, device=next(self.to_patch_embedding.parameters()).device,
                        dtype=dtype))
        self.register_tokens.data.normal_(generator=generator)

    def forward(self, img):
        x = self.embed(img)
        n = x.shape[1]
        r = self.register_tokens.to(x.dtype).expand(x.shape[0], -1, -1)
        x = self.transformer(torch.cat([x, r], dim=1))
        return self.linear_head(self.pool(x[:, :n]))
