"""SimpleViT with explicit flash attention (reference
simple_flash_attn_vit.py:139-176), port of
``vit_pytorch_tpu/models/simple_flash_attn_vit.py``.

The reference picks torch SDPA backends per GPU; the variant's architecture
differs from SimpleViT in two places, kept here: the transformer ends
without a LayerNorm, and the head is ``Sequential(LayerNorm, Linear)`` after
the mean pool (``linear_head.0|1``, ``utils/convert.py::
convert_simple_flash_attn_vit``).  ``use_flash`` maps to ``flash`` as the
JAX model maps it (:61-63): True leaves the kernels on, False opts out of
every kernel; an explicit ``flash`` wins.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import LN_EPS
from .simple_vit import SimpleViTBase, image_grid


def flash_of(use_flash: bool, flash: Optional[bool]) -> Optional[bool]:
    """The JAX variants' ``flash``: ``flash`` when given, else None (the
    kernels) for ``use_flash`` and False (none) without."""
    return flash if flash is not None else (None if use_flash else False)


class SimpleViT(SimpleViTBase):
    """reference simple_flash_attn_vit.py:139 — same keyword constructor
    (``use_flash``), with ``flash``, ``device``, ``dtype`` and
    ``generator`` as in ``models/simple_vit.py``."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 channels: int = 3, dim_head: int = 64, use_flash: bool = True, flash: Optional[bool] = None,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__(*image_grid(image_size, patch_size), channels=channels, num_classes=num_classes, dim=dim,
                         depth=depth, heads=heads, mlp_dim=mlp_dim, dim_head=dim_head,
                         flash=flash_of(use_flash, flash), final_norm=False, device=device, dtype=dtype,
                         generator=generator)

    def _head(self, dim: int, num_classes: int, **kw) -> nn.Module:
        return nn.Sequential(nn.LayerNorm(dim, eps=LN_EPS, **kw), nn.Linear(dim, num_classes, **kw))
