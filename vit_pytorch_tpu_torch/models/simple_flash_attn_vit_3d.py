"""SimpleViT-3D with explicit flash attention (reference
simple_flash_attn_vit_3d.py:136-171), port of
``vit_pytorch_tpu/models/simple_flash_attn_vit_3d.py``: the 3-D SimpleViT
whose transformer ends without a LayerNorm, a plain Linear head after the
mean pool (``utils/convert.py::convert_simple_flash_attn_vit_3d``), and
``use_flash_attn`` mapped to ``flash`` as in the 2-D variant.
"""

from __future__ import annotations

from typing import Optional

import torch

from .simple_flash_attn_vit import flash_of
from .simple_vit import SimpleViTBase
from .simple_vit_3d import video_grid


class SimpleViT(SimpleViTBase):
    """reference simple_flash_attn_vit_3d.py:136 — same keyword constructor
    (``use_flash_attn``), with ``flash``, ``device``, ``dtype`` and
    ``generator`` as in ``models/simple_vit.py``."""

    def __init__(self, *, image_size, image_patch_size, frames: int, frame_patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int, channels: int = 3, dim_head: int = 64,
                 use_flash_attn: bool = True, flash: Optional[bool] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(*video_grid(image_size, image_patch_size, frames, frame_patch_size), channels=channels,
                         num_classes=num_classes, dim=dim, depth=depth, heads=heads, mlp_dim=mlp_dim,
                         dim_head=dim_head, flash=flash_of(use_flash_attn, flash), final_norm=False, device=device,
                         dtype=dtype, generator=generator)
