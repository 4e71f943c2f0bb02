"""ViT for video tubelets (reference vit_3d.py:77-126), port of
``vit_pytorch_tpu/models/vit_3d.py``: ``models/vit_1d.py``'s body on
(pf, p1, p2) tubelets of a (b, c, frames, h, w) clip.

The state_dict is the reference's (``utils/convert.py::convert_vit_3d``,
``utils/from_jax.py::vit_3d_state_dict_from_jax``).  Past 208 tokens (a
16-frame 128 x 128 clip of 2 x 16 x 16 tubelets gives 513) the layers take
the module composite, as the JAX package's do past its kernels' bound.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.helpers import pair
from .vit_1d import PatchViT


class ViT(PatchViT):
    """reference vit_3d.py:77 — same keyword constructor, with ``flash``,
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, image_size, image_patch_size, frames: int, frame_patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int, pool: str = "cls", channels: int = 3,
                 dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0, flash: Optional[bool] = None,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        (image_height, image_width), (patch_height, patch_width) = pair(image_size), pair(image_patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if frames % frame_patch_size:
            raise ValueError("Frames must be divisible by the frame patch size")
        num_patches = (image_height // patch_height) * (image_width // patch_width) * (frames // frame_patch_size)
        super().__init__((frame_patch_size, patch_height, patch_width), num_patches, cls_shape=(1, 1, dim),
                         num_classes=num_classes, dim=dim, depth=depth, heads=heads, mlp_dim=mlp_dim, pool=pool,
                         channels=channels, dim_head=dim_head, dropout=dropout, emb_dropout=emb_dropout, flash=flash,
                         device=device, dtype=dtype, generator=generator)
