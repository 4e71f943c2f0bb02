"""SimpleViT for video tubelets (reference simple_vit_3d.py:93-128), port of
``vit_pytorch_tpu/models/simple_vit_3d.py``: (frame, height, width) patches,
the 3-D sincos table, the SimpleViT body.

The state_dict is SimpleViT's (``utils/convert.py::convert_simple_vit_3d``,
``utils/from_jax.py::simple_vit_state_dict_from_jax``).  On the card in bf16
an attention call runs the attention-block kernels where they take the
token count (n <= 208); longer clips take the composite, as the JAX
dispatcher sends them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .simple_vit import SimpleViTBase, image_grid


def video_grid(image_size, image_patch_size, frames: int, frame_patch_size: int):
    """The (pf, p1, p2) patch and the (f, h, w) grid of a clip."""
    patch, grid = image_grid(image_size, image_patch_size)
    if frames % frame_patch_size:
        raise ValueError("Frames must be divisible by the frame patch size.")
    return (frame_patch_size, *patch), (frames // frame_patch_size, *grid)


class SimpleViT(SimpleViTBase):
    """reference simple_vit_3d.py:93 — same keyword constructor, with
    ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/simple_vit.py``.  Input (b, channels, frames, height, width)."""

    def __init__(self, *, image_size, image_patch_size, frames: int, frame_patch_size: int, num_classes: int,
                 dim: int, depth: int, heads: int, mlp_dim: int, channels: int = 3, dim_head: int = 64,
                 flash: Optional[bool] = None, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__(*video_grid(image_size, image_patch_size, frames, frame_patch_size), channels=channels,
                         num_classes=num_classes, dim=dim, depth=depth, heads=heads, mlp_dim=mlp_dim,
                         dim_head=dim_head, flash=flash, device=device, dtype=dtype, generator=generator)
