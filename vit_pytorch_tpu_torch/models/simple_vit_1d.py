"""SimpleViT for 1-D sequences (reference simple_vit_1d.py:78-110), port of
``vit_pytorch_tpu/models/simple_vit_1d.py``: patches of ``patch_size``
steps, the 1-D sincos table, the SimpleViT body.

The state_dict is SimpleViT's (``utils/convert.py::convert_simple_vit_1d``,
``utils/from_jax.py::simple_vit_state_dict_from_jax``).  On the card in bf16
every attention call runs the attention-block kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from .simple_vit import SimpleViTBase


class SimpleViT(SimpleViTBase):
    """reference simple_vit_1d.py:78 — same keyword constructor, with
    ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/simple_vit.py``.  Input (b, channels, seq_len)."""

    def __init__(self, *, seq_len: int, patch_size: int, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, channels: int = 3, dim_head: int = 64, flash: Optional[bool] = None, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        if seq_len % patch_size:
            raise ValueError("seq_len must be divisible by the patch size.")
        super().__init__((patch_size,), (seq_len // patch_size,), channels=channels, num_classes=num_classes,
                         dim=dim, depth=depth, heads=heads, mlp_dim=mlp_dim, dim_head=dim_head, flash=flash,
                         device=device, dtype=dtype, generator=generator)
