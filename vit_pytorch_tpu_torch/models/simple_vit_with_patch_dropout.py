"""SimpleViT with patch dropout (reference
simple_vit_with_patch_dropout.py:103-150), port of
``vit_pytorch_tpu/models/simple_vit_with_patch_dropout.py``: in training a
random ``1 - patch_dropout`` of the tokens (``nn/patch.py::PatchDropout``)
goes through the transformer, after the sincos table is added.

The state_dict is SimpleViT's (``utils/convert.py::
convert_simple_vit_with_patch_dropout``).  On the card in bf16 every
attention call runs the attention-block kernels, at the kept token count
in training.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn.patch import PatchDropout
from .simple_vit import SimpleViT as _SimpleViT


class SimpleViT(_SimpleViT):
    """reference simple_vit_with_patch_dropout.py:103 — same constructor,
    with ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/simple_vit.py``.  A call's ``generator`` draws the kept tokens
    (:class:`~..nn.patch.PatchDropout`)."""

    def __init__(self, *, patch_dropout: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.patch_drop = PatchDropout(patch_dropout)

    def forward(self, img, generator: Optional[torch.Generator] = None):
        x = self.patch_drop(self.embed(img), generator)
        return self.linear_head(self.pool(self.transformer(x)))
