"""Patch embedding, port of ``vit_pytorch_tpu/nn/patch.py``.

The canonical form is
``Rearrange('b c (h p1) (w p2) -> b (h w) (p1 p2 c)') -> LN -> Linear -> LN``
(reference vit.py:99-104).  It stays plain PyTorch: the JAX package leaves it
to XLA outside any kernel too.
"""

from __future__ import annotations

import torch
from einops import rearrange
from torch import nn

from .blocks import LN_EPS


def patchify_2d(img: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """(b, c, h*p1, w*p2) -> (b, h*w, p1*p2*c), channel-last patch flattening
    matching the reference's einops pattern (vit.py:100)."""
    return rearrange(img, "b c (h p1) (w p2) -> b (h w) (p1 p2 c)", p1=p1, p2=p2)


class Patchify2d(nn.Module):
    def __init__(self, p1: int, p2: int):
        super().__init__()
        self.p1, self.p2 = p1, p2

    def forward(self, img):
        return patchify_2d(img, self.p1, self.p2)


class PatchEmbedding(nn.Sequential):
    """patchify -> LN -> Linear -> LN (reference vit.py:99-104), indexed as
    the reference's ``to_patch_embedding`` so that its ``state_dict`` keys
    are ``1.*``, ``2.*``, ``3.*``.  ``self[1:]`` embeds raw patches, as the
    JAX ``PatchEmbedding`` does (reference mae.py:28-31 slices the same way).
    """

    def __init__(self, patch_size, patch_dim: int, dim: int, *, device=None, dtype=None):
        kw = {"device": device, "dtype": dtype}
        super().__init__(
            Patchify2d(*patch_size),
            nn.LayerNorm(patch_dim, eps=LN_EPS, **kw),
            nn.Linear(patch_dim, dim, **kw),
            nn.LayerNorm(dim, eps=LN_EPS, **kw),
        )
