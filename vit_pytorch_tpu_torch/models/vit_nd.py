"""ViT-ND, a 1- to 7-dimensional ViT (reference vit_nd.py:89-189), port of
``vit_pytorch_tpu/models/vit_nd.py``: the einops patchify pattern built
from ``ndim`` (:func:`nd_patterns`), a Linear -> LN embedding, a cls token,
a learned position table, the ``Transformer`` with its final norm, and a
bare Linear head on the cls token or the mean of the other tokens.

The state_dict is the reference's (``to_patch_embedding.1|2``,
``cls_token``, ``pos_embedding``, ``transformer.*``, ``mlp_head``): see
``utils/convert.py::convert_vit_nd`` and
``utils/from_jax.py::vit_nd_state_dict_from_jax``.  At 1,025 tokens (1,024
patches and the cls token) each attention call on the card in bf16 takes
the flash kernels of ``ops/flash_attention.py``, as the JAX dispatcher
sends m >= 1024 to its flash kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from einops import rearrange
from torch import nn

from ..nn.blocks import LayerNorm, Transformer
from ..utils.helpers import cast_tuple, default_device
from .vit import init_modules_like_jax


def nd_patterns(ndim: int) -> str:
    """The einops pattern from (b, c, d_1 p_1, ..., d_k p_k) to (b, d_1 ...
    d_k, p_1 ... p_k c) (reference vit_nd.py:128-139)."""
    dim_names = "fghijkl"[:ndim]
    input_dims = [f"({d} p{i})" for i, d in enumerate(dim_names)]
    patch_dims = [f"p{i}" for i in range(ndim)]
    return f"b c {' '.join(input_dims)} -> b ({' '.join(dim_names)}) ({' '.join(patch_dims)} c)"


def nd_grid(ndim: int, input_shape, patch_size) -> Tuple[tuple, tuple]:
    """The patch size and the grid of patches, each ``ndim`` long, with the
    reference's checks."""
    if not 1 <= ndim <= 7:
        raise ValueError("ndim must be between 1 and 7")
    input_shape, patch_size = cast_tuple(input_shape, ndim), cast_tuple(patch_size, ndim)
    if any(i % p for i, p in zip(input_shape, patch_size)):
        raise ValueError(f"input shape {input_shape} must be divisible by the patch size {patch_size}")
    return patch_size, tuple(i // p for i, p in zip(input_shape, patch_size))


class NDPatchify(nn.Module):
    """(b, c, *input_shape) -> (b, patches, patch_dim) by
    :func:`nd_patterns`."""

    def __init__(self, patch_size: tuple):
        super().__init__()
        self.pattern = nd_patterns(len(patch_size))
        self.sizes = {f"p{i}": p for i, p in enumerate(patch_size)}

    def forward(self, x):
        return rearrange(x, self.pattern, **self.sizes)


class ViTND(nn.Module):
    """reference vit_nd.py:89 — same keyword constructor, with ``flash``,
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, ndim: int, input_shape: Union[int, Tuple[int, ...]], patch_size: Union[int, Tuple[int, ...]],
                 num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int, pool: str = "cls",
                 channels: int = 3, dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 flash: Optional[bool] = None, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        patch, grid = nd_grid(ndim, input_shape, patch_size)
        self.pool, self.dim = pool, dim
        self.to_patch_embedding = nn.Sequential(
            NDPatchify(patch), nn.Linear(channels * math.prod(patch), dim, **kw), LayerNorm(dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, math.prod(grid) + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, dropout, flash=flash, **kw)
        self.mlp_head = nn.Linear(dim, num_classes, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)

    def forward(self, x):
        x = self.to_patch_embedding(x)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = self.transformer(self.dropout(x + self.pos_embedding[:, : n + 1].to(x.dtype)))
        # the mean leaves the cls token out (reference vit_nd.py:168)
        return self.mlp_head(x[:, 1:].mean(dim=1) if self.pool == "mean" else x[:, 0])
