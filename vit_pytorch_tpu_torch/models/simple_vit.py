"""SimpleViT (reference simple_vit.py:80-120), port of
``vit_pytorch_tpu/models/simple_vit.py``: ViT without dropout or cls token,
a fixed 2-D sincos position table, mean pooling and a linear head.

Same keyword constructor as the reference and the JAX package.  Parameters
keep the reference's ``state_dict`` layout (``to_patch_embedding.1/2/3``,
``transformer.layers.N.0.norm|to_qkv|to_out``,
``transformer.layers.N.1.net.0|1|3``, ``transformer.norm``,
``linear_head``), so ``utils/convert.py::convert_simple_vit`` maps
``state_dict()`` onto the JAX params and
``utils/from_jax.py::simple_vit_state_dict_from_jax`` back.  On the card in
bf16 every attention call runs the attention-block kernels (4 launches a
layer forward, 6 backward); the FF runs as plain PyTorch, as in the JAX
package.  :class:`SimpleViTBase` is the body the 1-D, 3-D and other
variants of the family share.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn.blocks import SimpleTransformer
from ..nn.patch import PatchEmbedding
from ..nn.posemb import posemb_sincos_1d, posemb_sincos_2d, posemb_sincos_3d
from ..utils.helpers import default_device, pair, table_device
from .vit import init_modules_like_jax

_POSEMB = {1: posemb_sincos_1d, 2: posemb_sincos_2d, 3: posemb_sincos_3d}


class SimpleViTBase(nn.Module):
    """The SimpleViT body on ``patch`` ((p,), (p1, p2) or (pf, p1, p2)) and
    its ``grid`` of patches: the patch embedding, the fixed sincos table of
    the grid's rank (a buffer outside the state_dict; the model's dtype
    casts it as the JAX model casts it to the activations' dtype), the
    :class:`SimpleTransformer` (``final_norm`` as there), a head, and the
    JAX package's initialisation from ``generator`` (unit LayerNorms,
    truncated lecun-normal Linear weights, zero biases).  ``device`` is the
    CUDA card unless it names another.  ``transformer``: a variant's own
    transformer in place of the :class:`SimpleTransformer`, built on
    ``default_device(device)``."""

    qk_norm = False  # the attention's qk-norm, on in models/simple_vit_with_qk_norm.py

    def __init__(self, patch, grid, *, channels: int, num_classes: int, dim: int, depth: int, heads: int,
                 mlp_dim: int, dim_head: int, flash: Optional[bool], final_norm: bool = True,
                 transformer: Optional[nn.Module] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = default_device(device)
        kw = {"device": device, "dtype": dtype}
        self.to_patch_embedding = PatchEmbedding(patch, channels * math.prod(patch), dim, **kw)
        self.register_buffer("pos_embedding", _POSEMB[len(grid)](*grid, dim, device=table_device(device)),
                             persistent=False)
        self.transformer = transformer if transformer is not None else SimpleTransformer(
            dim, depth, heads, dim_head, mlp_dim, qk_norm=self.qk_norm, final_norm=final_norm, flash=flash, **kw)
        self.linear_head = self._head(dim, num_classes, **kw)
        self.reset_parameters(generator)

    def _head(self, dim: int, num_classes: int, **kw) -> nn.Module:
        return nn.Linear(dim, num_classes, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)

    def embed(self, img):
        """Patch embedding plus the sincos table (simple_vit.py:113-115)."""
        x = self.to_patch_embedding(img)
        return x + self.pos_embedding.to(x.dtype)

    def pool(self, x):
        return x.mean(dim=1)

    def forward(self, img):
        return self.linear_head(self.pool(self.transformer(self.embed(img))))


def image_grid(image_size, patch_size):
    """The (p1, p2) patch and the (h, w) grid of patches of an image."""
    (image_height, image_width), patch = pair(image_size), tuple(pair(patch_size))
    if image_height % patch[0] or image_width % patch[1]:
        raise ValueError("Image dimensions must be divisible by the patch size.")
    return patch, (image_height // patch[0], image_width // patch[1])


class SimpleViT(SimpleViTBase):
    """reference simple_vit.py:80 — same keyword constructor.  ``flash`` is
    the JAX ``SimpleViT``'s (``flash=False`` opts out of every kernel);
    ``device``, ``dtype`` and ``generator`` as in :class:`SimpleViTBase`."""

    def __init__(
        self,
        *,
        image_size,
        patch_size,
        num_classes: int,
        dim: int,
        depth: int,
        heads: int,
        mlp_dim: int,
        channels: int = 3,
        dim_head: int = 64,
        flash: Optional[bool] = None,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(*image_grid(image_size, patch_size), channels=channels, num_classes=num_classes, dim=dim,
                         depth=depth, heads=heads, mlp_dim=mlp_dim, dim_head=dim_head, flash=flash, device=device,
                         dtype=dtype, generator=generator)
