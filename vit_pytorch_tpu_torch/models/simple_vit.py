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
package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import SimpleTransformer
from ..nn.patch import PatchEmbedding
from ..nn.posemb import posemb_sincos_2d
from ..utils.helpers import default_device, pair
from .vit import init_modules_like_jax


class SimpleViT(nn.Module):
    """reference simple_vit.py:80 — same keyword constructor.  ``flash`` is
    the JAX ``SimpleViT``'s (``flash=False`` opts out of every kernel);
    ``device`` (the CUDA card unless it names another) and ``dtype`` place
    the parameters, ``generator`` seeds their initialisation (the JAX
    package's: unit LayerNorms, truncated lecun-normal Linear weights, zero
    biases)."""

    qk_norm = False  # the attention's qk-norm, on in models/simple_vit_with_qk_norm.py

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
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        device = default_device(device)
        kw = {"device": device, "dtype": dtype}
        patch_dim = channels * patch_height * patch_width
        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), patch_dim, dim, **kw)
        # the fixed table, a buffer outside the state_dict; the model's dtype
        # casts it as the JAX model casts it to the activations' dtype
        self.register_buffer(
            "pos_embedding",
            posemb_sincos_2d(image_height // patch_height, image_width // patch_width, dim, device=device),
            persistent=False,
        )
        self.transformer = SimpleTransformer(dim, depth, heads, dim_head, mlp_dim, qk_norm=self.qk_norm, flash=flash,
                                             **kw)
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
