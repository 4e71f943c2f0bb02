"""Canonical ViT (reference vit.py:85-139), port of
``vit_pytorch_tpu/models/vit.py``.

Same keyword constructor as the reference and the JAX package.  Parameters
keep the reference ``state_dict`` layout (``to_patch_embedding.1/2/3``,
``cls_token``, ``pos_embedding``, ``transformer.*``, ``mlp_head``) and the JAX
package's shapes (``cls_token`` (num_cls_tokens, dim), ``pos_embedding``
(num_patches + num_cls_tokens, dim)), so ``utils/convert.py::convert_vit``
maps ``state_dict()`` onto the JAX params unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn.blocks import RMSNorm, Transformer
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device, pair

# flax's truncated-normal variance_scaling divides by the std of a standard
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_modules_like_jax(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's initialisation of every ``nn.Linear``,
    ``nn.Conv1d``, ``nn.Conv2d``, LayerNorm and ``RMSNorm`` in ``model``: truncated
    lecun-normal weights (fan-in: the inputs of one output) and zero biases,
    LayerNorm ones/zeros, RMSNorm gamma at its ``gamma_init``."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, RMSNorm):
            m.gamma.fill_(m.gamma_init)


class ViT(nn.Module):
    """reference vit.py:85 — same keyword constructor.

    ``generator`` seeds the initialisation (the JAX package's: LayerNorm
    ones/zeros, truncated lecun-normal Linear weights, zero biases, unit
    normal cls token and position embedding); ``device``/``dtype`` place the
    parameters, on the CUDA card unless ``device`` names another
    (``utils/helpers.py::default_device``).  ``flash`` and ``remat`` are the
    JAX ``ViT``'s (models/vit.py:43-44), passed to the :class:`Transformer`:
    ``flash=False`` opts out of every kernel, ``remat`` recomputes the
    layers in the backward.  ``model.train()`` stands for the JAX
    ``train=True``.

    The encoder protocol of the JAX ``ViT`` (models/vit.py:8-15), which
    ``ssl/mae.py::MAE`` reads: :meth:`patchify` (raw patches),
    :attr:`patch_embedding` (their embedding, ``to_patch_embedding[1:]``),
    ``pos_embedding``, ``transformer``, ``pool``, ``num_cls_tokens``, ``dim``,
    ``patch_size``, ``image_size`` and ``channels``.
    """

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
        pool: str = "cls",
        channels: int = 3,
        dim_head: int = 64,
        dropout: float = 0.0,
        emb_dropout: float = 0.0,
        flash: Optional[bool] = None,
        remat: bool = False,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        self.pool = pool
        self.num_classes = num_classes
        self.dim, self.image_size, self.patch_size, self.channels = dim, image_size, patch_size, channels
        self.num_patches = (image_height // patch_height) * (image_width // patch_width)
        self.num_cls_tokens = 1 if pool == "cls" else 0
        patch_dim = channels * patch_height * patch_width

        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), patch_dim, dim, **kw)
        self.cls_token = nn.Parameter(torch.empty(self.num_cls_tokens, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(self.num_patches + self.num_cls_tokens, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, dropout, flash=flash, remat=remat, **kw)
        self.mlp_head = nn.Linear(dim, num_classes, **kw) if num_classes > 0 else None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.cls_token.normal_(generator=generator)
        self.pos_embedding.normal_(generator=generator)

    def patchify(self, img):
        """(b, c, h, w) images -> (b, n, patch_dim) raw patches."""
        return self.to_patch_embedding[0](img)

    @property
    def patch_embedding(self) -> nn.Sequential:
        """LN -> Linear -> LN on raw patches: ``to_patch_embedding[1:]``,
        the same modules."""
        return nn.Sequential(*list(self.to_patch_embedding.children())[1:])

    def embed(self, img, *, dropout: bool = True):
        """Patchify + embed + cls + pos emb + dropout (vit.py:120-128).
        ``dropout=False`` leaves out the embedding dropout (the JAX
        ``embed(dropout=False)``): ``ssl/distill.py::DistillableViT``
        appends its distillation token first and drops the whole sequence
        out itself (reference distill.py:33-34, 64-66)."""
        x = self.to_patch_embedding(img)
        b = x.shape[0]
        cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embedding[: x.shape[1]].to(x.dtype)
        return self.dropout(x) if dropout else x

    def forward(self, img):
        x = self.transformer(self.embed(img))
        if self.mlp_head is None:
            return x
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return self.mlp_head(x)
