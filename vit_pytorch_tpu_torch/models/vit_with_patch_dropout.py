"""Classic ViT with patch dropout (reference vit_with_patch_dropout.py:96-147),
port of ``vit_pytorch_tpu/models/vit_with_patch_dropout.py``.

Faithful quirks of the reference: the patch embedding is a bare Linear (no
LayerNorms), the position embedding is added to the patches before the
class token is put in front of them, the transformer has no final norm, and
the head is LayerNorm -> Linear.  In training :class:`~..nn.patch.PatchDropout`
keeps ``max(1, int(n * (1 - patch_dropout)))`` of the n patches, drawn from
the caller's ``generator`` (else from the global generator of the input's
device, which ``parallel/train.py::make_train_step`` seeds each step).

The layers are the port's :class:`~..nn.blocks.Transformer`: on the card, in
bf16, served (and trained at dropout 0) each layer is one whole-layer chain
of kernels; trained at dropout > 0 each attention call takes the
attention-block kernels with their in-kernel dropout, at the kept token
count.

The state_dict is the reference's (``to_patch_embedding.1``,
``pos_embedding`` (num_patches, dim), ``cls_token`` (1, 1, dim),
``transformer.layers.N.0|1``, ``mlp_head.0|1``):
``utils/convert.py::convert_vit_with_patch_dropout``,
``utils/from_jax.py::vit_with_patch_dropout_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import LayerNorm, Transformer
from ..nn.patch import PatchDropout, Patchify
from ..utils.helpers import default_device, pair
from .vit import init_modules_like_jax


class ViT(nn.Module):
    """reference vit_with_patch_dropout.py:96 — same keyword constructor,
    with ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/vit.py`` (the class token and the position embedding unit
    normal, as the JAX init)."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 pool: str = "cls", channels: int = 3, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, patch_dropout: float = 0.25, flash: Optional[bool] = None, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_height // patch_height) * (image_width // patch_width)
        self.pool = pool
        self.to_patch_embedding = nn.Sequential(Patchify(patch_height, patch_width),
                                                nn.Linear(channels * patch_height * patch_width, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(num_patches, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.patch_dropout = PatchDropout(patch_dropout)
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, dropout, final_norm=False, flash=flash,
                                       **kw)
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)

    def forward(self, img, generator: Optional[torch.Generator] = None):
        x = self.to_patch_embedding(img)
        x = self.patch_dropout(x + self.pos_embedding.to(x.dtype), generator)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = self.dropout(torch.cat([cls, x], dim=1))
        x = self.transformer(x)
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return self.mlp_head(x)
