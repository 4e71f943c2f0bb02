"""T2T-ViT, the token-to-token stem (reference t2t.py:26-80), port of
``vit_pytorch_tpu/models/t2t.py``.

The stem iterates: tokens back to an image (but first), an overlapping
unfold (``nn.Unfold``, channel slowest, as the JAX ``nn/patch.py::
unfold_2d``), and a one-head depth-1 ``Transformer`` of the unfolded width
(but last), each stage multiplying the width by kernel_size**2
(t2t.py:35-49); a Linear projects the last stage's tokens, a cls token and
a learned table join them, and the main transformer (a ``Transformer`` of
the constructor's widths, or the caller's module) runs on them.  The stem
transformers' attention is one head of their whole width, so it has no
projection out and the kernels refuse it (their widths are 147 and 1,323 on
3-channel images); the main transformer takes the whole-layer kernels on
the card in bf16 (197 tokens at 224 x 224), or the attention-block kernels
in training with dropout.

The state_dict is the reference's (``to_patch_embedding.{3, 7}`` the stem
transformers, ``to_patch_embedding.12`` the projection, ``pos_embedding``,
``cls_token``, ``transformer.*``, ``mlp_head``): ``utils/convert.py::
convert_t2t``, ``utils/from_jax.py::t2t_state_dict_from_jax``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.blocks import Transformer
from ..utils.helpers import default_device
from .vit import init_modules_like_jax


def conv_output_size(image_size, kernel_size, stride, padding):
    """reference t2t.py:13-14."""
    return int(((image_size - kernel_size + (2 * padding)) / stride) + 1)


class RearrangeImage(nn.Module):
    """(b, n, c) tokens -> (b, c, sqrt n, sqrt n) (reference t2t.py:20-22)."""

    def forward(self, x):
        b, n, c = x.shape
        side = int(math.sqrt(n))
        return x.transpose(1, 2).reshape(b, c, side, side)


class Transpose(nn.Module):
    """(b, c, n) -> (b, n, c)."""

    def forward(self, x):
        return x.transpose(1, 2)


class T2TViT(nn.Module):
    """reference t2t.py:26 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py``.  ``transformer``: a
    module ``x -> x`` on (b, n + 1, dim) in place of the built-in one (the
    reference's external transformer), on the caller's device."""

    def __init__(self, *, image_size: int, num_classes: int, dim: int, depth: Optional[int] = None,
                 heads: Optional[int] = None, mlp_dim: Optional[int] = None, pool: str = "cls", channels: int = 3,
                 dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 transformer: Optional[nn.Module] = None,
                 t2t_layers: Tuple[Tuple[int, int], ...] = ((7, 4), (3, 2), (3, 2)), device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        self.pool, self.dim, self.num_classes = pool, dim, num_classes
        layers, layer_dim, output_image_size = [], channels, image_size
        for i, (kernel_size, stride) in enumerate(t2t_layers):
            layer_dim *= kernel_size**2
            is_first, is_last = i == 0, i == len(t2t_layers) - 1
            output_image_size = conv_output_size(output_image_size, kernel_size, stride, stride // 2)
            layers += [
                nn.Identity() if is_first else RearrangeImage(),
                nn.Unfold(kernel_size=kernel_size, stride=stride, padding=stride // 2),
                Transpose(),
                nn.Identity() if is_last else Transformer(layer_dim, 1, 1, layer_dim, layer_dim, dropout, **kw),
            ]
        layers.append(nn.Linear(layer_dim, dim, **kw))
        self.to_patch_embedding = nn.Sequential(*layers)
        self.pos_embedding = nn.Parameter(torch.empty(1, output_image_size**2 + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.external_transformer = transformer is not None
        if transformer is None:
            if depth is None or heads is None or mlp_dim is None:
                raise ValueError("depth, heads and mlp_dim must be given without a transformer")
            transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, dropout, **kw)
        self.transformer = transformer
        self.mlp_head = nn.Linear(dim, num_classes, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The JAX package's initialisation of the stem, the projection, the
        head, the cls token and the table, and of the built-in transformer
        (a caller's transformer keeps its own)."""
        for m in (self.to_patch_embedding, self.mlp_head) + (() if self.external_transformer else (self.transformer,)):
            init_modules_like_jax(m, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)

    def embed(self, img, *, dropout: bool = True):
        """The stem, the projection, the cls token and the table
        (t2t.py:35-63); ``dropout=False`` leaves out the embedding dropout
        (the JAX ``embed(dropout=False)``, for the distillable model, which
        appends its token first)."""
        x = self.to_patch_embedding(img)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embedding[:, : n + 1].to(x.dtype)
        return self.dropout(x) if dropout else x

    def trunk(self, x):
        """The main transformer (t2t.py:57)."""
        return self.transformer(x)

    def head(self, x):
        return self.mlp_head(x.mean(dim=1) if self.pool == "mean" else x[:, 0])

    def forward(self, img):
        return self.head(self.trunk(self.embed(img)))
