"""PiT, the pooling-based ViT (reference pit.py:117-182), port of
``vit_pytorch_tpu/models/pit.py``.

Overlapping patches (``nn.Unfold`` at stride p/2, channel slowest, as the
JAX ``nn/patch.py::unfold_2d``) are projected, a cls token and a learned
table join them, and stages of the shared ``Transformer`` (no final norm)
alternate with a pooling that doubles the width: a depthwise convolution of
stride 2 (``groups = gcd(dim_in, dim_out)``, padding 1) and a 1x1
convolution on the token grid, a Linear on the cls token (pit.py:86-113).
At 224 x 224 with patch 14 the stages run at 962, 257 and 65 tokens: the
first two take the composite (n > 208), the third the whole-layer kernels
when served and the attention-block kernels in training with dropout, as
the JAX ``Transformer``'s predicates decide.

The state_dict is the reference's (``to_patch_embedding.2``,
``pos_embedding``, ``cls_token``, ``layers.2s`` stage s's transformer,
``layers.2s+1`` its pool with ``downsample.net.0|1`` and ``cls_ff``,
``mlp_head.0|1``): ``utils/convert.py::convert_pit``,
``utils/from_jax.py::pit_state_dict_from_jax``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..nn.blocks import LayerNorm, Transformer
from ..utils.helpers import cast_tuple, default_device
from .t2t import Transpose, conv_output_size
from .vit import init_modules_like_jax


class DepthWiseConv2d(nn.Module):
    """reference pit.py:86-94: a grouped k x k convolution (groups
    ``gcd(dim_in, dim_out)``, the JAX module's) then a 1x1 one."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, padding: int, stride: int, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.net = nn.Sequential(
            nn.Conv2d(dim_in, dim_out, kernel_size, stride=stride, padding=padding,
                      groups=math.gcd(dim_in, dim_out), **kw),
            nn.Conv2d(dim_out, dim_out, 1, **kw),
        )

    def forward(self, x):
        return self.net(x)


class Pool(nn.Module):
    """reference pit.py:98-113: the cls token through a Linear, the token
    grid through the stride-2 pair, both to twice the width."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.downsample = DepthWiseConv2d(dim, dim * 2, 3, 1, 2, **kw)
        self.cls_ff = nn.Linear(dim, dim * 2, **kw)

    def forward(self, x):
        cls_token, tokens = x[:, :1], x[:, 1:]
        b, n, c = tokens.shape
        side = int(math.sqrt(n))
        tokens = self.downsample(tokens.transpose(1, 2).reshape(b, c, side, side))
        return torch.cat([self.cls_ff(cls_token), tokens.flatten(2).transpose(1, 2)], dim=1)


class PiT(nn.Module):
    """reference pit.py:117 — same keyword constructor (``depth`` a tuple of
    the stages' layer counts, ``heads`` one count or one a stage), with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, image_size: int, patch_size: int, num_classes: int, dim: int, depth: Sequence[int],
                 heads: Union[int, Sequence[int]], mlp_dim: int, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, channels: int = 3, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if not isinstance(depth, (tuple, list)):
            raise ValueError("depth must be a tuple of integers, specifying the number of blocks before each "
                             "downsizing")
        kw = {"device": default_device(device), "dtype": dtype}
        heads = cast_tuple(heads, len(depth))
        patch_dim = channels * patch_size**2
        output_size = conv_output_size(image_size, patch_size, patch_size // 2, 0)
        self.to_patch_embedding = nn.Sequential(
            nn.Unfold(kernel_size=patch_size, stride=patch_size // 2), Transpose(), nn.Linear(patch_dim, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, output_size**2 + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        layers = []
        for ind, (layer_depth, layer_heads) in enumerate(zip(depth, heads)):
            layers.append(Transformer(dim, layer_depth, layer_heads, dim_head, mlp_dim, dropout, final_norm=False,
                                      **kw))
            if ind < len(depth) - 1:
                layers.append(Pool(dim, **kw))
                dim *= 2
        self.layers = nn.Sequential(*layers)
        self.mlp_head = nn.Sequential(LayerNorm(dim, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)

    def forward(self, img):
        x = self.to_patch_embedding(img)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = self.layers(self.dropout(x + self.pos_embedding[:, : n + 1].to(x.dtype)))
        return self.mlp_head(x[:, 0])
