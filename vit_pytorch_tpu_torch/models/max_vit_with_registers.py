"""MaxViT with register tokens (reference max_vit_with_registers.py:200-345),
port of ``vit_pytorch_tpu/models/max_vit_with_registers.py``.

Each block's learned register tokens join every window of its block
attention, ride through the block feed-forward, are averaged over the
windows and join every grid window; they leave before the grid
feed-forward (reference :290-330).  The attention's bias table has one more
row, the index of every pair with a register (:148-158).  It reuses
``max_vit``'s MBConv, feed-forward, window attention and
``rel_pos_indices``; like MaxViT it launches none of the port's kernels.

Parameters keep the reference's ``state_dict`` layout (``conv_stem.0|1``,
``register_tokens.N``, ``layers.N.0`` the MBConv, ``layers.N.1|2.0`` the
block and grid attention, ``layers.N.1|2.1.0|1|4`` their feed-forwards,
``mlp_head.1|2``), which the JAX package's ``utils/convert.py::
convert_max_vit_with_registers`` reads and ``utils/from_jax.py::
max_vit_with_registers_state_dict_from_jax`` writes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from einops import rearrange, repeat
from torch import nn

from ..utils.helpers import default, default_device
from .max_vit import MBConv, WindowAttention, conv_stem, feed_forward_layers, init_max_vit, mlp_head, stage_blocks


class MaxViT(nn.Module):
    """reference max_vit_with_registers.py:200 — same keyword constructor;
    ``device``, ``dtype`` and ``generator`` as :class:`.max_vit.MaxViT`'s."""

    def __init__(
        self,
        *,
        num_classes: int,
        dim: int,
        depth: Sequence[int],
        dim_head: int = 32,
        dim_conv_stem: Optional[int] = None,
        window_size: int = 7,
        mbconv_expansion_rate: float = 4,
        mbconv_shrinkage_rate: float = 0.25,
        dropout: float = 0.1,
        channels: int = 3,
        num_register_tokens: int = 4,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not isinstance(depth, (tuple, list)):
            raise ValueError("depth needs to be tuple if integers indicating number of transformer blocks at that "
                             "stage")
        if num_register_tokens <= 0:
            raise ValueError("num_register_tokens must be greater than 0")
        kw = {"device": default_device(device), "dtype": dtype}
        self.window_size, self.num_register_tokens = window_size, num_register_tokens
        self.conv_stem = conv_stem(channels, default(dim_conv_stem, dim), **kw)
        pair = lambda d: nn.ModuleList([
            WindowAttention(d, dim_head, dropout, window_size, num_register_tokens, **kw),
            nn.Sequential(*feed_forward_layers(d, dropout=dropout, **kw)),
        ])
        blocks = stage_blocks(dim, depth, dim_conv_stem)
        self.register_tokens = nn.ParameterList(
            nn.Parameter(torch.empty(num_register_tokens, d, **kw)) for _, d, _ in blocks
        )
        self.layers = nn.ModuleList(
            nn.ModuleList([
                MBConv(dim_in, d, downsample=first, expansion_rate=mbconv_expansion_rate,
                       shrinkage_rate=mbconv_shrinkage_rate, **kw),
                pair(d),
                pair(d),
            ])
            for dim_in, d, first in blocks
        )
        self.mlp_head = mlp_head((2 ** (len(depth) - 1)) * dim, num_classes, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_max_vit(self, generator)
        for r in self.register_tokens:
            r.normal_(generator=generator)

    def forward(self, img):
        w, r = self.window_size, self.num_register_tokens
        x = self.conv_stem(img)
        for (mbconv, (block_attn, block_ff), (grid_attn, grid_ff)), registers in zip(self.layers,
                                                                                     self.register_tokens):
            x = mbconv(x)
            b, _, h, wd = x.shape
            gx, gy = h // w, wd // w
            # block attention: registers packed into every contiguous window
            xw = rearrange(x, "b d (x w1) (y w2) -> (b x y) (w1 w2) d", w1=w, w2=w)
            packed = torch.cat([repeat(registers.to(xw.dtype), "n d -> B n d", B=xw.shape[0]), xw], dim=1)
            packed = block_attn(packed) + packed
            packed = block_ff(packed) + packed
            rr, xw = packed[:, :r], packed[:, r:]
            x = rearrange(xw, "(b x y) (w1 w2) d -> b d (x w1) (y w2)", b=b, x=gx, w1=w)
            # grid attention: the registers averaged over the windows, packed into every dilated window
            rr = repeat(rr.reshape(b, gx * gy, r, -1).mean(dim=1), "b n d -> (b g) n d", g=gx * gy)
            xw = rearrange(x, "b d (w1 x) (w2 y) -> (b x y) (w1 w2) d", w1=w, w2=w)
            packed = torch.cat([rr.to(xw.dtype), xw], dim=1)
            packed = grid_attn(packed) + packed
            xw = packed[:, r:]  # the registers leave before the grid feed-forward (reference :323-328)
            xw = grid_ff(xw) + xw
            x = rearrange(xw, "(b x y) (w1 w2) d -> b d (w1 x) (w2 y)", b=b, x=gx, w1=w)
        return self.mlp_head(x)
