"""MobileViT, a MobileNetV2 trunk with patch-group transformers (reference
mobile_vit.py:173-243), port of ``vit_pytorch_tpu/models/mobile_vit.py``.

Convolutions, flax's BatchNorm (``models/max_vit.py::BatchNorm``, its
running statistics as buffers) and SiLU on NCHW maps (the JAX package's are
NHWC): a stride-2 stem, four inverted-residual blocks (the JAX stem as it
is: its last two blocks are both ``MV2Block(ch[2], ch[3])``), then three
stages of a stride-2 inverted-residual block and a MobileViT block.  A
MobileViT block's transformer attends within each of the ph x pw patch
positions: the map is laid out (b, ph pw, h w, d) and the groups folded
into the batch (mobile_vit.py:163), through the shared ``Transformer``
(heads 4, dim_head 8, a SiLU feed-forward, no final norm), whose dim_head 8
the kernels refuse, so its attention takes the composite, as in the JAX
package.

The state_dict is the reference's (``conv1.0|1``, ``stem.N.conv.0|1|3|4|6|7``,
``trunk.i.0`` the inverted-residual block, ``trunk.i.1`` the MobileViT
block with ``conv1..4.0|1`` and ``transformer.layers.N.0|1``,
``to_logits.0.0|1`` and ``to_logits.2``): ``utils/convert.py::
convert_mobile_vit``, ``utils/from_jax.py::mobile_vit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from einops import rearrange
from einops.layers.torch import Reduce
from torch import nn

from ..nn.blocks import Transformer
from ..utils.helpers import default_device
from .max_vit import BatchNorm
from .vit import init_modules_like_jax


def conv_bn(inp: int, oup: int, kernel_size: int = 1, stride: int = 1, padding: int = 0, *, device=None,
            dtype=None) -> nn.Sequential:
    """conv_1x1_bn / conv_nxn_bn (reference mobile_vit.py:9-21): a bias-free
    convolution, BatchNorm, SiLU."""
    kw = {"device": device, "dtype": dtype}
    return nn.Sequential(nn.Conv2d(inp, oup, kernel_size, stride, padding, bias=False, **kw), BatchNorm(oup, **kw),
                         nn.SiLU())


class MV2Block(nn.Module):
    """The MobileNetV2 inverted residual (reference mobile_vit.py:95-139):
    with ``expansion`` != 1 a 1x1 expansion, BatchNorm and SiLU (``conv.0|1``),
    then the depthwise 3x3 (``conv.3|4``) and the 1x1 projection with its
    BatchNorm (``conv.6|7``); with ``expansion`` 1 the depthwise pair at
    ``conv.0|1`` and the projection at ``conv.3|4``.  The input is added where
    the stride is 1 and the widths agree."""

    def __init__(self, inp: int, oup: int, stride: int = 1, expansion: int = 4, *, device=None, dtype=None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError("MV2Block: stride must be 1 or 2")
        kw = {"device": device, "dtype": dtype}
        hidden = int(inp * expansion)
        self.use_res_connect = stride == 1 and inp == oup
        layers = [] if expansion == 1 else [nn.Conv2d(inp, hidden, 1, bias=False, **kw), BatchNorm(hidden, **kw),
                                            nn.SiLU()]
        layers += [
            nn.Conv2d(hidden, hidden, 3, stride, 1, groups=hidden, bias=False, **kw), BatchNorm(hidden, **kw),
            nn.SiLU(),
            nn.Conv2d(hidden, oup, 1, bias=False, **kw), BatchNorm(oup, **kw),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return out + x if self.use_res_connect else out


class MobileViTBlock(nn.Module):
    """reference mobile_vit.py:141-172: two convolutions into ``dim``, the
    patch-group transformer, one back to ``channel``, and a convolution of
    that and the input, concatenated on the channels."""

    def __init__(self, dim: int, depth: int, channel: int, kernel_size: int, patch_size, mlp_dim: int,
                 dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ph, self.pw = patch_size
        self.conv1 = conv_bn(channel, channel, kernel_size, padding=1, **kw)
        self.conv2 = conv_bn(channel, dim, **kw)
        self.transformer = Transformer(dim, depth, 4, 8, mlp_dim, dropout, final_norm=False, ff_activation="silu",
                                       **kw)
        self.conv3 = conv_bn(dim, channel, **kw)
        self.conv4 = conv_bn(2 * channel, channel, kernel_size, padding=1, **kw)

    def forward(self, x):
        y = x
        x = self.conv2(self.conv1(x))
        b, d, h, w = x.shape
        gh, gw = h // self.ph, w // self.pw
        x = rearrange(x, "b d (h ph) (w pw) -> (b ph pw) (h w) d", ph=self.ph, pw=self.pw)
        x = self.transformer(x)
        x = rearrange(x, "(b ph pw) (h w) d -> b d (h ph) (w pw)", b=b, h=gh, w=gw, ph=self.ph, pw=self.pw)
        return self.conv4(torch.cat([self.conv3(x), y], dim=1))


class MobileViT(nn.Module):
    """reference mobile_vit.py:173 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py``."""

    def __init__(self, *, image_size, dims: Sequence[int], channels: Sequence[int], num_classes: int,
                 expansion: int = 4, kernel_size: int = 3, patch_size=(2, 2), depths: Sequence[int] = (2, 4, 3),
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(dims) != 3:
            raise ValueError("dims must be a tuple of 3")
        if len(depths) != 3:
            raise ValueError("depths must be a tuple of 3")
        ih, iw = image_size
        ph, pw = patch_size
        if ih % ph or iw % pw:
            raise ValueError("the image size must divide by the patch size")
        kw = {"device": default_device(device), "dtype": dtype}
        ch = channels
        init_dim, last_dim = ch[0], ch[-1]
        self.conv1 = conv_bn(3, init_dim, 3, stride=2, padding=1, **kw)
        self.stem = nn.ModuleList([
            MV2Block(ch[0], ch[1], 1, expansion, **kw),
            MV2Block(ch[1], ch[2], 2, expansion, **kw),
            MV2Block(ch[2], ch[3], 1, expansion, **kw),
            MV2Block(ch[2], ch[3], 1, expansion, **kw),
        ])
        trunk = ((ch[3], ch[4], ch[5], dims[0], depths[0], int(dims[0] * 2)),
                 (ch[5], ch[6], ch[7], dims[1], depths[1], int(dims[1] * 4)),
                 (ch[7], ch[8], ch[9], dims[2], depths[2], int(dims[2] * 4)))
        self.trunk = nn.ModuleList(
            nn.ModuleList([MV2Block(c_in, c_mid, 2, expansion, **kw),
                           MobileViTBlock(dim, depth, c_out, kernel_size, patch_size, mlp_dim, **kw)])
            for c_in, c_mid, c_out, dim, depth, mlp_dim in trunk
        )
        self.to_logits = nn.Sequential(conv_bn(ch[-2], last_dim, **kw), Reduce("b c h w -> b c", "mean"),
                                       nn.Linear(last_dim, num_classes, bias=False, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, img):
        x = self.conv1(img)
        for block in self.stem:
            x = block(x)
        for conv, attn in self.trunk:
            x = attn(conv(x))
        return self.to_logits(x)
