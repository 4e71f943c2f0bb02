"""MaxViT, MBConv and block/grid windowed attention (reference
max_vit.py:208-291), port of ``vit_pytorch_tpu/models/max_vit.py``.

The model takes NCHW images and keeps NCHW between its blocks (PyTorch's
convolution layout); each attention and feed-forward runs on windows
folded to (b, x, y, w1, w2, d), block windows as contiguous tiles and grid
windows dilated.  Attention adds the per-head relative-position bias
gathered from the learned ((2w - 1)^2, heads) table and goes through
``ops/attention.py::dot_product_attention``, which sends 49-token windows to
its composite on the card as the JAX dispatcher does (JAX
ops/attention.py:222-239): this model launches none of the port's kernels.
Its convolutions and BatchNorms are plain PyTorch, as the JAX package
computes them outside any Pallas kernel.

:class:`BatchNorm` is flax's: statistics in f32 over (b, h, w) with the
biased variance ``E[x^2] - E[x]^2``, the running averages updated with
flax's ``momentum=0.9`` (torch's 0.1), and flax's arithmetic in the dtype of
its operands (bf16 statistics when served in bf16, as the JAX ``Predictor``
casts ``batch_stats``).  :class:`Dropsample` is the intended per-sample drop,
not the reference's ``torch.FloatTensor((shape))`` bug.

Parameters keep the reference's ``state_dict`` layout (``conv_stem.0|1``,
``layers.N.0`` the MBConv, ``layers.N.2|3|6|7.fn`` the block and grid
attention and feed-forward, ``mlp_head.1|2``), which the JAX package's
``utils/convert.py::convert_max_vit`` reads;
``utils/from_jax.py::max_vit_state_dict_from_jax`` maps the JAX ``params``
and ``batch_stats`` back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from einops.layers.torch import Rearrange, Reduce
from torch import nn

from ..nn.blocks import GELU, LN_EPS
from ..ops.attention import dot_product_attention
from ..utils.helpers import default, default_device, table_device
from .vit import init_modules_like_jax


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels of
    an NCHW tensor (JAX max_vit.py:80-82).  Training: the batch's mean and
    biased variance in f32 (flax ``_compute_stats``), the output in the
    dtype of x, weight and bias, the running averages updated in place.
    Evaluation: the running averages, in their dtype.  ``weight``/``bias``
    are flax's ``scale``/``bias``, ``running_mean``/``running_var`` its
    ``batch_stats`` ``mean``/``var``."""

    def __init__(self, num_features: int, *, momentum: float = 0.9, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features, **kw))
        self.bias = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("running_mean", torch.zeros(num_features, **kw))
        self.register_buffer("running_var", torch.ones(num_features, **kw))

    @torch.no_grad()
    def reset_parameters(self):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        if self.training:
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        col = lambda t: t[None, :, None, None]
        # flax _normalize: y = x - mean; mul = rsqrt(var + eps) * scale; y * mul + bias
        y = (x - col(mean)) * col(torch.rsqrt(var + self.eps) * self.weight) + col(self.bias)
        return y.to(torch.promote_types(torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype))


class SqueezeExcitation(nn.Module):
    """reference max_vit.py:47-62: x scaled by a sigmoid gate of its spatial
    mean (``gate.1``, ``gate.3`` the bias-free Linears)."""

    def __init__(self, dim: int, shrinkage_rate: float = 0.25, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        hidden = int(dim * shrinkage_rate)
        self.gate = nn.Sequential(
            Reduce("b c h w -> b c", "mean"),
            nn.Linear(dim, hidden, bias=False, **kw),
            nn.SiLU(),
            nn.Linear(hidden, dim, bias=False, **kw),
            nn.Sigmoid(),
            Rearrange("b c -> b c 1 1"),
        )

    def forward(self, x):
        return x * self.gate(x)


class Dropsample(nn.Module):
    """Per-sample stochastic depth in training (the intent of reference
    max_vit.py:76-88): each sample is kept with probability 1 - prob and
    scaled by 1 / (1 - prob), or zeroed whole.  The draw comes from the
    global RNG, which ``make_train_step`` seeds from its generator."""

    def __init__(self, prob: float = 0.0):
        super().__init__()
        self.prob = prob

    def forward(self, x):
        if self.prob == 0.0 or not self.training:
            return x
        keep = torch.rand((x.shape[0], 1, 1, 1), device=x.device) > self.prob
        return torch.where(keep, x / (1 - self.prob), 0.0)


class MBConv(nn.Sequential):
    """reference max_vit.py:90-117: 1x1 expand, BatchNorm, GELU, 3x3
    depthwise (stride 2 when it downsamples), BatchNorm, GELU,
    squeeze-excitation, 1x1 project, BatchNorm (children 0-8); with
    ``dim_in == dim_out`` and no downsampling a Dropsample (child 9) and the
    residual.  GELU is the dtype-adaptive one (tanh in bf16)."""

    def __init__(self, dim_in: int, dim_out: int, *, downsample: bool, expansion_rate: float = 4,
                 shrinkage_rate: float = 0.25, dropout: float = 0.0, device=None, dtype=None):
        kw = {"device": device, "dtype": dtype}
        hidden = int(expansion_rate * dim_out)
        layers = [
            nn.Conv2d(dim_in, hidden, 1, **kw),
            BatchNorm(hidden, **kw),
            GELU(),
            nn.Conv2d(hidden, hidden, 3, stride=2 if downsample else 1, padding=1, groups=hidden, **kw),
            BatchNorm(hidden, **kw),
            GELU(),
            SqueezeExcitation(hidden, shrinkage_rate, **kw),
            nn.Conv2d(hidden, dim_out, 1, **kw),
            BatchNorm(dim_out, **kw),
        ]
        residual = dim_in == dim_out and not downsample
        if residual:
            layers.append(Dropsample(dropout))
        super().__init__(*layers)
        self.residual = residual

    def forward(self, x):
        out = super().forward(x)
        return out + x if self.residual else out


def rel_pos_indices(window_size: int) -> np.ndarray:
    """(w^2, w^2) indices into the ((2w - 1)^2, heads) bias table
    (reference max_vit.py:152-159)."""
    w = window_size
    pos = np.arange(w)
    grid = np.stack(np.meshgrid(pos, pos, indexing="ij"), axis=-1).reshape(-1, 2)
    rel = grid[:, None, :] - grid[None, :, :] + (w - 1)
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]


class WindowAttention(nn.Module):
    """reference max_vit.py:121-206: pre-LN attention within each window of
    w^2 tokens (the input's last axis is the feature axis, the w^2 tokens of
    a window the axes before it: (b, x, y, w1, w2, d), or (B, r + w^2, d)
    with ``num_registers`` r), with the per-head bias gathered from
    ``rel_pos_bias`` (an Embedding of (2w - 1)^2 rows, one more for the
    registers' pairs: reference max_vit_with_registers.py:148-158); a
    bias-free projection out and dropout."""

    def __init__(self, dim: int, dim_head: int = 32, dropout: float = 0.0, window_size: int = 7,
                 num_registers: int = 0, *, device=None, dtype=None):
        super().__init__()
        if dim % dim_head:
            raise ValueError("dimension should be divisible by dimension per head")
        kw = {"device": device, "dtype": dtype}
        self.heads, self.dim_head, self.dropout = dim // dim_head, dim_head, dropout
        self.tokens = num_registers + window_size**2
        num_rel = (2 * window_size - 1) ** 2
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.to_qkv = nn.Linear(dim, dim * 3, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Linear(dim, dim, bias=False, **kw), nn.Dropout(dropout))
        self.rel_pos_bias = nn.Embedding(num_rel + (1 if num_registers else 0), self.heads, **kw)
        idx = np.pad(rel_pos_indices(window_size), ((num_registers, 0), (num_registers, 0)), constant_values=num_rel)
        self.register_buffer("rel_pos_indices", torch.from_numpy(idx).to(table_device(kw["device"])),
                             persistent=False)

    def forward(self, x):
        shape = x.shape
        x = self.norm(x).reshape(-1, self.tokens, shape[-1])
        bsz, n, _ = x.shape
        q, k, v = self.to_qkv(x).reshape(bsz, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        bias = self.rel_pos_bias.weight[self.rel_pos_indices].permute(2, 0, 1)  # (h, n, n)
        out = dot_product_attention(q, k, v, scale=self.dim_head**-0.5, bias=bias,
                                    dropout_rate=self.dropout if self.training else 0.0)
        out = self.to_out(out.transpose(1, 2).reshape(bsz, n, -1))
        return out.reshape(shape)


def feed_forward_layers(dim: int, mult: float = 4, dropout: float = 0.0, *, device=None, dtype=None) -> list:
    """LN, Linear, GELU, Dropout, Linear, Dropout (reference max_vit.py:30-43)."""
    kw = {"device": device, "dtype": dtype}
    inner = int(dim * mult)
    return [nn.LayerNorm(dim, eps=LN_EPS, **kw), nn.Linear(dim, inner, **kw), GELU(), nn.Dropout(dropout),
            nn.Linear(inner, dim, **kw), nn.Dropout(dropout)]


class MaxFeedForward(nn.Module):
    """reference max_vit.py:30-43, the JAX ``MaxFeedForward`` (``net.0|1|4``)."""

    def __init__(self, dim: int, mult: float = 4, dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        self.net = nn.Sequential(*feed_forward_layers(dim, mult, dropout, device=device, dtype=dtype))

    def forward(self, x):
        return self.net(x)


class Residual(nn.Module):
    """fn(x) + x (reference max_vit.py:19-26)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x) + x


def stage_blocks(dim: int, depth: Sequence[int], dim_conv_stem: Optional[int]):
    """(dim_in, dim, first) of each block, stage by stage: stage i is
    ``2**i * dim`` wide, and its first block takes the previous stage's
    width and downsamples (reference max_vit.py:240-262)."""
    dims = (default(dim_conv_stem, dim), *((2**i) * dim for i in range(len(depth))))
    return [(dims[i] if j == 0 else dims[i + 1], dims[i + 1], j == 0) for i, d in enumerate(depth) for j in range(d)]


def conv_stem(channels: int, dim: int, **kw) -> nn.Sequential:
    """3x3 stride 2, then 3x3 (reference max_vit.py:234-237)."""
    return nn.Sequential(nn.Conv2d(channels, dim, 3, stride=2, padding=1, **kw),
                         nn.Conv2d(dim, dim, 3, padding=1, **kw))


def mlp_head(dim: int, num_classes: int, **kw) -> nn.Sequential:
    """Mean over the image, LayerNorm, Linear (reference max_vit.py:283-287)."""
    return nn.Sequential(Reduce("b d h w -> b d", "mean"), nn.LayerNorm(dim, eps=LN_EPS, **kw),
                         nn.Linear(dim, num_classes, **kw))


@torch.no_grad()
def init_max_vit(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's initialisation of a MaxViT: Linear and Conv weights
    truncated lecun-normal, zero biases, unit LayerNorms and BatchNorms (mean
    0, variance 1), unit normal bias tables."""
    init_modules_like_jax(model, generator)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.reset_parameters()
        elif isinstance(m, WindowAttention):
            m.rel_pos_bias.weight.normal_(generator=generator)


class MaxViT(nn.Module):
    """reference max_vit.py:208 — same keyword constructor.  ``device`` (the
    CUDA card unless it names another) and ``dtype`` place the parameters,
    ``generator`` seeds their initialisation; ``model.train()`` stands for
    the JAX ``train=True`` (batch statistics, running averages updated)."""

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
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if not isinstance(depth, (tuple, list)):
            raise ValueError("depth needs to be tuple if integers indicating number of transformer blocks at that "
                             "stage")
        kw = {"device": default_device(device), "dtype": dtype}
        w = window_size
        self.conv_stem = conv_stem(channels, default(dim_conv_stem, dim), **kw)
        attn = lambda d: Residual(WindowAttention(d, dim_head, dropout, w, **kw))
        ff = lambda d: Residual(MaxFeedForward(d, dropout=dropout, **kw))
        self.layers = nn.ModuleList(
            nn.Sequential(
                MBConv(dim_in, d, downsample=first, expansion_rate=mbconv_expansion_rate,
                       shrinkage_rate=mbconv_shrinkage_rate, **kw),
                Rearrange("b d (x w1) (y w2) -> b x y w1 w2 d", w1=w, w2=w),  # block windows: contiguous tiles
                attn(d), ff(d),
                Rearrange("b x y w1 w2 d -> b d (x w1) (y w2)"),
                Rearrange("b d (w1 x) (w2 y) -> b x y w1 w2 d", w1=w, w2=w),  # grid windows: dilated
                attn(d), ff(d),
                Rearrange("b x y w1 w2 d -> b d (w1 x) (w2 y)"),
            )
            for dim_in, d, first in stage_blocks(dim, depth, dim_conv_stem)
        )
        self.mlp_head = mlp_head((2 ** (len(depth) - 1)) * dim, num_classes, **kw)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_max_vit(self, generator)

    def forward(self, img):
        x = self.conv_stem(img)
        for block in self.layers:
            x = block(x)
        return self.mlp_head(x)
