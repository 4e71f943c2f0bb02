"""CvT, the convolutional vision transformer (reference cvt.py:114-173), port
of ``vit_pytorch_tpu/models/cvt.py``.

Three stages, each a strided convolution embedding, a LayerNorm over the
channels and layers of convolutional-projection attention and a 1x1
convolution feed-forward (cvt.py:37-97), on NCHW maps (the JAX package's
are NHWC).  q comes from a depthwise convolution at stride 1, k and v from
one at ``kv_proj_stride``, each followed by flax's BatchNorm
(``models/max_vit.py::BatchNorm``, its running statistics as buffers) and a
1x1 convolution, bias-free.  At 224 x 224 the keys are 784, 196 and 49, so
``ops/attention.py::dot_product_attention`` takes its composite, as the JAX
dispatcher does.  :class:`ChanLayerNorm` keeps the reference's ``g`` and
``b`` of shape (1, c, 1, 1); NesT and Twins-SVT share it.

The state_dict is the reference's (``layers.s.0`` the embedding convolution,
``layers.s.1`` its norm, ``layers.s.2.layers.N.0`` the attention with
``norm``, ``to_q.net.0|1|2``, ``to_kv.net.0|1|2`` and ``to_out.0``,
``layers.s.2.layers.N.1.net.0|1|4``, ``to_logits.2``):
``utils/convert.py::convert_cvt``, ``utils/from_jax.py::cvt_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import GELU, LN_EPS
from ..ops.attention import dot_product_attention
from ..utils.helpers import default_device
from .max_vit import BatchNorm
from .vit import init_modules_like_jax


class ChanLayerNorm(nn.Module):
    """LayerNorm over the channels of an NCHW map with the biased variance
    (reference cvt.py:25-35), the JAX ``ChanLayerNorm`` (a last-axis
    LayerNorm on NHWC); ``g``/``b`` of shape (1, c, 1, 1)."""

    def __init__(self, dim: int, eps: float = LN_EPS, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1, device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(1, dim, 1, 1, device=device, dtype=dtype))

    @torch.no_grad()
    def reset_parameters(self):
        self.g.fill_(1.0)
        self.b.zero_()

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, x.shape[-1:], self.g.flatten(), self.b.flatten(), self.eps)
        return x.permute(0, 3, 1, 2)


def reset_chan_norms(model: nn.Module) -> None:
    """Ones and zeros in every :class:`ChanLayerNorm` of ``model``."""
    for m in model.modules():
        if isinstance(m, ChanLayerNorm):
            m.reset_parameters()


def to_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, h d, y, x) -> (b, h, y x, d): the channels as ``heads`` heads, the
    map's positions as the sequence."""
    b, c, y, x = t.shape
    return t.reshape(b, heads, c // heads, y * x).transpose(-1, -2)


def from_heads(t: torch.Tensor, y: int, x: int) -> torch.Tensor:
    """(b, h, y x, d) -> (b, h d, y, x), the inverse of :func:`to_heads`."""
    b, h, _, d = t.shape
    return t.transpose(-1, -2).reshape(b, h * d, y, x)


class DepthWiseConv2d(nn.Module):
    """reference cvt.py:51-60: a depthwise convolution, BatchNorm, a 1x1
    convolution (``net.0|1|2``)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, padding: int, stride: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.net = nn.Sequential(
            nn.Conv2d(dim_in, dim_in, kernel_size, stride=stride, padding=padding, groups=dim_in, bias=bias, **kw),
            BatchNorm(dim_in, **kw),
            nn.Conv2d(dim_in, dim_out, 1, bias=bias, **kw),
        )

    def forward(self, x):
        return self.net(x)


class Attention(nn.Module):
    """reference cvt.py:62-97, the JAX ``CvTAttention``: the channel norm, q
    and k, v from the depthwise projections, the dispatcher, a 1x1
    convolution out and its dropout."""

    def __init__(self, dim: int, proj_kernel: int, kv_proj_stride: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        padding = proj_kernel // 2
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.norm = ChanLayerNorm(dim, **kw)
        self.to_q = DepthWiseConv2d(dim, inner, proj_kernel, padding, 1, bias=False, **kw)
        self.to_kv = DepthWiseConv2d(dim, inner * 2, proj_kernel, padding, kv_proj_stride, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Conv2d(inner, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, x):
        x = self.norm(x)
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=1)
        y, w = q.shape[-2:]
        out = dot_product_attention(to_heads(q, self.heads), to_heads(k, self.heads), to_heads(v, self.heads),
                                    scale=self.dim_head**-0.5, dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(from_heads(out, y, w))


class FeedForward(nn.Module):
    """reference cvt.py:37-49: the channel norm, a 1x1 convolution to
    ``dim * mult``, GELU, dropout, a 1x1 convolution back, dropout."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.net = nn.Sequential(
            ChanLayerNorm(dim, **kw), nn.Conv2d(dim, dim * mult, 1, **kw), GELU(), nn.Dropout(dropout),
            nn.Conv2d(dim * mult, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class Transformer(nn.Module):
    """Residual attention and feed-forward a layer (the JAX CvT's stage
    loop, cvt.py:179-194)."""

    def __init__(self, dim: int, proj_kernel: int, kv_proj_stride: int, depth: int, heads: int, dim_head: int = 64,
                 mlp_mult: int = 4, dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, proj_kernel, kv_proj_stride, heads, dim_head, dropout, **kw),
                           FeedForward(dim, mlp_mult, dropout, **kw)])
            for _ in range(depth)
        )

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return x


_STAGE_KEYS = ("emb_dim", "emb_kernel", "emb_stride", "proj_kernel", "kv_proj_stride", "heads", "depth", "mlp_mult")


class CvT(nn.Module):
    """reference cvt.py:114 — same keyword constructor (the ``s1_``, ``s2_``,
    ``s3_`` stage options), with ``device``, ``dtype`` and ``generator`` as
    in ``models/vit.py``."""

    def __init__(self, *, num_classes: int, s1_emb_dim: int = 64, s1_emb_kernel: int = 7, s1_emb_stride: int = 4,
                 s1_proj_kernel: int = 3, s1_kv_proj_stride: int = 2, s1_heads: int = 1, s1_depth: int = 1,
                 s1_mlp_mult: int = 4, s2_emb_dim: int = 192, s2_emb_kernel: int = 3, s2_emb_stride: int = 2,
                 s2_proj_kernel: int = 3, s2_kv_proj_stride: int = 2, s2_heads: int = 3, s2_depth: int = 2,
                 s2_mlp_mult: int = 4, s3_emb_dim: int = 384, s3_emb_kernel: int = 3, s3_emb_stride: int = 2,
                 s3_proj_kernel: int = 3, s3_kv_proj_stride: int = 2, s3_heads: int = 6, s3_depth: int = 10,
                 s3_mlp_mult: int = 4, dropout: float = 0.0, channels: int = 3, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        options = locals()
        dim, layers = channels, []
        for prefix in ("s1", "s2", "s3"):
            c = {k: options[f"{prefix}_{k}"] for k in _STAGE_KEYS}
            layers.append(nn.Sequential(
                nn.Conv2d(dim, c["emb_dim"], c["emb_kernel"], stride=c["emb_stride"], padding=c["emb_kernel"] // 2,
                          **kw),
                ChanLayerNorm(c["emb_dim"], **kw),
                Transformer(c["emb_dim"], c["proj_kernel"], c["kv_proj_stride"], c["depth"], c["heads"],
                            mlp_mult=c["mlp_mult"], dropout=dropout, **kw),
            ))
            dim = c["emb_dim"]
        self.layers = nn.Sequential(*layers)
        self.to_logits = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        reset_chan_norms(self)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, img):
        return self.to_logits(self.layers(img))
