"""CCT, the compact convolutional transformer (reference cct.py:306-353),
port of ``vit_pytorch_tpu/models/cct.py``.

A convolutional tokenizer (Conv -> ReLU -> MaxPool a layer, NCHW here where
the JAX package runs NHWC; the tokens keep the (h, w) order), a transformer
of post-norm-fed layers with per-sample stochastic depth (``DropPath``,
drawn from a generator), a sine, learned or no position table, and a
sequence-pool head (a learned softmax over the tokens).  The sequence length
comes from the conv arithmetic (``Tokenizer.sequence_length``), not from a
probe forward.  Each attention (``CCTAttention``: ``dim // heads`` a head,
the scale given to the dispatcher) goes through ``ops/attention.py::
dot_product_attention``, as the JAX model's does: on the card at 392
tokens the composite, at CCT-3D's 1,568 the flash kernels.

The state_dict is the reference's (``tokenizer.conv_layers.N.0``,
``classifier.blocks.N.{pre_norm, self_attn.qkv, self_attn.proj, norm1,
linear1, linear2}``, ``classifier.{norm, attention_pool, fc}``, and
``classifier.positional_emb`` when learned; the sine table is a buffer
outside it): ``utils/convert.py::convert_cct``,
``utils/from_jax.py::cct_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn.blocks import LayerNorm, gelu
from ..ops.attention import dot_product_attention
from ..utils.helpers import default, default_device, pair, table_device
from .vit import init_modules_like_jax

__all__ = ["CCT", "cct_2", "cct_4", "cct_6", "cct_7", "cct_8", "cct_14", "cct_16"]


def conv_out(size: int, kernel: int, stride: int, padding: int) -> int:
    """A convolution's or pooling's output length."""
    return (size + 2 * padding - kernel) // stride + 1


def sinusoidal_embedding(n_channels: int, dim: int) -> torch.Tensor:
    """The (1, n_channels, dim) float32 sine table (reference cct.py:75-80)."""
    pe = np.array([[p / (10000 ** (2 * (i // 2) / dim)) for i in range(dim)] for p in range(n_channels)],
                  dtype=np.float32)
    pe[:, 0::2] = np.sin(pe[:, 0::2])
    pe[:, 1::2] = np.cos(pe[:, 1::2])
    return torch.from_numpy(pe[None])


class DropPath(nn.Module):
    """Per-sample stochastic depth (reference cct.py:144-160): in training
    each sample's branch is kept with probability 1 - ``drop_prob`` (a
    uniform from ``generator``, on its device, else from the global
    generator of x's device) and scaled by its inverse."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.drop_prob <= 0.0 or not self.training:
            return x
        keep_prob = 1 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        u = torch.rand(shape, generator=generator, device=generator.device if generator is not None else x.device)
        return torch.where(u.to(x.device) < keep_prob, x / keep_prob, 0.0).to(x.dtype)


class Tokenizer(nn.Module):
    """reference cct.py:162-206: ``n_conv_layers`` of Conv -> ReLU ->
    MaxPool, then (b, c, h, w) -> (b, h w, c)."""

    def __init__(self, kernel_size: int, stride: int, padding: int, pooling_kernel_size: int = 3,
                 pooling_stride: int = 2, pooling_padding: int = 1, n_conv_layers: int = 1,
                 n_input_channels: int = 3, n_output_channels: int = 64, in_planes: int = 64, use_relu: bool = True,
                 max_pool: bool = True, conv_bias: bool = False, *, device=None, dtype=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.pooling = (pooling_kernel_size, pooling_stride, pooling_padding)
        self.n_conv_layers, self.max_pool = n_conv_layers, max_pool
        chans = [n_input_channels] + [in_planes] * (n_conv_layers - 1) + [n_output_channels]
        self.conv_layers = nn.Sequential(*(
            nn.Sequential(
                nn.Conv2d(c_in, c_out, kernel_size, stride=stride, padding=padding, bias=conv_bias, device=device,
                          dtype=dtype),
                nn.ReLU() if use_relu else nn.Identity(),
                nn.MaxPool2d(pooling_kernel_size, pooling_stride, pooling_padding) if max_pool else nn.Identity(),
            )
            for c_in, c_out in zip(chans[:-1], chans[1:])
        ))

    def sequence_length(self, height: int, width: int) -> int:
        """The token count of a (height, width) image, from the conv
        arithmetic."""
        h, w = height, width
        for _ in range(self.n_conv_layers):
            h, w = (conv_out(s, self.kernel_size, self.stride, self.padding) for s in (h, w))
            if self.max_pool:
                h, w = (conv_out(s, *self.pooling) for s in (h, w))
        return h * w

    def forward(self, x):
        return self.conv_layers(x).flatten(2).transpose(1, 2)


class CCTAttention(nn.Module):
    """reference cct.py:84-111: bias-free ``qkv``, ``dim // num_heads`` a
    head, the dispatcher at ``head_dim**-0.5`` with the attention dropout,
    ``proj`` and its dropout."""

    def __init__(self, dim: int, num_heads: int = 8, attention_dropout: float = 0.1, projection_dropout: float = 0.1,
                 *, device=None, dtype=None):
        super().__init__()
        self.heads, self.head_dim, self.attention_dropout = num_heads, dim // num_heads, attention_dropout
        self.qkv = nn.Linear(dim, dim * 3, bias=False, device=device, dtype=dtype)
        self.proj = nn.Linear(dim, dim, device=device, dtype=dtype)
        self.proj_drop = nn.Dropout(projection_dropout)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, self.head_dim).permute(2, 0, 3, 1, 4)
        out = dot_product_attention(q, k, v, scale=self.head_dim**-0.5,
                                    dropout_rate=self.attention_dropout if self.training else 0.0)
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(b, n, c)))


class TransformerEncoderLayer(nn.Module):
    """reference cct.py:114-142: the feed-forward's residual is the normed
    stream (``src = self.norm1(src)`` reassigns it, :139)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048, dropout: float = 0.1,
                 attention_dropout: float = 0.1, drop_path_rate: float = 0.1, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.pre_norm = LayerNorm(d_model, **kw)
        self.self_attn = CCTAttention(d_model, nhead, attention_dropout, dropout, **kw)
        self.linear1 = nn.Linear(d_model, dim_feedforward, **kw)
        self.dropout1 = nn.Dropout(dropout)
        self.norm1 = LayerNorm(d_model, **kw)
        self.linear2 = nn.Linear(dim_feedforward, d_model, **kw)
        self.dropout2 = nn.Dropout(dropout)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, src, generator: Optional[torch.Generator] = None):
        src = src + self.drop_path(self.self_attn(self.pre_norm(src)), generator)
        src = self.norm1(src)
        src2 = self.dropout2(self.linear2(self.dropout1(gelu(self.linear1(src)))))
        return src + self.drop_path(src2, generator)


class TransformerClassifier(nn.Module):
    """reference cct.py:209-292: the class token unless ``seq_pool``, the
    position table, the layers at stochastic depth rising linearly to
    ``stochastic_depth_rate``, the final norm, the sequence pool (or the
    class token) and ``fc``."""

    def __init__(self, seq_pool: bool = True, embedding_dim: int = 768, num_layers: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, num_classes: int = 1000, dropout_rate: float = 0.1,
                 attention_dropout: float = 0.1, stochastic_depth_rate: float = 0.1,
                 positional_embedding: str = "sine", sequence_length: Optional[int] = None, *, device=None,
                 dtype=None):
        super().__init__()
        if positional_embedding not in ("sine", "learnable", "none"):
            raise ValueError(f"positional_embedding {positional_embedding!r} is not sine, learnable or none")
        if sequence_length is None and positional_embedding != "none":
            raise ValueError("positional embedding needs the sequence length")
        kw = {"device": device, "dtype": dtype}
        self.seq_pool, self.positional_embedding = seq_pool, positional_embedding
        seq_len = sequence_length
        if not seq_pool:
            seq_len += 1
            self.class_emb = nn.Parameter(torch.zeros(1, 1, embedding_dim, **kw))
        if positional_embedding == "learnable":
            self.positional_emb = nn.Parameter(torch.empty(1, seq_len, embedding_dim, **kw))
        elif positional_embedding == "sine":
            pos = sinusoidal_embedding(seq_len, embedding_dim).to(table_device(device))
            self.register_buffer("positional_emb", pos, persistent=False)
        self.dropout = nn.Dropout(dropout_rate)
        dpr = np.linspace(0, stochastic_depth_rate, num_layers)
        self.blocks = nn.ModuleList(
            TransformerEncoderLayer(embedding_dim, num_heads, int(embedding_dim * mlp_ratio), dropout_rate,
                                    attention_dropout, float(dpr[i]), **kw)
            for i in range(num_layers)
        )
        self.norm = LayerNorm(embedding_dim, **kw)
        if seq_pool:
            self.attention_pool = nn.Linear(embedding_dim, 1, **kw)
        self.fc = nn.Linear(embedding_dim, num_classes, **kw)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.seq_pool:
            x = torch.cat([self.class_emb.to(x.dtype).expand(x.shape[0], -1, -1), x], dim=1)
        if self.positional_embedding != "none":
            x = x + self.positional_emb.to(x.dtype)
        x = self.dropout(x)
        for block in self.blocks:
            x = block(x, generator)
        x = self.norm(x)
        if self.seq_pool:
            weights = self.attention_pool(x)[..., 0].softmax(dim=1)
            x = torch.einsum("bn,bnd->bd", weights, x)
        else:
            x = x[:, 0]
        return self.fc(x)


@torch.no_grad()
def init_cct(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX CCT's initialisation: lecun-normal Linears, unit LayerNorms,
    Kaiming-normal convolutions (fan-in), a learned position table from a
    normal of std 0.2 truncated at 2 std, zero class embedding."""
    init_modules_like_jax(model, generator)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d)):
            nn.init.kaiming_normal_(m.weight, mode="fan_in", nonlinearity="relu", generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, TransformerClassifier) and isinstance(getattr(m, "positional_emb", None), nn.Parameter):
            nn.init.trunc_normal_(m.positional_emb, std=0.2, a=-0.4, b=0.4, generator=generator)


class CCT(nn.Module):
    """reference cct.py:306 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py``.  ``forward(img,
    generator=None)``: ``generator`` draws the stochastic depth's uniforms."""

    def __init__(self, *, img_size=224, embedding_dim: int = 768, n_input_channels: int = 3, n_conv_layers: int = 1,
                 kernel_size: int = 7, stride: int = 2, padding: int = 3, pooling_kernel_size: int = 3,
                 pooling_stride: int = 2, pooling_padding: int = 1, dropout_rate: float = 0.0,
                 attention_dropout: float = 0.1, stochastic_depth_rate: float = 0.1, num_layers: int = 14,
                 num_heads: int = 6, mlp_ratio: float = 3.0, num_classes: int = 1000,
                 positional_embedding: str = "sine", seq_pool: bool = True, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        self.tokenizer = Tokenizer(kernel_size, stride, padding, pooling_kernel_size, pooling_stride, pooling_padding,
                                   n_conv_layers, n_input_channels, embedding_dim, **kw)
        self.classifier = TransformerClassifier(
            seq_pool, embedding_dim, num_layers, num_heads, mlp_ratio, num_classes, dropout_rate, attention_dropout,
            stochastic_depth_rate, positional_embedding, self.tokenizer.sequence_length(*pair(img_size)), **kw)
        init_cct(self, generator)

    def forward(self, img, generator: Optional[torch.Generator] = None):
        return self.classifier(self.tokenizer(img), generator)


def _cct(num_layers, num_heads, mlp_ratio, embedding_dim, kernel_size=3, stride=None, padding=None, *, model=CCT,
         **kwargs):
    return model(num_layers=num_layers, num_heads=num_heads, mlp_ratio=mlp_ratio, embedding_dim=embedding_dim,
                 kernel_size=kernel_size, stride=default(stride, max(1, (kernel_size // 2) - 1)),
                 padding=default(padding, max(1, (kernel_size // 2))), **kwargs)


def cct_2(**kw):
    return _cct(2, 2, 1, 128, **kw)


def cct_4(**kw):
    return _cct(4, 2, 1, 128, **kw)


def cct_6(**kw):
    return _cct(6, 4, 2, 256, **kw)


def cct_7(**kw):
    return _cct(7, 4, 2, 256, **kw)


def cct_8(**kw):
    return _cct(8, 4, 2, 256, **kw)


def cct_14(**kw):
    return _cct(14, 6, 3, 384, **kw)


def cct_16(**kw):
    return _cct(16, 6, 3, 384, **kw)
