"""CCT-3D, the compact convolutional transformer for video (reference
cct_3d.py:325-388), port of ``vit_pytorch_tpu/models/cct_3d.py``: a Conv3d
tokenizer with its own frame kernel, stride, padding and pooling, then
``models/cct.py``'s classifier.  The sequence length comes from the conv
arithmetic (``Tokenizer3D.sequence_length``).  Convs run NCDHW here where
the JAX package runs NDHWC; the tokens keep the (f, h, w) order.  At 224 x
224 and 8 frames (1,568 tokens) each attention takes the flash kernels on
the card in bf16, with their dropout in training.

The state_dict is the reference's (``utils/convert.py::convert_cct_3d``,
``utils/from_jax.py::cct_3d_state_dict_from_jax``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.helpers import default, default_device, pair
from .cct import TransformerClassifier, _cct, conv_out, init_cct

__all__ = ["CCT", "cct_2", "cct_4", "cct_6", "cct_7", "cct_8", "cct_14", "cct_16"]


class Tokenizer3D(nn.Module):
    """reference cct_3d.py:162-224: ``n_conv_layers`` of Conv3d -> ReLU ->
    MaxPool3d, the frame axis with its own kernel, stride and padding, then
    (b, c, f, h, w) -> (b, f h w, c)."""

    def __init__(self, frame_kernel_size: int, kernel_size: int, stride: int, padding: int, frame_stride: int = 1,
                 frame_padding: Optional[int] = None, frame_pooling_kernel_size: int = 1,
                 frame_pooling_stride: int = 1, frame_pooling_padding: Optional[int] = None,
                 pooling_kernel_size: int = 3, pooling_stride: int = 2, pooling_padding: int = 1,
                 n_conv_layers: int = 1, n_input_channels: int = 3, n_output_channels: int = 64, in_planes: int = 64,
                 use_relu: bool = True, max_pool: bool = True, conv_bias: bool = False, *, device=None, dtype=None):
        super().__init__()
        fp = default(frame_padding, frame_kernel_size // 2)
        fpp = default(frame_pooling_padding, frame_pooling_kernel_size // 2)
        self.conv = ((frame_kernel_size, frame_stride, fp), (kernel_size, stride, padding))
        self.pool = ((frame_pooling_kernel_size, frame_pooling_stride, fpp),
                     (pooling_kernel_size, pooling_stride, pooling_padding))
        self.n_conv_layers, self.max_pool = n_conv_layers, max_pool
        chans = [n_input_channels] + [in_planes] * (n_conv_layers - 1) + [n_output_channels]
        self.conv_layers = nn.Sequential(*(
            nn.Sequential(
                nn.Conv3d(c_in, c_out, (frame_kernel_size, kernel_size, kernel_size),
                          stride=(frame_stride, stride, stride), padding=(fp, padding, padding), bias=conv_bias,
                          device=device, dtype=dtype),
                nn.ReLU() if use_relu else nn.Identity(),
                nn.MaxPool3d((frame_pooling_kernel_size, pooling_kernel_size, pooling_kernel_size),
                             (frame_pooling_stride, pooling_stride, pooling_stride),
                             (fpp, pooling_padding, pooling_padding)) if max_pool else nn.Identity(),
            )
            for c_in, c_out in zip(chans[:-1], chans[1:])
        ))

    def sequence_length(self, frames: int, height: int, width: int) -> int:
        """The token count of a (frames, height, width) clip."""
        sizes = [frames, height, width]
        for _ in range(self.n_conv_layers):
            sizes = [conv_out(s, *self.conv[min(i, 1)]) for i, s in enumerate(sizes)]
            if self.max_pool:
                sizes = [conv_out(s, *self.pool[min(i, 1)]) for i, s in enumerate(sizes)]
        f, h, w = sizes
        return f * h * w

    def forward(self, x):
        return self.conv_layers(x).flatten(2).transpose(1, 2)


class CCT(nn.Module):
    """reference cct_3d.py:325 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py``.  Input (b, c,
    frames, h, w); ``forward(video, generator=None)`` as the 2-D CCT's."""

    def __init__(self, *, img_size=224, num_frames: int = 8, embedding_dim: int = 768, n_input_channels: int = 3,
                 n_conv_layers: int = 1, frame_stride: int = 1, frame_kernel_size: int = 3,
                 frame_padding: Optional[int] = None, frame_pooling_kernel_size: int = 1,
                 frame_pooling_stride: int = 1, frame_pooling_padding: Optional[int] = None, kernel_size: int = 7,
                 stride: int = 2, padding: int = 3, pooling_kernel_size: int = 3, pooling_stride: int = 2,
                 pooling_padding: int = 1, num_layers: int = 14, num_heads: int = 6, mlp_ratio: float = 3.0,
                 num_classes: int = 1000, positional_embedding: str = "sine", seq_pool: bool = True,
                 dropout_rate: float = 0.0, attention_dropout: float = 0.1, stochastic_depth_rate: float = 0.1,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        self.tokenizer = Tokenizer3D(
            frame_kernel_size, kernel_size, stride, padding, frame_stride, frame_padding, frame_pooling_kernel_size,
            frame_pooling_stride, frame_pooling_padding, pooling_kernel_size, pooling_stride, pooling_padding,
            n_conv_layers, n_input_channels, embedding_dim, **kw)
        seq_len = self.tokenizer.sequence_length(num_frames, *pair(img_size))
        self.classifier = TransformerClassifier(
            seq_pool, embedding_dim, num_layers, num_heads, mlp_ratio, num_classes, dropout_rate, attention_dropout,
            stochastic_depth_rate, positional_embedding, seq_len, **kw)
        init_cct(self, generator)

    def forward(self, video, generator: Optional[torch.Generator] = None):
        return self.classifier(self.tokenizer(video), generator)


def cct_2(**kw):
    return _cct(2, 2, 1, 128, model=CCT, **kw)


def cct_4(**kw):
    return _cct(4, 2, 1, 128, model=CCT, **kw)


def cct_6(**kw):
    return _cct(6, 4, 2, 256, model=CCT, **kw)


def cct_7(**kw):
    return _cct(7, 4, 2, 256, model=CCT, **kw)


def cct_8(**kw):
    return _cct(8, 4, 2, 256, model=CCT, **kw)


def cct_14(**kw):
    return _cct(14, 6, 3, 384, model=CCT, **kw)


def cct_16(**kw):
    return _cct(16, 6, 3, 384, model=CCT, **kw)
