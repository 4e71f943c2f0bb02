"""SimpleViT with an FFT token stream (reference simple_vit_with_fft.py:
81-146), port of ``vit_pytorch_tpu/models/simple_vit_with_fft.py``: the real
and imaginary parts of ``fft2(img)``, cut into ``freq_patch_size`` patches,
are embedded by a second patch embedding with their own sincos table and
packed before the image tokens; the mean pool takes the image tokens only
(the JAX :70-75).

``torch.fft.fft2`` takes no bf16: the spectrum is computed in f32 and cast
once to the image's dtype, as ``ops/spectrogram.py`` does for bf16 audio.
The state_dict is SimpleViT's plus ``to_freq_embedding.1/2/3``
(``utils/convert.py::convert_simple_vit_with_fft``).  On the card in bf16
every attention call runs the attention-block kernels, at the two streams'
token count.
"""

from __future__ import annotations

from typing import Optional

import torch
from einops import rearrange
from torch import nn

from ..nn.patch import PatchEmbedding
from ..nn.posemb import posemb_sincos_2d
from ..utils.helpers import pair, table_device
from .simple_vit import SimpleViT as _SimpleViT
from .vit import init_modules_like_jax


class FreqPatchify(nn.Module):
    """(b, c, h*p1, w*p2) images -> (b, h*w, p1*p2*2*c) patches of their
    spectrum, real and imaginary parts interleaved per channel (reference
    :130-131)."""

    def __init__(self, p1: int, p2: int):
        super().__init__()
        self.p1, self.p2 = p1, p2

    def forward(self, img):
        freqs = torch.fft.fft2(img.float())
        freqs = torch.stack([freqs.real, freqs.imag], dim=-1).to(img.dtype)
        return rearrange(freqs, "b c (h p1) (w p2) ri -> b (h w) (p1 p2 ri c)", p1=self.p1, p2=self.p2)


class SimpleViT(_SimpleViT):
    """reference simple_vit_with_fft.py:81 — same keyword constructor, with
    ``flash``, ``device``, ``dtype`` and ``generator`` as in
    ``models/simple_vit.py``."""

    def __init__(self, *, image_size, patch_size, freq_patch_size, num_classes: int, dim: int, depth: int,
                 heads: int, mlp_dim: int, channels: int = 3, dim_head: int = 64, flash: Optional[bool] = None,
                 device=None, dtype=None, generator: Optional[torch.Generator] = None):
        (image_height, image_width), (fph, fpw) = pair(image_size), pair(freq_patch_size)
        if image_height % fph or image_width % fpw:
            raise ValueError("Image dimensions must be divisible by the freq patch size.")
        super().__init__(image_size=image_size, patch_size=patch_size, num_classes=num_classes, dim=dim,
                         depth=depth, heads=heads, mlp_dim=mlp_dim, channels=channels, dim_head=dim_head,
                         flash=flash, device=device, dtype=dtype, generator=generator)
        device = next(self.to_patch_embedding.parameters()).device
        self.to_freq_embedding = PatchEmbedding((fph, fpw), 2 * channels * fph * fpw, dim, device=device,
                                                dtype=dtype)
        self.to_freq_embedding[0] = FreqPatchify(fph, fpw)
        pos = posemb_sincos_2d(image_height // fph, image_width // fpw, dim, device=table_device(device))
        self.register_buffer("freq_pos_embedding", pos, persistent=False)
        init_modules_like_jax(self.to_freq_embedding, generator)

    def forward(self, img):
        f = self.to_freq_embedding(img)
        f = f + self.freq_pos_embedding.to(f.dtype)
        tokens = self.transformer(torch.cat([f, self.embed(img)], dim=1))
        return self.linear_head(self.pool(tokens[:, f.shape[1]:]))
