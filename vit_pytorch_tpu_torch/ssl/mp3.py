"""MP3, masked position prediction (reference mp3.py:150-186), port of
``vit_pytorch_tpu/ssl/mp3.py``.

Every patch token queries the unmasked tokens by cross-attention, and a
LayerNorm + Linear head predicts each token's patch index (cross-entropy).
MP3 ships its own ViT, SimpleViT-flavoured (a sincos position table, mean
pool) whose transformer takes a context stream normed by the same LayerNorm
as the queries (mp3.py:72-77) and has no final norm.  Its attention goes
through ``ops/attention.py::dot_product_attention``: the cross-attention has
fewer than 1,024 keys, so on the card it takes the composite, as the JAX
dispatcher sends it, and no kernel runs.

``state_dict()``: ``vit.to_patch_embedding.{1,2,3}``,
``vit.transformer.layers.N.0.{norm,to_q,to_kv,to_out.0}``,
``vit.transformer.layers.N.1.net.{0,1,4}``, ``vit.linear_head.{0,1}``,
``mlp_head.{0,1}``: the layout ``utils/convert.py::convert_mp3`` reads.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.vit import init_modules_like_jax
from ..nn.blocks import LN_EPS, FeedForward
from ..nn.patch import PatchEmbedding
from ..nn.posemb import posemb_sincos_2d
from ..ops.attention import dot_product_attention
from ..utils.helpers import default_device, pair
from .mae import _take


class MP3Attention(nn.Module):
    """reference mp3.py:52-89: q from x, k and v from the context (x
    without one), both normed by the one LayerNorm."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))

    def forward(self, x, context=None):
        x = self.norm(x)
        context = x if context is None else self.norm(context)
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.heads, self.dim_head).transpose(1, 2)
        q = split(self.to_q(x))
        k, v = map(split, self.to_kv(context).chunk(2, dim=-1))
        out = dot_product_attention(q, k, v, dropout_rate=self.dropout if self.training else 0.0)
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head))


class MP3Transformer(nn.Module):
    """reference mp3.py:91-104: pre-norm attention and FF layers with
    residuals, one context for every layer, no final norm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([MP3Attention(dim, heads, dim_head, dropout, **kw), FeedForward(dim, mlp_dim, dropout, **kw)])
            for _ in range(depth)
        )

    def forward(self, x, context=None):
        for attn, ff in self.layers:
            x = attn(x, context=context) + x
            x = ff(x) + x
        return x


class ViT(nn.Module):
    """reference mp3.py:106-146 — same keyword constructor; ``device``,
    ``dtype`` and ``generator`` as the port ``ViT``'s (the JAX package's
    initialisation)."""

    def __init__(self, *, num_classes: int, image_size, patch_size, dim: int, depth: int, heads: int, mlp_dim: int,
                 channels: int = 3, dim_head: int = 64, dropout: float = 0.0, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        self.dim = dim
        self.grid_hw = (image_height // patch_height, image_width // patch_width)
        self.num_patches = self.grid_hw[0] * self.grid_hw[1]
        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), channels * patch_height * patch_width,
                                                 dim, **kw)
        self.transformer = MP3Transformer(dim, depth, heads, dim_head, mlp_dim, dropout, **kw)
        self.linear_head = nn.Sequential(nn.LayerNorm(dim, eps=LN_EPS, **kw), nn.Linear(dim, num_classes, **kw))
        init_modules_like_jax(self, generator)

    def embed_patches(self, img):
        return self.to_patch_embedding(img)

    def forward(self, img):
        x = self.embed_patches(img)
        x = x + posemb_sincos_2d(*self.grid_hw, self.dim, dtype=x.dtype, device=x.device)
        return self.linear_head(self.transformer(x).mean(dim=1))


class MP3(nn.Module):
    """reference mp3.py:150 — same keyword constructor; ``device``,
    ``dtype`` and ``generator`` place and seed the position head."""

    def __init__(self, *, vit: ViT, masking_ratio: float, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0 < masking_ratio < 1:
            raise ValueError("masking ratio must be kept between 0 and 1")
        kw = {"device": default_device(device), "dtype": dtype}
        self.vit, self.masking_ratio = vit, masking_ratio
        self.mlp_head = nn.Sequential(nn.LayerNorm(vit.dim, eps=LN_EPS, **kw),
                                      nn.Linear(vit.dim, vit.num_patches, **kw))
        init_modules_like_jax(self.mlp_head, generator)

    def forward(self, img, *, rand_indices: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The loss (JAX :148-170).  ``rand_indices`` (b, num_patches): a
        permutation a row, the first ``int(masking_ratio * n)`` masked;
        without it, ``argsort`` of uniforms drawn from ``generator``."""
        tokens = self.vit.embed_patches(img)
        b, n, _ = tokens.shape
        num_masked = int(self.masking_ratio * n)
        if rand_indices is None:
            device = img.device if generator is None else generator.device
            rand_indices = torch.rand((b, n), generator=generator, device=device).argsort(dim=-1)
        unmasked = rand_indices.to(device=img.device, dtype=torch.long)[:, num_masked:]
        attended = self.vit.transformer(tokens, _take(tokens, unmasked))
        logits = self.mlp_head(attended).reshape(-1, n)
        labels = torch.arange(n, device=img.device).repeat(b)
        return -logits.log_softmax(dim=-1).gather(1, labels[:, None]).mean()
