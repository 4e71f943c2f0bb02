"""NaViT, nested-tensor variant (reference na_vit_nested_tensor.py:134-301),
port of ``vit_pytorch_tpu/models/na_vit_nested_tensor.py``.

The reference runs on ``torch.nested`` jagged tensors; like the JAX package,
the port runs it on the packed fixed-shape batch of ``ops/packing.py`` with
segment-id block-diagonal masking, so on a CUDA device in bf16 its attention
is the same flash kernels as ``models/na_vit.py``, attention dropout
included in training.  What makes the variant distinct is its architecture,
all of it here:

  - split q/k/v projections, all bias-free (reference :52-54);
  - qk-norm is a bias-free LayerNorm over dim_head shared across heads
    (reference :59-60), not the per-head-gamma RMSNorm of na_vit.py, and
    the attention scale stays the default 1/sqrt(d) (SDPA default, :102);
  - biased patch-embed LayerNorms (plain nn.LayerNorm, reference :177-181);
  - bias-free pre-norm / final-norm / head-norm LayerNorms (:46, :124, :200);
  - attention pooling WITHOUT a residual connection (:291);
  - token keep count per image = int((1-p)·len), min 1 (:239).

The 3-D variant, ``na_vit_nested_tensor_3d.py``, reuses its
``NestedAttention`` and ``NestedTransformer``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from ..nn.blocks import LN_EPS, FeedForward
from ..ops.attention import dot_product_attention
from ..ops.packing import PackedImages
from ..utils.helpers import default_device, pair
from .na_vit import embed_packed, pooling_query_ids, run_packed
from .vit import init_modules_like_jax


class NestedAttention(nn.Module):
    """reference na_vit_nested_tensor.py:43-111."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, qk_norm: bool = True,
                 *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout, self.qk_norm = heads, dim_head, dropout, qk_norm
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, bias=False, **kw)
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_k = nn.Linear(dim, inner, bias=False, **kw)
        self.to_v = nn.Linear(dim, inner, bias=False, **kw)
        if qk_norm:
            # LayerNorm over dim_head, scale only, shared across heads
            self.q_norm = nn.LayerNorm(dim_head, eps=LN_EPS, bias=False, **kw)
            self.k_norm = nn.LayerNorm(dim_head, eps=LN_EPS, bias=False, **kw)
        self.to_out = nn.Linear(inner, dim, bias=False, **kw)

    def forward(self, x, context=None, *, q_segment_ids=None, kv_segment_ids=None):
        x = self.norm(x)
        kv_input = context if context is not None else x  # reference :75: the context stays un-normed
        b = x.shape[0]
        split = lambda t: t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)
        q, k, v = split(self.to_q(x)), split(self.to_k(kv_input)), split(self.to_v(kv_input))
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        out = dot_product_attention(
            q, k, v, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            dropout_rate=self.dropout if self.training else 0.0,
        )
        return self.to_out(out.transpose(1, 2).reshape(b, x.shape[1], self.heads * self.dim_head))


class NestedTransformer(nn.Module):
    """reference na_vit_nested_tensor.py:113-132; the feed-forward is the
    shared ``FeedForward`` with a bias-free LayerNorm (:33-41)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0,
                 qk_norm: bool = True, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([
                NestedAttention(dim, heads, dim_head, dropout, qk_norm, **kw),
                FeedForward(dim, mlp_dim, dropout, norm_bias=False, **kw),
            ])
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, bias=False, **kw)

    def forward(self, x, *, q_segment_ids=None, kv_segment_ids=None):
        for attn, ff in self.layers:
            x = attn(x, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids) + x
            x = ff(x) + x
        return self.norm(x)


class NaViT(nn.Module):
    """reference na_vit_nested_tensor.py:134 — same keyword constructor;
    ``device`` (the CUDA card by default), ``dtype`` and ``generator`` as in
    ``models/na_vit.py``."""

    def __init__(
        self,
        *,
        image_size,
        patch_size: int,
        num_classes: int,
        dim: int,
        depth: int,
        heads: int,
        mlp_dim: int,
        channels: int = 3,
        dim_head: int = 64,
        dropout: float = 0.0,
        emb_dropout: float = 0.0,
        qk_rmsnorm: bool = True,
        token_dropout_prob: Optional[Union[float, Callable]] = None,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        image_height, image_width = pair(image_size)
        if image_height % patch_size or image_width % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        self.patch_size = patch_size
        self.token_dropout_prob = token_dropout_prob
        patch_dim = channels * patch_size**2

        # BIASED patch-embed LayerNorms (reference :177-181)
        self.patch_norm_pre = nn.LayerNorm(patch_dim, eps=LN_EPS, **kw)
        self.patch_proj = nn.Linear(patch_dim, dim, **kw)
        self.patch_norm_post = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.pos_embed_height = nn.Parameter(torch.empty(image_height // patch_size, dim, **kw))
        self.pos_embed_width = nn.Parameter(torch.empty(image_width // patch_size, dim, **kw))
        self.emb_drop = nn.Dropout(emb_dropout)
        self.transformer = NestedTransformer(dim, depth, heads, dim_head, mlp_dim, dropout, qk_rmsnorm, **kw)
        self.attn_pool_queries = nn.Parameter(torch.empty(dim, **kw))
        self.attn_pool = NestedAttention(dim, heads, dim_head, **kw)
        self.head_norm = nn.LayerNorm(dim, eps=LN_EPS, bias=False, **kw)
        self.mlp_head = nn.Linear(dim, num_classes, bias=False, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        for p in (self.pos_embed_height, self.pos_embed_width, self.attn_pool_queries):
            p.normal_(generator=generator)

    def forward(self, packed: PackedImages) -> torch.Tensor:
        """(b, max_images, num_classes) logits of a packed batch."""
        x = embed_packed(self, packed)
        seg = packed.image_ids
        x = self.transformer(x, q_segment_ids=seg, kv_segment_ids=seg)
        # attention pooling, one query per image, NO residual (reference :291)
        queries = self.attn_pool_queries.to(x.dtype).expand(x.shape[0], packed.max_images, -1)
        pooled = self.attn_pool(queries, context=x, q_segment_ids=pooling_query_ids(packed), kv_segment_ids=seg)
        return self.mlp_head(self.head_norm(pooled))


def forward_images(model: NaViT, images, *, rng=None, max_seq_len: int = 2048) -> torch.Tensor:
    """Reference call shape (na_vit_nested_tensor.py:208-301): a list of
    (c, H, W) images of arbitrary resolutions -> (len(images), num_classes),
    packed greedily by ``max_seq_len``."""
    return run_packed(model, images, group_images=True, max_seq_len=max_seq_len, rng=rng)
