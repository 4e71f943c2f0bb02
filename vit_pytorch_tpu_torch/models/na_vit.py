"""NaViT — variable-resolution packed ViT (reference na_vit.py:195-402), port
of ``vit_pytorch_tpu/models/na_vit.py``.

The host packs images into fixed-shape tensors (``ops/packing.py``) and the
model consumes the segment ids directly: on a CUDA device in bf16 every
attention call is the flash kernels of ``ops/flash_attention.py``, which
skip cross-segment tiles instead of materializing the (b, 1, n, n)
block-diagonal mask.  In training with ``dropout`` > 0 each layer's
attention dropout runs inside those kernels (their ``[dropout]``
instantiations, a seed drawn on the host a call); ``attn_pool`` has no
dropout (JAX na_vit.py:92-100).  Reference behaviours kept, as in the JAX
model:

  - bias-free LayerNorms throughout (na_vit.py:82-89);
  - qk RMSNorm with learned per-head gamma, attention scale 1
    (na_vit.py:93-101, 161-166): the attention hands the gammas to the
    dispatcher, which applies them eagerly by default and, with
    ``VIT_TPU_FUSE_QKNORM`` set, sends them into the flash kernels'
    ``[qknorm]`` instantiations (every layer and ``attn_pool``);
  - factorized learned h/w position embeddings (na_vit.py:230-231, 352-359);
  - per-image attention pooling with a learned query (na_vit.py:371-387);
    empty query slots carry segment id -2 and attend nothing;
  - token dropout at pack time (na_vit.py:306-314 -> ops/packing.py).

Output is (b, max_images, num_classes); ``PackedImages.is_image`` selects
the real rows, and ``forward_packed`` returns them flattened as the
reference does (na_vit.py:389-402).  Parameter names follow the JAX module
tree (``utils/from_jax.py::na_vit_state_dict_from_jax`` maps it).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import LN_EPS, Attention, Transformer
from ..ops.packing import PackedImages, pack_images
from ..utils.helpers import default_device, pair
from .vit import init_modules_like_jax


def pooling_query_ids(packed: PackedImages) -> torch.Tensor:
    """(b, max_images) int32 segment ids of the pooling queries: query i
    attends the tokens of image i, an empty slot gets -2 and attends nothing
    (JAX na_vit.py:126-128)."""
    ids = torch.arange(packed.max_images, dtype=torch.int32, device=packed.device)
    return torch.where(packed.is_image, ids, -2).to(torch.int32)


def embed_packed(model: nn.Module, packed: PackedImages) -> torch.Tensor:
    """LN -> Linear -> LN on the patches plus the factorised h/w position
    tables (na_vit.py:224-231, 352-359), then the embedding dropout.  The
    tables are read with ``F.embedding``, whose backward sums the many
    duplicate indices of a row in parallel; advanced indexing's backward
    sums them one after another (39 ms of a 131 ms NaViT-B training step on
    an H100)."""
    x = model.patch_norm_post(model.patch_proj(model.patch_norm_pre(packed.patches)))
    pos = packed.pos_hw.long()
    x = x + F.embedding(pos[..., 0], model.pos_embed_height) + F.embedding(pos[..., 1], model.pos_embed_width)
    return model.emb_drop(x)


class NaViT(nn.Module):
    """reference na_vit.py:196 — same keyword constructor.  ``flash`` is the
    JAX ``NaViT``'s (``flash=False`` forces the composite attention);
    ``device``/``dtype`` place the parameters (on the CUDA card unless
    ``device`` names another) and ``generator`` seeds their
    initialisation (the JAX package's: normal(1) position tables and pooling
    query, truncated lecun-normal Linear weights, unit LayerNorms and
    gammas)."""

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
        token_dropout_prob: Optional[Union[float, Callable]] = None,
        flash: Optional[bool] = None,
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

        # bias-free LN -> Linear -> bias-free LN (na_vit.py:224-228)
        self.patch_norm_pre = nn.LayerNorm(patch_dim, eps=LN_EPS, bias=False, **kw)
        self.patch_proj = nn.Linear(patch_dim, dim, **kw)
        self.patch_norm_post = nn.LayerNorm(dim, eps=LN_EPS, bias=False, **kw)
        self.pos_embed_height = nn.Parameter(torch.empty(image_height // patch_size, dim, **kw))
        self.pos_embed_width = nn.Parameter(torch.empty(image_width // patch_size, dim, **kw))
        self.emb_drop = nn.Dropout(emb_dropout)
        self.transformer = Transformer(
            dim, depth, heads, dim_head, mlp_dim, dropout, qk_norm=True, norm_bias=False, attn_out_bias=False,
            flash=flash, **kw,
        )
        self.attn_pool_queries = nn.Parameter(torch.empty(dim, **kw))
        self.attn_pool = Attention(
            dim, heads=heads, dim_head=dim_head, qk_norm=True, norm_bias=False, out_bias=False,
            force_split_qkv=True, **kw,
        )
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
        seg = packed.image_ids  # (b, L), -1 = pad -> block-diagonal attention
        x = self.transformer(x, q_segment_ids=seg, kv_segment_ids=seg)

        # attention pooling: one learned query per image slot; query i may
        # only attend tokens of image i (na_vit.py:371-387)
        b = x.shape[0]
        queries = self.attn_pool_queries.to(x.dtype).expand(b, packed.max_images, -1)
        pooled = self.attn_pool(
            queries, context=x, q_segment_ids=pooling_query_ids(packed), kv_segment_ids=seg
        ) + queries
        return self.mlp_head(self.head_norm(pooled))


def run_packed(model: nn.Module, images, *, group_images: bool, max_seq_len: int, rng=None) -> torch.Tensor:
    """Pack ``images`` for ``model`` (its device, its parameters' dtype, its
    token dropout when training), run it and return the real images' logits
    flattened, (total_images, num_classes)."""
    weight = model.patch_proj.weight
    packed = pack_images(
        images, model.patch_size, group_images=group_images, max_seq_len=max_seq_len,
        token_dropout_prob=model.token_dropout_prob, train=model.training, rng=rng,
        dtype=weight.dtype, device=weight.device,
    )
    logits = model(packed)
    return logits.reshape(-1, logits.shape[-1])[packed.is_image.reshape(-1)]


def forward_packed(model: NaViT, images, *, rng=None, group_images: bool = True, group_max_seq_len: int = 2048):
    """Reproduces the reference call shape (na_vit.py:255-402): a list of
    (c, H, W) images (or of lists, pre-grouped) -> (total_images,
    num_classes).  The JAX ``forward_packed`` with the module's own state
    for ``params`` and ``train`` (``model.training``); ``rng`` is the numpy
    generator of the token dropout."""
    return run_packed(model, images, group_images=group_images, max_seq_len=group_max_seq_len, rng=rng)
