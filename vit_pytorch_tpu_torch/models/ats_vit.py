"""ATS-ViT, adaptive token sampling (reference ats_vit.py:215-262), port of
``vit_pytorch_tpu/models/ats_vit.py``.

The JAX package's static-shape redesign of the reference's ``torch.unique``
and ``pad_sequence`` (ats_vit.py:88-89), kept as it is: a layer whose
tokens (past the class token) outnumber its budget ``max_tokens_per_depth[i]``
draws ``budget`` token ids (Gumbel-max over the class token's attention
weighted by the value norms), sorts them, marks duplicates with a sentinel,
sorts again and masks, so the sequence shrinks to budget + 1 tokens with a
validity mask carrying the padding (:func:`unique_sorted_with_pad`).  The
mask reaches the next layers' logits (``finfo(float32).min``), the padded
tokens' sampling logits (``finfo(dtype).min / 2``) and nothing else.

Sampling: the JAX model adds the Gumbel noise when the caller gives it a
``sampling`` rng.  Here ``forward(..., sample=None)`` adds it in training
(``model.train()``) and not in evaluation unless ``sample`` says otherwise;
the uniforms come from ``generator`` (on its device) or, without one, from
the global generator of the input's device, which
``parallel/train.py::make_train_step`` seeds from its generator each step.
Without the noise the draw is the argmax, every row alike.

The attention is materialised (the sampler reads its map), as in the JAX
package: no kernel.  The state_dict is the reference's
(``to_patch_embedding.1|2|3``, ``cls_token``, ``pos_embedding``,
``transformer.layers.N.0`` with ``norm``, ``to_qkv``, ``to_out.0``,
``transformer.layers.N.1.net.0|1|4``, ``mlp_head.0|1``):
``utils/convert.py::convert_ats_vit``,
``utils/from_jax.py::ats_vit_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import LN_EPS, FeedForward
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default_device, pair
from .vit import init_modules_like_jax

_BIG = 1 << 30


def _log(t, eps: float = 1e-6):
    return torch.log(t + eps)


def unique_sorted_with_pad(ids: torch.Tensor):
    """Static-shape ``torch.unique`` and pad (the JAX :30-40): (ids sorted,
    each once, then zeros; the mask of the valid slots)."""
    sorted_ids = ids.sort(dim=-1).values
    prev = torch.nn.functional.pad(sorted_ids[:, :-1], (1, 0), value=-1)
    marked = torch.where(sorted_ids == prev, _BIG, sorted_ids)
    out = marked.sort(dim=-1).values
    valid = out != _BIG
    return torch.where(valid, out, 0), valid


class AdaptiveTokenSampling(nn.Module):
    """reference ats_vit.py:42-109, the JAX ``AdaptiveTokenSampling``: the
    sampled attention rows (the class token's first), the new mask and the
    ids, 0 the class token or padding."""

    def __init__(self, output_num_tokens: int, eps: float = 1e-6):
        super().__init__()
        self.output_num_tokens, self.eps = output_num_tokens, eps

    def forward(self, attn, value, mask, *, sample: bool = False, generator: Optional[torch.Generator] = None):
        b, heads, _, n = attn.shape
        k, eps = self.output_num_tokens, self.eps
        value_norms = torch.linalg.vector_norm(value[..., 1:, :], dim=-1)
        cls_attn = torch.einsum("bhn,bhn->bn", attn[..., 0, 1:], value_norms)
        normed = cls_attn / (cls_attn.sum(dim=-1, keepdim=True) + eps)
        pseudo_logits = _log(normed, eps)
        mask_value = torch.finfo(attn.dtype).min / 2
        pseudo_logits = torch.where(mask[:, 1:], pseudo_logits, mask_value)
        pseudo_logits = pseudo_logits[:, None, :].expand(b, k, n - 1)
        if sample:
            device = attn.device if generator is None else generator.device
            u = torch.rand(pseudo_logits.shape, generator=generator, device=device).to(attn.device)
            pseudo_logits = pseudo_logits + -_log(-_log(u, eps), eps)
        sampled = pseudo_logits.argmax(dim=-1) + 1  # 0: the class token or padding
        unique_ids, new_mask = unique_sorted_with_pad(sampled)
        new_mask = torch.nn.functional.pad(new_mask, (1, 0), value=True)
        unique_ids = torch.nn.functional.pad(unique_ids, (1, 0), value=0)
        new_attn = torch.gather(attn, 2, unique_ids[:, None, :, None].expand(b, heads, k + 1, n))
        return new_attn, new_mask, unique_ids


class Attention(nn.Module):
    """reference ats_vit.py:127-175, the JAX ``ATSAttention``: LayerNorm, a
    bias-free qkv projection, f32 logits masked where a query or a key is
    padding, softmax, dropout, the sampler where the tokens outnumber
    ``output_num_tokens``, the projection out and dropout (``to_out.0``)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 output_num_tokens: Optional[int] = None, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.output_num_tokens = heads, dim_head, output_num_tokens
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, **kw)
        self.attend = nn.Dropout(dropout)
        self.ats = AdaptiveTokenSampling(output_num_tokens) if output_num_tokens is not None else None
        self.to_out = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))

    def forward(self, x, *, mask, sample: bool = False, generator: Optional[torch.Generator] = None):
        b, n, _ = x.shape
        q, k, v = self.to_qkv(self.norm(x)).reshape(b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        dots = torch.matmul(q.float(), k.float().transpose(-1, -2)) * self.dim_head**-0.5
        if mask is not None:
            dots_mask = mask[:, None, :, None] & mask[:, None, None, :]
            dots = dots.masked_fill(~dots_mask, torch.finfo(dots.dtype).min)
        attn = self.attend(torch.softmax(dots, dim=-1).to(v.dtype))
        sampled_token_ids = None
        if self.ats is not None and n - 1 > self.output_num_tokens:
            attn, mask, sampled_token_ids = self.ats(attn, v, mask, sample=sample, generator=generator)
        out = torch.matmul(attn, v)
        return self.to_out(out.transpose(1, 2).reshape(b, out.shape[2], -1)), mask, sampled_token_ids


class Transformer(nn.Module):
    """reference ats_vit.py:177-213: each layer's attention with its budget,
    the tokens it keeps gathered before its residual, then the
    feed-forward."""

    def __init__(self, dim: int, depth: int, max_tokens_per_depth, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, heads, dim_head, dropout, output_num_tokens, **kw),
                           FeedForward(dim, mlp_dim, dropout=dropout, **kw)])
            for output_num_tokens in max_tokens_per_depth
        )

    def forward(self, x, *, sample: bool = False, generator: Optional[torch.Generator] = None):
        b, n, d = x.shape
        mask = torch.ones((b, n), dtype=torch.bool, device=x.device)
        token_ids = torch.arange(n, device=x.device).expand(b, n)
        for attn, ff in self.layers:
            attn_out, mask, sampled = attn(x, mask=mask, sample=sample, generator=generator)
            if sampled is not None:
                x = torch.gather(x, 1, sampled[..., None].expand(-1, -1, d))
                token_ids = torch.gather(token_ids, 1, sampled)
            x = x + attn_out
            x = ff(x) + x
        return x, token_ids


class ViT(nn.Module):
    """reference ats_vit.py:215 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py`` (the class token and
    the position embedding unit normal, as the JAX init).  ``forward(img,
    return_sampled_token_ids=False, *, sample=None, generator=None)``: with
    ``return_sampled_token_ids`` also the ids (0-based patches) the last
    layer kept, the class token's and the padding's -1."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, max_tokens_per_depth,
                 heads: int, mlp_dim: int, channels: int = 3, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if len(max_tokens_per_depth) != depth:
            raise ValueError("max_tokens_per_depth must be a tuple of length that is equal to the depth of the "
                             "transformer")
        if sorted(max_tokens_per_depth, reverse=True) != list(max_tokens_per_depth):
            raise ValueError("max_tokens_per_depth must be in decreasing order")
        if min(max_tokens_per_depth) <= 0:
            raise ValueError("max_tokens_per_depth must have at least 1 token at any layer")
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_height // patch_height) * (image_width // patch_width)
        patch_dim = channels * patch_height * patch_width
        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), patch_dim, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = Transformer(dim, depth, max_tokens_per_depth, heads, dim_head, mlp_dim, dropout, **kw)
        self.mlp_head = nn.Sequential(nn.LayerNorm(dim, eps=LN_EPS, **kw), nn.Linear(dim, num_classes, **kw))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)

    def forward(self, img, return_sampled_token_ids: bool = False, *, sample: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        x = self.to_patch_embedding(img)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        x = self.dropout(x + self.pos_embedding[:, : x.shape[1]].to(x.dtype))
        x, token_ids = self.transformer(x, sample=self.training if sample is None else sample, generator=generator)
        logits = self.mlp_head(x[:, 0])
        return (logits, token_ids[:, 1:] - 1) if return_sampled_token_ids else logits
