"""WWT: a token stream and slot streams of decreasing size that exchange
information by mutual attention (reference wwt.py:278-443), port of
``vit_pytorch_tpu/models/wwt.py``.

Each layer normalises every stream (bias-free LayerNorms), and for each
interaction (i, j) a :class:`MutualAttention` lets stream i's tokens attend
stream j's slots and the slots attend the tokens, both through the same
logits plus a learned mask that an MLP updates each layer (reference
wwt.py:139-226): a softmax over the slots for the slots' side and, by
default, over the tokens for the tokens' side (``token_softmax_over_slots``
gives the tokens a second group of queries with a softmax over the slots).
Register tokens and slots ride at the front of each stream.  The optional
:class:`AutoencodingHead` (wwt.py:47-127) maps slot features back to the
patch grid through the masks.  Everything is the composite: no kernel of
the port runs in this model, as in JAX.

The masks start at zero in the streams' dtype (the JAX model keeps them in
f32, its dtype promotion); at fp32 the two agree.

The state_dict is the reference's (``to_patch_embedding.1|2|3`` with
bias-free LNs, ``pos_embedding``, ``slots.N``, ``register_tokens``,
``register_slots.N``, ``layers.N.norms.M``, ``layers.N.attns.M``,
``layers.N.mlps.M``, ``mlp_head.0|1``): ``utils/convert.py::convert_wwt``,
``utils/from_jax.py::wwt_state_dict_from_jax``; the parameters the JAX
converter does not map keep the port's names: ``attns.M.mask_project``
(``project_mask_groups``) and ``mlp_head_tokens.0|1`` (``return_tokens``).
"""

from __future__ import annotations

from collections import namedtuple
from typing import Optional, Sequence, Union

import torch
from einops import rearrange, reduce
from torch import nn

from ..nn.blocks import Activation, LayerNorm
from ..nn.patch import PatchEmbedding
from ..utils.helpers import default, default_device, exists, pair
from .vit import init_modules_like_jax

WWTReturn = namedtuple("WWTReturn", ["slot_logits", "token_logits"])
WWTFeatureReturn = namedtuple("WWTFeatureReturn", ["slots", "tokens", "masks"])


def l1norm(t, dim: int = -1, eps: float = 1e-8):
    return t / t.sum(dim=dim, keepdim=True).clamp_min(eps)


def feed_forward(dim: int, hidden_dim: int, dropout: float = 0.0, out_dim: Optional[int] = None, *, device=None,
                 dtype=None) -> nn.Sequential:
    """reference wwt.py:129-137: bias-free LN -> Linear -> GELU -> Dropout
    -> Linear -> Dropout (``0|1|4``)."""
    kw = {"device": device, "dtype": dtype}
    return nn.Sequential(LayerNorm(dim, use_bias=False, **kw), nn.Linear(dim, hidden_dim, **kw), Activation("gelu"),
                         nn.Dropout(dropout), nn.Linear(hidden_dim, default(out_dim, dim), **kw), nn.Dropout(dropout))


class MutualAttention(nn.Module):
    """reference wwt.py:139-226."""

    def __init__(self, dim: int, num_slots: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0,
                 l1norm_after_tokens_softmax: bool = False, token_softmax_over_slots: bool = False,
                 project_mask_groups: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dim_head, self.scale = heads, dim_head, dim_head**-0.5
        self.l1norm_after_tokens_softmax, self.token_softmax_over_slots = l1norm_after_tokens_softmax, \
            token_softmax_over_slots
        self.groups = 2 if token_softmax_over_slots else 1
        self.project_masks = project_mask_groups and token_softmax_over_slots
        self.mask_groups = 1 if self.project_masks else self.groups
        self.to_q_v_tokens = nn.Linear(dim, inner * (self.groups + 1), bias=False, **kw)
        self.to_k_v_slots = nn.Linear(dim, inner * 2, bias=False, **kw)
        self.to_out_tokens = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))
        self.to_out_slots = nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))
        if self.project_masks:
            self.mask_project = nn.Linear(self.groups * heads, heads, **kw)  # a 1 x 1 conv over groups x heads
        masks = self.mask_groups * heads * num_slots
        self.mlp_mask = feed_forward(masks + dim, mlp_dim, dropout, masks, **kw)

    def forward(self, tokens, slots, mask):
        h, g, dh = self.heads, self.groups, self.dim_head
        b, t, _ = tokens.shape
        s = slots.shape[1]
        qv = self.to_q_v_tokens(tokens).reshape(b, t, g + 1, h, dh).permute(2, 0, 3, 1, 4)  # (g+1) b h t d
        q, v_tokens = qv[:-1].transpose(0, 1), qv[-1]  # b g h t d
        k, v_slots = self.to_k_v_slots(slots).reshape(b, s, 2, h, dh).permute(2, 0, 3, 1, 4)
        sim = torch.einsum("bghtd,bhsd->bghts", q, k) * self.scale
        mask_prime = mask + sim  # broadcast over the groups when mask_groups is 1

        mask_prime_slots = mask_prime[:, 0]
        if self.token_softmax_over_slots:
            attn_tokens = torch.softmax(mask_prime[:, 1], dim=-1)
        else:
            attn_tokens = torch.softmax(mask_prime_slots, dim=-2)
        attn_slots = torch.softmax(mask_prime_slots, dim=-1)
        if self.l1norm_after_tokens_softmax:
            attn_slots = l1norm(attn_slots, dim=-2)

        tokens_agg = torch.einsum("bhts,bhsd->bhtd", attn_tokens, v_slots).transpose(1, 2).reshape(b, t, -1)
        tokens_out = self.to_out_tokens(tokens_agg)
        slots_agg = torch.einsum("bhts,bhtd->bhsd", attn_slots, v_tokens).transpose(1, 2).reshape(b, s, -1)
        slots_out = self.to_out_slots(slots_agg)

        # the mask update (wwt.py:217-224)
        if self.project_masks:
            mp = self.mask_project(rearrange(mask_prime, "b g h t s -> b t s (g h)"))
            mask_prime = rearrange(mp, "b t s h -> b 1 h t s")
        mask_flat = rearrange(mask_prime, "b g h t s -> b t (g h s)")
        mask_next = self.mlp_mask(torch.cat([mask_flat, tokens + tokens_out], dim=-1))
        return tokens_out, slots_out, rearrange(mask_next, "b t (g h s) -> b g h t s", h=h, g=self.mask_groups)


class AutoencodingHead(nn.Module):
    """reference wwt.py:47-127: each pathway (a sequence of hierarchy levels)
    carries the features of its first level to its last through the
    softmaxed, head-averaged masks of the interactions on its way; at the
    patch level (``patch_pathway_id``) the tokens are laid out on the patch
    grid (channel-first with ``channel_first``), then the optional
    ``decoder`` runs."""

    def __init__(self, image_size, patch_size, decoder=None, pathways: Optional[Sequence[Sequence[int]]] = None,
                 patch_pathway_id: int = 0, channel_first: bool = False):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        self.grid = (image_height // patch_height, image_width // patch_width)
        self.decoder, self.pathways = decoder, pathways
        self.patch_pathway_id, self.channel_first = patch_pathway_id, channel_first

    def forward(self, hierarchy_features, masks, interactions):
        masks = {tuple(i): reduce(m, "b ... t s -> b t s", "mean") for m, i in zip(masks, interactions)}
        pathways = default(self.pathways, tuple((j, self.patch_pathway_id) for i, j in interactions
                                                if i == self.patch_pathway_id))
        assert len(pathways) > 0

        def construct(pathway):
            start, end = pathway[0], pathway[-1]
            descending = start > end
            features = hierarchy_features[start]
            for source, target in zip(pathway[:-1], pathway[1:]):
                interaction = (target, source) if descending else (source, target)
                assert interaction in masks, f"interaction {interaction} is missing"
                mask = masks[interaction] if descending else masks[interaction].transpose(-1, -2)
                features = torch.einsum("bts,bsd->btd", torch.softmax(mask, dim=-1), features)
            if end == self.patch_pathway_id:
                features = features.reshape(features.shape[0], *self.grid, -1)
                if self.channel_first:
                    features = features.permute(0, 3, 1, 2)
            return self.decoder(features) if exists(self.decoder) else features

        maps = tuple(construct(tuple(p)) for p in pathways)
        return maps[0] if len(maps) == 1 else maps


class WWT(nn.Module):
    """reference wwt.py:278 — same keyword constructor, with ``device``,
    ``dtype`` and ``generator`` as in ``models/vit.py`` (the position
    embedding, the slots and the registers unit normal, as the JAX
    init)."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int,
                 num_slots: Union[int, Sequence[int]], interactions: Optional[Sequence[Sequence[int]]] = None,
                 heads: int = 8, dim_head: int = 64, mlp_dim: Optional[int] = None, channels: int = 3,
                 dropout: float = 0.0, return_tokens: bool = False, l1norm_after_tokens_softmax: bool = False,
                 token_softmax_over_slots: bool = False, project_mask_groups: bool = False,
                 num_register_tokens: int = 0, num_register_slots: Union[int, Sequence[int]] = 0,
                 task_heads: Sequence[nn.Module] = (), device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_height // patch_height) * (image_width // patch_width)
        mlp_dim = default(mlp_dim, dim * 4)
        num_slots = (num_slots,) if isinstance(num_slots, int) else tuple(num_slots)
        for s1, s2 in zip(num_slots[:-1], num_slots[1:]):
            assert s1 > s2, "slots must be strictly decreasing"
        interactions = tuple(tuple(i) for i in default(interactions, tuple((0, i + 1) for i in range(len(num_slots)))))
        assert len(set(interactions)) == len(interactions) and all(i < j for i, j in interactions)
        num_register_slots = ((num_register_slots,) * len(num_slots) if isinstance(num_register_slots, int)
                              else tuple(num_register_slots))
        assert len(num_register_slots) == len(num_slots)
        self.heads, self.return_tokens, self.interactions = heads, return_tokens, interactions
        self.num_regs = (num_register_tokens, *num_register_slots)
        self.token_softmax_over_slots = token_softmax_over_slots
        self.project_masks = project_mask_groups and token_softmax_over_slots
        self.mask_groups = 1 if self.project_masks else (2 if token_softmax_over_slots else 1)
        self.seq_lengths = (num_patches + num_register_tokens, *(s + r for s, r in zip(num_slots, num_register_slots)))
        hierarchies = 1 + len(num_slots)

        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), channels * patch_height * patch_width,
                                                 dim, norm_bias=False, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(num_patches, dim, **kw))
        self.slots = nn.ParameterList(nn.Parameter(torch.empty(n, dim, **kw)) for n in num_slots)
        self.register_tokens = nn.Parameter(torch.empty(num_register_tokens, dim, **kw))
        self.register_slots = nn.ParameterList(nn.Parameter(torch.empty(n, dim, **kw)) for n in num_register_slots)
        self.layers = nn.ModuleList()
        for _ in range(depth):
            layer = nn.Module()
            layer.norms = nn.ModuleList(LayerNorm(dim, use_bias=False, **kw) for _ in range(hierarchies))
            layer.attns = nn.ModuleList(
                MutualAttention(dim, self.seq_lengths[j], heads, dim_head, mlp_dim, dropout,
                                l1norm_after_tokens_softmax, token_softmax_over_slots, project_mask_groups, **kw)
                for _, j in interactions
            )
            layer.mlps = nn.ModuleList(feed_forward(dim, mlp_dim, dropout, **kw) for _ in range(hierarchies))
            self.layers.append(layer)
        self.mlp_head = nn.Sequential(LayerNorm(dim, use_bias=False, **kw), nn.Linear(dim, num_classes, **kw))
        if return_tokens:
            self.mlp_head_tokens = nn.Sequential(LayerNorm(dim, use_bias=False, **kw),
                                                 nn.Linear(dim, num_classes, **kw))
        self.task_heads = nn.ModuleList(task_heads)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        for p in (self.pos_embedding, *self.slots, self.register_tokens, *self.register_slots):
            p.normal_(generator=generator)

    def forward(self, img, return_embeddings: bool = False):
        tokens = self.to_patch_embedding(img)
        b = tokens.shape[0]
        tokens = tokens + self.pos_embedding.to(tokens.dtype)
        streams = [tokens, *(s.to(tokens.dtype).expand(b, -1, -1) for s in self.slots)]
        regs = [self.register_tokens, *self.register_slots]
        # registers at the front of each stream (wwt.py:386-392)
        streams = [torch.cat([r.to(s.dtype).expand(b, -1, -1), s], dim=1) for r, s in zip(regs, streams)]
        masks = [tokens.new_zeros(b, self.mask_groups, self.heads, self.seq_lengths[i], self.seq_lengths[j])
                 for i, j in self.interactions]
        for layer in self.layers:
            normed = [norm(seq) for norm, seq in zip(layer.norms, streams)]
            delta = [0.0] * len(streams)
            next_masks = []
            for attn, mask, (i, j) in zip(layer.attns, masks, self.interactions):
                tokens_out, slots_out, next_mask = attn(normed[i], normed[j], mask)
                delta[i] = delta[i] + tokens_out
                delta[j] = delta[j] + slots_out
                next_masks.append(next_mask)
            streams = [seq + d + mlp(seq + d) for mlp, seq, d in zip(layer.mlps, streams, delta)]
            masks = next_masks

        tokens_out, *slots_out = [seq[:, r:] for r, seq in zip(self.num_regs, streams)]
        slots_out = tuple(slots_out)
        processed_masks = []
        for mask, (i, j) in zip(masks, self.interactions):
            m = mask[..., self.num_regs[i]:, self.num_regs[j]:]
            processed_masks.append(m[:, 0] if not self.token_softmax_over_slots or self.project_masks else m)
        if return_embeddings:
            return WWTFeatureReturn(slots_out, tokens_out if self.return_tokens else None, processed_masks)

        out = sum(self.mlp_head(s).mean(dim=1) for s in slots_out) / len(slots_out)
        if self.return_tokens:
            out = WWTReturn(out, self.mlp_head_tokens(tokens_out).mean(dim=1))
        if len(self.task_heads) == 0:
            return out
        return (out, *(h((tokens_out, *slots_out), processed_masks, self.interactions) for h in self.task_heads))
