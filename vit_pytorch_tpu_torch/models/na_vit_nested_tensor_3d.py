"""NaViT-3D, nested-tensor variant (reference na_vit_nested_tensor_3d.py:
135-356), port of ``vit_pytorch_tpu/models/na_vit_nested_tensor_3d.py``.

Variable-length videos, ``(c, F, H, W)`` with per-video frame counts and
resolutions, are packed into fixed-shape rows with segment ids
(:func:`pack_volumes`, the JAX function step for step on the host), as the
2-D variant packs images.  Per-video register tokens are appended at the end
of the packed row with the video's segment id: under block-diagonal masking
attention does not depend on token order, so the tail is the reference's
prepend.  The transformer is the 2-D nested variant's (reference
na_vit_nested_tensor_3d.py:44-133 is line-identical to
na_vit_nested_tensor.py:43-132): split bias-free q/k/v, qk-norm as a
bias-free LayerNorm over dim_head, the default 1/sqrt(d) scale.  So on a
CUDA device in bf16 every attention call is the flash kernels of
``ops/flash_attention.py`` through segment ids, attention dropout included
in training; the pooling queries of empty video slots carry id -2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import LN_EPS
from ..utils.helpers import default_device, pair
from .na_vit_nested_tensor import NestedAttention, NestedTransformer
from .vit import init_modules_like_jax


@dataclass
class PackedVolumes:
    """Fixed-shape packed batch of videos.  b = number of groups.

    patches:      (b, L, patch_dim) float — flattened (frame, h, w) patches
    pos_fhw:      (b, L, 3) int32 — (frame, h, w) patch grid coordinates
    segment_ids:  (b, L) int32 — video index in the group, -1 for padding
    num_videos:   (b,) int32 — real videos per group
    max_videos:   int — query count for attention pooling
    """

    patches: torch.Tensor
    pos_fhw: torch.Tensor
    segment_ids: torch.Tensor
    num_videos: torch.Tensor
    max_videos: int

    @property
    def is_video(self) -> torch.Tensor:
        """(b, max_videos) bool — which pooled outputs are real videos."""
        ar = torch.arange(self.max_videos, device=self.num_videos.device)
        return ar[None, :] < self.num_videos[:, None]

    @property
    def device(self) -> torch.device:
        return self.patches.device

    def to(self, device=None, dtype=None) -> "PackedVolumes":
        """The batch on ``device``, with ``patches`` cast to ``dtype``."""
        return PackedVolumes(
            self.patches.to(device=device, dtype=dtype), self.pos_fhw.to(device), self.segment_ids.to(device),
            self.num_videos.to(device), self.max_videos,
        )


def pack_volumes(
    volumes: Sequence,
    patch_size: int,
    frame_patch_size: int,
    *,
    max_seq_len: int = 2048,
    max_videos: Optional[int] = None,
    token_dropout_prob: Optional[float] = None,
    train: bool = False,
    rng: Optional[np.random.Generator] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> PackedVolumes:
    """Greedy pack of (c, F, H, W) volumes (numpy arrays or tensors) into one
    fixed row per group, on ``device`` (the CUDA card unless it names
    another), ``patches`` in ``dtype``.  The JAX ``pack_volumes`` step for
    step: ``rng=None`` is ``np.random.default_rng(0)``; token dropout keeps
    ``max(1, int(n * (1 - p)))`` patches of a video in a random order."""
    device = default_device(device)
    if rng is None:
        rng = np.random.default_rng(0)
    p, pf = patch_size, frame_patch_size
    dropping = bool(token_dropout_prob) and train

    groups: list[list] = []
    group: list = []
    seq = 0
    for vol in volumes:
        v = vol.detach().cpu().numpy() if hasattr(vol, "detach") else np.asarray(vol)
        c, frames, height, width = v.shape
        if frames % pf or height % p or width % p:
            raise ValueError(f"volume {v.shape} does not divide into patches of {pf} x {p} x {p}")
        n = (frames // pf) * (height // p) * (width // p)
        if dropping:
            n = int(n * (1 - token_dropout_prob))
        if n > max_seq_len:
            raise ValueError(f"volume {v.shape} has {n} patches, more than max_seq_len {max_seq_len}")
        if seq + n > max_seq_len:
            groups.append(group)
            group, seq = [], 0
        group.append(v)
        seq += n
    if group:
        groups.append(group)

    rows, poss, segs, counts = [], [], [], []
    for vids in groups:
        seq_list, pos_list, seg_list = [], [], []
        for idx, v in enumerate(vids):
            c, frames, height, width = v.shape
            f, h, w = frames // pf, height // p, width // p
            patches = v.reshape(c, f, pf, h, p, w, p).transpose(1, 3, 5, 0, 2, 4, 6).reshape(f * h * w, c * pf * p * p)
            ff, hh, ww = np.meshgrid(np.arange(f), np.arange(h), np.arange(w), indexing="ij")
            pos = np.stack([ff.ravel(), hh.ravel(), ww.ravel()], axis=-1)
            if dropping:
                keep = rng.permutation(patches.shape[0])[: max(1, int(patches.shape[0] * (1 - token_dropout_prob)))]
                patches, pos = patches[keep], pos[keep]
            seq_list.append(patches)
            pos_list.append(pos)
            seg_list.append(np.full(patches.shape[0], idx, np.int32))
        rows.append(np.concatenate(seq_list))
        poss.append(np.concatenate(pos_list))
        segs.append(np.concatenate(seg_list))
        counts.append(len(vids))

    b, L = len(groups), max_seq_len
    patches_out = np.zeros((b, L, rows[0].shape[-1]), np.float32)
    pos_out = np.zeros((b, L, 3), np.int32)
    seg_out = np.full((b, L), -1, np.int32)
    for i in range(b):
        n = rows[i].shape[0]
        patches_out[i, :n] = rows[i]
        pos_out[i, :n] = poss[i]
        seg_out[i, :n] = segs[i]

    return PackedVolumes(
        patches=torch.from_numpy(patches_out).to(device=device, dtype=dtype),
        pos_fhw=torch.from_numpy(pos_out).to(device),
        segment_ids=torch.from_numpy(seg_out).to(device),
        num_videos=torch.tensor(counts, dtype=torch.int32, device=device),
        max_videos=int(max_videos if max_videos is not None else max(counts)),
    )


class NaViT(nn.Module):
    """reference na_vit_nested_tensor_3d.py:135 — same keyword constructor;
    ``device`` (the CUDA card by default), ``dtype`` and ``generator`` as in
    ``models/na_vit.py``.  Initialisation is the JAX model's: normal(0.02)
    position tables and register tokens, a normal(1) pooling query,
    truncated lecun-normal Linear weights, unit LayerNorms."""

    def __init__(
        self,
        *,
        image_size,
        max_frames: int,
        patch_size: int,
        frame_patch_size: int,
        num_classes: int,
        dim: int,
        depth: int,
        heads: int,
        mlp_dim: int,
        channels: int = 3,
        dim_head: int = 64,
        dropout: float = 0.0,
        emb_dropout: float = 0.0,
        num_registers: int = 4,
        qk_rmsnorm: bool = True,
        token_dropout_prob: Optional[float] = None,
        device=None,
        dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        image_height, image_width = pair(image_size)
        if image_height % patch_size or image_width % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if max_frames % frame_patch_size:
            raise ValueError("Frames must be divisible by the frame patch size.")
        kw = {"device": default_device(device), "dtype": dtype}
        self.patch_size, self.frame_patch_size = patch_size, frame_patch_size
        self.num_registers = num_registers
        self.token_dropout_prob = token_dropout_prob
        patch_dim = channels * patch_size**2 * frame_patch_size

        # BIASED patch-embed LayerNorms, as the 2-D nested variant's
        self.patch_norm_pre = nn.LayerNorm(patch_dim, eps=LN_EPS, **kw)
        self.patch_proj = nn.Linear(patch_dim, dim, **kw)
        self.patch_norm_post = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.pos_embed_frame = nn.Parameter(torch.empty(max_frames // frame_patch_size, dim, **kw))
        self.pos_embed_height = nn.Parameter(torch.empty(image_height // patch_size, dim, **kw))
        self.pos_embed_width = nn.Parameter(torch.empty(image_width // patch_size, dim, **kw))
        self.register_tokens = nn.Parameter(torch.empty(num_registers, dim, **kw))
        self.emb_drop = nn.Dropout(emb_dropout)
        self.transformer = NestedTransformer(dim, depth, heads, dim_head, mlp_dim, dropout, qk_rmsnorm, **kw)
        self.attn_pool_queries = nn.Parameter(torch.empty(dim, **kw))
        # reference :207: attn_pool keeps qk_norm=True whatever qk_rmsnorm is
        self.attn_pool = NestedAttention(dim, heads, dim_head, **kw)
        self.head_norm = nn.LayerNorm(dim, eps=LN_EPS, bias=False, **kw)
        self.mlp_head = nn.Linear(dim, num_classes, bias=False, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        for p in (self.pos_embed_frame, self.pos_embed_height, self.pos_embed_width, self.register_tokens):
            p.normal_(std=0.02, generator=generator)
        self.attn_pool_queries.normal_(generator=generator)

    def forward(self, packed: PackedVolumes) -> torch.Tensor:
        """(b, max_videos, num_classes) logits of a packed batch."""
        x = self.patch_norm_post(self.patch_proj(self.patch_norm_pre(packed.patches)))
        pos = packed.pos_fhw.long()
        x = x + (F.embedding(pos[..., 0], self.pos_embed_frame) + F.embedding(pos[..., 1], self.pos_embed_height)
                 + F.embedding(pos[..., 2], self.pos_embed_width)).to(x.dtype)

        # per-video registers appended with the video's segment id (-1 for
        # an empty slot)
        b, dim = x.shape[0], x.shape[-1]
        nv, regs_per = packed.max_videos, self.num_registers
        regs = self.register_tokens.to(x.dtype)[None, None].expand(b, nv, regs_per, dim).reshape(b, nv * regs_per, dim)
        slots = torch.arange(nv, dtype=torch.int32, device=x.device)
        reg_seg = torch.where(packed.is_video.repeat_interleave(regs_per, dim=1),
                              slots.repeat_interleave(regs_per)[None], -1)
        tokens = self.emb_drop(torch.cat([x, regs], dim=1))
        segs = torch.cat([packed.segment_ids, reg_seg], dim=1).to(torch.int32)
        tokens = self.transformer(tokens, q_segment_ids=segs, kv_segment_ids=segs)

        # attention pooling, one query per video slot, NO residual
        queries = self.attn_pool_queries.to(tokens.dtype).expand(b, nv, dim)
        q_seg = torch.where(packed.is_video, slots[None], -2).to(torch.int32)
        pooled = self.attn_pool(queries, context=tokens, q_segment_ids=q_seg, kv_segment_ids=segs)
        return self.mlp_head(self.head_norm(pooled))


def forward_volumes(model: NaViT, volumes, *, rng=None, max_seq_len: int = 2048) -> torch.Tensor:
    """A list of (c, F, H, W) videos -> (len(volumes), num_classes): packed
    greedily by ``max_seq_len`` for ``model`` (its device, its parameters'
    dtype, its token dropout when training), the real videos' logits
    flattened in order."""
    weight = model.patch_proj.weight
    packed = pack_volumes(
        volumes, model.patch_size, model.frame_patch_size, max_seq_len=max_seq_len,
        token_dropout_prob=model.token_dropout_prob, train=model.training, rng=rng, dtype=weight.dtype,
        device=weight.device,
    )
    logits = model(packed)
    return logits.reshape(-1, logits.shape[-1])[packed.is_video.reshape(-1)]
