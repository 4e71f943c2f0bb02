"""VAT, the vision-action transformer (reference vat.py:260-511), port of
``vit_pytorch_tpu/ssl/vat.py``.

Action, register, advantage and extra tokens cross-attend the ViT's
per-layer hidden-state trajectory (picked by ``vit_layer_indices``; index
``depth`` is the final embedding), with FiLM task conditioning, per-head
sigmoid output gates on attention (vat.py:95-131), view and time embeddings
and an L1 action loss.  ``freeze_vit`` detaches the trajectory (JAX
``stop_gradient``); the ViT then runs without autograd.

Every attention goes through ``ops/attention.py::dot_product_attention``,
which picks the route as the JAX dispatcher does.  On the card in bf16 the
cross-attention (a few dozen queries against views x frames x tokens keys,
dim_head 64) takes the flash kernels at m >= 1,025 keys, the short kernel at
m = 1,024 and the composite below; the ViT's self-attention (m < 1,024) and
the action tokens' (dim_head 32) take the composite.

``state_dict()`` mirrors the JAX module tree: ``vit.patch_embedding.{1,2,3}``,
``vit.layers.N.{0,1}`` (a ``GatedAttention`` and a ``VATFeedForward``),
``films.N.proj``, ``cross_attns.N``, ``self_attns.N``, ``ffs.N``,
``final_norm``, ``to_pred_action``, ``to_extra_token``, ``advantage_emb``;
``utils/from_jax.py::vat_family_state_dict_from_jax`` writes it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..models.vit import init_modules_like_jax
from ..nn.blocks import LN_EPS, gelu
from ..nn.patch import PatchEmbedding
from ..ops.attention import dot_product_attention
from ..utils.helpers import default, default_device, exists, pair


class FiLM(nn.Module):
    """reference vat.py:25-44: ``tokens * gamma + beta`` from a
    zero-initialised projection of the condition."""

    def __init__(self, dim: int, *, device=None, dtype=None):
        super().__init__()
        self.proj = nn.Linear(dim, dim * 2, device=device, dtype=dtype)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        self.proj.weight.zero_()
        self.proj.bias.zero_()

    def forward(self, tokens, cond):
        gamma, beta = self.proj(cond).chunk(2, dim=-1)
        return tokens * gamma[:, None, :] + beta[:, None, :]


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, n, h*d) -> (b, h, n, d), a view."""
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).transpose(1, 2)


class GatedAttention(nn.Module):
    """reference vat.py:66-134: pre-LN attention, ``to_q``/``to_kv`` without
    bias, per-head sigmoid output gates from the normed x (with bias); with
    ``cross_attend`` the context has a LayerNorm of its own and gives k and v."""

    def __init__(self, dim: int, dim_context: Optional[int] = None, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, cross_attend: bool = False, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.dropout, self.cross_attend = heads, dropout, cross_attend
        self.project_out = not (heads == 1 and dim_head == dim)
        dim_kv = default(dim_context, dim) if cross_attend else dim
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        if cross_attend:
            self.context_norm = nn.LayerNorm(dim_kv, eps=LN_EPS, **kw)
        self.to_q = nn.Linear(dim, inner, bias=False, **kw)
        self.to_kv = nn.Linear(dim_kv, inner * 2, bias=False, **kw)
        self.to_out_gates = nn.Linear(dim, heads, **kw)
        if self.project_out:
            self.to_out = nn.Linear(inner, dim, **kw)
            self.out_dropout = nn.Dropout(dropout)

    def forward(self, x, context=None):
        assert not (self.cross_attend ^ exists(context))
        x = self.norm(x)
        kv_input = self.context_norm(context) if self.cross_attend else x
        q = split_heads(self.to_q(x), self.heads)
        k, v = (split_heads(t, self.heads) for t in self.to_kv(kv_input).chunk(2, dim=-1))
        out = dot_product_attention(q, k, v, dropout_rate=self.dropout if self.training else 0.0)
        gates = torch.sigmoid(self.to_out_gates(x))  # (b, n, h): vat.py:95-99, 131
        out = out * gates.transpose(1, 2)[..., None]
        b, _, n, _ = out.shape
        out = out.transpose(1, 2).reshape(b, n, -1)
        if self.project_out:
            out = self.out_dropout(self.to_out(out))
        return out


class VATFeedForward(nn.Module):
    """LN -> fc1 -> GELU (the JAX package's dtype-adaptive form) -> dropout
    -> fc2 -> dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.fc1 = nn.Linear(dim, hidden_dim, **kw)
        self.fc2 = nn.Linear(hidden_dim, dim, **kw)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        x = self.dropout(gelu(self.fc1(self.norm(x))))
        return self.dropout(self.fc2(x))


class ViT(nn.Module):
    """reference vat.py:177-253: the ViT exposing its representation
    trajectory (the pre-layer hidden states, vat.py:162-175).  The position
    embedding is added to the patches before the register tokens and the
    cls token are put in front of them, registers first.  Same keyword
    constructor; ``device`` (the CUDA card unless it names another),
    ``dtype`` and ``generator`` as the port's ``models/vit.py::ViT``."""

    def __init__(
        self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
        pool: str = "cls", channels: int = 3, dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
        num_register_tokens: int = 0, device=None, dtype=None, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        assert image_height % patch_height == 0 and image_width % patch_width == 0
        assert pool in {"cls", "mean"}
        kw = {"device": default_device(device), "dtype": dtype}
        self.dim, self.depth, self.pool, self.num_register_tokens = dim, depth, pool, num_register_tokens
        num_patches = (image_height // patch_height) * (image_width // patch_width)
        patch_dim = channels * patch_height * patch_width
        self.patch_embedding = PatchEmbedding((patch_height, patch_width), patch_dim, dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(num_patches, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(dim, **kw))
        self.register_tokens = nn.Parameter(torch.empty(num_register_tokens, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.layers = nn.ModuleList(
            nn.ModuleList([GatedAttention(dim, heads=heads, dim_head=dim_head, dropout=dropout, **kw),
                           VATFeedForward(dim, mlp_dim, dropout, **kw)])
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.mlp_head = nn.Linear(dim, num_classes, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)
        self.register_tokens.normal_(std=1e-2, generator=generator)

    def forward(self, img, return_hiddens: bool = False):
        """Logits, or with ``return_hiddens`` (the normed tokens, the stack
        of the ``depth`` pre-layer states)."""
        x = self.patch_embedding(img)
        b, n, _ = x.shape
        x = x + self.pos_embedding[:n].to(x.dtype)
        r = self.num_register_tokens
        cls = self.cls_token.to(x.dtype).expand(b, 1, -1)
        regs = self.register_tokens.to(x.dtype).expand(b, r, -1)
        x = self.dropout(torch.cat([regs, cls, x], dim=1))
        hiddens = []
        for attn, ff in self.layers:
            hiddens.append(x)
            x = attn(x) + x
            x = ff(x) + x
        x = self.norm(x)
        if return_hiddens:
            return x, torch.stack(hiddens)
        pooled = x[:, r + 1 :].mean(dim=1) if self.pool == "mean" else x[:, r]
        return self.mlp_head(pooled)


def fold_views(video_or_image, time_seq_len: int):
    """(b, c, h, w), (b, v, c, h, w) or (b, v, c, t, h, w) -> ((b v t), c, h,
    w) images, v and t (vat.py:309-310)."""
    if video_or_image.ndim == 4:
        video_or_image = video_or_image[:, None]
    if video_or_image.ndim == 5:
        video_or_image = video_or_image[:, :, :, None]
    assert video_or_image.shape[3] == time_seq_len
    v, t = video_or_image.shape[1], video_or_image.shape[3]
    images = video_or_image.transpose(2, 3)  # b v t c h w
    return images.reshape(-1, *images.shape[3:]), v, t


def run_backbone(backbone, inputs, freeze: bool):
    """(embed, hiddens) of ``backbone(inputs, return_hiddens=True)``;
    ``freeze`` detaches both (runs the backbone without autograd)."""
    with torch.set_grad_enabled(torch.is_grad_enabled() and not freeze):
        return backbone(inputs, return_hiddens=True)


def trajectory(embed, hiddens, indices: Sequence[int], views: int, *inner, time_pos_emb=None, view_emb=None):
    """The per-layer contexts (vat.py:316-338): the pre-layer states and the
    final embedding picked by ``indices``, (l, (b v *inner), n, d) ->
    (l, b, v * prod(inner) * n, d), with the time embedding added along the
    frames (``inner`` = (t,)) and the view embedding along the views."""
    hiddens = torch.cat([hiddens, embed[None]], dim=0)
    hiddens = hiddens[torch.tensor(list(indices), device=hiddens.device)]
    l, _, n, d = hiddens.shape
    hiddens = hiddens.reshape(l, -1, views, *inner, n, d)
    if time_pos_emb is not None:
        hiddens = hiddens + time_pos_emb[:, None, :].to(hiddens.dtype)
    if view_emb is not None:
        assert view_emb.shape[0] == views
        hiddens = hiddens + view_emb.reshape(views, *(1,) * (len(inner) + 1), d).to(hiddens.dtype)
    return hiddens.reshape(l, hiddens.shape[1], -1, d)


class ActionTokens(nn.Module):
    """The action side shared by VAT, VAAT and SigLIPVAT: the task table and
    FiLMs, the register tokens, the advantage embedding, the action position
    table, the extra-token projection, the layers' loop and the head (final
    LayerNorm, bias-free projection to ``dim_action``, the L1 loss).
    Subclasses build their per-layer cross-attentions, ``self_attns`` and
    ``ffs``, and call :meth:`act` on their contexts."""

    def _init_action(self, *, dim, depth, dim_action, num_tasks, dim_extra_token, num_register_tokens,
                     action_chunk_len, num_advantage_bins, kw):
        self.dim, self.depth, self.action_chunk_len = dim, depth, action_chunk_len
        self.num_register_tokens, self.num_advantage_bins = num_register_tokens, num_advantage_bins
        self.num_tasks, self.dim_extra_token = num_tasks, dim_extra_token
        if exists(num_tasks):
            self.task_emb = nn.Parameter(torch.empty(num_tasks, dim, **kw))
            self.films = nn.ModuleList(FiLM(dim, **kw) for _ in range(depth))
        self.register_tokens = nn.Parameter(torch.empty(num_register_tokens, dim, **kw))
        self.action_pos_emb = nn.Parameter(torch.empty(action_chunk_len, dim, **kw))
        if num_advantage_bins > 0:
            self.advantage_emb = nn.Embedding(num_advantage_bins + 1, dim, **kw)
        self.final_norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.to_pred_action = nn.Linear(dim, dim_action, bias=False, **kw)
        if exists(dim_extra_token):
            self.to_extra_token = nn.Linear(dim_extra_token, dim, **kw)

    @torch.no_grad()
    def _reset_action(self, generator, backbones=("vit",)):
        """The JAX package's initialisation of everything but the backbones:
        truncated lecun-normal Linear weights, zero biases, unit LayerNorms,
        zero FiLMs, the tables normal with std 1e-2, the advantage table
        normal with std dim ** -0.5 (flax's Embed)."""
        for name, child in self.named_children():
            if name not in backbones:
                init_modules_like_jax(child, generator)
        for film in getattr(self, "films", ()):
            film.reset_parameters()
        for name, p in self.named_parameters(recurse=False):
            p.normal_(std=1e-2, generator=generator)
        if self.num_advantage_bins > 0:
            self.advantage_emb.weight.normal_(std=1 / math.sqrt(self.dim), generator=generator)

    def queries(self, batch: int, advantages=None, extra=None):
        """(tokens, start): registers, the advantage token (``advantages`` an
        int for the whole batch or a (b,) tensor of bins, embedded at
        ``advantages + 1``), the action tokens and the extra token, and the
        index of the first action token (vat.py:340-384)."""
        dim = self.dim
        parts = [self.register_tokens.expand(batch, -1, -1)]
        start = self.num_register_tokens
        if self.num_advantage_bins > 0 and exists(advantages):
            if isinstance(advantages, int):
                advantages = torch.full((batch,), advantages, dtype=torch.long, device=self.action_pos_emb.device)
            parts.append(self.advantage_emb(advantages.long() + 1)[:, None, :])
            start += 1
        parts.append(self.action_pos_emb.expand(batch, -1, -1))
        if exists(extra):
            assert exists(self.dim_extra_token)
            parts.append(self.to_extra_token(extra.to(self.to_extra_token.weight.dtype))[:, None, :])
        return torch.cat([p.reshape(batch, -1, dim) for p in parts], dim=1), start

    def act(self, batch: int, contexts, *, extra=None, tasks=None, advantages=None, actions=None,
            return_hiddens: bool = False):
        """The action transformer (vat.py:364-394): the query tokens through
        ``depth`` layers of FiLM (with ``tasks``), each cross-attention on
        its context (``contexts``: (modules, (depth, b, m, d) contexts)
        pairs, in order), the self-attention and the FF, each with its
        residual; then the predicted action chunk, with ``return_hiddens``
        also the stacked token states, or with ``actions`` the L1 loss."""
        tokens, start = self.queries(batch, advantages, extra)
        cond = None
        if exists(tasks):
            assert exists(self.num_tasks)
            cond = self.task_emb[tasks]
        all_hiddens = [tokens]
        for i in range(self.depth):
            if exists(cond):
                tokens = self.films[i](tokens, cond)
            for crosses, context in contexts:
                tokens = crosses[i](tokens, context[i]) + tokens
            if hasattr(self, "self_attns"):
                tokens = self.self_attns[i](tokens) + tokens
            tokens = self.ffs[i](tokens) + tokens
            all_hiddens.append(tokens)
        pred_action = self.to_pred_action(self.final_norm(tokens[:, start : start + self.action_chunk_len]))
        if not exists(actions):
            return (pred_action, torch.stack(all_hiddens)) if return_hiddens else pred_action
        assert pred_action.shape[1] == actions.shape[1]
        return (pred_action - actions).abs().mean()


class VAT(ActionTokens):
    """reference vat.py:260 — same keyword constructor (``vit`` a VAT
    :class:`ViT` or a dict of its kwargs).  ``device`` (the CUDA card unless
    it names another) and ``dtype`` place the parameters; ``generator``
    seeds the initialisation of the VAT's own parameters (and of the ViT
    built from a dict), the JAX package's."""

    def __init__(
        self, *, vit, dim: int, depth: int, heads: int, dim_head: int, dim_action: int, mlp_dim: int,
        num_views: Optional[int] = None, num_tasks: Optional[int] = None, dim_extra_token: Optional[int] = None,
        num_register_tokens: int = 4, action_chunk_len: int = 7, time_seq_len: int = 1, dropout: float = 0.0,
        add_self_attn: bool = True, self_attn_heads: int = 4, self_attn_dim_head: int = 32,
        vit_layer_indices: Optional[Sequence[int]] = None, num_advantage_bins: int = 0,
        device=None, dtype=None, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        if isinstance(vit, dict):
            vit = ViT(**vit, **kw, generator=generator)
        self.vit = vit
        vit_dim = vit.dim
        assert vit.depth == depth or exists(vit_layer_indices)
        self.layer_indices = tuple(default(vit_layer_indices, range(depth)))
        assert len(self.layer_indices) == depth
        self.time_seq_len, self.num_views = time_seq_len, num_views
        self._init_action(dim=dim, depth=depth, dim_action=dim_action, num_tasks=num_tasks,
                          dim_extra_token=dim_extra_token, num_register_tokens=num_register_tokens,
                          action_chunk_len=action_chunk_len, num_advantage_bins=num_advantage_bins, kw=kw)
        if time_seq_len > 1:
            self.time_pos_emb = nn.Parameter(torch.empty(time_seq_len, vit_dim, **kw))
        if exists(num_views) and num_views > 1:
            self.view_emb = nn.Parameter(torch.empty(num_views, vit_dim, **kw))
        if add_self_attn:
            self.self_attns = nn.ModuleList(
                GatedAttention(dim, heads=self_attn_heads, dim_head=self_attn_dim_head, dropout=dropout, **kw)
                for _ in range(depth))
        self.cross_attns = nn.ModuleList(
            GatedAttention(dim, vit_dim, heads=heads, dim_head=dim_head, dropout=dropout, cross_attend=True, **kw)
            for _ in range(depth))
        self.ffs = nn.ModuleList(VATFeedForward(dim, mlp_dim, dropout, **kw) for _ in range(depth))
        self._reset_action(generator)

    def forward(self, video_or_image, *, extra=None, tasks=None, advantages=None, actions=None,
                return_hiddens: bool = False, freeze_vit: bool = False):
        """``video_or_image``: (b, c, h, w), (b, v, c, h, w) or (b, v, c, t,
        h, w).  Returns the predicted actions (b, action_chunk_len,
        dim_action), with ``return_hiddens`` also the token states (depth +
        1, b, tokens, dim), or with ``actions`` the L1 loss."""
        batch = video_or_image.shape[0]
        images, v, t = fold_views(video_or_image, self.time_seq_len)
        embed, hiddens = run_backbone(self.vit, images, freeze_vit)
        context = trajectory(embed, hiddens, self.layer_indices, v, t, time_pos_emb=getattr(self, "time_pos_emb", None),
                             view_emb=getattr(self, "view_emb", None))
        return self.act(batch, [(self.cross_attns, context)], extra=extra, tasks=tasks, advantages=advantages,
                        actions=actions, return_hiddens=return_hiddens)
