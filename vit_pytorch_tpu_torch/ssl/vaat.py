"""VAAT, the vision-audio-action transformer (reference vaat.py:421-780),
port of ``vit_pytorch_tpu/ssl/vaat.py``.

VAT plus an audio branch: an :class:`AST` (audio spectrogram transformer,
vaat.py:205-330) gives a second per-layer hidden trajectory, and every VAAT
layer cross-attends both trajectories, images first (vaat.py:702-710).  The
torchaudio ``Spectrogram`` is ``ops/spectrogram.py`` (``torch.stft``), and
spectrograms are cropped to the patch grid as in the reference.  Routes on
the card as in ``ssl/vat.py``: the image cross-attention takes the flash
kernels at m >= 1,025 keys, the audio one (a few hundred keys a view) the
composite.

``state_dict()``: the VAT layout with ``ast.*`` (``patch_norm_pre``,
``patch_proj``, ``patch_norm_post``, ``register_tokens``, ``layers.N.{0,1}``,
``norm``, ``final_norm``, ``mlp_head``), ``img_crosses.N``,
``audio_crosses.N``, ``image_view_emb`` and ``audio_view_emb``;
``utils/from_jax.py::vat_family_state_dict_from_jax`` writes it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..models.vit import init_modules_like_jax
from ..nn.blocks import LN_EPS
from ..nn.posemb import posemb_sincos_2d
from ..ops.spectrogram import spectrogram
from ..utils.helpers import default, default_device, exists, pair
from .vat import ActionTokens, GatedAttention, VATFeedForward, ViT, fold_views, run_backbone, trajectory


class AST(nn.Module):
    """reference vaat.py:205-330: the audio spectrogram transformer with
    register tokens and a hidden-state trajectory.  Raw audio (b, samples)
    becomes a power spectrogram; with ``accept_spec`` the input is a (b,
    time, freq) spectrogram.  The spectrogram is cropped to the patch grid,
    cut into patches of (freq, time) = ``patch_size``, embedded (LN ->
    Linear -> LN) with the 2-D sincos table, and the transformer's norm and
    ``final_norm`` follow each other (vaat.py:199, 329).  Same keyword
    constructor; ``device``, ``dtype`` and ``generator`` as the port's ViT."""

    def __init__(
        self, *, dim: int, depth: int, mlp_dim: int, num_classes: Optional[int] = None, patch_size=16,
        dim_head: int = 64, heads: int = 8, dropout: float = 0.0, accept_spec: bool = False,
        accept_spec_time_first: bool = True, spec_n_fft: int = 128, spec_power: float = 2.0,
        spec_win_length: int = 24, spec_hop_length: Optional[int] = None, spec_pad: int = 0,
        spec_center: bool = True, spec_pad_mode: str = "reflect", num_register_tokens: int = 4,
        device=None, dtype=None, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        self.dim, self.depth, self.patch_size, self.accept_spec = dim, depth, pair(patch_size), accept_spec
        self.num_register_tokens = num_register_tokens
        self.spec_kw = dict(n_fft=spec_n_fft, power=spec_power, win_length=spec_win_length,
                            hop_length=spec_hop_length, pad=spec_pad, center=spec_center, pad_mode=spec_pad_mode)
        patch_dim = self.patch_size[0] * self.patch_size[1]
        self.patch_norm_pre = nn.LayerNorm(patch_dim, eps=LN_EPS, **kw)
        self.patch_proj = nn.Linear(patch_dim, dim, **kw)
        self.patch_norm_post = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.register_tokens = nn.Parameter(torch.empty(num_register_tokens, dim, **kw))
        self.layers = nn.ModuleList(
            nn.ModuleList([GatedAttention(dim, heads=heads, dim_head=dim_head, dropout=dropout, **kw),
                           VATFeedForward(dim, mlp_dim, dropout, **kw)])
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.final_norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.mlp_head = nn.Linear(dim, num_classes, **kw) if exists(num_classes) else None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.register_tokens.normal_(std=1e-2, generator=generator)

    def patches(self, raw_audio_or_spec):
        """(b, h, w, ph * pw) patches of the cropped spectrogram."""
        ph, pw = self.patch_size
        assert raw_audio_or_spec.ndim == (3 if self.accept_spec else 2)
        if self.accept_spec:
            spec = raw_audio_or_spec.transpose(1, 2)  # b t f -> b f t
        else:
            spec = spectrogram(raw_audio_or_spec, **self.spec_kw)
        height, width = spec.shape[-2:]
        spec = spec[..., : height // ph * ph, : width // pw * pw]  # vaat.py:289-296
        b = spec.shape[0]
        h, w = spec.shape[-2] // ph, spec.shape[-1] // pw
        return spec.reshape(b, h, ph, w, pw).permute(0, 1, 3, 2, 4).reshape(b, h, w, ph * pw)

    def forward(self, raw_audio_or_spec, return_hiddens: bool = False):
        """Pooled embeddings or logits, or with ``return_hiddens`` (the
        normed tokens, the stack of the ``depth`` pre-layer states)."""
        patches = self.patches(raw_audio_or_spec)
        b, h, w, _ = patches.shape
        tokens = self.patch_norm_post(self.patch_proj(self.patch_norm_pre(patches.to(self.patch_proj.weight.dtype))))
        pe = posemb_sincos_2d(h, w, self.dim, dtype=tokens.dtype, device=tokens.device)
        tokens = tokens.reshape(b, h * w, self.dim) + pe
        regs = self.register_tokens.to(tokens.dtype).expand(b, -1, -1)
        x = torch.cat([regs, tokens], dim=1)
        hiddens = []
        for attn, ff in self.layers:
            hiddens.append(x)
            x = attn(x) + x
            x = ff(x) + x
        normed = self.final_norm(self.norm(x))
        if return_hiddens:
            return normed, torch.stack(hiddens)
        pooled = normed[:, self.num_register_tokens :].mean(dim=1)
        return self.mlp_head(pooled) if exists(self.mlp_head) else pooled


class VAAT(ActionTokens):
    """reference vaat.py:421 — same keyword constructor (``vit`` and ``ast``
    modules or dicts of their kwargs); ``device``, ``dtype`` and
    ``generator`` as :class:`~.vat.VAT`'s."""

    def __init__(
        self, *, vit, ast, dim: int, depth: int, heads: int, dim_head: int, dim_action: int, mlp_dim: int,
        num_image_views: Optional[int] = None, num_audio_views: Optional[int] = None,
        num_tasks: Optional[int] = None, dim_extra_token: Optional[int] = None, num_register_tokens: int = 4,
        action_chunk_len: int = 7, time_seq_len: int = 1, dropout: float = 0.0, add_self_attn: bool = True,
        self_attn_heads: int = 4, self_attn_dim_head: int = 32,
        ast_layer_indices: Optional[Sequence[int]] = None, vit_layer_indices: Optional[Sequence[int]] = None,
        num_advantage_bins: int = 0, device=None, dtype=None, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        if isinstance(vit, dict):
            vit = ViT(**vit, **kw, generator=generator)
        if isinstance(ast, dict):
            ast = AST(**ast, **kw, generator=generator)
        self.vit, self.ast = vit, ast
        assert vit.depth == depth or exists(vit_layer_indices)
        assert ast.depth == depth or exists(ast_layer_indices)
        self.vit_indices = tuple(default(vit_layer_indices, range(depth)))
        self.ast_indices = tuple(default(ast_layer_indices, range(depth)))
        assert len(self.vit_indices) == depth and len(self.ast_indices) == depth
        self.time_seq_len = time_seq_len
        self._init_action(dim=dim, depth=depth, dim_action=dim_action, num_tasks=num_tasks,
                          dim_extra_token=dim_extra_token, num_register_tokens=num_register_tokens,
                          action_chunk_len=action_chunk_len, num_advantage_bins=num_advantage_bins, kw=kw)
        if time_seq_len > 1:
            self.time_pos_emb = nn.Parameter(torch.empty(time_seq_len, vit.dim, **kw))
        if exists(num_image_views) and num_image_views > 1:
            self.image_view_emb = nn.Parameter(torch.empty(num_image_views, vit.dim, **kw))
        if exists(num_audio_views) and num_audio_views > 1:
            self.audio_view_emb = nn.Parameter(torch.empty(num_audio_views, ast.dim, **kw))
        if add_self_attn:
            self.self_attns = nn.ModuleList(
                GatedAttention(dim, heads=self_attn_heads, dim_head=self_attn_dim_head, dropout=dropout, **kw)
                for _ in range(depth))
        self.img_crosses, self.audio_crosses = (
            nn.ModuleList(GatedAttention(dim, ctx, heads=heads, dim_head=dim_head, dropout=dropout, cross_attend=True,
                                         **kw) for _ in range(depth))
            for ctx in (vit.dim, ast.dim))
        self.ffs = nn.ModuleList(VATFeedForward(dim, mlp_dim, dropout, **kw) for _ in range(depth))
        self._reset_action(generator, backbones=("vit", "ast"))

    def forward(self, video_or_image, audio_or_spec, *, extra=None, tasks=None, advantages=None, actions=None,
                return_hiddens: bool = False, freeze_vit: bool = False, freeze_ast: bool = False):
        """``video_or_image`` as :meth:`VAT.forward`'s; ``audio_or_spec``:
        (b, samples) or (b, audio views, samples), with ``accept_spec`` (b,
        time, freq) or (b, audio views, time, freq)."""
        batch = video_or_image.shape[0]
        images, v, t = fold_views(video_or_image, self.time_seq_len)
        if audio_or_spec.ndim == (3 if self.ast.accept_spec else 2):
            audio_or_spec = audio_or_spec[:, None]
        va = audio_or_spec.shape[1]
        audio = audio_or_spec.reshape(-1, *audio_or_spec.shape[2:])

        embed, hiddens = run_backbone(self.vit, images, freeze_vit)
        image_context = trajectory(embed, hiddens, self.vit_indices, v, t,
                                   time_pos_emb=getattr(self, "time_pos_emb", None),
                                   view_emb=getattr(self, "image_view_emb", None))
        audio_embed, audio_hiddens = run_backbone(self.ast, audio, freeze_ast)
        audio_view_emb = getattr(self, "audio_view_emb", None)
        # the learned per-view table must match the audio views fed in (JAX
        # vaat.py:310-320)
        assert audio_view_emb is None or audio_view_emb.shape[0] == va, (
            f"audio has {va} view(s) but num_audio_views={audio_view_emb.shape[0]}")
        audio_context = trajectory(audio_embed, audio_hiddens, self.ast_indices, va, view_emb=audio_view_emb)

        return self.act(batch, [(self.img_crosses, image_context), (self.audio_crosses, audio_context)], extra=extra,
                        tasks=tasks, advantages=advantages, actions=actions, return_hiddens=return_hiddens)
