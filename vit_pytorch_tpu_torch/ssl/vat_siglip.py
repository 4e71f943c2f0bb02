"""SigLIPVAT (reference vat_siglip.py:99-521), port of
``vit_pytorch_tpu/ssl/vat_siglip.py``: VAT on a SigLIP vision tower, and
the import of a Hugging Face SigLIP checkpoint into the tower
(vat_siglip.py:273-343).

SigLIP uses LayerNorm eps 1e-6 and the tanh GELU in every dtype
(``jax.nn.gelu(approximate=True)``), biased q and kv projections and no
cls token; its heads are ``dim / heads`` wide (72 at so400m), so on the
card its self-attention takes the composite.  The action transformer's
cross-attention (8 heads of 64 by default, gated) takes the flash kernels at
m >= 1,025 context tokens, the short kernel at m = 1,024 and the composite
below, as ``ops/attention.py::dot_product_attention`` routes it.

``state_dict()``: ``vit.*`` (the :class:`SigLIP`: ``patch_embed``,
``pos_embed``, ``layers.N.0.{norm,to_q,to_kv,to_out}``,
``layers.N.1.{norm,fc1,fc2}``, ``norm``), ``films.N.proj``,
``self_attns.N``, ``crosses.N`` (with ``norm_context`` and
``to_out_gates``), ``ffs.N``, ``final_norm``, ``to_pred_action``, and the
tables; ``utils/from_jax.py::vat_family_state_dict_from_jax`` writes it,
and :func:`load_siglip` writes the tower's from the HF layout.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.vit import init_modules_like_jax
from ..nn.patch import patchify_2d
from ..ops.attention import dot_product_attention
from ..utils.helpers import default, default_device, exists
from .vat import ActionTokens, fold_views, run_backbone, split_heads, trajectory

SIGLIP_EPS = 1e-6


class SigLIPAttention(nn.Module):
    """reference vat_siglip.py:27-85: pre-LN attention with biased q and kv,
    optional cross-attention (its context with a LayerNorm of its own) and
    per-head sigmoid output gates."""

    def __init__(self, dim: int, dim_context: Optional[int] = None, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, norm_eps: float = SIGLIP_EPS, gate_attn: bool = False, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.heads, self.is_cross, self.gate_attn = heads, exists(dim_context), gate_attn
        self.norm = nn.LayerNorm(dim, eps=norm_eps, **kw)
        if self.is_cross:
            self.norm_context = nn.LayerNorm(dim_context, eps=norm_eps, **kw)
        self.to_q = nn.Linear(dim, inner, **kw)
        self.to_kv = nn.Linear(default(dim_context, dim), inner * 2, **kw)
        if gate_attn:
            self.to_out_gates = nn.Linear(dim, heads, **kw)
        self.to_out = nn.Linear(inner, dim, **kw)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, context=None):
        x = self.norm(x)
        if self.is_cross:
            assert exists(context)
            context = self.norm_context(context)
        else:
            context = x
        q = split_heads(self.to_q(x), self.heads)
        k, v = (split_heads(t, self.heads) for t in self.to_kv(context).chunk(2, dim=-1))
        out = dot_product_attention(q, k, v)
        if self.gate_attn:
            out = out * torch.sigmoid(self.to_out_gates(x)).transpose(1, 2)[..., None]
        b, _, n, _ = out.shape
        return self.dropout(self.to_out(out.transpose(1, 2).reshape(b, n, -1)))


class SigLIPFeedForward(nn.Module):
    """reference vat_siglip.py:87-97: LN -> fc1 -> tanh GELU -> fc2."""

    def __init__(self, dim: int, dim_inner: int, norm_eps: float = SIGLIP_EPS, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm = nn.LayerNorm(dim, eps=norm_eps, **kw)
        self.fc1 = nn.Linear(dim, dim_inner, **kw)
        self.fc2 = nn.Linear(dim_inner, dim, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x)), approximate="tanh"))


class SigLIP(nn.Module):
    """reference vat_siglip.py:99-151 — same keyword constructor: the
    so400m/14 @224 tower by default (dim 1152, depth 27, 16 heads, mlp
    4304).  ``device``, ``dtype`` and ``generator`` as the port's ViT."""

    def __init__(self, *, image_size: int = 224, patch_size: int = 14, dim: int = 1152, depth: int = 27,
                 heads: int = 16, mlp_dim: int = 4304, norm_eps: float = SIGLIP_EPS, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        self.dim, self.depth, self.patch_size = dim, depth, patch_size
        num_patches = (image_size // patch_size) ** 2
        self.patch_embed = nn.Linear(3 * patch_size * patch_size, dim, **kw)
        self.pos_embed = nn.Parameter(torch.empty(num_patches, dim, **kw))
        self.layers = nn.ModuleList(
            nn.ModuleList([SigLIPAttention(dim, heads=heads, dim_head=dim // heads, norm_eps=norm_eps, **kw),
                           SigLIPFeedForward(dim, mlp_dim, norm_eps, **kw)])
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim, eps=norm_eps, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embed.normal_(generator=generator)

    def forward(self, x, return_hiddens: bool = False):
        """(b, c, h, w) -> the normed tokens (b, n, dim), with
        ``return_hiddens`` also the stack of the pre-layer states."""
        p = self.patch_size
        x = self.patch_embed(patchify_2d(x, p, p))
        x = x + self.pos_embed[: x.shape[1]].to(x.dtype)
        hiddens = []
        for attn, ff in self.layers:
            hiddens.append(x)
            x = attn(x) + x
            x = ff(x) + x
        out = self.norm(x)
        return (out, torch.stack(hiddens)) if return_hiddens else out


def download_siglip(repo_id: str = "google/siglip-so400m-patch14-224", folder: str = "checkpoints/siglip") -> str:
    """Download the SigLIP checkpoint from the HF hub like reference
    vat_siglip.py:277-285 (``snapshot_download`` of ``config.json`` and
    ``model.safetensors``, skipped when the weights file is there) and
    return the local safetensors path, for :func:`load_siglip`.  The
    ``huggingface_hub`` import happens here, at call time."""
    from pathlib import Path

    weights = Path(folder) / "model.safetensors"
    if not weights.exists():
        from huggingface_hub import snapshot_download

        snapshot_download(repo_id=repo_id, local_dir=Path(folder),
                          allow_patterns=["config.json", "model.safetensors"])
    return str(weights)


_PALIGEMMA = "paligemma_with_expert.paligemma.model.vision_tower.vision_model."


def _hf_tensors(source) -> dict:
    """{name: f32 tensor} from a local safetensors path, an HF repo id or a
    {name: array or tensor} dict."""
    if isinstance(source, (str, os.PathLike)):
        source = str(source)
        if not os.path.exists(source):
            # only a plain namespace/repo goes to the hub; a mistyped local
            # path fails here instead of asking the hub for a nonsense repo
            if source.count("/") == 1 and not source.endswith((".safetensors", ".json")):
                source = download_siglip(repo_id=source)
            else:
                raise FileNotFoundError(
                    f"load_siglip: {source!r} does not exist locally and does not look like an HF repo id "
                    "(namespace/repo)")
        from safetensors import safe_open

        with safe_open(source, framework="pt") as f:
            return {k: f.get_tensor(k).float() for k in f.keys()}
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))).float()
            for k, v in source.items()}


def load_siglip(source, depth: int = 27) -> dict[str, torch.Tensor]:
    """An HF SigLIP vision tower -> the :class:`SigLIP`'s ``state_dict``
    (f32 CPU tensors; ``model.vit.load_state_dict(load_siglip(path))``), the
    remap of vat_siglip.py:273-343: q_proj into ``to_q``, k_proj and v_proj
    stacked into ``to_kv``, the patch conv (d, c, p, p) as the Linear of
    the (p1 p2 c) patch flattening.  ``source``: a local safetensors path,
    a {name: array or tensor} dict, or an HF repo id (``namespace/repo``,
    downloaded by :func:`download_siglip`).  Names may carry the
    ``vision_model.`` or PaliGemma's vision-tower prefix."""
    tensors = _hf_tensors(source)
    prefix = ""
    if any(k.startswith(_PALIGEMMA) for k in tensors):
        prefix = _PALIGEMMA
    elif any(k.startswith("vision_model") for k in tensors):
        prefix = "vision_model."
    t = lambda name: tensors[prefix + name]

    pw = t("embeddings.patch_embedding.weight")
    out = {
        "patch_embed.weight": pw.permute(0, 2, 3, 1).reshape(pw.shape[0], -1).contiguous(),
        "patch_embed.bias": t("embeddings.patch_embedding.bias"),
        "pos_embed": t("embeddings.position_embedding.weight"),
        "norm.weight": t("post_layernorm.weight"),
        "norm.bias": t("post_layernorm.bias"),
    }
    for i in range(depth):
        pre, attn, ff = f"encoder.layers.{i}", f"layers.{i}.0", f"layers.{i}.1"
        pairs = {
            f"{attn}.norm": f"{pre}.layer_norm1", f"{attn}.to_q": f"{pre}.self_attn.q_proj",
            f"{attn}.to_out": f"{pre}.self_attn.out_proj", f"{ff}.norm": f"{pre}.layer_norm2",
            f"{ff}.fc1": f"{pre}.mlp.fc1", f"{ff}.fc2": f"{pre}.mlp.fc2",
        }
        for ours, theirs in pairs.items():
            for leaf in ("weight", "bias"):
                out[f"{ours}.{leaf}"] = t(f"{theirs}.{leaf}")
        for leaf in ("weight", "bias"):
            out[f"{attn}.to_kv.{leaf}"] = torch.cat([t(f"{pre}.self_attn.k_proj.{leaf}"),
                                                     t(f"{pre}.self_attn.v_proj.{leaf}")])
    return out


class SigLIPVAT(ActionTokens):
    """reference vat_siglip.py:170 — same keyword constructor, its defaults
    π0's action head on SigLIP so400m: dim 512, depth 27, 8 cross heads of
    64, 4 self heads of 32, mlp 2048, a chunk of 50 actions of 32 dims, 4
    register tokens.  ``device``, ``dtype`` and ``generator`` as
    :class:`~.vat.VAT`'s (the tower initialised from the generator too)."""

    def __init__(
        self, *, dim: int = 512, depth: int = 27, heads: int = 8, dim_head: int = 64, dim_action: int = 32,
        mlp_dim: int = 2048, num_views: int = 1, num_tasks: Optional[int] = None,
        dim_extra_token: Optional[int] = None, num_register_tokens: int = 4, action_chunk_len: int = 50,
        time_seq_len: int = 1, dropout: float = 0.0, add_self_attn: bool = True, self_attn_heads: int = 4,
        self_attn_dim_head: int = 32, vit_layer_indices: Optional[Sequence[int]] = None,
        num_advantage_bins: int = 0, siglip_image_size: int = 224, siglip_patch_size: int = 14,
        siglip_dim: int = 1152, siglip_depth: int = 27, siglip_heads: int = 16, siglip_mlp_dim: int = 4304,
        siglip_norm_eps: float = SIGLIP_EPS, device=None, dtype=None, generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kw = {"device": default_device(device), "dtype": dtype}
        self.vit = SigLIP(image_size=siglip_image_size, patch_size=siglip_patch_size, dim=siglip_dim,
                          depth=siglip_depth, heads=siglip_heads, mlp_dim=siglip_mlp_dim, norm_eps=siglip_norm_eps,
                          **kw, generator=generator)
        self.layer_indices = tuple(default(vit_layer_indices, range(depth)))
        assert len(self.layer_indices) == depth
        self.time_seq_len, self.num_views = time_seq_len, num_views
        self._init_action(dim=dim, depth=depth, dim_action=dim_action, num_tasks=num_tasks,
                          dim_extra_token=dim_extra_token, num_register_tokens=num_register_tokens,
                          action_chunk_len=action_chunk_len, num_advantage_bins=num_advantage_bins, kw=kw)
        if time_seq_len > 1:
            self.time_pos_emb = nn.Parameter(torch.empty(time_seq_len, siglip_dim, **kw))
        if num_views > 1:
            self.view_emb = nn.Parameter(torch.empty(num_views, siglip_dim, **kw))
        if add_self_attn:
            self.self_attns = nn.ModuleList(
                SigLIPAttention(dim, heads=self_attn_heads, dim_head=self_attn_dim_head, dropout=dropout, **kw)
                for _ in range(depth))
        self.crosses = nn.ModuleList(
            SigLIPAttention(dim, siglip_dim, heads=heads, dim_head=dim_head, dropout=dropout, gate_attn=True, **kw)
            for _ in range(depth))
        self.ffs = nn.ModuleList(SigLIPFeedForward(dim, mlp_dim, **kw) for _ in range(depth))
        self._reset_action(generator)

    def forward(self, video_or_image, *, extra=None, tasks=None, advantages=None, actions=None,
                return_hiddens: bool = False, freeze_vit: bool = False):
        """As :meth:`~.vat.VAT.forward`."""
        batch = video_or_image.shape[0]
        images, v, t = fold_views(video_or_image, self.time_seq_len)
        embed, hiddens = run_backbone(self.vit, images, freeze_vit)
        context = trajectory(embed, hiddens, self.layer_indices, v, t, time_pos_emb=getattr(self, "time_pos_emb", None),
                             view_emb=getattr(self, "view_emb", None))
        return self.act(batch, [(self.crosses, context)], extra=extra, tasks=tasks, advantages=advantages,
                        actions=actions, return_hiddens=return_hiddens)
