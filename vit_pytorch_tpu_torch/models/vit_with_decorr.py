"""ViT with a decorrelation auxiliary loss (reference vit_with_decorr.py:
190-280), port of ``vit_pytorch_tpu/models/vit_with_decorr.py``.

The forward returns ``(logits, decorr_aux_loss)``: in training (or with
``return_decorr_aux_loss=True``) :class:`DecorrelationLoss` penalises the
off-diagonal entries of the Gram matrix of each attention and FF call's
normed input (or, with ``decorr_layer_outputs_across_depth``, of the calls'
outputs across depth), optionally over a random subset of the tokens,
random orthogonal subspaces and mean-centred (reference :28-102); else the
loss is 0.  ``parallel/train.py::make_train_step(aux_loss_weight=)`` adds it
to the cross-entropy.  The token subset is drawn in training from the
caller's ``generator`` (else from the global generator of the tokens'
device, which ``make_train_step`` seeds each step), as the JAX model draws
it from its ``decorr`` rng; outside training the first tokens are taken,
as the JAX model does without that rng.

The attention calls ``ops/attention.py::dot_product_attention`` itself (the
composite below 1,024 keys, as in JAX): no kernel of the port runs here.
The subspace projections are a buffer outside the state_dict (the JAX
model keeps them in its ``buffers`` collection, drawn from its own RNG):
``decorr_loss.proj``, (num_subspaces, dim, dim_subspace), orthogonal
columns.

The state_dict is the reference's (``to_patch_embedding.1|2|3``,
``pos_embedding`` (1, num_patches + 1, dim), ``cls_token``,
``transformer.layers.N.0.norm|to_qkv|to_out.0``,
``transformer.layers.N.1.norm|net.0|net.3``, ``transformer.norm``,
``mlp_head``): ``utils/convert.py::convert_vit_with_decorr``,
``utils/from_jax.py::vit_with_decorr_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import Activation, LayerNorm
from ..nn.patch import PatchEmbedding
from ..ops.attention import dot_product_attention
from ..utils.helpers import default, default_device, exists, pair
from .vit import init_modules_like_jax


def sample_scores(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The standard-normal scores whose smallest pick the sampled tokens,
    from ``generator`` (on its device), else from the global generator of
    ``device``."""
    return torch.randn(shape, generator=generator, device=generator.device if exists(generator) else device)


class DecorrelationLoss(nn.Module):
    """reference vit_with_decorr.py:28-102."""

    def __init__(self, sample_frac: float = 1.0, soft_validate_num_sampled: bool = False, use_subspace: bool = False,
                 dim: Optional[int] = None, dim_subspace: int = 64, num_subspaces: int = 1,
                 mean_center: bool = False, across_depth: bool = False, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sample_frac, self.soft_validate_num_sampled = sample_frac, soft_validate_num_sampled
        self.use_subspace, self.dim_subspace = use_subspace, dim_subspace
        self.mean_center, self.across_depth = mean_center, across_depth
        if use_subspace:
            assert exists(dim), "dim must be passed in if using subspaces"
            assert dim_subspace < dim
            proj = torch.empty(num_subspaces, dim, dim_subspace, device=device)
            for p in proj:
                nn.init.orthogonal_(p, generator=generator)
            self.register_buffer("proj", proj, persistent=False)

    def forward(self, tokens, generator: Optional[torch.Generator] = None):
        *lead, seq_len, dim = tokens.shape
        if self.sample_frac < 1.0 and not self.across_depth:
            num_sampled = int(seq_len * self.sample_frac)
            assert self.soft_validate_num_sampled or num_sampled >= 2
            if num_sampled <= 1:
                return torch.zeros((), device=tokens.device)
            flat = tokens.reshape(-1, seq_len, dim)
            if self.training:
                idx = sample_scores(flat.shape[:2], generator, tokens.device).argsort(dim=-1)[:, :num_sampled]
                idx = idx.to(tokens.device)
                flat = torch.gather(flat, 1, idx[..., None].expand(-1, -1, dim))
            else:
                flat = flat[:, :num_sampled]
            tokens = flat.reshape(*lead, num_sampled, dim)
        if self.use_subspace:
            tokens = torch.einsum("...nd,sde->...sne", tokens, self.proj.to(tokens.dtype))
            dim = self.dim_subspace
        else:
            tokens = tokens[..., None, :, :]
        if self.mean_center:
            tokens = tokens - tokens.mean(dim=-2, keepdim=True)
        dist = torch.einsum("...snd,...sne->...sde", tokens, tokens) / tokens.shape[-2]
        off_diagonal = 1.0 - torch.eye(dim, device=tokens.device, dtype=tokens.dtype)
        loss = (dist.square() * off_diagonal / ((dim - 1) * dim)).sum(dim=(-1, -2, -3))
        while loss.ndim > 1:
            loss = loss.sum(dim=0)
        return loss.mean()


class Attention(nn.Module):
    """The ViT's attention (reference vit_with_decorr.py:122-156), also
    returning its normed input."""

    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads, self.dropout = heads, dropout
        self.norm = LayerNorm(dim, **kw)
        self.to_qkv = nn.Linear(dim, heads * dim_head * 3, bias=False, **kw)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim, **kw), nn.Dropout(dropout))

    def forward(self, x):
        b, n, _ = x.shape
        normed = self.norm(x)
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2) for t in self.to_qkv(normed).chunk(3, dim=-1))
        out = dot_product_attention(q, k, v, dropout_rate=self.dropout if self.training else 0.0)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1)), normed


class FeedForward(nn.Module):
    """reference vit_with_decorr.py:105-120: its LayerNorm outside ``net``,
    also returning its normed input."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm = LayerNorm(dim, **kw)
        self.net = nn.Sequential(nn.Linear(dim, hidden_dim, **kw), Activation(), nn.Dropout(dropout),
                                 nn.Linear(hidden_dim, dim, **kw), nn.Dropout(dropout))

    def forward(self, x):
        normed = self.norm(x)
        return self.net(normed), normed


class ViT(nn.Module):
    """reference vit_with_decorr.py:190 — same keyword constructor, with
    ``device``, ``dtype`` and ``generator`` as in ``models/vit.py`` (the
    position embedding and the class token unit normal; ``generator`` also
    draws the subspace projections)."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 pool: str = "cls", channels: int = 3, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, decorr_sample_frac: float = 1.0, decorr_use_subspace: bool = False,
                 decorr_dim_subspace: int = 64, decorr_num_subspaces: int = 1, decorr_mean_center: bool = False,
                 decorr_layer_outputs_across_depth: bool = False, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in ("cls", "mean"):
            raise ValueError("pool type must be either cls or mean")
        kw = {"device": default_device(device), "dtype": dtype}
        num_patches = (image_height // patch_height) * (image_width // patch_width)
        self.pool, self.decorr_sample_frac = pool, decorr_sample_frac
        self.across_depth = decorr_layer_outputs_across_depth
        self.to_patch_embedding = PatchEmbedding((patch_height, patch_width), channels * patch_height * patch_width,
                                                 dim, **kw)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, heads, dim_head, dropout, **kw), FeedForward(dim, mlp_dim, dropout, **kw)])
            for _ in range(depth)
        )
        self.transformer.norm = LayerNorm(dim, **kw)
        self.decorr_loss = DecorrelationLoss(decorr_sample_frac, use_subspace=decorr_use_subspace, dim=dim,
                                             dim_subspace=decorr_dim_subspace, num_subspaces=decorr_num_subspaces,
                                             mean_center=decorr_mean_center,
                                             across_depth=decorr_layer_outputs_across_depth, device=kw["device"],
                                             generator=generator)
        self.mlp_head = nn.Linear(dim, num_classes, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        init_modules_like_jax(self, generator)
        self.pos_embedding.normal_(generator=generator)
        self.cls_token.normal_(generator=generator)

    def forward(self, img, return_decorr_aux_loss: Optional[bool] = None,
                generator: Optional[torch.Generator] = None):
        return_aux = default(return_decorr_aux_loss, self.training) and self.decorr_sample_frac > 0.0
        x = self.to_patch_embedding(img)
        n = x.shape[1]
        x = torch.cat([self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1), x], dim=1)
        x = self.dropout(x + self.pos_embedding[:, : n + 1].to(x.dtype))
        normed_inputs, layer_outputs = [], []
        for attn, ff in self.transformer.layers:
            attn_out, attn_normed = attn(x)
            x = attn_out + x
            ff_out, ff_normed = ff(x)
            x = ff_out + x
            layer_outputs += [attn_out, ff_out]
            normed_inputs += [attn_normed, ff_normed]
        x = self.transformer.norm(x)

        aux = torch.zeros((), device=x.device)
        if return_aux:
            # across depth: (l, b, n, d) -> (n, b, l, d)
            inputs = torch.stack(layer_outputs).permute(2, 1, 0, 3) if self.across_depth else torch.stack(normed_inputs)
            aux = self.decorr_loss(inputs, generator)
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return self.mlp_head(x), aux
