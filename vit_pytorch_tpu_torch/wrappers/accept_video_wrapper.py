"""AcceptVideoWrapper: an image network over video frames (reference
accept_video_wrapper.py:27-180), port of
``vit_pytorch_tpu/wrappers/accept_video_wrapper.py``.

Time folds into the batch ((b c t h w) -> ((b t) c h w)), the wrapped net
runs once on all the frames (any method, by ``forward_function``), and each
output tensor is reshaped back to (b, t, ...); the output at
``output_pos_add_pos_emb`` may be projected (``proj_embed_to_dim``) and get
a learned time embedding (``add_time_pos_emb``), along its second axis or,
with ``embed_is_channel_first``, broadcast over its trailing axes.  With
``moss`` (a dict of ``models/vivit_with_moss.py::MOSS`` keywords, or a
module) that output, (b, t, num_cls + num_patches, d) tokens, has its
class tokens split off, :class:`~..models.vivit_with_moss.MOSS` run over
the (b, t, h, w, d) patch grid and the class tokens put back (the JAX
wrapper, :112-139); the patch size is ``patch_size``, else the wrapped
net's ``patch_size``, else its ``vit.patch_size``.  The wrapped net runs as
it would alone: a port ViT takes its kernels on all b * t frames in one
call; MOSS is plain modules.

``state_dict()``: ``image_net.*``, ``embed_proj``, ``pos_emb`` and
``moss.*``, the JAX names;
``utils/from_jax.py::accept_video_wrapper_state_dict_from_jax`` writes the
wrapper's own.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..models.vivit_with_moss import MOSS
from ..utils.helpers import default, default_device, exists, pair


class AcceptVideoWrapper(nn.Module):
    """reference accept_video_wrapper.py:27 — same keyword constructor.
    ``dim_emb`` is the width of the output at ``output_pos_add_pos_emb``
    (the input width of ``embed_proj``).  ``device``, ``dtype`` and
    ``generator`` place and seed the wrapper's own parameters (``pos_emb``
    normal with std 1e-2, ``embed_proj`` the JAX package's Linear
    initialisation, a ``moss`` dict's MOSS too)."""

    def __init__(
        self, image_net: nn.Module, forward_function: str = "forward", add_time_pos_emb: bool = False,
        dim_emb: Optional[int] = None, time_seq_len: Optional[int] = None, embed_is_channel_first: bool = False,
        output_pos_add_pos_emb: int = 0, proj_embed_to_dim: Optional[int] = None,
        patch_size: Optional[Union[int, Tuple[int, int]]] = None, moss=None, *, device=None, dtype=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.image_net = image_net
        self.forward_function = "forward" if forward_function == "__call__" else forward_function
        self.add_time_pos_emb, self.time_seq_len = add_time_pos_emb, time_seq_len
        self.embed_is_channel_first, self.output_pos_add_pos_emb = embed_is_channel_first, output_pos_add_pos_emb
        kw = {"device": default_device(device), "dtype": dtype}
        self.embed_proj = None
        if exists(proj_embed_to_dim):
            assert exists(dim_emb), "`dim_emb` must be passed in"
            self.embed_proj = nn.Linear(dim_emb, proj_embed_to_dim, **kw)
        self.pos_emb = None
        if add_time_pos_emb:
            assert exists(dim_emb) and exists(time_seq_len)
            self.pos_emb = nn.Parameter(torch.empty(time_seq_len, default(proj_embed_to_dim, dim_emb), **kw))
        self.patch_size = patch_size
        self.moss = MOSS(**moss, **kw) if isinstance(moss, dict) else moss
        self._init_moss = isinstance(moss, dict)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        from ..models.vit import init_modules_like_jax

        if exists(self.embed_proj):
            init_modules_like_jax(self.embed_proj, generator)
        if exists(self.pos_emb):
            self.pos_emb.normal_(std=1e-2, generator=generator)
        if self._init_moss:
            init_modules_like_jax(self.moss, generator)

    def forward(self, video, eval_with_no_grad: bool = False, forward_kwargs=None):
        """``video`` (b, c, t, h, w) -> the net's outputs with (b, t) leading;
        ``eval_with_no_grad`` runs the net without autograd."""
        time = video.shape[2]
        if self.add_time_pos_emb:
            assert time <= self.time_seq_len
        frames = video.transpose(1, 2)  # b t c h w
        frames = frames.reshape(-1, *frames.shape[2:])
        func = getattr(self.image_net, self.forward_function)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not eval_with_no_grad):
            outputs = func(frames, **(forward_kwargs or {}))

        leaves, spec = tree_flatten(outputs)
        leaves = [t.reshape(-1, time, *t.shape[1:]) if isinstance(t, torch.Tensor) and t.numel() > 1 else t
                  for t in leaves]
        pos = self.output_pos_add_pos_emb
        if exists(self.embed_proj):
            leaves[pos] = self.embed_proj(leaves[pos])
        if exists(self.pos_emb):
            embed = leaves[pos]
            extra = embed.ndim - 3
            pe = self.pos_emb[None, : embed.shape[1]]  # (1, t, d)
            if self.embed_is_channel_first:
                pe = pe.reshape(*pe.shape, *(1,) * extra)
            else:
                pe = pe.reshape(*pe.shape[:2], *(1,) * extra, pe.shape[-1])
            leaves[pos] = embed + pe.to(embed.dtype)
        if exists(self.moss):
            patch_size = self.patch_size
            if not exists(patch_size):
                patch_size = getattr(self.image_net, "patch_size", None)
            if not exists(patch_size):
                patch_size = getattr(getattr(self.image_net, "vit", None), "patch_size", None)
            if not exists(patch_size):
                raise ValueError("`patch_size` must be provided for MOSS")
            ph, pw = pair(patch_size)
            num_h, num_w = video.shape[-2] // ph, video.shape[-1] // pw
            embed = leaves[pos]
            num_cls = embed.shape[-2] - num_h * num_w
            cls_tokens, patch_tokens = embed[:, :, :num_cls], embed[:, :, num_cls:]
            b, t = patch_tokens.shape[:2]
            patch_tokens = self.moss(patch_tokens.reshape(b, t, num_h, num_w, -1))
            leaves[pos] = torch.cat([cls_tokens, patch_tokens.reshape(b, t, num_h * num_w, -1)], dim=-2)
        return tree_unflatten(leaves, spec)
