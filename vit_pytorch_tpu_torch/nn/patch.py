"""Patch embedding and patch dropout, port of ``vit_pytorch_tpu/nn/patch.py``.

The canonical form is
``Rearrange('b c (h p1) (w p2) -> b (h w) (p1 p2 c)') -> LN -> Linear -> LN``
(reference vit.py:99-104), with its 1-D (vit_1d.py:81) and 3-D
(vit_3d.py:95-101) patchify.  It stays plain PyTorch: the JAX package leaves
it to XLA outside any kernel too.
"""

from __future__ import annotations

from typing import Optional

import torch
from einops import rearrange
from torch import nn

from .blocks import LN_EPS


def patchify_1d(series: torch.Tensor, p: int) -> torch.Tensor:
    """(b, c, n*p) -> (b, n, p*c) (reference vit_1d.py:81)."""
    return rearrange(series, "b c (n p) -> b n (p c)", p=p)


def patchify_2d(img: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """(b, c, h*p1, w*p2) -> (b, h*w, p1*p2*c), channel-last patch flattening
    matching the reference's einops pattern (vit.py:100)."""
    return rearrange(img, "b c (h p1) (w p2) -> b (h w) (p1 p2 c)", p1=p1, p2=p2)


def patchify_3d(video: torch.Tensor, pf: int, p1: int, p2: int) -> torch.Tensor:
    """(b, c, f*pf, h*p1, w*p2) -> (b, f*h*w, pf*p1*p2*c) (reference
    vit_3d.py:95-101)."""
    return rearrange(video, "b c (f pf) (h p1) (w p2) -> b (f h w) (pf p1 p2 c)", pf=pf, p1=p1, p2=p2)


_PATCHIFY = {1: patchify_1d, 2: patchify_2d, 3: patchify_3d}


class Patchify(nn.Module):
    """:func:`patchify_1d`, :func:`patchify_2d` or :func:`patchify_3d` by
    the length of ``patch_size``: (p,), (p1, p2) or (pf, p1, p2)."""

    def __init__(self, *patch_size: int):
        super().__init__()
        self.patch_size = patch_size

    def forward(self, x):
        return _PATCHIFY[len(self.patch_size)](x, *self.patch_size)


class PatchEmbedding(nn.Sequential):
    """patchify -> LN -> Linear -> LN (reference vit.py:99-104), indexed as
    the reference's ``to_patch_embedding`` so that its ``state_dict`` keys
    are ``1.*``, ``2.*``, ``3.*``.  The modules after the first embed raw
    patches, as the JAX ``PatchEmbedding`` does (reference mae.py:28-31
    slices the same way).  ``patch_size``: (p,), (p1, p2) or (pf, p1, p2)
    for 1-D, 2-D or 3-D inputs.  ``norm_input``/``norm_output`` (the JAX
    :93-132) drop the LN before or after the Linear (an ``nn.Identity``
    keeps the indices); ``norm_bias=False``: bias-free LNs."""

    def __init__(self, patch_size, patch_dim: int, dim: int, *, norm_input: bool = True, norm_output: bool = True,
                 norm_bias: bool = True, device=None, dtype=None):
        kw = {"device": device, "dtype": dtype}
        norm = lambda d, on: nn.LayerNorm(d, eps=LN_EPS, bias=norm_bias, **kw) if on else nn.Identity()
        super().__init__(
            Patchify(*patch_size),
            norm(patch_dim, norm_input),
            nn.Linear(patch_dim, dim, **kw),
            norm(dim, norm_output),
        )


class PatchDropout(nn.Module):
    """Keep a random subset of the tokens at train time (reference
    simple_vit_with_patch_dropout.py:27-44, the JAX :68-90): in training
    ``max(1, int(n * (1 - prob)))`` tokens of each sample, those with the
    largest of (b, n) standard-normal scores drawn from ``generator`` (on
    its device; without one from the global generator of x's device, which
    ``make_train_step`` seeds each step), in the order of their scores; the
    identity in eval mode or at ``prob`` 0."""

    def __init__(self, prob: float):
        super().__init__()
        if not 0.0 <= prob < 1.0:
            raise ValueError(f"PatchDropout: prob {prob} is not in [0, 1)")
        self.prob = prob

    def keep_indices(self, b: int, n: int, generator: Optional[torch.Generator] = None, device=None):
        """The (b, num_keep) indices of the kept tokens."""
        num_keep = max(1, int(n * (1 - self.prob)))
        scores = torch.randn((b, n), generator=generator,
                             device=generator.device if generator is not None else device)
        idx = scores.topk(num_keep, dim=-1).indices
        return idx if device is None else idx.to(device)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if not self.training or self.prob == 0.0:
            return x
        b, n, d = x.shape
        idx = self.keep_indices(b, n, generator, x.device)
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, d))
