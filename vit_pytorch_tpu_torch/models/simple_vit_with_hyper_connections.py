"""SimpleViT with hyper-connections (reference
simple_vit_with_hyper_connections.py:166-233), port of
``vit_pytorch_tpu/models/simple_vit_with_hyper_connections.py``: the tokens
(patches and register tokens) run as ``num_residual_streams`` residual
streams; before each block a ``HyperConnection`` mixes the streams into the
block's input and the rest (static and dynamic alpha, the width
connection), after it adds the block's output to each stream with a static
and dynamic beta (the depth connection).  The streams are summed before the
final LayerNorm, and the registers stripped before the mean pool.

The state_dict keeps the reference's layout (``register_tokens``,
``transformer.layers.N.0|2`` the attention's and the FF's
``HyperConnection``, ``.1`` the attention (``norm|to_qkv|to_out``), ``.3.net.
0|1|3`` the FF), which ``utils/convert.py::
convert_simple_vit_with_hyper_connections`` maps.  The block's input is a
strided view of the mix (one stream of it); on the card in bf16 the
attention-block kernels take it (their Function makes x contiguous once).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import LN_EPS, Attention, FeedForward, LayerNorm
from ..utils.helpers import default_device
from .simple_vit import SimpleViTBase, image_grid


class HyperConnection(nn.Module):
    """reference :33-84 (Appendix J, Algorithm 2, dynamic only), the JAX
    ``HyperConnection`` (:18-66), with its initialisation: ``static_alpha``
    (e, e + 1) the one-hot of stream ``layer_index % e`` beside the
    identity, ``static_beta`` ones, the dynamic maps zeros and their scales
    1e-2, a bias-free LayerNorm."""

    def __init__(self, dim: int, num_residual_streams: int, layer_index: int, *, device=None, dtype=None):
        super().__init__()
        e = num_residual_streams
        kw = {"device": device, "dtype": dtype}
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, bias=False, **kw)
        self.static_beta = nn.Parameter(torch.ones(e, **kw))
        alpha0 = torch.zeros(e, 1, **kw)
        alpha0[layer_index % e, 0] = 1.0
        self.static_alpha = nn.Parameter(torch.cat([alpha0, torch.eye(e, **kw)], dim=1))
        self.dynamic_alpha_fn = nn.Parameter(torch.zeros(dim, e + 1, **kw))
        self.dynamic_alpha_scale = nn.Parameter(torch.full((), 1e-2, **kw))
        self.dynamic_beta_fn = nn.Parameter(torch.zeros(dim, **kw))
        self.dynamic_beta_scale = nn.Parameter(torch.full((), 1e-2, **kw))

    def width_connection(self, residuals):
        """(b, n, e, d) streams -> the block's input (b, n, d), a strided
        view of the mix, the other e mixed streams and beta (b, n, e)."""
        normed = self.norm(residuals)
        wc = torch.tanh(normed @ self.dynamic_alpha_fn.to(normed.dtype))
        alpha = wc * self.dynamic_alpha_scale + self.static_alpha.to(normed.dtype)
        dc = torch.tanh(normed @ self.dynamic_beta_fn.to(normed.dtype))
        beta = dc * self.dynamic_beta_scale + self.static_beta.to(normed.dtype)
        mix = torch.einsum("...ef,...ed->...fd", alpha, residuals)
        return mix[..., 0, :], mix[..., 1:, :], beta

    def depth_connection(self, branch_output, residuals, beta):
        return torch.einsum("bnd,bne->bned", branch_output, beta) + residuals


class HyperTransformer(nn.Module):
    """The layers ``[attn_hyper, attn, ff_hyper, ff]`` and the final
    LayerNorm over the summed streams."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, num_residual_streams: int, *,
                 flash: Optional[bool], device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        hyper = lambda i: HyperConnection(dim, num_residual_streams, i, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                hyper(i),
                Attention(dim, heads=heads, dim_head=dim_head, out_bias=False, simple=True, flash=flash, **kw),
                hyper(i),
                FeedForward(dim, mlp_dim, simple=True, **kw),
            ])
            for i in range(depth)
        )
        self.norm = LayerNorm(dim, **kw)

    def forward(self, x):
        for attn_hyper, attn, ff_hyper, ff in self.layers:
            for hc, block in ((attn_hyper, attn), (ff_hyper, ff)):
                branch, residuals, beta = hc.width_connection(x)
                x = hc.depth_connection(block(branch), residuals, beta)
        return self.norm(x.sum(dim=2))


class SimpleViT(SimpleViTBase):
    """reference simple_vit_with_hyper_connections.py:166 — same keyword
    constructor, with ``flash``, ``device``, ``dtype`` and ``generator`` as
    in ``models/simple_vit.py``; the register tokens drawn from a unit
    normal."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 num_residual_streams: int, num_register_tokens: int = 4, channels: int = 3, dim_head: int = 64,
                 flash: Optional[bool] = None, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        device = default_device(device)
        transformer = HyperTransformer(dim, depth, heads, dim_head, mlp_dim, num_residual_streams, flash=flash,
                                       device=device, dtype=dtype)
        super().__init__(*image_grid(image_size, patch_size), channels=channels, num_classes=num_classes, dim=dim,
                         depth=depth, heads=heads, mlp_dim=mlp_dim, dim_head=dim_head, flash=flash,
                         transformer=transformer, device=device, dtype=dtype, generator=generator)
        self.num_residual_streams = num_residual_streams
        self.register_tokens = nn.Parameter(torch.empty(num_register_tokens, dim, device=device, dtype=dtype))
        self.register_tokens.data.normal_(generator=generator)

    def forward(self, img):
        x = self.embed(img)
        b, n, d = x.shape
        r = self.register_tokens.to(x.dtype).expand(b, -1, -1)
        x = torch.cat([x, r], dim=1)
        x = x[:, :, None, :].expand(-1, -1, self.num_residual_streams, d)
        x = self.transformer(x)
        return self.linear_head(self.pool(x[:, :n]))
