"""SimpleViT with the orthogonal residual update (reference
simple_vit_orthog_residual_update.py:146-206), port of
``vit_pytorch_tpu/models/simple_vit_orthog_residual_update.py``: each
block's output is split into its components along and orthogonal to the
residual stream, and only the orthogonal one is added (with ``learned``,
both, each gated by a sigmoid of a Linear of the block's output).

``double_precision`` follows the JAX package, not the reference's fp64: the
projection runs in an fp32 island, cast back to the stream's dtype (the JAX
docstring :6-9, :25-35).  The state_dict keeps the reference's layout, the
blocks under ``.block`` (``transformer.layers.N.0.block.norm|to_qkv|to_out``,
``transformer.layers.N.1.block.net.0|1|3``; with ``learned`` a
``to_modulation`` Linear beside each block), which
``utils/convert.py::convert_simple_vit_orthog_residual`` maps where
``learned`` is off.  On the card in bf16 every attention call, without a
residual, runs the attention-block kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.blocks import Attention, FeedForward, LayerNorm
from ..utils.helpers import default_device
from .simple_vit import SimpleViTBase, image_grid


def orthog_proj(block_out, residual, high_precision: bool):
    """(parallel, orthogonal) components of ``block_out`` along the unit
    residual, in the residual's dtype, computed in f32 with
    ``high_precision`` (the JAX :25-35)."""
    dtype = residual.dtype
    if high_precision:
        residual, block_out = residual.float(), block_out.float()
    unit = residual / torch.linalg.vector_norm(residual, dim=-1, keepdim=True).clamp_min(1e-12)
    parallel = (block_out * unit).sum(dim=-1, keepdim=True) * unit
    return parallel.to(dtype), (block_out - parallel).to(dtype)


class OrthogonalResidualBlock(nn.Module):
    """reference :72-122: ``block`` with the orthogonal residual update."""

    def __init__(self, block: nn.Module, dim: int, *, double_precision: bool = True, learned: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.block, self.double_precision = block, double_precision
        self.to_modulation = nn.Linear(dim, 2, device=device, dtype=dtype) if learned else None

    def forward(self, x):
        block_out = self.block(x)
        parallel, orthogonal = orthog_proj(block_out, x, self.double_precision)
        if self.to_modulation is None:
            return x + orthogonal
        mod = torch.sigmoid(self.to_modulation(block_out))
        return x + parallel * mod[..., :1] + orthogonal * mod[..., 1:]


class OrthogonalTransformer(nn.Module):
    """The layers (an attention and an FF block each, the SimpleViT blocks
    without the residual add) and the final LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, *, flash: Optional[bool],
                 **orthog):
        super().__init__()
        kw = {"device": orthog["device"], "dtype": orthog["dtype"]}
        self.layers = nn.ModuleList(
            nn.ModuleList([
                OrthogonalResidualBlock(Attention(dim, heads=heads, dim_head=dim_head, out_bias=False, simple=True,
                                                  flash=flash, **kw), dim, **orthog),
                OrthogonalResidualBlock(FeedForward(dim, mlp_dim, simple=True, **kw), dim, **orthog),
            ])
            for _ in range(depth)
        )
        self.norm = LayerNorm(dim, **kw)

    def forward(self, x):
        for attn, ff in self.layers:
            x = ff(attn(x))
        return self.norm(x)


class SimpleViT(SimpleViTBase):
    """reference simple_vit_orthog_residual_update.py:146 — same constructor,
    ``orthog_residual_update_kwargs`` flattened into ``orthog_learned`` and
    ``orthog_double_precision`` as in the JAX model, with ``flash``,
    ``device``, ``dtype`` and ``generator`` as in ``models/simple_vit.py``."""

    def __init__(self, *, image_size, patch_size, num_classes: int, dim: int, depth: int, heads: int, mlp_dim: int,
                 channels: int = 3, dim_head: int = 64, orthog_learned: bool = False,
                 orthog_double_precision: bool = True, flash: Optional[bool] = None, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        device = default_device(device)
        transformer = OrthogonalTransformer(dim, depth, heads, dim_head, mlp_dim, flash=flash,
                                            double_precision=orthog_double_precision, learned=orthog_learned,
                                            device=device, dtype=dtype)
        super().__init__(*image_grid(image_size, patch_size), channels=channels, num_classes=num_classes, dim=dim,
                         depth=depth, heads=heads, mlp_dim=mlp_dim, dim_head=dim_head, flash=flash,
                         transformer=transformer, device=device, dtype=dtype, generator=generator)
