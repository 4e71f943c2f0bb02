"""Transformer blocks, port of ``vit_pytorch_tpu/nn/blocks.py`` (the ViT's
options so far).

Modules keep the reference's ``state_dict`` layout (vit.py:15-83):
``layers.N.0.norm|to_qkv|to_out.0`` and ``layers.N.1.net.0|1|4``, so the JAX
package's ``utils/convert.py::convert_vit`` maps them onto JAX params
unchanged.

On a CUDA device, in bf16, ``Transformer`` sends each layer through the
Hopper kernels of ``ops/fused_block.py``, forward and backward (the
whole-layer predicate of the JAX ``Transformer``, blocks.py:618-653).  Where
the whole layer is refused but the attention block is not (training with
dropout), ``Attention`` runs the attention-block kernels with in-kernel
dropout (``fused_block_eligible``, the JAX blocks.py:47-98); everything else
runs the module composite below.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention, on_cuda
from ..ops.fused_block import (
    LN_EPS,
    fused_attention_block,
    fused_block_supported,
    fused_dropout_supported,
    fused_transformer_layer,
    whole_layer_supported,
)


def fused_block_eligible(
    *, x: torch.Tensor, heads: int, dim_head: int, dim: int, flash, project_out: bool, dropout: float = 0.0,
    train: bool = False,
) -> bool:
    """Whether ``Attention`` takes the attention-block kernels: the JAX
    predicate (blocks.py:47-98) with ``on_cuda(x)`` for ``on_tpu()``.  One
    predicate for ``Attention.forward`` (to dispatch) and ``Transformer``
    (to leave remat off the call that fuses).  The JAX predicate's other
    conditions (context, rotary, masks, bias, segments, recording, qk-norm)
    are options the port's ``Attention`` does not have yet; they join the
    predicate with them."""
    return (
        flash is not False  # explicit flash=False opts out of ALL kernels
        # train-time dropout runs inside the kernels when their backward can
        # replay the masks
        and (dropout == 0.0 or not train or fused_dropout_supported(x.shape, heads, dim_head))
        and project_out
        and x.dim() == 3
        and fused_block_supported(x.shape, x.dtype, heads, dim_head, dim)
        and on_cuda(x)
    )


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Dtype-adaptive GELU of the JAX package (blocks.py:252-259): the tanh
    approximation in bf16/f16, within one bf16 ulp of the exact form; exact
    erf in fp32, torch ``nn.GELU()`` parity."""
    approximate = "tanh" if x.dtype in (torch.bfloat16, torch.float16) else "none"
    return F.gelu(x, approximate=approximate)


class GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class FeedForward(nn.Module):
    """LN -> Linear -> GELU -> Dropout -> Linear -> Dropout (reference
    vit.py:15-28); ``net.0|1|4`` hold the parameters."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.net = nn.Sequential(
            nn.LayerNorm(dim, eps=LN_EPS, **kw),
            nn.Linear(dim, hidden_dim, **kw),
            GELU(),
            nn.Dropout(dropout),
            nn.Linear(hidden_dim, dim, **kw),
            nn.Dropout(dropout),
        )

    def forward(self, x):
        return self.net(x)


class Attention(nn.Module):
    """Pre-LN multi-head attention, fused qkv without bias, projection out
    with bias and dropout (reference vit.py:30-64)."""

    def __init__(
        self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
        *, flash: Optional[bool] = None, device=None, dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.dim, self.heads, self.dim_head, self.dropout, self.flash = dim, heads, dim_head, dropout, flash
        self.project_out = not (heads == 1 and dim_head == dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False, **kw)
        self.to_out = (
            nn.Sequential(nn.Linear(inner, dim, **kw), nn.Dropout(dropout))
            if self.project_out
            else nn.Identity()
        )

    def fuses(self, x) -> bool:
        """Whether a call on ``x`` takes the attention-block kernels."""
        return fused_block_eligible(
            x=x, heads=self.heads, dim_head=self.dim_head, dim=self.dim, flash=self.flash,
            project_out=self.project_out, dropout=self.dropout, train=self.training,
        )

    def forward(self, x, context=None, *, residual=None):
        """``residual``: optional tensor added to the output (the JAX
        ``residual`` keyword, blocks.py:358-363).  On the kernel path it rides
        into the block's last launch; on the module path it is a plain add."""
        if context is not None:
            raise NotImplementedError("cross-attention is not ported yet (ROADMAP: modules to port, item 9)")
        if self.fuses(x):
            rate = self.dropout if self.training else 0.0
            # the int32 seed of the kernels' Philox streams, drawn from the
            # CPU generator (seeded per step by make_train_step's generator):
            # a draw on the card would stall the host once a layer
            seed = int(torch.randint(0, 2**31 - 1, (), dtype=torch.int32)) if rate > 0.0 else None
            cast = lambda t: t.to(x.dtype)
            out_proj = self.to_out[0]
            return fused_attention_block(
                x, residual, cast(self.to_qkv.weight), cast(out_proj.weight), cast(self.norm.weight),
                cast(self.norm.bias), heads=self.heads, dim_head=self.dim_head, b_out=cast(out_proj.bias),
                eps=LN_EPS, dropout_rate=rate, dropout_seed=seed,
            )
        b, n, _ = x.shape
        q, k, v = (
            self.to_qkv(self.norm(x))
            .reshape(b, n, 3, self.heads, self.dim_head)
            .permute(2, 0, 3, 1, 4)
        )
        out = dot_product_attention(q, k, v, dropout_rate=self.dropout if self.training else 0.0)
        out = self.to_out(out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head))
        return out if residual is None else out + residual


class Transformer(nn.Module):
    """Pre-norm residual transformer (reference vit.py:66-83).

    ``flash=False`` opts out of every kernel (JAX blocks.py:75).  ``remat``
    recomputes each attention and FF call in the backward
    (``torch.utils.checkpoint``) on the composite path.  As in the JAX
    package (blocks.py:655-658) it leaves alone the attention call that
    takes the attention-block kernels, whose Function saves only x (it
    remats the FF call alone there, with ``checkpoint``'s default
    ``preserve_rng_state=True`` so that the FF's dropout masks replay), and
    it is a no-op on the whole-layer path, whose Function saves only x and
    y."""

    def __init__(
        self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
        dropout: float = 0.0, *, qk_norm: bool = False, ff_glu: bool = False,
        flash: Optional[bool] = None, remat: bool = False, device=None, dtype=None,
    ):
        super().__init__()
        if qk_norm or ff_glu:
            raise NotImplementedError(
                "qk_norm and ff_glu are not ported yet (ROADMAP: modules to port, items 2 and 6)"
            )
        kw = {"device": device, "dtype": dtype}
        self.dim, self.heads, self.dim_head, self.mlp_dim = dim, heads, dim_head, mlp_dim
        self.dropout, self.flash, self.remat = dropout, flash, remat
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList(
                [
                    Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, flash=flash, **kw),
                    FeedForward(dim, mlp_dim, dropout=dropout, **kw),
                ]
            )
            for _ in range(depth)
        )

    def whole_layer_eligible(self, x: torch.Tensor) -> bool:
        """The JAX whole-layer predicate (blocks.py:618-653) for this
        module's options, with ``on_cuda`` for ``on_tpu`` and
        ``self.training`` for ``train``."""
        return (
            on_cuda(x)
            and self.flash is not False
            and (self.dropout == 0.0 or not self.training)
            and not (self.heads == 1 and self.dim_head == self.dim)  # project_out
            and whole_layer_supported(x.shape, x.dtype, self.heads, self.dim_head, self.dim, self.mlp_dim)
        )

    def layer_weights(self, i: int, dtype: torch.dtype):
        """Layer ``i``'s operands of :func:`fused_transformer_layer`, in its
        positional order, cast to ``dtype`` (a no-op for serving weights)."""
        attn, ff = self.layers[i]
        cast = lambda t: t.to(dtype)
        return (
            cast(attn.to_qkv.weight), cast(attn.to_out[0].weight),
            cast(attn.norm.weight), cast(attn.norm.bias),
            cast(ff.net[0].weight), cast(ff.net[0].bias),
            cast(ff.net[1].weight), cast(ff.net[1].bias),
            cast(ff.net[4].weight), cast(ff.net[4].bias),
        ), {"b_out": cast(attn.to_out[0].bias)}

    def forward(self, x, *, rotary=None, return_hiddens: bool = False):
        if rotary is not None or return_hiddens:
            raise NotImplementedError("rotary and return_hiddens are not ported yet (ROADMAP: modules to port, item 9)")
        if self.whole_layer_eligible(x):
            for i in range(len(self.layers)):
                weights, biases = self.layer_weights(i, x.dtype)
                x = fused_transformer_layer(
                    x, *weights, heads=self.heads, dim_head=self.dim_head, eps=LN_EPS, **biases
                )
        else:
            # every layer's Attention shares this predicate (JAX attn_will_fuse)
            attn_fuses = len(self.layers) > 0 and self.layers[0][0].fuses(x)
            for attn, ff in self.layers:
                # the residual rides into the attention call, as JAX's attn_call
                # (blocks.py:593-607); remat only where it does not fuse
                x = attn(x, residual=x) if attn_fuses else self._call(attn, x) + x
                x = self._call(ff, x) + x
        return self.norm(x)

    def _call(self, module: nn.Module, x):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, x, use_reentrant=False)
        return module(x)
