"""Transformer blocks, port of ``vit_pytorch_tpu/nn/blocks.py`` (the options
of ViT, NaViT and SimpleViT so far).

Modules keep the reference's ``state_dict`` layout (vit.py:15-83):
``layers.N.0.norm|to_qkv|to_out.0`` and ``layers.N.1.net.0|1|4``, so the JAX
package's ``utils/convert.py::convert_vit`` maps them onto JAX params
unchanged; ``SimpleTransformer`` keeps the simple layout (simple_vit.py:
23-78): ``layers.N.0.to_out`` a bare Linear, ``layers.N.1.net.0|1|3``
(``transformer_rules(simple=True)``).

On a CUDA device, in bf16, ``Transformer`` sends each layer through the
Hopper kernels of ``ops/fused_block.py``, forward and backward (the
whole-layer predicate of the JAX ``Transformer``, blocks.py:618-653).  Where
the whole layer is refused but the attention block is not (training with
dropout, qk-norm) and in ``SimpleTransformer``, ``Attention`` runs the
attention-block kernels, with in-kernel dropout and qk-norm
(``fused_block_eligible``, the JAX blocks.py:47-98); everything else runs
the module composite below, whose attention goes through
``ops/attention.py::dot_product_attention`` (segment ids: the flash kernels).
While a ``wrappers/recorder.py::Recorder`` records, every ``Attention``
takes the composite and keeps its attention map (``Attention.recorded``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import dot_product_attention, on_cuda
from ..ops.flash_attention import rms_norm
from ..ops.fused_block import (
    LN_EPS,
    fused_attention_block,
    fused_block_supported,
    fused_dropout_supported,
    fused_transformer_layer,
    fused_transformer_stack,
    whole_layer_stack_group,
    whole_layer_supported,
)


def fused_block_eligible(
    *, x: torch.Tensor, heads: int, dim_head: int, dim: int, flash, project_out: bool, dropout: float = 0.0,
    train: bool = False, force_split_qkv: bool = False, has_context: bool = False, has_segments: bool = False,
    has_mask: bool = False, record: bool = False,
) -> bool:
    """Whether ``Attention`` takes the attention-block kernels: the JAX
    predicate (blocks.py:47-98) with ``on_cuda(x)`` for ``on_tpu()``.  One
    predicate for ``Attention.forward`` (to dispatch) and ``Transformer``
    (to leave remat off the call that fuses).  qk-norm does not refuse the
    block, as in the JAX package: the attention kernels normalise q and k
    themselves, forward and backward.  A mask refuses the block, as in the
    JAX package (:82), and so does recording (``record``: a
    ``wrappers/recorder.py::Recorder`` is taking the attention maps, which
    only the materialized composite gives, :85).  The JAX predicate's other
    conditions (rotary, bias, pre_norm) are options the port's ``Attention``
    does not have yet; they join the predicate with them."""
    return (
        not record
        and not has_context
        and not has_segments
        and not has_mask
        and not force_split_qkv
        and flash is not False  # explicit flash=False opts out of ALL kernels
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


class RMSNorm(nn.Module):
    """Per-head RMSNorm with learned gamma (reference na_vit.py:93-103): the
    JAX ``RMSNorm``/``_RMSParams`` (blocks.py:165-180, 225-245), gamma of
    shape (heads, 1, dim) initialised to ``gamma_init``."""

    def __init__(self, heads: int, dim: int, gamma_init: float = 1.0, *, device=None, dtype=None):
        super().__init__()
        self.gamma_init = gamma_init
        self.gamma = nn.Parameter(torch.full((heads, 1, dim), gamma_init, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.gamma)


class FeedForward(nn.Module):
    """LN -> Linear -> GELU -> Dropout -> Linear -> Dropout (reference
    vit.py:15-28); ``net.0|1|4`` hold the parameters.  ``norm_bias=False``:
    a bias-free LayerNorm (na_vit.py:82-89).  ``simple=True``: the
    SimpleViT FF without dropout, LN -> Linear -> GELU -> Linear,
    ``net.0|1|3`` (simple_vit.py:23-34)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, *, norm_bias: bool = True,
                 simple: bool = False, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        layers = [nn.LayerNorm(dim, eps=LN_EPS, bias=norm_bias, **kw), nn.Linear(dim, hidden_dim, **kw), GELU()]
        if simple:
            layers.append(nn.Linear(hidden_dim, dim, **kw))
        else:
            layers += [nn.Dropout(dropout), nn.Linear(hidden_dim, dim, **kw), nn.Dropout(dropout)]
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)


class Attention(nn.Module):
    """Pre-LN multi-head attention, fused qkv without bias, projection out
    with bias and dropout (reference vit.py:30-64), with the JAX
    ``Attention`` options the NaViT slice needs (blocks.py:307-550):

    - ``qk_norm``: per-head RMSNorm on q and k (``q_norm``/``k_norm``, gamma
      (heads, 1, dim_head) initialised to ``qk_norm_gamma_init``), scale 1
      (na_vit.py:115-169); the dispatcher applies it;
    - ``norm_bias``/``out_bias``: bias-free LayerNorm / output projection;
    - ``force_split_qkv``: split ``to_q``/``to_kv`` projections, which a call
      with ``context`` (cross-attention: LayerNorm on x only, k and v from
      the context, blocks.py:443-458) needs;
    - ``q_segment_ids``/``kv_segment_ids`` at call: packed-sequence
      block-diagonal masking, the flash kernels on the card;
    - ``simple``: the projection out is a bare Linear at ``to_out``, without
      dropout (simple_vit.py:36-62).

    ``recorded``: None, or the list a ``wrappers/recorder.py::Recorder``
    gave it; while it is a list every call takes the materialized composite
    and appends its post-softmax map (b, heads, n, m) to it, as the JAX
    ``Attention`` sows its map into ``attn_maps`` (blocks.py:497-519)."""

    def __init__(
        self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
        *, qk_norm: bool = False, qk_norm_gamma_init: float = 1.0, norm_bias: bool = True, out_bias: bool = True,
        force_split_qkv: bool = False, simple: bool = False, flash: Optional[bool] = None, device=None, dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.dim, self.heads, self.dim_head, self.dropout, self.flash = dim, heads, dim_head, dropout, flash
        self.qk_norm, self.force_split_qkv = qk_norm, force_split_qkv
        self.recorded: Optional[list] = None
        self.project_out = not (heads == 1 and dim_head == dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, bias=norm_bias, **kw)
        if force_split_qkv:
            self.to_q = nn.Linear(dim, inner, bias=False, **kw)
            self.to_kv = nn.Linear(dim, inner * 2, bias=False, **kw)
        else:
            self.to_qkv = nn.Linear(dim, inner * 3, bias=False, **kw)
        if qk_norm:
            self.q_norm = RMSNorm(heads, dim_head, qk_norm_gamma_init, **kw)
            self.k_norm = RMSNorm(heads, dim_head, qk_norm_gamma_init, **kw)
        if not self.project_out:
            self.to_out = nn.Identity()
        elif simple:
            self.to_out = nn.Linear(inner, dim, bias=out_bias, **kw)
        else:
            self.to_out = nn.Sequential(nn.Linear(inner, dim, bias=out_bias, **kw), nn.Dropout(dropout))

    @property
    def out_proj(self) -> nn.Linear:
        """The projection out's Linear, in either layout."""
        return self.to_out if isinstance(self.to_out, nn.Linear) else self.to_out[0]

    def fuses(self, x, *, context=None, has_segments: bool = False, has_mask: bool = False) -> bool:
        """Whether a call on ``x`` takes the attention-block kernels."""
        return fused_block_eligible(
            x=x, heads=self.heads, dim_head=self.dim_head, dim=self.dim, flash=self.flash,
            project_out=self.project_out, dropout=self.dropout, train=self.training,
            force_split_qkv=self.force_split_qkv, has_context=context is not None, has_segments=has_segments,
            has_mask=has_mask, record=self.recorded is not None,
        )

    def forward(self, x, context=None, *, mask=None, q_segment_ids=None, kv_segment_ids=None, residual=None):
        """``residual``: optional tensor added to the output (the JAX
        ``residual`` keyword, blocks.py:358-363).  On the kernel path it rides
        into the block's last launch; on the module path it is a plain add.
        ``mask``: a boolean key mask broadcastable to (b, heads, n, m), True
        where a key is attended (ViViT's frame mask, (b, 1, 1, m)); it goes
        to the dispatcher's composite and refuses the kernels (JAX :351).
        In training the attention dropout runs in the attention-block
        kernels (seed drawn here) or, with segment ids or context, in the
        dispatcher's route: the flash kernels' (seed drawn there) or the
        composite's."""
        has_segments = q_segment_ids is not None or kv_segment_ids is not None
        if self.fuses(x, context=context, has_segments=has_segments, has_mask=mask is not None):
            rate = self.dropout if self.training else 0.0
            # the int32 seed of the kernels' Philox streams, drawn from the
            # CPU generator (seeded per step by make_train_step's generator):
            # a draw on the card would stall the host once a layer
            seed = int(torch.randint(0, 2**31 - 1, (), dtype=torch.int32)) if rate > 0.0 else None
            cast = lambda t: None if t is None else t.to(x.dtype)
            out_proj = self.out_proj
            ln_bias = self.norm.bias if self.norm.bias is not None else torch.zeros_like(self.norm.weight)
            return fused_attention_block(
                x, residual, cast(self.to_qkv.weight), cast(out_proj.weight), cast(self.norm.weight),
                cast(ln_bias), heads=self.heads, dim_head=self.dim_head, b_out=cast(out_proj.bias),
                gamma_q=cast(self.q_norm.gamma) if self.qk_norm else None,
                gamma_k=cast(self.k_norm.gamma) if self.qk_norm else None,
                scale=1.0 if self.qk_norm else None, eps=LN_EPS, dropout_rate=rate, dropout_seed=seed,
            )
        b, n, _ = x.shape
        x = self.norm(x)
        split = lambda t: t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)
        if context is not None or self.force_split_qkv:
            if not self.force_split_qkv:
                raise ValueError("Attention: a call with context needs force_split_qkv=True (split to_q/to_kv)")
            kv = self.to_kv(x if context is None else context)
            q, k, v = split(self.to_q(x)), *map(split, kv.chunk(2, dim=-1))
        else:
            q, k, v = (
                self.to_qkv(x)
                .reshape(b, n, 3, self.heads, self.dim_head)
                .permute(2, 0, 3, 1, 4)
            )
        record = self.recorded is not None
        out = dot_product_attention(
            q, k, v, scale=1.0 if self.qk_norm else None,
            gamma_q=self.q_norm.gamma if self.qk_norm else None,
            gamma_k=self.k_norm.gamma if self.qk_norm else None, mask=mask,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            dropout_rate=self.dropout if self.training else 0.0, return_attn=record, use_flash=self.flash,
        )
        if record:
            out, attn = out
            self.recorded.append(attn)
        out = self.to_out(out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head))
        return out if residual is None else out + residual


class SimpleTransformer(nn.Module):
    """SimpleViT's transformer (reference simple_vit.py:64-78, JAX
    models/simple_vit.py:17-51): no dropout, bias-free projection out, the
    simple state_dict layout, a final LayerNorm, and no whole-layer kernel
    (as in the JAX package, each layer is an attention call and an FF call).

    Each attention call takes ``residual=x``, which on the card rides into
    the attention block's last launch.  With ``qk_norm`` (the JAX
    ``simple_vit_with_qk_norm`` loop, :44-64) the attention normalises q and
    k with gammas initialised to ``dim_head**-0.5`` and scale 1, and the
    residual is added outside the call, as that loop adds it (a second
    rounding in bf16)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, *, qk_norm: bool = False,
                 flash: Optional[bool] = None, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.qk_norm = qk_norm
        self.layers = nn.ModuleList(
            nn.ModuleList(
                [
                    Attention(dim, heads=heads, dim_head=dim_head, qk_norm=qk_norm,
                              qk_norm_gamma_init=dim_head**-0.5, out_bias=False, simple=True, flash=flash, **kw),
                    FeedForward(dim, mlp_dim, simple=True, **kw),
                ]
            )
            for _ in range(depth)
        )
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x) + x if self.qk_norm else attn(x, residual=x)
            x = ff(x) + x
        return self.norm(x)


class Transformer(nn.Module):
    """Pre-norm residual transformer (reference vit.py:66-83), with the JAX
    ``Transformer`` options ``qk_norm``, ``norm_bias`` and ``attn_out_bias``
    (blocks.py:553-779) and segment ids threaded into every attention call
    (:593-607).

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
        dropout: float = 0.0, *, qk_norm: bool = False, norm_bias: bool = True, attn_out_bias: bool = True,
        ff_glu: bool = False, flash: Optional[bool] = None, remat: bool = False, device=None, dtype=None,
    ):
        super().__init__()
        if ff_glu:
            raise NotImplementedError("ff_glu is not ported yet (ROADMAP: modules to port, item 9)")
        kw = {"device": device, "dtype": dtype}
        self.dim, self.heads, self.dim_head, self.mlp_dim = dim, heads, dim_head, mlp_dim
        self.dropout, self.flash, self.remat, self.qk_norm = dropout, flash, remat, qk_norm
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, bias=norm_bias, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleList(
                [
                    Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, qk_norm=qk_norm,
                              norm_bias=norm_bias, out_bias=attn_out_bias, flash=flash, **kw),
                    FeedForward(dim, mlp_dim, dropout=dropout, norm_bias=norm_bias, **kw),
                ]
            )
            for _ in range(depth)
        )

    def whole_layer_eligible(self, x: torch.Tensor, *, has_segments: bool = False, has_mask: bool = False) -> bool:
        """The JAX whole-layer predicate (blocks.py:618-653) for this
        module's options, with ``on_cuda`` for ``on_tpu`` and
        ``self.training`` for ``train``; a mask refuses it (:628)."""
        return (
            on_cuda(x)
            and not has_segments
            and not has_mask
            and not self.qk_norm  # the whole-layer kernel has no qk-norm (:647)
            and all(attn.recorded is None for attn, _ in self.layers)  # recording (:631)
            and self.flash is not False
            and (self.dropout == 0.0 or not self.training)
            and not (self.heads == 1 and self.dim_head == self.dim)  # project_out
            and whole_layer_supported(x.shape, x.dtype, self.heads, self.dim_head, self.dim, self.mlp_dim)
        )

    def layer_weights(self, i: int, dtype: torch.dtype):
        """Layer ``i``'s operands of :func:`fused_transformer_layer`, in its
        positional order, cast to ``dtype`` (a no-op for serving weights); a
        bias-free LayerNorm gives zeros, as the JAX ``_layer_tuple`` does."""
        attn, ff = self.layers[i]
        cast = lambda t: t.to(dtype)
        bias = lambda ln: cast(ln.bias) if ln.bias is not None else torch.zeros_like(ln.weight, dtype=dtype)
        out_bias = attn.to_out[0].bias
        return (
            cast(attn.to_qkv.weight), cast(attn.to_out[0].weight),
            cast(attn.norm.weight), bias(attn.norm),
            cast(ff.net[0].weight), bias(ff.net[0]),
            cast(ff.net[1].weight), cast(ff.net[1].bias),
            cast(ff.net[4].weight), cast(ff.net[4].bias),
        ), {"b_out": None if out_bias is None else cast(out_bias)}

    def layer_tuple(self, i: int, dtype: torch.dtype):
        """Layer ``i``'s operands as one tuple of
        :func:`fused_transformer_stack`: ``(w_qkv, b_qkv, w_out, b_out, ln1s,
        ln1b, ln2s, ln2b, w1, b1, w2, b2)``, the JAX ``_layer_tuple``'s order
        (the ViT has no qkv bias)."""
        (w_qkv, w_out, *rest), biases = self.layer_weights(i, dtype)
        return (w_qkv, None, w_out, biases["b_out"], *rest)

    def forward(self, x, *, mask=None, q_segment_ids=None, kv_segment_ids=None, rotary=None,
                return_hiddens: bool = False):
        """``mask``: a boolean key mask for every attention call (JAX
        :585-600), broadcastable to (b, heads, n, n); it takes every layer to
        the module composite."""
        if rotary is not None or return_hiddens:
            raise NotImplementedError("rotary and return_hiddens are not ported yet (ROADMAP: modules to port, item 9)")
        has_segments = q_segment_ids is not None or kv_segment_ids is not None
        if self.whole_layer_eligible(x, has_segments=has_segments, has_mask=mask is not None):
            depth = len(self.layers)
            # layers a stack_layers launch, 1 unless VIT_TPU_STACK_LAYERS asks
            # for more; groups of min(g, depth - i) as JAX blocks.py:667-721
            group = whole_layer_stack_group(x.shape, x.dtype, self.heads, self.dim_head, self.dim, self.mlp_dim, depth)
            if group > 1:
                for i in range(0, depth, group):
                    x = fused_transformer_stack(
                        x, [self.layer_tuple(j, x.dtype) for j in range(i, min(i + group, depth))],
                        heads=self.heads, dim_head=self.dim_head, eps=LN_EPS,
                    )
            else:
                for i in range(depth):
                    weights, biases = self.layer_weights(i, x.dtype)
                    x = fused_transformer_layer(
                        x, *weights, heads=self.heads, dim_head=self.dim_head, eps=LN_EPS, **biases
                    )
        else:
            # every layer's Attention shares this predicate (JAX attn_will_fuse)
            attn_fuses = len(self.layers) > 0 and self.layers[0][0].fuses(
                x, has_segments=has_segments, has_mask=mask is not None)
            segs = dict(mask=mask, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
            for attn, ff in self.layers:
                # the residual rides into the attention call, as JAX's attn_call
                # (blocks.py:593-607); remat only where it does not fuse
                x = attn(x, residual=x, **segs) if attn_fuses else self._call(attn, x, **segs) + x
                x = self._call(ff, x) + x
        return self.norm(x)

    def _call(self, module: nn.Module, x, **kwargs):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, x, use_reentrant=False, **kwargs)
        return module(x, **kwargs)
