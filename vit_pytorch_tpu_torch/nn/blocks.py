"""Transformer blocks, port of ``vit_pytorch_tpu/nn/blocks.py``: the JAX
``Attention``, ``FeedForward`` and ``Transformer`` with their options, the
``LayerNorm`` and ``UnitOffsetLayerNorm`` classes and the activation table.

Modules keep the reference's ``state_dict`` layout (vit.py:15-83):
``layers.N.0.norm|to_qkv|to_out.0`` and ``layers.N.1.net.0|1|4``, so the JAX
package's ``utils/convert.py::convert_vit`` maps them onto JAX params
unchanged; ``SimpleTransformer`` keeps the simple layout (simple_vit.py:
23-78): ``layers.N.0.to_out`` a bare Linear, ``layers.N.1.net.0|1|3``
(``transformer_rules(simple=True)``).  Every form of ``FeedForward`` keeps
fc1 at ``net.1`` and fc2 at ``net.4`` (``net.3`` in the simple layout): the
GLU's gate rides in fc1 (reference rvt.py:75-92), and ``pre_norm=False``
leaves an ``nn.Identity`` at ``net.0``.

On a CUDA device, in bf16, ``Transformer`` sends each layer through the
Hopper kernels of ``ops/fused_block.py``, forward and backward (the
whole-layer predicate of the JAX ``Transformer``, blocks.py:618-653).  Where
the whole layer is refused but the attention block is not (training with
dropout, qk-norm, a GLU or another activation) and in ``SimpleTransformer``,
``Attention`` runs the attention-block kernels, with in-kernel dropout and
qk-norm, a qkv bias and any scale (``fused_block_eligible``, the JAX
blocks.py:47-98); everything else (a rotary, a bias, no pre-norm, a
context) runs the module composite below, whose attention goes through
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
    stack_attention_supported,
    whole_layer_stack_group,
    whole_layer_supported,
)
from ..utils.helpers import is_dtensor


def fused_block_eligible(
    *, x: torch.Tensor, heads: int, dim_head: int, dim: int, flash, project_out: bool, dropout: float = 0.0,
    train: bool = False, pre_norm: bool = True, force_split_qkv: bool = False, has_context: bool = False,
    has_rotary: bool = False, has_mask: bool = False, has_bias: bool = False, has_segments: bool = False,
    record: bool = False, sharded: bool = False,
) -> bool:
    """Whether ``Attention`` takes the attention-block kernels: the JAX
    predicate (blocks.py:47-98) with ``on_cuda(x)`` for ``on_tpu()``.  One
    predicate for ``Attention.forward`` (to dispatch) and ``Transformer``
    (to leave remat off the call that fuses).  qk-norm does not refuse the
    block, as in the JAX package: the attention kernels normalise q and k
    themselves, forward and backward; nor do a qkv bias and a scale, which
    the kernels take as operands.  No pre-norm, a rotary, a mask and an
    additive bias refuse it, as in the JAX package (:77-83), and so does
    recording (``record``: a ``wrappers/recorder.py::Recorder`` is taking
    the attention maps, which only the materialized composite gives,
    :85).  ``sharded``: the module's weights are DTensors (tensor
    parallelism over a mesh, ``parallel/train.py::shard_train_state``),
    which the kernels cannot take: the composite keeps their meaning
    through DTensor's ops."""
    return (
        not record
        and not sharded
        and not has_context
        and not has_segments
        and not has_mask
        and not has_bias
        and not has_rotary
        and pre_norm
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


def dtensor_weights(module: nn.Module) -> bool:
    """Whether any parameter of ``module`` is a DTensor, laid out over a
    mesh by ``parallel/train.py::shard_train_state`` (under ``fully_shard``
    the parameters are plain tensors inside the forward, DTensors only
    where a 'model' axis shards them)."""
    return any(is_dtensor(p) for p in module.parameters())


def gathered(t: Optional[torch.Tensor]):
    """``(t as a plain tensor, its mesh)``; ``(t, None)`` for a plain ``t``.
    Under tensor parallelism a fused projection's product (qkv, kv) is a
    DTensor sharded on its last dim over the 'model' axis, which holds no
    whole heads' q, k and v on a rank: it is gathered, and the attention
    then runs on plain tensors, the same on every rank of the axis (as
    GSPMD keeps the JAX package's plain column split), its gradient coming
    back replicated.  :func:`on_mesh` returns its output to the mesh."""
    if not is_dtensor(t):
        return t, None
    from torch.distributed.tensor import Replicate

    whole = [Replicate()] * t.device_mesh.ndim
    return t.redistribute(placements=whole).to_local(grad_placements=whole), t.device_mesh


def on_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``, the same on every rank, as a replicated DTensor on ``mesh``
    (None: ``t`` as it is)."""
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with torch's epsilon and an optional bias (reference
    na_vit.py:82-90): the JAX ``LayerNorm`` (blocks.py:198-206)."""

    def __init__(self, dim: int, use_bias: bool = True, eps: float = LN_EPS, *, device=None, dtype=None):
        super().__init__(dim, eps=eps, bias=use_bias, device=device, dtype=dtype)


class UnitOffsetLayerNorm(nn.Module):
    """Bias-free LayerNorm whose scale is ``gamma + 1``, gamma initialised
    at zero (reference look_vit.py:37-45, the JAX blocks.py:209-222)."""

    def __init__(self, dim: int, eps: float = LN_EPS, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], eps=self.eps) * (self.gamma.to(x.dtype) + 1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Dtype-adaptive GELU of the JAX package (blocks.py:252-259): the tanh
    approximation in bf16/f16, within one bf16 ulp of the exact form; exact
    erf in fp32, torch ``nn.GELU()`` parity."""
    approximate = "tanh" if x.dtype in (torch.bfloat16, torch.float16) else "none"
    return F.gelu(x, approximate=approximate)


# the JAX _ACTIVATIONS (blocks.py:262-269)
ACTIVATIONS = {
    "gelu": gelu,
    "gelu_exact": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "hardswish": F.hardswish,
}


class Activation(nn.Module):
    """One entry of :data:`ACTIVATIONS`; with ``glu`` the gated form of the
    JAX ``FeedForward`` (blocks.py:294-297): the input's halves (x, gate),
    ``x * act(gate)``."""

    def __init__(self, name: str = "gelu", glu: bool = False):
        super().__init__()
        if name not in ACTIVATIONS:
            raise ValueError(f"unknown activation {name!r}; one of {sorted(ACTIVATIONS)}")
        self.name, self.glu = name, glu

    def forward(self, x):
        act = ACTIVATIONS[self.name]
        if self.glu:
            x, gate = x.chunk(2, dim=-1)
            return x * act(gate)
        return act(x)


class GELU(Activation):
    def __init__(self):
        super().__init__("gelu")


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
    """LN -> Linear -> act -> Dropout -> Linear -> Dropout (reference
    vit.py:15-28), the JAX ``FeedForward`` (blocks.py:272-304); ``net.0|1|4``
    hold the parameters.  ``activation``: a name of :data:`ACTIVATIONS`;
    ``glu``: fc1 is twice as wide and its second half gates the first
    (GEGLU with the default activation, reference rvt.py:75-92);
    ``pre_norm=False``: no LayerNorm (an ``nn.Identity`` at ``net.0``);
    ``use_bias=False``: bias-free fc1 and fc2; ``norm_bias=False``: a
    bias-free LayerNorm (na_vit.py:82-89).  ``simple=True``: the SimpleViT
    FF without dropout, LN -> Linear -> act -> Linear, ``net.0|1|3``
    (simple_vit.py:23-34)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, *, activation: str = "gelu",
                 glu: bool = False, pre_norm: bool = True, use_bias: bool = True, norm_bias: bool = True,
                 simple: bool = False, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        layers = [
            LayerNorm(dim, norm_bias, **kw) if pre_norm else nn.Identity(),
            nn.Linear(dim, hidden_dim * (2 if glu else 1), bias=use_bias, **kw),
            Activation(activation, glu),
        ]
        if simple:
            layers.append(nn.Linear(hidden_dim, dim, bias=use_bias, **kw))
        else:
            layers += [nn.Dropout(dropout), nn.Linear(hidden_dim, dim, bias=use_bias, **kw), nn.Dropout(dropout)]
        self.net = nn.Sequential(*layers)

    def forward(self, x):
        return self.net(x)


class Attention(nn.Module):
    """Pre-LN multi-head attention, fused qkv, projection out with bias and
    dropout (reference vit.py:30-64), with the options of the JAX
    ``Attention`` (blocks.py:307-550):

    - ``qk_norm``: per-head RMSNorm on q and k (``q_norm``/``k_norm``, gamma
      (heads, 1, dim_head) initialised to ``qk_norm_gamma_init``), scale 1
      unless ``scale`` says otherwise (na_vit.py:115-169); the dispatcher
      applies it, or the attention-block kernels;
    - ``qkv_bias``: biased ``to_qkv`` (``to_q``/``to_kv``); ``scale``: the
      logits' scale, ``dim_head**-0.5`` when None; both ride into the
      attention-block kernels as operands;
    - ``pre_norm=False``: no LayerNorm on x (it refuses the kernels);
      ``norm_bias``/``out_bias``: bias-free LayerNorm / output projection;
    - ``force_split_qkv``: split ``to_q``/``to_kv`` projections, which a call
      with ``context`` (cross-attention: LayerNorm on x only, k and v from
      the context, blocks.py:443-458) needs; ``norm_context``: a LayerNorm
      on the context (``norm_context``); ``kv_include_self``: k and v over
      the normed x followed by the context (cait.py:87, cross_vit.py:58).
      Either of the last two acts only on a context, so it builds the split
      projections too: the JAX module builds them at its first call with a
      context (:451-458), the port at construction (``split_qkv``);
    - ``project_out``: the projection out, by default unless one head of
      ``dim``;
    - ``q_segment_ids``/``kv_segment_ids`` at call: packed-sequence
      block-diagonal masking, the flash kernels on the card; ``bias``: an
      additive logit bias; ``rotary``: a callable applied to q and k after
      the head split (after the qk-norm, which it then forces eagerly,
      blocks.py:466-491); each of these three refuses the kernels;
    - ``simple``: the projection out is a bare Linear at ``to_out``, without
      dropout (simple_vit.py:36-62).

    ``recorded``: None, or the list a ``wrappers/recorder.py::Recorder``
    gave it; while it is a list every call takes the materialized composite
    and appends ``(sow_index, map)``, its post-softmax map (b, heads, n, m),
    as the JAX ``Attention`` sows its map into ``attn_maps`` (blocks.py:
    497-519); the Recorder orders the maps by ``sow_index`` where it is
    given (JAX's ``attn_{index:04d}``), else by call."""

    def __init__(
        self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
        *, qk_norm: bool = False, qk_norm_gamma_init: float = 1.0, pre_norm: bool = True, norm_bias: bool = True,
        norm_context: bool = False, qkv_bias: bool = False, out_bias: bool = True, scale: Optional[float] = None,
        project_out: Optional[bool] = None, kv_include_self: bool = False, force_split_qkv: bool = False,
        simple: bool = False, flash: Optional[bool] = None, sow_index: Optional[int] = None, device=None, dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        inner = heads * dim_head
        self.dim, self.heads, self.dim_head, self.dropout, self.flash = dim, heads, dim_head, dropout, flash
        self.qk_norm, self.force_split_qkv, self.pre_norm = qk_norm, force_split_qkv, pre_norm
        # the options that act only on a context imply the split projections
        self.split_qkv = force_split_qkv or norm_context or kv_include_self
        self.scale, self.kv_include_self, self.sow_index = scale, kv_include_self, sow_index
        self.recorded: Optional[list] = None
        self.project_out = not (heads == 1 and dim_head == dim) if project_out is None else project_out
        self.norm = LayerNorm(dim, norm_bias, **kw) if pre_norm else nn.Identity()
        if norm_context:
            self.norm_context = LayerNorm(dim, norm_bias, **kw)
        if self.split_qkv:
            self.to_q = nn.Linear(dim, inner, bias=qkv_bias, **kw)
            self.to_kv = nn.Linear(dim, inner * 2, bias=qkv_bias, **kw)
        else:
            self.to_qkv = nn.Linear(dim, inner * 3, bias=qkv_bias, **kw)
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

    @property
    def attn_scale(self) -> Optional[float]:
        """The logits' scale (None: the dispatcher's ``dim_head**-0.5``); 1
        by default under qk-norm, whose norm carries sqrt(dim_head)."""
        return 1.0 if self.scale is None and self.qk_norm else self.scale

    def fuses(self, x, *, context=None, has_segments: bool = False, has_mask: bool = False, has_bias: bool = False,
              has_rotary: bool = False) -> bool:
        """Whether a call on ``x`` takes the attention-block kernels."""
        return fused_block_eligible(
            x=x, heads=self.heads, dim_head=self.dim_head, dim=self.dim, flash=self.flash,
            project_out=self.project_out, dropout=self.dropout, train=self.training, pre_norm=self.pre_norm,
            force_split_qkv=self.split_qkv, has_context=context is not None, has_rotary=has_rotary,
            has_mask=has_mask, has_bias=has_bias, has_segments=has_segments, record=self.recorded is not None,
            sharded=dtensor_weights(self),
        )

    def forward(self, x, context=None, *, mask=None, bias=None, q_segment_ids=None, kv_segment_ids=None,
                rotary=None, residual=None):
        """``residual``: optional tensor added to the output (the JAX
        ``residual`` keyword, blocks.py:358-363).  On the kernel path it rides
        into the block's last launch; on the module path it is a plain add.
        ``mask``: a boolean key mask broadcastable to (b, heads, n, m), True
        where a key is attended (ViViT's frame mask, (b, 1, 1, m)); it goes
        to the dispatcher's composite and refuses the kernels (JAX :351).
        ``bias``: an additive logit bias for the dispatcher.  In training the
        attention dropout runs in the attention-block kernels (seed drawn
        here) or, with segment ids or context, in the dispatcher's route:
        the flash kernels' (seed drawn there) or the composite's."""
        has_segments = q_segment_ids is not None or kv_segment_ids is not None
        if self.fuses(x, context=context, has_segments=has_segments, has_mask=mask is not None,
                      has_bias=bias is not None, has_rotary=rotary is not None):
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
                cast(ln_bias), heads=self.heads, dim_head=self.dim_head, b_qkv=cast(self.to_qkv.bias),
                b_out=cast(out_proj.bias), gamma_q=cast(self.q_norm.gamma) if self.qk_norm else None,
                gamma_k=cast(self.k_norm.gamma) if self.qk_norm else None, scale=self.attn_scale, eps=LN_EPS,
                dropout_rate=rate, dropout_seed=seed,
            )
        b, n, _ = x.shape
        x = self.norm(x)
        split = lambda t: t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)
        if context is not None or self.split_qkv:
            if not self.split_qkv:
                raise ValueError("Attention: a call with context needs the split to_q/to_kv projections: build it "
                                 "with force_split_qkv=True (or norm_context / kv_include_self, which imply them)")
            if context is not None and hasattr(self, "norm_context"):
                context = self.norm_context(context)
            if context is not None and self.kv_include_self:
                context = torch.cat([x, context], dim=1)
            kv, _ = gathered(self.to_kv(x if context is None else context))
            q, mesh = gathered(self.to_q(x))
            q, k, v = split(q), *map(split, kv.chunk(2, dim=-1))
        else:
            qkv, mesh = gathered(self.to_qkv(x))
            q, k, v = qkv.reshape(b, n, 3, self.heads, self.dim_head).permute(2, 0, 3, 1, 4)
        gamma_q = gathered(self.q_norm.gamma)[0] if self.qk_norm else None
        gamma_k = gathered(self.k_norm.gamma)[0] if self.qk_norm else None
        if rotary is not None:
            # the rotary sees normed q and k (reference rvt.py)
            if self.qk_norm:
                q, k, gamma_q, gamma_k = rms_norm(q, gamma_q), rms_norm(k, gamma_k), None, None
            q, k = rotary(q), rotary(k)
        record = self.recorded is not None
        out = dot_product_attention(
            q, k, v, scale=self.attn_scale, bias=bias, gamma_q=gamma_q, gamma_k=gamma_k, mask=mask,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            dropout_rate=self.dropout if self.training else 0.0, return_attn=record,
            use_flash=self.flash,
        )
        if record:
            out, attn = out
            self.recorded.append((self.sow_index, attn))
        out = self.to_out(on_mesh(out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head), mesh))
        return out if residual is None else out + residual


class SimpleTransformer(nn.Module):
    """SimpleViT's transformer (reference simple_vit.py:64-78, JAX
    models/simple_vit.py:17-51): no dropout, bias-free projection out, the
    simple state_dict layout, a final LayerNorm unless ``final_norm=False``
    (the flash-attention variants, reference simple_flash_attn_vit.py:
    124-137), and no whole-layer kernel (as in the JAX package, each layer
    is an attention call and an FF call).

    Each attention call takes ``residual=x``, which on the card rides into
    the attention block's last launch; a ``rotary`` at call goes to every
    attention (and refuses the kernels).  With ``qk_norm`` (the JAX
    ``simple_vit_with_qk_norm`` loop, :44-64) the attention normalises q and
    k with gammas initialised to ``dim_head**-0.5`` and scale 1, and the
    residual is added outside the call, as that loop adds it (a second
    rounding in bf16)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, *, qk_norm: bool = False,
                 final_norm: bool = True, flash: Optional[bool] = None, device=None, dtype=None):
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
        self.norm = LayerNorm(dim, **kw) if final_norm else nn.Identity()

    def forward(self, x, *, rotary=None):
        for attn, ff in self.layers:
            x = attn(x, rotary=rotary) + x if self.qk_norm else attn(x, rotary=rotary, residual=x)
            x = ff(x) + x
        return self.norm(x)


class Transformer(nn.Module):
    """Pre-norm residual transformer (reference vit.py:66-83), with the JAX
    ``Transformer`` options (blocks.py:553-779): ``qk_norm``,
    ``final_norm``, ``norm_bias``, ``attn_out_bias``, ``qkv_bias``,
    ``ff_activation`` and ``ff_glu``, and at call a mask, an additive
    ``bias``, segment ids and a ``rotary`` threaded into every attention
    call (:593-607), and ``return_hiddens``.

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
        dropout: float = 0.0, *, qk_norm: bool = False, final_norm: bool = True, norm_bias: bool = True,
        attn_out_bias: bool = True, qkv_bias: bool = False,
        ff_activation: str = "gelu", ff_glu: bool = False, flash: Optional[bool] = None, remat: bool = False,
        device=None, dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.dim, self.heads, self.dim_head, self.mlp_dim = dim, heads, dim_head, mlp_dim
        self.dropout, self.flash, self.remat, self.qk_norm = dropout, flash, remat, qk_norm
        self.ff_activation, self.ff_glu = ff_activation, ff_glu
        self.norm = LayerNorm(dim, norm_bias, **kw) if final_norm else nn.Identity()
        self.layers = nn.ModuleList(
            nn.ModuleList(
                [
                    Attention(dim, heads=heads, dim_head=dim_head, dropout=dropout, qk_norm=qk_norm,
                              norm_bias=norm_bias, qkv_bias=qkv_bias, out_bias=attn_out_bias, flash=flash,
                              sow_index=i, **kw),
                    FeedForward(dim, mlp_dim, dropout=dropout, activation=ff_activation, glu=ff_glu,
                                norm_bias=norm_bias, **kw),
                ]
            )
            for i in range(depth)
        )

    def whole_layer_eligible(self, x: torch.Tensor, *, has_segments: bool = False, has_mask: bool = False,
                             has_bias: bool = False, has_rotary: bool = False) -> bool:
        """The JAX whole-layer predicate (blocks.py:618-653) for this
        module's options, with ``on_cuda`` for ``on_tpu`` and
        ``self.training`` for ``train``; a mask, a bias and a rotary refuse
        it (:627-629), and so do a GLU and any activation but the GELU, which
        the kernels' fc1 epilogue computes (:648-649), and DTensor weights
        (:func:`dtensor_weights`): the row-parallel projection out needs its
        all-reduce before the residual, which a whole layer on a shard has
        no place for."""
        return (
            on_cuda(x)
            and not dtensor_weights(self)
            and not has_segments
            and not has_mask
            and not has_bias
            and not has_rotary
            and not self.qk_norm  # the whole-layer kernel has no qk-norm (:647)
            and not self.ff_glu
            and self.ff_activation == "gelu"
            and all(attn.recorded is None for attn, _ in self.layers)  # recording (:631)
            and self.flash is not False
            and (self.dropout == 0.0 or not self.training)
            and not (self.heads == 1 and self.dim_head == self.dim)  # project_out
            and whole_layer_supported(x.shape, x.dtype, self.heads, self.dim_head, self.dim, self.mlp_dim)
        )

    def layer_weights(self, i: int, dtype: torch.dtype):
        """Layer ``i``'s operands of :func:`fused_transformer_layer`, in its
        positional order, cast to ``dtype`` (a no-op for serving weights),
        and its optional biases ``b_qkv`` and ``b_out`` (None without); a
        bias-free LayerNorm gives zeros, as the JAX ``_layer_tuple`` does."""
        attn, ff = self.layers[i]
        cast = lambda t: None if t is None else t.to(dtype)
        bias = lambda ln: cast(ln.bias) if ln.bias is not None else torch.zeros_like(ln.weight, dtype=dtype)
        return (
            cast(attn.to_qkv.weight), cast(attn.to_out[0].weight),
            cast(attn.norm.weight), bias(attn.norm),
            cast(ff.net[0].weight), bias(ff.net[0]),
            cast(ff.net[1].weight), cast(ff.net[1].bias),
            cast(ff.net[4].weight), cast(ff.net[4].bias),
        ), {"b_qkv": cast(attn.to_qkv.bias), "b_out": cast(attn.to_out[0].bias)}

    def layer_tuple(self, i: int, dtype: torch.dtype):
        """Layer ``i``'s operands as one tuple of
        :func:`fused_transformer_stack`: ``(w_qkv, b_qkv, w_out, b_out, ln1s,
        ln1b, ln2s, ln2b, w1, b1, w2, b2)``, the JAX ``_layer_tuple``'s
        order."""
        (w_qkv, w_out, *rest), biases = self.layer_weights(i, dtype)
        return (w_qkv, biases["b_qkv"], w_out, biases["b_out"], *rest)

    def forward(self, x, *, mask=None, bias=None, q_segment_ids=None, kv_segment_ids=None, rotary=None,
                return_hiddens: bool = False):
        """``mask``: a boolean key mask for every attention call (JAX
        :585-600), broadcastable to (b, heads, n, n); ``bias``: an additive
        logit bias for every call; either takes every layer to the module
        composite, as a ``rotary`` does.  ``return_hiddens``: also return
        each layer's output, before the final norm (:708-778); it runs the
        whole layers one a call, never the stack (:667-672)."""
        has_segments = q_segment_ids is not None or kv_segment_ids is not None
        refusals = dict(has_segments=has_segments, has_mask=mask is not None, has_bias=bias is not None,
                        has_rotary=rotary is not None)
        hiddens = []
        depth = len(self.layers)
        if self.whole_layer_eligible(x, **refusals):
            # layers a stack_layers launch, 1 unless VIT_TPU_STACK_LAYERS asks
            # for more; groups of min(g, depth - i) as JAX blocks.py:667-721
            group = 1 if return_hiddens else whole_layer_stack_group(
                x.shape, x.dtype, self.heads, self.dim_head, self.dim, self.mlp_dim, depth)
            if x.device.type != "cpu" and not stack_attention_supported(x.shape, self.dim_head):
                group = 1  # stack_layers' attention step takes dim_head 64, n <= 208 (on the CPU the twins take any)
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
                        x, *weights, heads=self.heads, dim_head=self.dim_head, eps=LN_EPS, **biases,
                    )
                    hiddens.append(x)
        else:
            # every layer's Attention shares this predicate (JAX attn_will_fuse)
            attn_fuses = depth > 0 and self.layers[0][0].fuses(x, **refusals)
            segs = dict(mask=mask, bias=bias, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                        rotary=rotary)
            for attn, ff in self.layers:
                # the residual rides into the attention call, as JAX's attn_call
                # (blocks.py:593-607); remat only where it does not fuse
                x = attn(x, residual=x, **segs) if attn_fuses else self._call(attn, x, **segs) + x
                x = self._call(ff, x) + x
                hiddens.append(x)
        x = self.norm(x)
        return (x, hiddens) if return_hiddens else x

    def _call(self, module: nn.Module, x, **kwargs):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(module, x, use_reentrant=False, **kwargs)
        return module(x, **kwargs)
