"""Scaled-dot-product attention, port of ``vit_pytorch_tpu/ops/attention.py``.

Three backends behind one dispatcher, as in the JAX package:

* ``xla_attention`` — the materialized composite (plain PyTorch), the only
  path that can return the attention matrix;
* ``short_attention`` — the Hopper kernel of ``ops/short_attention.py``
  (one-shot softmax over a whole key row, m <= 1024, an optional per-head
  (h, n, m) bias);
* ``flash_attention`` — the Hopper kernels of ``ops/flash_attention.py``
  (online-softmax tiles, segment-id masking with tile skipping, the causal
  mask, a (1|b, 1|h, n, m) bias, attention dropout and, opt-in, the qk-norm
  inside the kernels).

``dot_product_attention`` takes a kernel route on a CUDA device for packed
sequences (segment ids) and for m >= 1024, or when the caller asks with
``use_flash=True``, and then mirrors the JAX routes (:241-288):

* the short route for a call without segment ids, causal mask or dropout,
  with no bias or a per-head (h, n, m) one, and m <= 1024 (so m = 1024
  exactly, on the automatic route): ``short_attention``;
* the flash route for everything else: causal, a 4-D bias, a per-head bias
  that misses the short route (as ``bias[None]``), segment ids, dropout.

Each kernel route asks its gate (:func:`~.short_attention.short_supported`,
:func:`~.flash_attention.flash_supported`: bf16, q, k and v 64 wide) before it
launches on a CUDA tensor; fp32 and the shapes a kernel does not take go to
the composite, where the TPU sent what did not fit its VMEM.  On a CPU
tensor a kernel route runs its Function on the plain twins.  No route
raises ``NotImplementedError``.

Train-time dropout without a bias stays on the flash route: the dispatcher
draws the kernels' int32 seed on the host (JAX :264-268) and the kernels
drop the attention matrix themselves; with a bias it takes the composite, as
in JAX (:194-199), which draws its mask with ``torch.rand``.  qk-norm gammas
are applied here with the eager :func:`~.flash_attention.rms_norm`, unless
``VIT_TPU_FUSE_QKNORM`` is set (the JAX opt-in, read at each call as JAX
reads it at trace time; off by default): then they ride to the flash route,
whose kernels normalise in the tile, and are still normalised eagerly on
every other route, and on the flash route with a bias (:252-253,
:269-272).  The composite takes a causal triangle and a bias of shape
(h, n, m) or (b, h, n, m), as the JAX dispatcher's does.  The ViT's own
layers do not come here on the card: they go through
``ops/fused_block.py``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..utils.helpers import is_dtensor
from .flash_attention import flash_attention, flash_supported, rms_norm
from .short_attention import short_attention, short_supported


def on_cuda(x: torch.Tensor) -> bool:
    """True when computation on ``x`` lands on a CUDA device, as a plain
    tensor — the counterpart of the JAX package's ``on_tpu``.  PyTorch runs
    where the tensor lives, so the test is per tensor.  A DTensor (a tensor
    laid out over a mesh by ``parallel/mesh.py``) is refused: the kernels
    take plain tensors, and its ops keep the meaning of the whole tensor
    only through DTensor's own dispatch."""
    return x.device.type == "cuda" and not is_dtensor(x)


def build_segment_mask(q_segment_ids, kv_segment_ids, n: int, m: int, *, causal: bool = False, mask=None,
                       device=None):
    """Fold NaViT segment ids (token i attends j iff seg[i] == seg[j], both
    non-negative) and/or a causal triangle into a dense (b, 1, n, m) mask
    (JAX attention.py:51-68).  The triangle is built on ``device`` (the
    dispatcher passes q's), else on the segment ids' device, else the CPU."""
    if q_segment_ids is not None and kv_segment_ids is not None:
        qs, ks = q_segment_ids[:, :, None], kv_segment_ids[:, None, :]
        seg_mask = ((qs == ks) & (qs >= 0) & (ks >= 0))[:, None, :, :]
        mask = seg_mask if mask is None else (mask & seg_mask)
    if causal:
        if device is None:
            device = q_segment_ids.device if q_segment_ids is not None else "cpu"
        cmask = torch.ones((n, m), dtype=torch.bool, device=device).tril()
        mask = cmask if mask is None else (mask & cmask)
    return mask


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    return_attn: bool = False,
    keep: Optional[torch.Tensor] = None,
):
    """Materialized attention.  q: (b, h, n, d); k, v: (b, h, m, d).

    ``mask`` broadcasts against (b, h, n, m); True = may attend.  With
    ``dropout_rate`` > 0 the normalized matrix is dropped with ``keep``
    ((b, h, n, m) bool, a mask drawn elsewhere: the flash kernels' for
    :func:`~.flash_attention.flash_attention_reference`), else with a mask
    drawn from ``torch.rand`` and ``generator``.

    Dtype policy of the JAX package: fp32 inputs keep the logits in fp32;
    bf16/f16 inputs store the logits in the input dtype, and the softmax is
    always computed in fp32.  Fully masked rows give zeros.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    store = q.dtype if q.dtype in (torch.bfloat16, torch.float16) else torch.float32
    dots = torch.matmul(q.to(store), k.to(store).transpose(-1, -2)) * scale
    if bias is not None:
        dots = dots + bias.to(dots.dtype)
    if mask is not None:
        dots = dots.masked_fill(~mask, torch.finfo(dots.dtype).min)
    attn = torch.softmax(dots.float(), dim=-1)
    if mask is not None:
        attn = torch.where(mask.any(-1, keepdim=True), attn, 0.0)
    attn = attn.to(v.dtype)
    attn_out = attn
    if dropout_rate > 0.0:
        if keep is None:
            keep = torch.rand(attn.shape, generator=generator, device=attn.device) >= dropout_rate
        attn = torch.where(keep, attn / (1.0 - dropout_rate), 0.0).to(v.dtype)
    out = torch.matmul(attn, v)
    if return_attn:
        return out, attn_out
    return out


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    gamma_q: Optional[torch.Tensor] = None,
    gamma_k: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    return_attn: bool = False,
    use_flash: Optional[bool] = None,
):
    """Dispatching attention entry point (JAX attention.py:131-310).

    Segment ids (int, (b, n) and (b, m)) build the NaViT block-diagonal mask;
    on the flash route the kernels consume them tile by tile without a dense
    mask.  ``gamma_q``/``gamma_k``: per-head qk-RMSNorm gammas, which callers
    pass instead of normalising q and k (JAX :156-181): applied here eagerly
    with :func:`~.flash_attention.rms_norm` before any route (the JAX
    default); with ``VIT_TPU_FUSE_QKNORM`` set they ride to the flash route
    (its ``[qknorm]`` kernels), and every other route applies them here.
    ``use_flash``: None decides as the JAX dispatcher does
    (a kernel route on a CUDA device for segment ids or m >= 1024); True
    asks for the kernel routes (on CPU tensors the short and flash routes run
    their plain twins); False forces the composite.

    ``dropout_rate`` > 0 (train time): on the flash route the kernels drop
    the attention matrix with an int32 seed drawn here, on the host, from
    ``generator`` (on its device) or, without one, from the global CPU
    generator, which ``make_train_step`` seeds from its own each step; a
    draw on the card would stall the host once a layer.  The composite
    draws its mask with ``torch.rand``.  With a bias dropout takes the
    composite, as in JAX (the kernels' bias backward cannot replay it)."""
    n, m = q.shape[-2], k.shape[-2]
    if (gamma_q is None) != (gamma_k is None):
        raise ValueError("qk-norm gammas must be given for both q and k")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("segment ids must be given for both q and kv")
    # the in-kernel qk-norm is opt-in, read at each call (JAX :171-181)
    if gamma_q is not None and not os.environ.get("VIT_TPU_FUSE_QKNORM"):
        q, k = rms_norm(q, gamma_q), rms_norm(k, gamma_k)
        gamma_q = gamma_k = None
    # a per-head (h, n, m) rel-pos table shared by the batch (windowed
    # attention), the short kernel's operand (JAX :183-188)
    per_head_bias = bias is not None and bias.ndim == 3 and tuple(bias.shape) == (q.shape[1], n, m)

    # train-time dropout runs inside the flash kernels, without a bias (JAX
    # :194-199; JAX also needs the TPU, while the port's CPU twins replay the
    # kernels' masks, so use_flash=True takes them on the CPU too); a traced
    # scale cannot be baked into a kernel (:204)
    kernel_dropout_ok = dropout_rate > 0.0 and bias is None
    static_scale = scale is None or isinstance(scale, (int, float))
    kernel_ok = (
        not return_attn
        and (dropout_rate == 0.0 or kernel_dropout_ok)
        and mask is None
        and static_scale
        and q.shape[-1] <= 256
    )
    if use_flash is None:
        use_flash = kernel_ok and on_cuda(q) and (m >= 1024 or q_segment_ids is not None)

    if use_flash and kernel_ok:
        if (bias is None or per_head_bias) and q_segment_ids is None and not causal and dropout_rate == 0.0 \
                and m <= 1024:
            # the short route (JAX :242-254): gammas normalised here
            if gamma_q is not None:
                q, k = rms_norm(q, gamma_q), rms_norm(k, gamma_k)
                gamma_q = gamma_k = None
            # the kernel's gate: fp32 and shapes it does not take on the card
            # go to the composite below
            if not on_cuda(q) or short_supported(q.shape, k.shape, v.shape, q.dtype):
                return short_attention(q, k, v, scale=scale, bias=bias)
        else:
            # the flash route (JAX :256-288): a per-head table as (1, h, n,
            # m); gammas with a bias normalised here (its backward is the
            # composite)
            flash_bias = bias[None] if per_head_bias else bias
            if gamma_q is not None and bias is not None:
                q, k = rms_norm(q, gamma_q), rms_norm(k, gamma_k)
                gamma_q = gamma_k = None
            if not on_cuda(q) or flash_supported(q.shape, k.shape, v.shape, q.dtype):
                seed = None
                if dropout_rate > 0.0:  # JAX :264-268, on the host
                    device = "cpu" if generator is None else generator.device
                    seed = int(torch.randint(0, 2**31 - 1, (), dtype=torch.int32, generator=generator, device=device))
                return flash_attention(
                    q, k, v, scale=scale, bias=flash_bias, gamma_q=gamma_q, gamma_k=gamma_k,
                    q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids, causal=causal,
                    dropout_rate=dropout_rate, dropout_seed=seed,
                )

    # every route but the flash kernels normalises here (JAX :290-291)
    if gamma_q is not None:
        q, k = rms_norm(q, gamma_q), rms_norm(k, gamma_k)
    # segments and the causal triangle fold into the dense mask; a bias of
    # shape (h, n, m) or (b, h, n, m) adds to the logits (JAX :290-310)
    mask = build_segment_mask(q_segment_ids, kv_segment_ids, n, m, causal=causal, mask=mask, device=q.device)
    return xla_attention(
        q, k, v, scale=scale, bias=bias, mask=mask, dropout_rate=dropout_rate,
        generator=generator, return_attn=return_attn,
    )
