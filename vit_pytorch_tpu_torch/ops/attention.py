"""Scaled-dot-product attention, port of ``vit_pytorch_tpu/ops/attention.py``.

Only the materialized path is ported so far.  The kernel routes of the JAX
dispatcher (flash, short, segment ids, per-head bias) raise
``NotImplementedError`` naming the ROADMAP item that brings them.  The ViT's
inference and training paths do not come here on the card: its whole layer
goes through ``ops/fused_block.py``.
"""

from __future__ import annotations

from typing import Optional

import torch


def on_cuda(x: torch.Tensor) -> bool:
    """True when computation on ``x`` lands on a CUDA device — the
    counterpart of the JAX package's ``on_tpu``.  PyTorch runs where the
    tensor lives, so the test is per tensor."""
    return x.device.type == "cuda"


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
):
    """Materialized attention.  q: (b, h, n, d); k, v: (b, h, m, d).

    ``mask`` broadcasts against (b, h, n, m); True = may attend.

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
    """Dispatching attention entry point; the materialized path only."""
    if use_flash:
        raise NotImplementedError(
            "flash/short attention kernels are not ported yet "
            "(ROADMAP: TPU kernels to port, items 4-6)"
        )
    if q_segment_ids is not None or kv_segment_ids is not None or causal:
        raise NotImplementedError(
            "segment-id and causal masking are not ported yet (ROADMAP: modules "
            "to port, item 6, the NaViT packed slice)"
        )
    if gamma_q is not None or gamma_k is not None:
        raise NotImplementedError(
            "qk-norm is not ported yet (ROADMAP: modules to port, item 6)"
        )
    if bias is not None and bias.ndim == 3:
        raise NotImplementedError(
            "per-head (h, n, m) bias routing is not ported yet (ROADMAP: TPU "
            "kernels to port, item 6)"
        )
    return xla_attention(
        q, k, v, scale=scale, bias=bias, mask=mask, dropout_rate=dropout_rate,
        generator=generator, return_attn=return_attn,
    )
