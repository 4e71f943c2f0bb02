"""One-shot attention for short sequences on Hopper, port of
``vit_pytorch_tpu/ops/short_attention.py``.

Its TPU kernel ``_short_kernel`` (:31, called at :135) is the hand-written
CUDA kernel ``short_attention`` of ``csrc/short_attention.cu`` (and its
``[bias]`` instantiation): the whole key row's softmax with its exact max, the
division by l after the p.v product, keys past m masked, an optional
per-head (h, n, m) additive bias shared by the batch (read with batch stride
0, never broadcast in memory).

:func:`short_attention` is the JAX function's counterpart, an autograd
Function: the forward is the kernel; the backward is autograd through the
port's composite ``xla_attention`` on the saved q, k, v (and bias), as the
JAX ``_bwd`` / ``_bwd_bias`` (:162-198), dbias summed over the batch.
:func:`short_attention_reference` is the kernel's plain twin at its
rounding points (:40-61), which CPU tensors take; on a CUDA tensor the
wrapper :func:`short_fwd` launches the kernel or raises.  Each launch adds
one to ``LAUNCHES["short_attention"]`` or ``LAUNCHES["short_attention[bias]"]``.
:func:`short_attention_twins` runs the same Function on the twin on any
device.

The kernel takes bf16 with ``dim_head == dim_value == 64`` and m <= 1024 on
a CUDA device; :func:`short_supported` is the gate the dispatcher asks, and
everything else goes to the composite (where the TPU's ``_VMEM_BUDGET``
fallback sent what did not fit its VMEM, :230-235).  The TPU knobs
``group`` (the (b*h) slices a program), ``_VMEM_BUDGET`` and ``interpret``
are not ported: a block of the H100 kernel takes 64 queries of one slice.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from ._build import load_library
from ._library import op_name, traced
from .flash_attention import DIM_HEAD, bias_operand, kernel_layout

MAX_KEYS = 1024  # the dispatcher's short route ends here (JAX attention.py:247)

# launches per variant since the last reset_launch_counts()
LAUNCHES = {"short_attention": 0, "short_attention[bias]": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def short_supported(q_shape, k_shape, v_shape, dtype) -> bool:
    """Whether the kernel takes (b, h, n, d) q and (b, h, m, d) k, v of
    ``dtype`` on a CUDA device: bf16, ``d == dv == 64``, 0 < m <= 1024 and at
    most 65,535 (b, h) pairs (the grid's y axis).  The dispatcher sends
    everything else to the materialized composite."""
    b, h, n, d = q_shape
    return (
        dtype == torch.bfloat16
        and d == DIM_HEAD
        and len(k_shape) == 4
        and len(v_shape) == 4
        and tuple(k_shape[:2]) == (b, h)
        and tuple(v_shape[:3]) == tuple(k_shape[:3])
        and k_shape[3] == d
        and v_shape[3] == DIM_HEAD
        and n > 0
        and 0 < k_shape[2] <= MAX_KEYS
        and b * h <= 65535
    )


def _check_bias(bias, q, k):
    """The JAX shape check (:225-229)."""
    h, n, m = q.shape[1], q.shape[2], k.shape[2]
    if bias is not None and tuple(bias.shape) != (h, n, m):
        raise ValueError(f"short_attention bias must be (heads, n, m) = {(h, n, m)}, got {tuple(bias.shape)}")


def short_attention_reference(q, k, v, *, scale: float, bias=None):
    """Plain twin of :func:`short_fwd` at ``_short_kernel``'s rounding points
    (:40-61): s = q.k^T in f32, times the scale; + the bias upcast to f32;
    p = exp(s - rowmax) in f32; l = sum of the unrounded p in f32; o =
    (p cast to v's dtype) . v in f32, divided by l, cast once to q's dtype.
    Unlike ``xla_attention`` (logits stored in the input dtype, p normalised
    before its cast) this rounds where the kernel does.  dv may differ from
    d."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    return (torch.matmul(p.to(v.dtype).float(), v.float()) / l).to(q.dtype)


def _strides(*tensors):
    """The 12 (b, h, row) strides of q, k, v and o."""
    return (ctypes.c_longlong * 12)(*[s for t in tensors for s in t.stride()[:3]])


def short_fwd(q, k, v, *, scale: float, bias=None):
    """o (b, h, n, 64) bf16 of one-shot softmax attention, in the
    merged-heads layout; ``bias`` (h, n, m) (the ``[bias]`` instantiation;
    f32 and bf16 as they are, other float dtypes upcast) added after the
    scale.  See :func:`short_attention_reference`."""
    _check_bias(bias, q, k)
    if q.device.type == "cpu":
        return short_attention_reference(q, k, v, scale=scale, bias=bias)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"short_attention: the kernel runs on a CUDA device, not {dev}")
    if not short_supported(q.shape, k.shape, v.shape, q.dtype):
        raise ValueError(f"short_attention: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)} {q.dtype} is not "
                         f"supported by the kernel (bf16, dim_head {DIM_HEAD}, at most {MAX_KEYS} keys)")
    if bias is not None:
        bias, _ = bias_operand(bias, dev)
    if traced(q):
        return torch.ops.vit_torch.short_attention(q, k, v, float(scale), bias)
    return _short_fwd(q, k, v, scale, bias)


@torch.library.custom_op(op_name("short_attention"), mutates_args=())
def _short_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    return _short_fwd(q, k, v, scale, bias)


@_short_fwd_op.register_fake
def _(q, k, v, scale, bias):
    b, h, n, _ = q.shape
    return q.new_empty((b, n, h, DIM_HEAD)).transpose(1, 2)


@register_flop_formula(torch.ops.vit_torch.short_attention)
def _(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    b, h, n, d = q_shape
    return 2 * b * h * n * k_shape[2] * (d + v_shape[3])


def _short_fwd(q, k, v, scale: float, bias):
    """The launch of :func:`short_fwd` (the op's implementation); the bias
    is :func:`~.flash_attention.bias_operand`'s."""
    dev = q.device
    for t in (q, k, v):
        if torch.is_grad_enabled() and t.requires_grad:
            raise ValueError("short_attention: a kernel call outside autograd; an operand requires grad")
        if t.device != dev or t.dtype != torch.bfloat16:
            raise ValueError(f"short_attention: operand {t.dtype} on {t.device}, expected bf16 on {dev}")
        if not kernel_layout(t):
            raise ValueError(f"short_attention: operand strides {t.stride()}: the head dim must be contiguous, rows "
                             f"16-byte aligned")
    b, h, n, d = q.shape
    m = k.shape[2]
    bias_bf16, bias_strides = 0, (0, 0)
    if bias is not None:
        bias_bf16, bias_strides = int(bias.dtype == torch.bfloat16), bias.stride()[:2]
    o = torch.empty((b, n, h, DIM_HEAD), dtype=q.dtype, device=dev).transpose(1, 2)
    lib = load_library()
    err = lib.lib.vit_short_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None if bias is None else bias.data_ptr(), bias_bf16,
        *bias_strides, b, h, n, m, d, v.shape[3], float(scale), _strides(q, k, v, o),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    name = "short_attention" if bias is None else "short_attention[bias]"
    lib.check(name, err)
    LAUNCHES[name] += 1
    return o


KERNEL = SimpleNamespace(fwd=short_fwd)
TWIN = SimpleNamespace(fwd=short_attention_reference)


class _ShortAttention(torch.autograd.Function):
    """The JAX ``_short_attention_core`` / ``_short_attention_bias_core``
    custom_vjps (:153-198): the forward is the kernel (or its twin), the
    backward autograd through ``xla_attention`` on the saved q, k, v and
    bias, dbias in the bias's (h, n, m) shape, summed over the batch."""

    @staticmethod
    def forward(ctx, ops, scale, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return ops.fwd(q, k, v, scale=scale, bias=bias)

    @staticmethod
    def backward(ctx, g):
        from .attention import xla_attention

        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v) + (() if bias is None else (bias,))]
            out = xla_attention(*leaves[:3], scale=ctx.scale, bias=leaves[3] if bias is not None else None)
            grads = torch.autograd.grad(out, leaves, g)
        return None, None, *grads[:3], grads[3] if bias is not None else None


def _short(ops, q, k, v, scale, bias):
    _check_bias(bias, q, k)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if q.device.type != "cpu":
        q, k, v = (t if kernel_layout(t) else t.contiguous() for t in (q, k, v))
    operands = (q, k, v) if bias is None else (q, k, v, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _ShortAttention.apply(ops, scale, q, k, v, bias)
    return ops.fwd(q, k, v, scale=scale, bias=bias)


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: Optional[float] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Short-sequence attention, q (b, h, n, d), k (b, h, m, d), v (b, h, m,
    dv) -> (b, h, n, dv), the JAX ``short_attention`` (:201-244) without its
    TPU knobs.  ``bias``: an optional per-head additive logits bias of shape
    (h, n, m), shared by the batch (a ``ValueError`` otherwise, as JAX's).
    Differentiable in q, k, v and the bias.  On the CPU it runs the Function
    on the plain twin; on a CUDA tensor it launches the kernel and raises for
    what :func:`short_supported` refuses."""
    return _short(KERNEL, q, k, v, scale, bias)


def short_attention_twins(q, k, v, *, scale: Optional[float] = None, bias=None):
    """The plain path of :func:`short_attention` on any device: the same
    Function with the kernel swapped for its twin."""
    return _short(TWIN, q, k, v, scale, bias)

