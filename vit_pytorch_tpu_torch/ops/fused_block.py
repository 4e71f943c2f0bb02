"""The whole pre-norm transformer layer, forward, on Hopper.

Port of ``vit_pytorch_tpu/ops/fused_block.py::fused_transformer_layer``, whose
TPU kernel ``_layer_kernel`` runs a whole layer in one Pallas call with the
weights resident in VMEM.  A Hopper block has 227 KB of shared memory, so the
same function is a chain of seven launches of three hand-written kernels
(``csrc/fused_layer.cu``)::

    x -> layernorm_rows -> gemm_bf16[qkv] -> attention_rows -> gemm_bf16[out] (+x) = y
    y -> layernorm_rows -> gemm_bf16[fc1] (gelu) -> gemm_bf16[fc2] (+y) = out

Each kernel wrapper has its plain PyTorch twin (``*_reference``) in this
module.  A wrapper takes the twin only for a tensor on the CPU; on a CUDA
tensor it launches its kernel or raises.  Each launch adds one to
``LAUNCHES[kernel]``.

Weights are in ``nn.Linear``'s (out, in) layout; the kernels read them so.
Forward only: the backward kernels come with the training step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ._build import load_library

LN_EPS = 1e-5  # torch's LayerNorm default
_LOG2E = 1.4426950408889634  # log2(e)

# Shapes the kernels take; these mirror the constants of csrc/fused_layer.cu.
ATTN_DIM_HEAD = 64  # kAttnDh
ATTN_Q_TILE = 64  # kAttnQT
ATTN_MAX_KEYS = 208  # 16 * kAttnKT: keys padded to 13 chunks of 16
GEMM_BK = 64  # K must be a multiple of the k-tile (kGemmBK)
GEMM_MAX_ROWS = 65535 * 128  # M-tiles ride on gridDim.y

# launches per kernel since the last reset_launch_counts()
LAUNCHES = {"layernorm_rows": 0, "gemm_bf16": 0, "attention_rows": 0}

_EPILOGUES = {"qkv": 0, "out": 1, "fc1": 2, "fc2": 3}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def layernorm_rows_reference(x, weight, bias, *, eps: float = LN_EPS):
    """LayerNorm over the last axis, statistics in f32, output in x.dtype
    (``ln()`` of ``_layer_rows``, fused_block.py:1001-1008)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def gemm_bf16_reference(a, w, epilogue: str, *, bias=None, residual=None):
    """``a @ w.T`` with f32 accumulation and the epilogue of one of the four
    GEMM sites of ``_layer_rows``:

    - ``qkv``: + bias in f32, then one cast (:1015-1018);
    - ``out``/``fc2``: cast, + bias, + residual, each rounded (:1040-1049);
    - ``fc1``: cast, + bias, tanh-GELU (:1046-1047).
    """
    if epilogue == "qkv":
        if bias is None:
            return F.linear(a, w)
        return F.linear(a.float(), w.float(), bias.float()).to(a.dtype)
    h = F.linear(a, w)
    if bias is not None:
        h = h + bias
    if epilogue == "fc1":
        return F.gelu(h, approximate="tanh")
    return h + residual


def attention_rows_reference(qkv, *, heads: int, dim_head: int, scale: float):
    """Per-head softmax attention from the packed (b, n, 3*inner) qkv rows to
    merged heads (b, n, inner): f32 logits, ``_softmax_from_dots``
    (fused_block.py:82-93), P cast to qkv.dtype, P.V accumulated in f32."""
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, dim_head).permute(2, 0, 3, 1, 4).float()
    logits = torch.matmul(q, k.transpose(-1, -2)) * (scale * _LOG2E)
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    p = p * (1.0 / p.sum(-1, keepdim=True))
    o = torch.matmul(p.to(qkv.dtype).float(), v).to(qkv.dtype)
    return o.transpose(1, 2).reshape(b, n, heads * dim_head)


def layer_reference(
    x, w_qkv, w_out, ln1_scale, ln1_bias, ln2_scale, ln2_bias, w1, b1, w2, b2,
    *, heads: int, dim_head: int, b_qkv=None, b_out=None,
    scale: Optional[float] = None, eps: float = LN_EPS,
):
    """Plain PyTorch twin of :func:`fused_transformer_layer`: the JAX
    ``_xla_reference`` (fused_block.py:377-422) followed by ``_ff_reference``
    (:1759-1770), with the rounding points of ``_layer_rows``."""
    scale = dim_head**-0.5 if scale is None else scale
    h = layernorm_rows_reference(x, ln1_scale, ln1_bias, eps=eps)
    qkv = gemm_bf16_reference(h, w_qkv, "qkv", bias=b_qkv)
    m = attention_rows_reference(qkv, heads=heads, dim_head=dim_head, scale=scale)
    y = gemm_bf16_reference(m, w_out, "out", bias=b_out, residual=x)
    h2 = layernorm_rows_reference(y, ln2_scale, ln2_bias, eps=eps)
    a = gemm_bf16_reference(h2, w1, "fc1", bias=b1)
    return gemm_bf16_reference(a, w2, "fc2", bias=b2, residual=y)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(name: str, device, *tensors) -> None:
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: operand on {t.device}, expected {device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: operand dtype {t.dtype}, the kernel takes bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")
        if torch.is_grad_enabled() and t.requires_grad:
            raise ValueError(f"{name}: forward-only kernel; an operand requires grad")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def layernorm_rows(x, weight, bias, *, eps: float = LN_EPS):
    """LayerNorm of each row of ``x`` (last axis), output in bf16."""
    if x.device.type == "cpu":
        return layernorm_rows_reference(x, weight, bias, eps=eps)
    dim = x.shape[-1]
    if weight.shape != (dim,) or bias.shape != (dim,) or dim % 8:
        raise ValueError(f"layernorm_rows: x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    _check_operands("layernorm_rows", x.device, x, weight, bias)
    out = torch.empty_like(x)
    lib = load_library()
    err = lib.lib.vit_layernorm_rows(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        x.numel() // dim, dim, eps, _stream(x.device),
    )
    lib.check("layernorm_rows", err)
    LAUNCHES["layernorm_rows"] += 1
    return out


def gemm_bf16(a, w, epilogue: str, *, bias=None, residual=None):
    """``a @ w.T`` (w is (out, in)) with the named epilogue, see
    :func:`gemm_bf16_reference`."""
    if epilogue not in _EPILOGUES:
        raise ValueError(f"gemm_bf16: unknown epilogue {epilogue!r}")
    if a.device.type == "cpu":
        return gemm_bf16_reference(a, w, epilogue, bias=bias, residual=residual)
    n_out, k = w.shape
    if a.shape[-1] != k or k % GEMM_BK or n_out % 8 or a.numel() // k > GEMM_MAX_ROWS:
        raise ValueError(f"gemm_bf16: a {tuple(a.shape)} and w {tuple(w.shape)}")
    if bias is not None and bias.shape != (n_out,):
        raise ValueError(f"gemm_bf16: bias {tuple(bias.shape)} for {n_out} outputs")
    out_shape = (*a.shape[:-1], n_out)
    if epilogue in ("out", "fc2") and (residual is None or residual.shape != out_shape):
        raise ValueError(f"gemm_bf16[{epilogue}]: needs a residual of shape {out_shape}")
    _check_operands("gemm_bf16", a.device, a, w, bias, residual)
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    lib = load_library()
    err = lib.lib.vit_gemm_bf16(
        a.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        out.data_ptr(), a.numel() // k, n_out, k, _EPILOGUES[epilogue],
        _stream(a.device),
    )
    lib.check(f"gemm_bf16[{epilogue}]", err)
    LAUNCHES["gemm_bf16"] += 1
    return out


def attention_rows(qkv, *, heads: int, dim_head: int, scale: float):
    """Softmax attention of every head, from packed qkv rows (b, n, 3*inner)
    to merged heads (b, n, inner); the logits stay on chip."""
    if qkv.device.type == "cpu":
        return attention_rows_reference(qkv, heads=heads, dim_head=dim_head, scale=scale)
    b, n, three_inner = qkv.shape
    if (
        three_inner != 3 * heads * dim_head
        or dim_head != ATTN_DIM_HEAD
        or n > ATTN_MAX_KEYS
        or b > 65535
    ):
        raise ValueError(
            f"attention_rows: qkv {tuple(qkv.shape)} with heads={heads}, "
            f"dim_head={dim_head}; the kernel takes dim_head={ATTN_DIM_HEAD}, "
            f"n <= {ATTN_MAX_KEYS}"
        )
    _check_operands("attention_rows", qkv.device, qkv)
    out = torch.empty((b, n, heads * dim_head), dtype=qkv.dtype, device=qkv.device)
    lib = load_library()
    err = lib.lib.vit_attention_rows(
        qkv.data_ptr(), out.data_ptr(), b, n, heads, dim_head,
        scale * _LOG2E, _stream(qkv.device),
    )
    lib.check("attention_rows", err)
    LAUNCHES["attention_rows"] += 1
    return out


def whole_layer_supported(x_shape, dtype, heads: int, dim_head: int, dim: int, mlp_dim: int) -> bool:
    """Static eligibility of the kernel chain on an H100.

    Not the TPU's VMEM gate.  It admits bf16 3-D inputs with ``d == dim`` and
    the shapes the three kernels take:

    - attention_rows: ``dim_head == 64`` and ``n <= 208``, its one
      instantiation (keys padded to 13 chunks of 16, for ViT-B/16's 197
      tokens).  The logit rows sit in registers, 104 f32 a thread, which is
      the binding limit.  Its shared memory, ``(64 + 2*208) * 72 * 2`` =
      69,120 bytes, would stay under the 232,448-byte block limit up to 775
      padded keys.
    - gemm_bf16: every K (dim, inner, mlp_dim) a multiple of 64 and every N a
      multiple of 8; M = b*n is masked, up to 65535 row tiles of 128.
    - layernorm_rows: ``dim % 8 == 0``, implied by the GEMM's K.
    """
    if len(x_shape) != 3 or dtype != torch.bfloat16:
        return False
    b, n, d = x_shape
    inner = heads * dim_head
    return (
        d == dim
        and dim_head == ATTN_DIM_HEAD
        and 0 < n <= ATTN_MAX_KEYS
        and 0 < b <= 65535
        and b * n <= GEMM_MAX_ROWS
        and all(v % GEMM_BK == 0 for v in (dim, inner, mlp_dim))
    )


def fused_transformer_layer(
    x, w_qkv, w_out, ln1_scale, ln1_bias, ln2_scale, ln2_bias, w1, b1, w2, b2,
    *, heads: int, dim_head: int, b_qkv=None, b_out=None,
    scale: Optional[float] = None, eps: float = LN_EPS,
):
    """x -> x + Attn(LN(x)) -> . + FF(LN(.)): one pre-norm layer (reference
    vit.py:66-83 loop body), forward only.  On the CPU it is
    :func:`layer_reference`; on a CUDA tensor it is seven kernel launches and
    raises for a shape :func:`whole_layer_supported` refuses or an operand
    that requires grad."""
    scale = dim_head**-0.5 if scale is None else float(scale)
    operands = (x, w_qkv, w_out, ln1_scale, ln1_bias, ln2_scale, ln2_bias, w1, b1, w2, b2, b_qkv, b_out)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        raise ValueError("fused_transformer_layer: forward only; an operand requires grad")
    if x.device.type == "cpu":
        return layer_reference(
            x, w_qkv, w_out, ln1_scale, ln1_bias, ln2_scale, ln2_bias, w1, b1, w2, b2,
            heads=heads, dim_head=dim_head, b_qkv=b_qkv, b_out=b_out, scale=scale, eps=eps,
        )
    dim, mlp_dim = x.shape[-1], w1.shape[0]
    if not whole_layer_supported(x.shape, x.dtype, heads, dim_head, dim, mlp_dim):
        raise ValueError(
            f"fused_transformer_layer: x {tuple(x.shape)} {x.dtype} with heads={heads}, "
            f"dim_head={dim_head}, mlp_dim={mlp_dim} is not supported by the kernels"
        )
    h = layernorm_rows(x, ln1_scale, ln1_bias, eps=eps)
    qkv = gemm_bf16(h, w_qkv, "qkv", bias=b_qkv)
    m = attention_rows(qkv, heads=heads, dim_head=dim_head, scale=scale)
    y = gemm_bf16(m, w_out, "out", bias=b_out, residual=x)
    h2 = layernorm_rows(y, ln2_scale, ln2_bias, eps=eps)
    a = gemm_bf16(h2, w1, "fc1", bias=b1)
    return gemm_bf16(a, w2, "fc2", bias=b2, residual=y)
