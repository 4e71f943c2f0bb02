"""The whole pre-norm transformer layer, forward and backward, on Hopper.

Port of ``vit_pytorch_tpu/ops/fused_block.py::fused_transformer_layer``, whose
TPU kernel ``_layer_kernel`` runs a whole layer in one Pallas call with the
weights resident in VMEM.  A Hopper block has 227 KB of shared memory, so the
same function is a chain of seven launches of three hand-written kernels
(``csrc/fused_layer.cu``, ``csrc/gemm_bf16.cu``, ``csrc/attention_rows.cu``)::

    x -> layernorm_rows -> gemm_bf16[qkv] -> attention_rows -> gemm_bf16[out] (+x) = y
    y -> layernorm_rows -> gemm_bf16[fc1] (gelu) -> gemm_bf16[fc2] (+y) = out

The backward is the JAX package's decomposed ``_fused_layer_bwd``
(fused_block.py:1793-1872): the FF vjp from the saved ``y`` by autograd
through :func:`ff_reference` (plain PyTorch, where the JAX package uses XLA's
vjp), then the port of the attention-block backward kernel ``_bwd_kernel``
(:524) as six launches (``csrc/attention_bwd_rows.cu``, ``csrc/fused_layer_bwd.cu``
and the f32 epilogue of ``gemm_bf16``)::

    x  -> layernorm_rows -> gemm_bf16[qkv]                        = qkv  (recompute)
    dy -> gemm_bf16[cast] with W_out^T                            = dm
    qkv, dm -> attention_bwd_rows                                 = m, dqkv
    dqkv -> gemm_f32out with W_qkv^T                              = dh   (f32)
    x, dh, dy -> layernorm_bwd_rows                               = dx, dgamma, dbeta

and dW_qkv, dW_out, the biases' gradients as plain PyTorch over the whole
batch, as the JAX package leaves them to XLA (:802-816).

Where the whole layer is refused (training with dropout), the attention
block alone, ``fused_attention_block``, is the port of the JAX ``_kernel``
(:260) and its custom_vjp ``_fused`` (:820-916), with the train-time dropout
of both reference sites drawn in-kernel from a counter-based Philox4x32-10
keyed by (seed, img * 1024 + head) (``csrc/common.cuh``; the TPU kernels use
the TPU PRNG with the same key)::

    x -> layernorm_rows -> gemm_bf16[qkv] -> attention_rows (+dropout on P)
      -> gemm_bf16[block_out] (+b_out, +dropout, +residual, one cast)     = out
    g -> dropout_apply = gm; then the six launches above from gm, with
         attention_bwd_rows replaying the attention mask

``dropout_masks`` replays both masks (the JAX ``dropout_masks``, :190).

With ``gamma_q``/``gamma_k`` (qk-norm, SimpleViT-qk-norm's attention) the
attention launches normalise q and k in-kernel (``attention_rows[qknorm]``,
``_kernel`` :323-338) and the backward recomputes the norm, closes it on dq
and dk and returns dgamma_q/dgamma_k (``attention_bwd_rows[qknorm]``,
``_bwd_kernel`` :614-688).

The JAX package's two opt-in backwards of the whole layer run here behind the
same switches, read at call time (:1364-1386, :1619-1655), off by default:

- ``VIT_TPU_FF_BWD=full|hybrid`` (legacy ``VIT_TPU_ENABLE_FF_BWD=1`` is
  ``full``): the FF half is the port of the row-tiled ``_ff_bwd_kernel``
  (:1493), then the attention half as above::

    y  -> layernorm_rows                                    = y2   (recompute)
    y2 -> gemm_bf16[fc1_save] with W1                       = act, h1
    g  -> gemm_bf16[gelu_bwd] with W2, h1                   = dh1, db1
    dh1 -> gemm_f32out with W1                              = dyln (f32)
    y, dyln, g -> layernorm_bwd_rows[res_f32]               = dy, dln2 gamma/beta, db2
    full: gemm_wgrad(g, act) = dW2, gemm_wgrad(dh1, y2) = dW1;
    hybrid: the same two products as torch.matmul (XLA GEMMs in JAX, :1737-1745)

- ``VIT_TPU_ENABLE_WHOLE_LAYER_BWD``: the whole-layer ``_layer_bwd_kernel``
  (:1156): the FF chain with dy kept in f32, the attention half's launches
  from bf16(dy), ``layernorm_bwd_rows[res_f32]`` adding the f32 dy, and
  ``gemm_wgrad`` for dW_out and dW_qkv too.

The JAX switch ``VIT_TPU_STACK_LAYERS=g`` (the port of ``_stack_kernel``,
:1979) runs g consecutive layers' forward in one launch of ``stack_layers``
(``csrc/stack_layers.cu``): a cooperative grid of gemm_bf16's blocks walks
the chain's seven steps of every layer, the GEMM steps on gemm_bf16's own
main loop and epilogue (``csrc/gemm_ring.cuh``), the others on the chain's
tile bodies (``csrc/layer_tiles.cuh``), so the result is bitwise the
chain's.  ``fused_transformer_stack`` takes it
outside autograd; under autograd it runs the per-layer Functions, as JAX's
``_fused_stack`` custom_vjp does.  Off by default, as in JAX.

Each kernel wrapper has its plain PyTorch twin (``*_reference``) in this
module.  A wrapper takes the twin only for a tensor on the CPU; on a CUDA
tensor it launches its kernel or raises.  Each launch adds one to
``LAUNCHES[kernel]``.

Weights are in ``nn.Linear``'s (out, in) layout; the kernels read them so.
"""

from __future__ import annotations

import ctypes
import math
import os
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils.helpers import default_device
from ._build import load_library

LN_EPS = 1e-5  # torch's LayerNorm default
_LOG2E = 1.4426950408889634  # log2(e)

# Shapes the kernels take; these mirror the constants of csrc/*.cu.
ATTN_DIM_HEAD = 64  # kAttnDh
ATTN_Q_TILE = 64  # kAttnQT
ATTN_MAX_KEYS = 208  # 16 * kAttnKT: at most 13 key chunks of 16
# attention_rows' and attention_bwd_rows' instantiations, one per key-chunk count
# (VIT_ATTN_KEY_CHUNKS in csrc/layer_tiles.cuh); a call at n keys runs attention_key_chunks(n)
ATTN_KEY_CHUNKS = tuple(range(1, 14))
GEMM_BK = 64  # K must be a multiple of the k-tile (kGemmBK)
GEMM_MAX_ROWS = 65535 * 128  # the GEMM entry points take at most 65535 row tiles of 128
LN_BWD_MAX_DIM = 3584  # kLnBwdMaxDim: the widest row layernorm_bwd_rows takes (its loop path past 1024)
LN_BWD_RES_MAX_DIM = 2416  # kLnBwdResMaxDim: the [res_f32] variant's
GEMM_BM = 128  # kGemmBM: rows of a gemm_bf16 block (gelu_bwd's column partials, one row a block)

# the opt-in backwards of the whole layer, the JAX package's switches
FF_BWD_ENV, FF_BWD_LEGACY_ENV, LAYER_BWD_ENV = "VIT_TPU_FF_BWD", "VIT_TPU_ENABLE_FF_BWD", "VIT_TPU_ENABLE_WHOLE_LAYER_BWD"
# the multi-layer stack, the JAX package's switches and its most layers a call
STACK_ENV, DISABLE_STACK_ENV = "VIT_TPU_STACK_LAYERS", "VIT_TPU_DISABLE_STACK"
STACK_MAX_LAYERS = 6  # _STACK_MAX_LAYERS; kStackMaxLayers in csrc/stack_layers.cu

# launches per kernel since the last reset_launch_counts(); a variant
# ("[dropout]", "[qknorm]", "[block_out]") counts apart from its kernel's
# plain launches
LAUNCHES = {
    "layernorm_rows": 0, "gemm_bf16": 0, "attention_rows": 0,
    "attention_bwd_rows": 0, "gemm_f32out": 0, "layernorm_bwd_rows": 0,
    "attention_rows[dropout]": 0, "gemm_bf16[block_out]": 0, "dropout_apply": 0,
    "attention_bwd_rows[dropout]": 0, "dropout_masks": 0,
    "attention_rows[qknorm]": 0, "attention_rows[dropout,qknorm]": 0,
    "attention_bwd_rows[qknorm]": 0, "attention_bwd_rows[dropout,qknorm]": 0,
    "gemm_bf16[fc1_save]": 0, "gemm_bf16[gelu_bwd]": 0, "layernorm_bwd_rows[res_f32]": 0, "gemm_wgrad": 0,
    "stack_layers": 0, "attention_rows[n_keys]": 0, "stack_layers[tools]": 0,
}

# gemm_bf16 epilogues; "cast" is the qkv epilogue without a bias (one cast
# of the f32 dot), named for the backward's dm = dy . W_out; the FF
# backward's two ("fc1_save", "gelu_bwd") return two tensors each;
# "fc1_f32" is the fc1 of the layer prototypes in tools/
_EPILOGUES = {"qkv": 0, "cast": 0, "out": 1, "fc1": 2, "fc2": 3, "block_out": 5, "fc1_save": 6, "gelu_bwd": 7,
              "fc1_f32": 8}
_FF_EPILOGUES = ("fc1_save", "gelu_bwd")
_EPI_F32 = 4  # gemm_f32out: the f32 dot stored as it is

# gemm_bf16's launches by epilogue (its call site), beside its LAUNCHES entry
GEMM_LAUNCHES = dict.fromkeys(_EPILOGUES, 0)

QK_NORM_EPS = 1e-12  # the qk-norm's rsqrt(sum(x^2) + eps), fused_block.py:331-336

_U32 = 0xFFFFFFFF
STREAM_STRIDE = 1024  # Philox key word 2 = img * 1024 + head (_attn_keep, fused_block.py:171-179)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, GEMM_LAUNCHES):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# the dropout masks: Philox4x32-10 in int64 arithmetic
# ---------------------------------------------------------------------------


def _mulhilo32(m: int, a):
    """``(hi, lo)``, the 32-bit words of ``m * a`` for a uint32 constant and
    uint32 values held in int64.  The 64-bit product overflows int64, so
    ``a`` is split into 16-bit halves."""
    p_lo = m * (a & 0xFFFF)
    p_hi = m * (a >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _U32


def _philox_words(c0, c1, c2, c3, k0, k1):
    """The four output words of Philox4x32-10 (Random123's philox4x32, 10
    rounds), each argument an int or an int64 tensor of uint32 values; the
    twin of ``philox4x32_10`` in csrc/common.cuh."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _U32
            k1 = (k1 + 0xBB67AE85) & _U32
        hi0, lo0 = _mulhilo32(0xD2511F53, c0)
        hi1, lo1 = _mulhilo32(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox4x32_reference(ctr, key):
    """Philox4x32-10 of uint32 words held in integer tensors: ``ctr``
    (..., 4) and ``key`` (..., 2), broadcast, to (..., 4) int64."""
    words = _philox_words(*ctr.to(torch.int64).unbind(-1), *key.to(torch.int64).unbind(-1))
    return torch.stack(torch.broadcast_tensors(*words), -1)


def dropout_threshold(rate: float) -> int:
    """uint32 threshold t with P(bits < t) == rate for uniform bits: the JAX
    ``_dropout_threshold`` (fused_block.py:150-152)."""
    return min(int(rate * 2**32), 2**32 - 1)


def _inv_keep(rate: float) -> float:
    return 1.0 / (1.0 - rate)


_MASK_CHUNK_GROUPS = 1 << 24  # Philox calls a step of _keep_mask, to bound its int64 temporaries


def _keep_mask(seed, streams, n_rows: int, n_cols: int, rate: float):
    """Keep bits (..., n_rows, n_cols) of the Philox streams ``streams`` (an
    int64 tensor of key words img * 1024 + head, leading axis the images):
    element (row, col) is word ``col % 4`` of Philox(ctr = (row, col // 4, 0,
    0), key = (seed, stream)), kept iff >= ``dropout_threshold(rate)``."""
    device = streams.device
    groups = -(-n_cols // 4)
    row = torch.arange(n_rows, device=device, dtype=torch.int64)[:, None]
    c4 = torch.arange(groups, device=device, dtype=torch.int64)[None, :]
    t = dropout_threshold(rate)
    per_image = streams[:1].numel() * n_rows * groups
    out = []
    for chunk in streams.split(max(1, _MASK_CHUNK_GROUPS // per_image)):
        words = _philox_words(row, c4, 0, 0, int(seed) & _U32, chunk[..., None, None])
        bits = torch.stack(torch.broadcast_tensors(*words), -1)
        out.append(bits.reshape(*chunk.shape, n_rows, 4 * groups)[..., :n_cols] >= t)
    return torch.cat(out)


def _attn_keep(seed, b: int, n: int, heads: int, rate: float, device, m: Optional[int] = None):
    """(b, heads, n, m) keep mask of the attention matrix, m = n unless given
    (``_attn_keep``, fused_block.py:171-179; the flash kernels' (n, m)
    masks)."""
    imgs = torch.arange(b, device=device, dtype=torch.int64)
    hs = torch.arange(heads, device=device, dtype=torch.int64)
    return _keep_mask(seed, imgs[:, None] * STREAM_STRIDE + hs[None, :], n, n if m is None else m, rate)


def _out_keep(seed, b: int, n: int, dim: int, heads: int, rate: float, device):
    """(b, n, dim) keep mask of the output dropout, stream head ``heads``
    (``_out_keep``, fused_block.py:182-187)."""
    imgs = torch.arange(b, device=device, dtype=torch.int64)
    return _keep_mask(seed, imgs * STREAM_STRIDE + heads, n, dim, rate)


def dropout_masks_reference(seed, b: int, n: int, dim: int, heads: int, rate: float, *, device=None):
    """Plain twin of the JAX ``dropout_masks`` (fused_block.py:190) on the
    port's Philox streams: ``(attn_keep (b, heads, n, n), out_keep (b, n,
    dim))`` as int32 0/1."""
    device = torch.device("cpu") if device is None else torch.device(device)
    return (_attn_keep(seed, b, n, heads, rate, device).to(torch.int32),
            _out_keep(seed, b, n, dim, heads, rate, device).to(torch.int32))


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


def gelu_tanh_grad_reference(h):
    """d/dh of the tanh GELU in f32: the JAX ``_gelu_tanh_grad``
    (fused_block.py:1147-1153)."""
    c, a = 0.7978845608028654, 0.044715
    t = torch.tanh(c * (h + a * h * h * h))
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * c * (1.0 + 3.0 * a * h * h)


def gemm_bf16_reference(a, w, epilogue: str, *, bias=None, residual=None, aux=None, dropout_rate: float = 0.0,
                        seed=None, heads: int = 0):
    """``a @ w.T`` with f32 accumulation and the epilogue of one of the four
    GEMM sites of ``_layer_rows``:

    - ``qkv``: + bias in f32, then one cast (:1015-1018); ``cast`` is the
      same without a bias;
    - ``out``/``fc2``: cast, + bias, + residual, each rounded (:1040-1049);
    - ``fc1``: cast, + bias, tanh-GELU (:1046-1047);

    or ``block_out``, the out projection of the attention-block kernel
    ``_kernel`` (:357-374): f32 dot + f32 bias, times keep * 1/(1 - rate) of
    the output stream (stream head ``heads``) with ``dropout_rate`` > 0,
    + the f32 residual if given, one cast; ``a`` is (b, n, inner);

    or ``fc1_f32``, the fc1 of the layer prototypes in ``tools/``
    (bench_layer_fused.py:141-143, bench_stack_fusion.py:98-99,
    fused_block_proto.py:108-109): f32 dot + f32 bias, one cast, then the
    tanh GELU of that bf16 value (their out projection and fc2 are
    ``block_out`` without dropout);

    or one of the FF backward's two sites (``_ff_bwd_kernel`` :1553-1567):

    - ``fc1_save``: ``fc1``'s result and its GELU input, ``(act, h1)`` with
      ``h1 = cast(cast(dot) + bias)``;
    - ``gelu_bwd``: ``dh1 = f32 dot * gelu_tanh_grad(h1)`` for ``aux = h1``,
      ``(cast(dh1), db1)`` with ``db1`` the f32 column sum of dh1 over all
      rows.
    """
    if epilogue == "gelu_bwd":
        dh1 = F.linear(a.float(), w.float()) * gelu_tanh_grad_reference(aux.float())
        return dh1.to(a.dtype), dh1.reshape(-1, dh1.shape[-1]).sum(0)
    if epilogue == "fc1_save":
        h1 = F.linear(a, w)
        if bias is not None:
            h1 = h1 + bias
        return F.gelu(h1, approximate="tanh"), h1
    if epilogue == "block_out":
        out = F.linear(a.float(), w.float(), None if bias is None else bias.float())
        if dropout_rate > 0.0:
            b, n, _ = a.shape
            keep = _out_keep(seed, b, n, w.shape[0], heads, dropout_rate, a.device)
            out = out * torch.where(keep, _inv_keep(dropout_rate), 0.0)
        if residual is not None:
            out = out + residual.float()
        return out.to(a.dtype)
    if epilogue in ("qkv", "cast"):
        if bias is None:
            return F.linear(a, w)
        return F.linear(a.float(), w.float(), bias.float()).to(a.dtype)
    if epilogue == "fc1_f32":
        h = F.linear(a.float(), w.float(), None if bias is None else bias.float()).to(a.dtype)
        return F.gelu(h, approximate="tanh")
    h = F.linear(a, w)
    if bias is not None:
        h = h + bias
    if epilogue == "fc1":
        return F.gelu(h, approximate="tanh")
    return h + residual


def gemm_f32out_reference(a, w):
    """``a @ w.T`` accumulated and returned in f32: ``dh = dqkv . W_qkv^T``
    of ``_bwd_kernel`` (fused_block.py:695-700), which feeds the LayerNorm
    backward in f32."""
    return F.linear(a.float(), w.float())


def _qk_norm_rows(t, gamma, *, heads: int, dim_head: int, dtype):
    """The per-head RMSNorm of ``_kernel`` (fused_block.py:323-338) on the
    f32 rows ``t`` (b, heads, n, dh): ``xhat = t * rsqrt(sum(t^2) + 1e-12)``,
    then ``xhat * (gamma * sqrt(dh))`` in f32, cast to ``dtype``.  Returns
    (the normed rows as f32, xhat, the rsqrt), the last two for the
    backward."""
    r = torch.rsqrt(t.square().sum(-1, keepdim=True) + QK_NORM_EPS)
    xhat = t * r
    g = gamma.float().reshape(1, heads, 1, dim_head) * dim_head**0.5
    return (xhat * g).to(dtype).float(), xhat, r


def _softmax_rows(qkv, *, heads: int, dim_head: int, scale: float, gamma_q=None, gamma_k=None, n_keys=None):
    """q, k, v as f32 (b, h, n, d) and P of ``_softmax_from_dots``
    (fused_block.py:82-93) in f32; with the gammas q and k are the normed
    rows, and the last item is (qhat, rq, khat, rk) for the backward (else
    None).  Keys j >= ``n_keys`` (None: n) get no weight."""
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, dim_head).permute(2, 0, 3, 1, 4).float()
    norm = None
    if gamma_q is not None:
        kw = dict(heads=heads, dim_head=dim_head, dtype=qkv.dtype)
        (q, qhat, rq), (k, khat, rk) = _qk_norm_rows(q, gamma_q, **kw), _qk_norm_rows(k, gamma_k, **kw)
        norm = (qhat, rq, khat, rk)
    logits = torch.matmul(q, k.transpose(-1, -2)) * (scale * _LOG2E)
    if n_keys is not None:
        logits = logits.masked_fill(torch.arange(n, device=qkv.device) >= n_keys, -torch.inf)
    p = torch.exp2(logits - logits.amax(-1, keepdim=True))
    return q, k, v, p * (1.0 / p.sum(-1, keepdim=True)), norm


def attention_rows_reference(qkv, *, heads: int, dim_head: int, scale: float, dropout_rate: float = 0.0,
                             seed=None, gamma_q=None, gamma_k=None, n_keys=None):
    """Per-head softmax attention from the packed (b, n, 3*inner) qkv rows to
    merged heads (b, n, inner): f32 logits, ``_softmax_from_dots``
    (fused_block.py:82-93), with ``dropout_rate`` > 0 P = where(keep, P, 0)
    * 1/(1 - rate) in f32 (``_kernel`` :345-348), P cast to qkv.dtype, P.V
    accumulated in f32.  With ``gamma_q``/``gamma_k`` (heads * dim_head
    values each) q and k first go through the qk-norm (:323-338).  With
    ``n_keys`` (1 <= n_keys <= n) keys j >= n_keys are masked out of every
    row's softmax, the -inf key bias of the padded prototypes in ``tools/``
    (bench_layer_fused.py:267-268); all n rows are computed."""
    b, n, _ = qkv.shape
    n_keys = _n_keys("attention_rows", n, n_keys, dropout_rate, gamma_q)
    _, _, v, p, _ = _softmax_rows(qkv, heads=heads, dim_head=dim_head, scale=scale, gamma_q=gamma_q,
                                  gamma_k=gamma_k, n_keys=None if n_keys == n else n_keys)
    if dropout_rate > 0.0:
        keep = _attn_keep(seed, b, n, heads, dropout_rate, qkv.device)
        p = torch.where(keep, p, 0.0) * _inv_keep(dropout_rate)
    o = torch.matmul(p.to(qkv.dtype).float(), v).to(qkv.dtype)
    return o.transpose(1, 2).reshape(b, n, heads * dim_head)


def attention_bwd_rows_reference(qkv, dm, *, heads: int, dim_head: int, scale: float, dropout_rate: float = 0.0,
                                 seed=None, gamma_q=None, gamma_k=None):
    """The per-head loop of ``_bwd_kernel`` (fused_block.py:608-692): from
    the packed qkv rows and the gradient of the merged heads ``dm`` (both
    (b, n, .) in one dtype) to the recomputed merged heads ``m`` and the
    packed ``dqkv``.  P is recomputed as the forward computes it; ``pb =
    pd`` in the IO dtype feeds m and dv, where pd = P or, with
    ``dropout_rate`` > 0, where(keep, P, 0) * 1/(1 - rate); dp is masked and
    scaled the same way (:634-654); ``ds`` uses the unmasked f32 P; dq and dk
    take ``scale`` on the f32 product.

    With ``gamma_q``/``gamma_k`` the norm is recomputed (:614-627) and
    closed on the f32 dq and dk (:665-673): ``dgq = sum over rows of dq *
    qhat``, ``dq = rq (dq g - qhat <dq g, qhat>)`` with g = gamma * sqrt(dh),
    the same for k; the result is then ``(m, dqkv, dgamma_q, dgamma_k)``,
    the dgammas (heads * dim_head,) f32 summed over every row of the batch
    with the sqrt(dh) factor (:678-688)."""
    dt, (b, n, _) = qkv.dtype, qkv.shape
    q, k, v, p, norm = _softmax_rows(qkv, heads=heads, dim_head=dim_head, scale=scale, gamma_q=gamma_q,
                                     gamma_k=gamma_k)
    dmh = dm.reshape(b, n, heads, dim_head).transpose(1, 2).float()
    pd = p
    if dropout_rate > 0.0:
        keep, inv = _attn_keep(seed, b, n, heads, dropout_rate, qkv.device), _inv_keep(dropout_rate)
        pd = torch.where(keep, p, 0.0) * inv
    pb = pd.to(dt).float()
    m = torch.matmul(pb, v).to(dt)
    dv = torch.matmul(pb.transpose(-1, -2), dmh)
    dp = torch.matmul(dmh, v.transpose(-1, -2))
    if dropout_rate > 0.0:
        dp = torch.where(keep, dp, 0.0) * inv
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dgammas = ()
    if norm is not None:
        qhat, rq, khat, rk = norm
        root = dim_head**0.5

        def close(d, xhat, r, gamma):
            dg = (d * xhat).sum((0, 2)).reshape(-1) * root
            dh = d * (gamma.float().reshape(1, heads, 1, dim_head) * root)
            return r * (dh - xhat * (dh * xhat).sum(-1, keepdim=True)), dg

        (dq, dgq), (dk, dgk) = close(dq, qhat, rq, gamma_q), close(dk, khat, rk, gamma_k)
        dgammas = (dgq, dgk)
    dqkv = torch.stack((dq, dk, dv)).to(dt).permute(1, 3, 0, 2, 4)  # (b, n, 3, heads, dh)
    return (m.transpose(1, 2).reshape(b, n, -1), dqkv.reshape(b, n, -1), *dgammas)


def layernorm_bwd_rows_reference(x, dh, weight, *, residual=None, res_f32: bool = False, out_f32: bool = False,
                                 eps: float = LN_EPS):
    """LayerNorm backward of ``_bwd_kernel`` (fused_block.py:702-717) from the
    f32 gradient ``dh`` of the normalised rows: ``xhat`` and ``r`` recomputed
    from x in f32, ``dx = r (dxhat - mean(dxhat) - xhat mean(dxhat xhat))``
    cast to x.dtype, and with ``residual`` the add of :1868,
    ``(f32(dx) + f32(residual))`` cast once more.  Returns ``(dx, dgamma,
    dbeta)``, the last two summed over every row in f32.

    ``res_f32`` (the ``[res_f32]`` variant, ``_ff_bwd_kernel`` :1588-1596 and
    ``_layer_bwd_kernel`` :1261, :1342): the residual (x.dtype or f32) is
    added to the f32 dx before the one cast, which ``out_f32`` leaves out;
    the result is ``(dx, dgamma, dbeta, the residual's f32 column sum)``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    r = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xhat = xc * r
    dh = dh.float()
    dxhat = dh * weight.float()
    dx = r * (dxhat - dxhat.mean(-1, keepdim=True) - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    dim = x.shape[-1]
    sums = ((dh * xhat).reshape(-1, dim).sum(0), dh.reshape(-1, dim).sum(0))
    if res_f32:
        res = residual.float()
        dx = dx + res
        return (dx if out_f32 else dx.to(x.dtype)), *sums, res.reshape(-1, dim).sum(0)
    dx = dx.to(x.dtype)
    if residual is not None:
        dx = (dx.float() + residual.float()).to(x.dtype)
    return (dx, *sums)


def out_dropout_bwd_reference(g, seed, *, heads: int, rate: float):
    """``gm = where(out_keep, f32(g), 0) * 1/(1 - rate)`` cast to g.dtype,
    the first lines of ``_bwd_kernel`` (fused_block.py:574-580); g is (b, n,
    dim)."""
    b, n, dim = g.shape
    keep = _out_keep(seed, b, n, dim, heads, rate, g.device)
    return (torch.where(keep, g.float(), 0.0) * _inv_keep(rate)).to(g.dtype)


def gemm_wgrad_reference(a, b):
    """``a^T b`` over the row axis, in f32: a (K, M) and b (K, N) to (M, N),
    the weight gradients ``_ff_bwd_kernel`` and ``_layer_bwd_kernel``
    accumulate in f32 (fused_block.py:1245-1252, :1321-1333, :1573-1580)."""
    return torch.matmul(a.float().t(), b.float())


def ff_reference(y, ln2_scale, ln2_bias, w1, b1, w2, b2, *, eps: float = LN_EPS):
    """The FF half of the layer, ``y + FF(LN2(y))``: twin of the JAX
    ``_ff_reference`` (fused_block.py:1759-1770), differentiable by
    autograd."""
    h = layernorm_rows_reference(y, ln2_scale, ln2_bias, eps=eps)
    a = gemm_bf16_reference(h, w1, "fc1", bias=b1)
    return gemm_bf16_reference(a, w2, "fc2", bias=b2, residual=y)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_operands(name: str, device, *tensors, dtype=torch.bfloat16) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on a CUDA device, not {device}")
    for t in tensors:
        if t is None:
            continue
        if torch.is_grad_enabled() and t.requires_grad:
            raise ValueError(f"{name}: a kernel call outside autograd; an operand requires grad")
        if t.device != device:
            raise ValueError(f"{name}: operand on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: operand dtype {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _variant(name: str, drop: int, qk: bool, masked: bool = False) -> str:
    """The launch counter of a variant: ``name``, ``name[dropout]``,
    ``name[qknorm]``, ``name[dropout,qknorm]`` or ``name[n_keys]``."""
    tags = [tag for tag, on in (("dropout", drop), ("qknorm", qk), ("n_keys", masked)) if on]
    return f"{name}[{','.join(tags)}]" if tags else name


def _n_keys(name: str, n: int, n_keys, dropout_rate: float, gamma_q) -> int:
    """The key count of an ``attention_rows`` call (None: n), refused
    outside [1, n] and, when it masks keys, beside dropout or the qk-norm
    (the key mask is the tools' prototypes' plain attention)."""
    if n_keys is None:
        return n
    n_keys = int(n_keys)
    if not 1 <= n_keys <= n:
        raise ValueError(f"{name}: n_keys={n_keys} is not in [1, n={n}]")
    if n_keys < n and (dropout_rate or gamma_q is not None):
        raise ValueError(f"{name}: n_keys < n takes neither dropout nor the qk-norm")
    return n_keys


def _gammas(name: str, gamma_q, gamma_k, inner: int):
    """The qk-norm gammas as flat (inner,) views for the kernels, or (None,
    None)."""
    if (gamma_q is None) != (gamma_k is None):
        raise ValueError(f"{name}: gamma_q and gamma_k must be given together")
    if gamma_q is None:
        return None, None
    if gamma_q.numel() != inner or gamma_k.numel() != inner:
        raise ValueError(f"{name}: gammas of {gamma_q.numel()} and {gamma_k.numel()} values for {inner} columns")
    return gamma_q.reshape(-1), gamma_k.reshape(-1)


def _dropout_args(name: str, rate: float, seed):
    """The kernels' dropout arguments (drop, seed bits, threshold, 1/(1 -
    rate)); rate 0 is no dropout."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{name}: dropout rate {rate} is not in [0, 1)")
    if rate == 0.0:
        return 0, 0, 0, 1.0
    if seed is None:
        raise ValueError(f"{name}: dropout_rate > 0 requires a seed")
    return 1, int(seed) & _U32, dropout_threshold(rate), _inv_keep(rate)


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


def _check_gemm(name: str, a, w) -> None:
    n_out, k = w.shape
    if a.shape[-1] != k or k % GEMM_BK or n_out % 8 or a.numel() // k > GEMM_MAX_ROWS:
        raise ValueError(f"{name}: a {tuple(a.shape)} and w {tuple(w.shape)}")


def gemm_bf16(a, w, epilogue: str, *, bias=None, residual=None, aux=None, dropout_rate: float = 0.0, seed=None,
              heads: int = 0):
    """``a @ w.T`` (w is (out, in)) with the named epilogue, see
    :func:`gemm_bf16_reference`; ``block_out``, ``fc1_save`` and
    ``gelu_bwd`` count as variants of their own."""
    if epilogue not in _EPILOGUES:
        raise ValueError(f"gemm_bf16: unknown epilogue {epilogue!r}")
    if dropout_rate and epilogue != "block_out":
        raise ValueError(f"gemm_bf16[{epilogue}]: only the block_out epilogue takes dropout")
    if a.device.type == "cpu":
        return gemm_bf16_reference(a, w, epilogue, bias=bias, residual=residual, aux=aux, dropout_rate=dropout_rate,
                                   seed=seed, heads=heads)
    _check_gemm("gemm_bf16", a, w)
    if epilogue in _FF_EPILOGUES:
        return _gemm_ff(a, w, epilogue, bias, aux)
    n_out, k = w.shape
    if bias is not None and (epilogue == "cast" or bias.shape != (n_out,)):
        raise ValueError(f"gemm_bf16[{epilogue}]: bias {tuple(bias.shape)} for {n_out} outputs")
    out_shape = (*a.shape[:-1], n_out)
    if epilogue == "fc1_f32" and residual is not None:
        raise ValueError("gemm_bf16[fc1_f32]: takes no residual")
    if epilogue in ("out", "fc2") and (residual is None or residual.shape != out_shape):
        raise ValueError(f"gemm_bf16[{epilogue}]: needs a residual of shape {out_shape}")
    if epilogue == "block_out" and (a.dim() != 3 or (residual is not None and residual.shape != out_shape)):
        raise ValueError(f"gemm_bf16[block_out]: a {tuple(a.shape)} must be (b, n, in), residual (b, n, out) or None")
    drop = _dropout_args(f"gemm_bf16[{epilogue}]", dropout_rate, seed)
    _check_operands("gemm_bf16", a.device, a, w, bias, residual)
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    lib = load_library()
    err = lib.lib.vit_gemm_bf16(
        a.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        out.data_ptr(), a.numel() // k, n_out, k, _EPILOGUES[epilogue],
        a.shape[-2] if epilogue == "block_out" else 0, heads, *drop, _stream(a.device),
    )
    lib.check(f"gemm_bf16[{epilogue}]", err)
    LAUNCHES["gemm_bf16[block_out]" if epilogue == "block_out" else "gemm_bf16"] += 1
    GEMM_LAUNCHES[epilogue] += 1
    return out


def _gemm_ff(a, w, epilogue: str, bias, aux):
    """The FF backward's two epilogues of the gemm_bf16 kernel: ``fc1_save``
    returns ``(act, h1)``, ``gelu_bwd`` (``aux`` = h1) ``(dh1, db1)``; the
    latter's launch ends with the fixed-order sum of its blocks' column
    partials, so db1 is deterministic."""
    n_out, k = w.shape
    out_shape = (*a.shape[:-1], n_out)
    name = f"gemm_bf16[{epilogue}]"
    if bias is not None and (epilogue == "gelu_bwd" or bias.shape != (n_out,)):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} for {n_out} outputs")
    if epilogue == "gelu_bwd" and (aux is None or aux.shape != out_shape):
        raise ValueError(f"{name}: needs h1 (aux) of shape {out_shape}")
    _check_operands("gemm_bf16", a.device, a, w, bias, aux)
    rows = a.numel() // k
    out = torch.empty(out_shape, dtype=a.dtype, device=a.device)
    h1 = colpart = colsum = None
    if epilogue == "fc1_save":
        h1 = torch.empty_like(out)
    else:
        colpart = torch.empty((-(-rows // GEMM_BM), n_out), dtype=torch.float32, device=a.device)
        colsum = torch.empty((n_out,), dtype=torch.float32, device=a.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    err = lib.lib.vit_gemm_ff(
        a.data_ptr(), w.data_ptr(), ptr(bias), ptr(aux), out.data_ptr(), ptr(h1), ptr(colpart), ptr(colsum),
        rows, n_out, k, _EPILOGUES[epilogue], _stream(a.device),
    )
    lib.check(name, err)
    LAUNCHES[name] += 1
    GEMM_LAUNCHES[epilogue] += 1
    return (out, h1) if epilogue == "fc1_save" else (out, colsum)


# gemm_wgrad's work split (csrc/gemm_wgrad.cu): 128 x 128 output tiles,
# k-tiles of 64 rows
WGRAD_BM, WGRAD_BN, WGRAD_BK = 128, 128, 64


def gemm_wgrad_blocks(m: int, n: int, k: int, sms: int):
    """``(blocks, chunk)`` of ``gemm_wgrad`` at (M, N, K) on a card of
    ``sms`` SMs: one block an SM; the rem = tiles mod blocks tiles past the
    last whole wave are shared out by stream-K over K cut into chunks of
    ``chunk`` = blocks / gcd(rem, blocks) k-tiles (all of K if shorter), the
    shortest chunk whose rem x chunk units every block gets an equal share
    of: the blocks stay within one chunk of each other, so they read the
    same few k rows of A and B from L2.  A function of the shape and the SM
    count alone, so the pieces and the sums' order are too."""
    tiles, ktiles = -(-m // WGRAD_BM) * -(-n // WGRAD_BN), -(-k // WGRAD_BK)
    rem = tiles % sms
    return sms, (min(ktiles, sms // math.gcd(rem, sms)) if rem else 0)


def gemm_wgrad_pieces(m: int, n: int, k: int, blocks: int, chunk: int):
    """The kernel's walk, for the tests: a list a block of ``(tile, k-tiles)``,
    ``k-tiles`` the k-tiles it adds into that tile in order, then, for a
    stream-K piece, ``(slot, index, pieces)``: its partial's slot ``ts +
    b`` (``ts`` the tile's index among the stream-K tiles), its place in the
    tile's block order and the tile's piece count (``wgrad_pieces`` and
    ``wgrad_block_of`` in csrc/gemm_wgrad.cu)."""
    ktiles = -(-k // WGRAD_BK)
    tiles = -(-m // WGRAD_BM) * -(-n // WGRAD_BN)
    full, rem = divmod(tiles, blocks)
    units = rem * chunk
    skb = min(blocks, units)  # the blocks that share the stream-K units: no range is empty

    def block_of(u):
        return ((u + 1) * skb - 1) // units

    walk = []
    for b in range(blocks):
        pieces = [(b + i * blocks, list(range(ktiles))) for i in range(full)]
        if rem and b < skb:
            s, e = b * units // skb, (b + 1) * units // skb
            for ts in range(s // chunk, -(-e // chunk)):
                lo, hi = max(s, ts * chunk) - ts * chunk, min(e, (ts + 1) * chunk) - ts * chunk
                if lo >= hi:
                    continue
                kts = [c + o for c in range(0, ktiles, chunk) for o in range(lo, hi) if c + o < ktiles]
                first = block_of(ts * chunk)
                pieces.append((full * blocks + ts, kts, ts + b, b - first,
                               block_of((ts + 1) * chunk - 1) - first + 1))
        walk.append(pieces)
    return walk


def gemm_wgrad(a, b):
    """``a^T b`` over the row axis: a (K, M) and b (K, N) bf16 to (M, N) f32,
    a weight gradient (see :func:`gemm_wgrad_reference`).  One persistent
    launch (:func:`gemm_wgrad_blocks`): whole tiles a block, then the tiles
    left shared out by stream-K, each such tile's partial sums added in a
    fixed order by the last of its pieces, so the result is bitwise
    deterministic; neither operand is transposed in memory."""
    if a.device.type == "cpu":
        return gemm_wgrad_reference(a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0] or a.shape[0] > GEMM_MAX_ROWS or any(
        d < 8 or d % 8 for d in (a.shape[1], b.shape[1])
    ):
        raise ValueError(f"gemm_wgrad: a {tuple(a.shape)} and b {tuple(b.shape)}; needs (K, M) and (K, N), "
                         f"M and N multiples of 8")
    _check_operands("gemm_wgrad", a.device, a, b)
    (k, m), n = a.shape, b.shape[1]
    blocks, chunk = gemm_wgrad_blocks(m, n, k, torch.cuda.get_device_properties(a.device).multi_processor_count)
    rem = -(-m // WGRAD_BM) * -(-n // WGRAD_BN) % blocks
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    partial = counters = None
    if rem:
        partial = torch.empty((rem + blocks, 2, 64, WGRAD_BN), dtype=torch.float32, device=a.device)
        counters = torch.zeros((rem, 2), dtype=torch.int32, device=a.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    err = lib.lib.vit_gemm_wgrad(a.data_ptr(), b.data_ptr(), out.data_ptr(), ptr(partial), ptr(counters),
                                 m, n, k, blocks, chunk, _stream(a.device))
    lib.check("gemm_wgrad", err)
    LAUNCHES["gemm_wgrad"] += 1
    return out


def gemm_f32out(a, w):
    """``a @ w.T`` (w is (out, in)) of bf16 operands, stored in f32: the
    f32 epilogue of the ``gemm_bf16`` kernel, see
    :func:`gemm_f32out_reference`."""
    if a.device.type == "cpu":
        return gemm_f32out_reference(a, w)
    _check_gemm("gemm_f32out", a, w)
    _check_operands("gemm_f32out", a.device, a, w)
    n_out, k = w.shape
    out = torch.empty((*a.shape[:-1], n_out), dtype=torch.float32, device=a.device)
    lib = load_library()
    err = lib.lib.vit_gemm_bf16(
        a.data_ptr(), w.data_ptr(), None, None, out.data_ptr(),
        a.numel() // k, n_out, k, _EPI_F32, 0, 0, *_dropout_args("gemm_f32out", 0.0, None), _stream(a.device),
    )
    lib.check("gemm_f32out", err)
    LAUNCHES["gemm_f32out"] += 1
    return out


def attention_key_chunks(n: int) -> int:
    """The key chunks of 16 (the instantiation) that ``attention_rows`` and
    ``attention_bwd_rows`` run at ``n`` keys, 1 <= n <= ATTN_MAX_KEYS:
    ceil(n / 16), the choice of both C entry points (``attn_key_chunks`` in
    csrc/layer_tiles.cuh)."""
    if not 1 <= n <= ATTN_MAX_KEYS:
        raise ValueError(f"attention_rows: n={n} is not in [1, {ATTN_MAX_KEYS}]")
    return -(-n // 16)


def _check_attention(name: str, qkv, heads: int, dim_head: int) -> None:
    b, n, three_inner = qkv.shape
    if (
        three_inner != 3 * heads * dim_head
        or dim_head != ATTN_DIM_HEAD
        or n > ATTN_MAX_KEYS
        or b > 65535
    ):
        raise ValueError(
            f"{name}: qkv {tuple(qkv.shape)} with heads={heads}, "
            f"dim_head={dim_head}; the kernel takes dim_head={ATTN_DIM_HEAD}, "
            f"n <= {ATTN_MAX_KEYS}"
        )


def attention_rows(qkv, *, heads: int, dim_head: int, scale: float, dropout_rate: float = 0.0, seed=None,
                   gamma_q=None, gamma_k=None, n_keys=None):
    """Softmax attention of every head, from packed qkv rows (b, n, 3*inner)
    to merged heads (b, n, inner); the logits stay on chip.  With
    ``dropout_rate`` > 0 (the ``[dropout]`` variant) P is masked in-kernel
    from the (seed, img, head) Philox streams; with ``gamma_q``/``gamma_k``
    (the ``[qknorm]`` variant, heads * dim_head gammas each) q and k are
    normalised in-kernel; with ``n_keys`` < n (the ``[n_keys]`` variant)
    keys j >= n_keys are masked.  See :func:`attention_rows_reference`."""
    if qkv.device.type == "cpu":
        return attention_rows_reference(qkv, heads=heads, dim_head=dim_head, scale=scale,
                                        dropout_rate=dropout_rate, seed=seed, gamma_q=gamma_q, gamma_k=gamma_k,
                                        n_keys=n_keys)
    _check_attention("attention_rows", qkv, heads, dim_head)
    n_keys = _n_keys("attention_rows", qkv.shape[1], n_keys, dropout_rate, gamma_q)
    drop = _dropout_args("attention_rows", dropout_rate, seed)
    gq, gk = _gammas("attention_rows", gamma_q, gamma_k, heads * dim_head)
    _check_operands("attention_rows", qkv.device, qkv, gq, gk)
    b, n, _ = qkv.shape
    out = torch.empty((b, n, heads * dim_head), dtype=qkv.dtype, device=qkv.device)
    lib = load_library()
    err = lib.lib.vit_attention_rows(
        qkv.data_ptr(), out.data_ptr(), b, n, n_keys, heads, dim_head, scale * _LOG2E, *drop,
        None if gq is None else gq.data_ptr(), None if gk is None else gk.data_ptr(), _stream(qkv.device),
    )
    name = _variant("attention_rows", drop[0], gq is not None, n_keys < n)
    lib.check(name, err)
    LAUNCHES[name] += 1
    return out


def attention_bwd_rows(qkv, dm, *, heads: int, dim_head: int, scale: float, dropout_rate: float = 0.0, seed=None,
                       gamma_q=None, gamma_k=None):
    """The attention backward of every head, from packed qkv rows and the
    merged-heads gradient ``dm`` to ``(m, dqkv)``, see
    :func:`attention_bwd_rows_reference`.  One launch, a block an (image,
    head) at ``attention_key_chunks(n)`` key chunks, runs a row pass (m, dq)
    and a key pass (dk, dv) on operands it loads once; the logits stay on
    chip.  With ``dropout_rate`` > 0 (the ``[dropout]`` variant) the row pass
    draws the forward's mask once, into a scratch buffer the key pass reads.
    With ``gamma_q``/``gamma_k`` (the ``[qknorm]`` variant) each block
    normalises its head's q and k once and closes the norm on dq and dk,
    writes its head's dgamma terms into a scratch buffer, and a fixed-order
    sum of those ends the launch: the result is ``(m, dqkv, dgamma_q,
    dgamma_k)``."""
    if qkv.device.type == "cpu":
        return attention_bwd_rows_reference(qkv, dm, heads=heads, dim_head=dim_head, scale=scale,
                                            dropout_rate=dropout_rate, seed=seed, gamma_q=gamma_q, gamma_k=gamma_k)
    _check_attention("attention_bwd_rows", qkv, heads, dim_head)
    b, n, _ = qkv.shape
    inner = heads * dim_head
    if dm.shape != (b, n, inner):
        raise ValueError(f"attention_bwd_rows: dm {tuple(dm.shape)} for qkv {tuple(qkv.shape)}")
    drop = _dropout_args("attention_bwd_rows", dropout_rate, seed)
    gq, gk = _gammas("attention_bwd_rows", gamma_q, gamma_k, inner)
    _check_operands("attention_bwd_rows", qkv.device, qkv, dm, gq, gk)
    m = torch.empty((b, n, inner), dtype=qkv.dtype, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    kt = attention_key_chunks(n)
    keep = partial = dg = None
    if drop[0]:  # the keep words of each (image, head): 16 kt query rows x ceil(16 kt / 32) words
        keep = torch.empty((b, heads, 16 * kt, -(-kt // 2)), dtype=torch.int32, device=qkv.device)
    if gq is not None:
        partial = torch.empty((b, 2, inner), dtype=torch.float32, device=qkv.device)
        dg = torch.empty((2, inner), dtype=torch.float32, device=qkv.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load_library()
    err = lib.lib.vit_attention_bwd_rows(
        qkv.data_ptr(), dm.data_ptr(), m.data_ptr(), dqkv.data_ptr(), ptr(keep),
        b, n, heads, dim_head, scale * _LOG2E, scale, *drop, ptr(gq), ptr(gk), ptr(partial), ptr(dg),
        _stream(qkv.device),
    )
    name = _variant("attention_bwd_rows", drop[0], gq is not None)
    lib.check(name, err)
    LAUNCHES[name] += 1
    return (m, dqkv) if dg is None else (m, dqkv, dg[0], dg[1])


def dropout_apply(g, seed, *, heads: int, rate: float):
    """``gm``, the out projection's gradient after the output dropout: see
    :func:`out_dropout_bwd_reference`.  ``g`` is (b, n, dim) and ``rate`` > 0."""
    if g.device.type == "cpu":
        return out_dropout_bwd_reference(g, seed, heads=heads, rate=rate)
    if g.dim() != 3 or g.shape[-1] % 8 or not rate > 0.0:
        raise ValueError(f"dropout_apply: g {tuple(g.shape)} at rate {rate}; needs (b, n, dim), dim % 8 == 0, rate > 0")
    _, seed_bits, threshold, inv = _dropout_args("dropout_apply", rate, seed)
    _check_operands("dropout_apply", g.device, g)
    gm = torch.empty_like(g)
    b, n, dim = g.shape
    lib = load_library()
    err = lib.lib.vit_dropout_apply(
        g.data_ptr(), gm.data_ptr(), b * n, n, dim, heads, seed_bits, threshold, inv, _stream(g.device),
    )
    lib.check("dropout_apply", err)
    LAUNCHES["dropout_apply"] += 1
    return gm


def dropout_masks(seed, b: int, n: int, dim: int, heads: int, rate: float, *, device=None):
    """Replay of the attention block's keep masks, the JAX ``dropout_masks``
    (fused_block.py:190): ``(attn_keep (b, heads, n, n), out_keep (b, n,
    dim))`` int32 0/1.  On a CUDA ``device`` (the default, see
    :func:`~vit_pytorch_tpu_torch.utils.helpers.default_device`) one launch
    of the replay kernel; on ``device="cpu"`` :func:`dropout_masks_reference`."""
    device = default_device(device)
    if device.type == "cpu":
        return dropout_masks_reference(seed, b, n, dim, heads, rate, device=device)
    if device.type != "cuda":
        raise ValueError(f"dropout_masks: the kernel runs on a CUDA device, not {device}")
    if not (0 < b <= 65535 and n > 0 and dim > 0 and 0 < heads < STREAM_STRIDE):
        raise ValueError(f"dropout_masks: b={b}, n={n}, dim={dim}, heads={heads}")
    _, seed_bits, threshold, _ = _dropout_args("dropout_masks", rate, seed)
    attn = torch.empty((b, heads, n, n), dtype=torch.int32, device=device)
    out = torch.empty((b, n, dim), dtype=torch.int32, device=device)
    lib = load_library()
    err = lib.lib.vit_dropout_masks(attn.data_ptr(), out.data_ptr(), b, n, dim, heads, seed_bits, threshold,
                                    _stream(device))
    lib.check("dropout_masks", err)
    LAUNCHES["dropout_masks"] += 1
    return attn, out


def layernorm_bwd_rows(x, dh, weight, *, residual=None, res_f32: bool = False, out_f32: bool = False,
                       eps: float = LN_EPS):
    """LayerNorm backward of each row from its f32 gradient ``dh``, with the
    residual add, and dgamma/dbeta over all rows, see
    :func:`layernorm_bwd_rows_reference`.  One launch runs the row pass
    (per-block partial sums into a scratch buffer) and a fixed-order sum of
    the partials, so the result does not depend on block scheduling.
    ``res_f32`` is the ``[res_f32]`` variant (the residual, bf16 or f32,
    added before the one cast; ``out_f32`` keeps dx in f32; the residual's
    column sum as a fourth result)."""
    if x.device.type == "cpu":
        return layernorm_bwd_rows_reference(x, dh, weight, residual=residual, res_f32=res_f32, out_f32=out_f32,
                                            eps=eps)
    if res_f32:
        return _layernorm_bwd_rows_res(x, dh, weight, residual, out_f32, eps)
    if out_f32:
        raise ValueError("layernorm_bwd_rows: out_f32 is an option of the [res_f32] variant")
    dim = x.shape[-1]
    if (
        dh.shape != x.shape or weight.shape != (dim,) or dim % 8 or dim > LN_BWD_MAX_DIM
        or (residual is not None and residual.shape != x.shape)
    ):
        raise ValueError(f"layernorm_bwd_rows: x {tuple(x.shape)}, dh {tuple(dh.shape)}, weight {tuple(weight.shape)}")
    _check_operands("layernorm_bwd_rows", x.device, x, weight, residual)
    _check_operands("layernorm_bwd_rows", x.device, dh, dtype=torch.float32)
    rows = x.numel() // dim
    lib = load_library()
    blocks = lib.lib.vit_layernorm_bwd_blocks(rows)
    dx = torch.empty_like(x)
    partial = torch.empty((blocks, 2, dim), dtype=torch.float32, device=x.device)
    sums = torch.empty((2, dim), dtype=torch.float32, device=x.device)
    err = lib.lib.vit_layernorm_bwd_rows(
        x.data_ptr(), dh.data_ptr(), weight.data_ptr(),
        None if residual is None else residual.data_ptr(),
        dx.data_ptr(), partial.data_ptr(), sums.data_ptr(), rows, dim, eps, _stream(x.device),
    )
    lib.check("layernorm_bwd_rows", err)
    LAUNCHES["layernorm_bwd_rows"] += 1
    return dx, sums[0], sums[1]


def _layernorm_bwd_rows_res(x, dh, weight, residual, out_f32: bool, eps: float):
    """The ``[res_f32]`` launch of :func:`layernorm_bwd_rows`."""
    dim = x.shape[-1]
    name = "layernorm_bwd_rows[res_f32]"
    if (
        residual is None or residual.shape != x.shape or residual.dtype not in (x.dtype, torch.float32)
        or dh.shape != x.shape or weight.shape != (dim,) or dim % 8 or dim > LN_BWD_RES_MAX_DIM
    ):
        raise ValueError(f"{name}: x {tuple(x.shape)}, dh {tuple(dh.shape)}, weight {tuple(weight.shape)}, residual "
                         f"{None if residual is None else (tuple(residual.shape), residual.dtype)}")
    _check_operands(name, x.device, x, weight)
    _check_operands(name, x.device, dh, dtype=torch.float32)
    _check_operands(name, x.device, residual, dtype=residual.dtype)
    rows = x.numel() // dim
    lib = load_library()
    blocks = lib.lib.vit_layernorm_bwd_blocks(rows)
    dx = torch.empty(x.shape, dtype=torch.float32 if out_f32 else x.dtype, device=x.device)
    partial = torch.empty((blocks, 3, dim), dtype=torch.float32, device=x.device)
    sums = torch.empty((3, dim), dtype=torch.float32, device=x.device)
    err = lib.lib.vit_layernorm_bwd_rows_res(
        x.data_ptr(), dh.data_ptr(), weight.data_ptr(), residual.data_ptr(), int(residual.dtype == torch.float32),
        dx.data_ptr(), int(out_f32), partial.data_ptr(), sums.data_ptr(), rows, dim, eps, _stream(x.device),
    )
    lib.check(name, err)
    LAUNCHES[name] += 1
    return dx, sums[0], sums[1], sums[2]


# the kernels (each falls to its twin for a CPU tensor) and their twins, in
# the one chain that runs the layer either way
KERNELS = SimpleNamespace(
    layernorm_rows=layernorm_rows, gemm_bf16=gemm_bf16, attention_rows=attention_rows,
    attention_bwd_rows=attention_bwd_rows, gemm_f32out=gemm_f32out,
    layernorm_bwd_rows=layernorm_bwd_rows, dropout_apply=dropout_apply, gemm_wgrad=gemm_wgrad,
)
TWINS = SimpleNamespace(
    layernorm_rows=layernorm_rows_reference, gemm_bf16=gemm_bf16_reference,
    attention_rows=attention_rows_reference, attention_bwd_rows=attention_bwd_rows_reference,
    gemm_f32out=gemm_f32out_reference, layernorm_bwd_rows=layernorm_bwd_rows_reference,
    dropout_apply=out_dropout_bwd_reference, gemm_wgrad=gemm_wgrad_reference,
)


# ---------------------------------------------------------------------------
# the layer: forward chain, attention-block backward, autograd Function
# ---------------------------------------------------------------------------


def fused_block_supported(x_shape, dtype, heads: int, dim_head: int, dim: int) -> bool:
    """Static eligibility of the attention block's kernel chain, forward and
    backward, on an H100 (not the TPU's VMEM gates): bf16 3-D inputs with
    ``d == dim`` and the shapes its kernels take (see
    :func:`whole_layer_supported`): dim_head 64, n <= 208, K of every
    product (dim, inner, 3*inner) a multiple of 64, dim <= 3584."""
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
        and dim <= LN_BWD_MAX_DIM
        and dim % GEMM_BK == 0
        and inner % GEMM_BK == 0
    )


def fused_dropout_supported(x_shape, heads: int, dim_head: int) -> bool:
    """Kernel-tier dropout needs the kernel backward to replay the masks.
    Here the backward takes every shape the forward takes, so the only
    further condition is that the (seed, img * 1024 + head) streams stay
    apart: ``heads < 1024`` (the output stream is head ``heads``)."""
    return len(x_shape) == 3 and 0 < x_shape[1] <= ATTN_MAX_KEYS and dim_head == ATTN_DIM_HEAD and heads < STREAM_STRIDE


def whole_layer_supported(x_shape, dtype, heads: int, dim_head: int, dim: int, mlp_dim: int) -> bool:
    """Static eligibility of the kernel chains, forward and backward, on an
    H100.

    Not the TPU's VMEM gates.  It admits bf16 3-D inputs with ``d == dim`` and
    the shapes the kernels take:

    - attention_rows and attention_bwd_rows: ``dim_head == 64`` and
      ``n <= 208`` (13 key chunks of 16, for ViT-B/16's 197 tokens; both
      run ``attention_key_chunks(n)`` of them).  The logit rows sit in
      registers, up to 104 f32 a thread, which is the binding limit; the
      backward's block also holds its head's q, k, v and dm in shared
      memory, 104 KB at 208 keys (two blocks an SM).
    - gemm_bf16 and gemm_f32out: every K (dim, inner, 3*inner, mlp_dim) a
      multiple of 64 and every N a multiple of 8; M = b*n is masked, up to
      65535 row tiles of 128.
    - layernorm_rows: ``dim % 8 == 0``, implied by the GEMM's K;
      layernorm_bwd_rows also ``dim <= 3584`` (its per-warp f32 partial sums
      of dgamma and dbeta in shared memory).
    """
    return fused_block_supported(x_shape, dtype, heads, dim_head, dim) and mlp_dim % GEMM_BK == 0


def _ff_bwd_kernels_take(x_shape, dim: int, mlp_dim: int) -> bool:
    """The shapes the FF backward's kernels take beyond the forward's (the
    H100 kernels' own limits, not the TPU's VMEM estimates ``_ff_bwd_rows``,
    ``_vmem_bytes_*`` and the ``*_EST_LIMIT``s): every K a multiple of 64,
    layernorm_bwd_rows[res_f32]'s dim <= 2416; the rows are masked, so any
    b*n up to the GEMM's row limit goes."""
    b, n, _ = x_shape
    return (
        dim % GEMM_BK == 0 and mlp_dim % GEMM_BK == 0 and 0 < dim <= LN_BWD_RES_MAX_DIM
        and 0 < b * n <= GEMM_MAX_ROWS
    )


def ff_bwd_mode(x_shape, dtype, dim: int, mlp_dim: int) -> str:
    """The FF backward of the whole layer: ``""`` (autograd through
    :func:`ff_reference`, the default), ``"full"`` or ``"hybrid"`` (the port
    of ``_ff_bwd_kernel``), as the JAX ``ff_bwd_mode`` (fused_block.py:
    1619-1655) reads it at call time: ``VIT_TPU_FF_BWD``, else the legacy
    ``VIT_TPU_ENABLE_FF_BWD`` set means ``full``; any other value is off.
    The shape gate is the H100 kernels' (:func:`_ff_bwd_kernels_take`);
    ``dtype`` and the attention's shapes are the whole layer's own gate's
    (:func:`whole_layer_supported`), which admitted the forward on the card,
    and on the CPU the twins take any."""
    mode = os.environ.get(FF_BWD_ENV, "")
    if not mode and os.environ.get(FF_BWD_LEGACY_ENV):
        mode = "full"
    if mode not in ("full", "hybrid"):
        return ""
    return mode if _ff_bwd_kernels_take(x_shape, dim, mlp_dim) else ""


def ff_bwd_supported(x_shape, dtype, dim: int, mlp_dim: int) -> bool:
    return bool(ff_bwd_mode(x_shape, dtype, dim, mlp_dim))


def layer_bwd_supported(x_shape, dtype, heads: int, dim_head: int, dim: int, mlp_dim: int) -> bool:
    """The whole-layer backward (the port of ``_layer_bwd_kernel``), opt-in
    as in the JAX package (fused_block.py:1364-1386): ``VIT_TPU_ENABLE_
    WHOLE_LAYER_BWD`` set at call time, and the FF kernels' shapes, as
    :func:`ff_bwd_mode`; its attention half runs the kernels of the default
    backward, whose shapes the forward's gate admitted."""
    return bool(os.environ.get(LAYER_BWD_ENV)) and _ff_bwd_kernels_take(x_shape, dim, mlp_dim)


# the gemm_bf16 epilogues of the out projection, fc1 and fc2: the package's
# _layer_rows rounds each product before its adds; the layer prototypes in
# tools/ (bench_layer_fused.py, bench_stack_fusion.py) add in f32 and cast once
LAYER_EPILOGUES = {"package": ("out", "fc1", "fc2"), "tools": ("block_out", "fc1_f32", "block_out")}


def _layer_forward(ops, x, w_qkv, b_qkv, w_out, b_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, heads, dim_head, scale, eps,
                   epilogues: str = "package", n_keys=None):
    """The seven launches of the forward, with the out, fc1 and fc2
    epilogues of :data:`LAYER_EPILOGUES` ``[epilogues]`` and keys j >=
    ``n_keys`` masked (None: none); returns ``(out, y)``."""
    out_epi, fc1_epi, fc2_epi = LAYER_EPILOGUES[epilogues]
    h = ops.layernorm_rows(x, ln1s, ln1b, eps=eps)
    qkv = ops.gemm_bf16(h, w_qkv, "qkv", bias=b_qkv)
    m = ops.attention_rows(qkv, heads=heads, dim_head=dim_head, scale=scale, n_keys=n_keys)
    y = ops.gemm_bf16(m, w_out, out_epi, bias=b_out, residual=x)
    h2 = ops.layernorm_rows(y, ln2s, ln2b, eps=eps)
    a = ops.gemm_bf16(h2, w1, fc1_epi, bias=b1)
    return ops.gemm_bf16(a, w2, fc2_epi, bias=b2, residual=y), y


class AttentionBlockGrads(NamedTuple):
    """What :func:`attention_block_bwd_reference` returns: the outputs of the
    JAX ``_bwd_kernel`` (dx, h, dqkv, m, dgamma, dbeta) and the weight
    gradients its launcher ``_pallas_backward`` contracts from them, in the
    port's (out, in) weight layout."""

    dx: torch.Tensor
    h: torch.Tensor
    dqkv: torch.Tensor
    m: torch.Tensor
    dW_qkv: torch.Tensor
    db_qkv: Optional[torch.Tensor]
    dW_out: torch.Tensor
    dgamma: torch.Tensor
    dbeta: torch.Tensor
    gm: torch.Tensor  # g after the output dropout (g itself without dropout)
    dgamma_q: Optional[torch.Tensor] = None  # qk-norm: (heads * dim_head,) f32
    dgamma_k: Optional[torch.Tensor] = None


def _attention_block_bwd(
    ops, x, g, w_qkv, b_qkv, w_out, ln_scale, ln_bias, *, heads, dim_head, scale, eps, residual=None,
    dropout_rate: float = 0.0, seed=None, gamma_q=None, gamma_k=None,
) -> AttentionBlockGrads:
    """Backward of ``y = x + Attn(LN(x))`` with respect to everything but the
    residual path, from ``g = dL/dy``; with ``residual`` the LayerNorm
    backward also adds it to dx (the ``dx_ln + dy`` of :1868).  With
    ``dropout_rate`` > 0, g first goes through the output dropout's mask
    (``gm``, :574-580) and the attention backward replays the attention mask;
    with the qk-norm gammas it also returns dgamma_q and dgamma_k.

    The products in ``_bwd_kernel``'s body (dm, the attention products, dh)
    run through ``ops``; the weight gradients are ``torch.matmul`` over the
    whole batch as in ``_pallas_backward`` (:802-816), and return in the IO
    dtype: an f32-accumulated product rounded once, as the JAX package's f32
    dW cast to the weight dtype."""
    gm = ops.dropout_apply(g, seed, heads=heads, rate=dropout_rate) if dropout_rate > 0.0 else g
    h = ops.layernorm_rows(x, ln_scale, ln_bias, eps=eps)
    qkv = ops.gemm_bf16(h, w_qkv, "qkv", bias=b_qkv)
    # a.w products as a.(w^T)^T: a transposed copy of each weight, once a
    # backward, for the kernel's (out, in) operand layout
    dm = ops.gemm_bf16(gm, w_out.t().contiguous(), "cast")
    m, dqkv, *dgammas = ops.attention_bwd_rows(qkv, dm, heads=heads, dim_head=dim_head, scale=scale,
                                               dropout_rate=dropout_rate, seed=seed, gamma_q=gamma_q, gamma_k=gamma_k)
    dh = ops.gemm_f32out(dqkv, w_qkv.t().contiguous())
    dx, dgamma, dbeta = ops.layernorm_bwd_rows(x, dh, ln_scale, residual=residual, eps=eps)
    rows = lambda t: t.reshape(-1, t.shape[-1])
    dW_qkv = torch.matmul(rows(dqkv).t(), rows(h))
    dW_out = torch.matmul(rows(gm).t(), rows(m))
    db_qkv = rows(dqkv).float().sum(0) if b_qkv is not None else None
    return AttentionBlockGrads(dx, h, dqkv, m, dW_qkv, db_qkv, dW_out, dgamma, dbeta, gm, *dgammas)


def attention_block_bwd_reference(
    x, g, w_qkv, b_qkv, w_out, ln_scale, ln_bias, *, heads: int, dim_head: int,
    scale: Optional[float] = None, eps: float = LN_EPS,
) -> AttentionBlockGrads:
    """Plain twin of the JAX ``_pallas_backward`` without dropout and qk-norm
    (fused_block.py:720-817): dx is the LayerNorm path's ``dx_ln`` alone."""
    scale = dim_head**-0.5 if scale is None else float(scale)
    return _attention_block_bwd(
        TWINS, x, g, w_qkv, b_qkv, w_out, ln_scale, ln_bias,
        heads=heads, dim_head=dim_head, scale=scale, eps=eps,
    )


def _ff_backward(ops, y, g, ln2s, ln2b, w1, b1, w2, *, eps, hybrid: bool = False, dy_f32: bool = False):
    """The backward of ``z = y + FF(LN2(y)) + b2`` from ``g = dL/dz``, the
    port of ``_ff_pallas_backward`` (fused_block.py:1662-1756): ``(dy,
    dln2s, dln2b, dW1, db1, dW2, db2)``, dy in y's dtype (in f32 with
    ``dy_f32``, as ``_layer_bwd_kernel`` keeps it, :1261), db2 in f32, the
    rest in their parameters' dtypes, the weights' in the port's (out, in)
    layout.  ``hybrid``: the two dW products are ``torch.matmul`` on the
    emitted y2, act and dh1, as JAX leaves them to XLA (:1737-1745); else
    ``gemm_wgrad``, the accumulators of ``_ff_bwd_kernel``'s body."""
    rows = lambda t: t.reshape(-1, t.shape[-1])
    y2 = ops.layernorm_rows(y, ln2s, ln2b, eps=eps)
    act, h1 = ops.gemm_bf16(y2, w1, "fc1_save", bias=b1)
    # g . W2 and dh1 . W1 as a . (w^T)^T: a transposed copy of each weight,
    # for the kernel's (out, in) operand layout
    dh1, db1 = ops.gemm_bf16(g, w2.t().contiguous(), "gelu_bwd", aux=h1)
    del h1  # the (b*n, mlp) transients are 1.24 GB each at ViT-B bs=1024: each goes when it is read last
    dyln = ops.gemm_f32out(dh1, w1.t().contiguous())
    dy, dln2s, dln2b, db2 = ops.layernorm_bwd_rows(y, dyln, ln2s, residual=g, res_f32=True, out_f32=dy_f32, eps=eps)
    del dyln
    if hybrid:
        dW1, dW2 = torch.matmul(rows(dh1).t(), rows(y2)), torch.matmul(rows(g).t(), rows(act))
    else:
        dW1, dW2 = ops.gemm_wgrad(rows(dh1), rows(y2)), ops.gemm_wgrad(rows(g), rows(act))
    return (dy, dln2s.to(ln2s.dtype), dln2b.to(ln2b.dtype), dW1.to(w1.dtype), db1.to(b1.dtype), dW2.to(w2.dtype),
            db2)


def _layer_backward(ops, x, y, g, w_qkv, b_qkv, w_out, b_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, *,
                    heads, dim_head, scale, eps):
    """The whole layer's backward from the saved ``(x, y)``, the port of
    ``_layer_pallas_backward`` (fused_block.py:1389-1490): the FF half with dy
    kept in f32 (:1227-1261), then the attention half from bf16(dy)
    (:1263-1343, ``_bwd_kernel``'s math), dx = ln_bwd(dh) + dy added in f32
    before one cast, and every weight gradient from ``gemm_wgrad``.
    Returns its thirteen results: ``(dx, dW_qkv, db_qkv, dW_out, db_out,
    dln1s, dln1b, dln2s, dln2b, dW1, db1, dW2, db2)``, dx in x's dtype, the
    rest in their parameters' (db_qkv and db_out None without the bias).
    db_qkv sums the bf16 dqkv that attention_bwd_rows emits, where JAX sums
    the f32 one (:1327); ViT has no qkv bias."""
    rows = lambda t: t.reshape(-1, t.shape[-1])
    dy, dln2s, dln2b, dW1, db1, dW2, db2 = _ff_backward(ops, y, g, ln2s, ln2b, w1, b1, w2, eps=eps, dy_f32=True)
    dyb = dy.to(x.dtype)
    h = ops.layernorm_rows(x, ln1s, ln1b, eps=eps)
    qkv = ops.gemm_bf16(h, w_qkv, "qkv", bias=b_qkv)
    dm = ops.gemm_bf16(dyb, w_out.t().contiguous(), "cast")
    m, dqkv = ops.attention_bwd_rows(qkv, dm, heads=heads, dim_head=dim_head, scale=scale)
    del qkv, dm
    dh = ops.gemm_f32out(dqkv, w_qkv.t().contiguous())
    dx, dln1s, dln1b, db_out = ops.layernorm_bwd_rows(x, dh, ln1s, residual=dy, res_f32=True, eps=eps)
    del dh, dy
    dW_out = ops.gemm_wgrad(rows(dyb), rows(m))
    dW_qkv = ops.gemm_wgrad(rows(dqkv), rows(h))
    db_qkv = rows(dqkv).float().sum(0).to(b_qkv.dtype) if b_qkv is not None else None
    return (
        dx, dW_qkv.to(w_qkv.dtype), db_qkv, dW_out.to(w_out.dtype), None if b_out is None else db_out.to(b_out.dtype),
        dln1s.to(ln1s.dtype), dln1b.to(ln1b.dtype), dln2s, dln2b, dW1, db1, dW2, db2.to(b2.dtype),
    )


class _FusedLayer(torch.autograd.Function):
    """The counterpart of the JAX ``_fused_layer`` custom_vjp
    (fused_block.py:1773-1875): the forward saves ``(x, y)`` and the
    weights; the backward dispatches as ``_fused_layer_bwd`` does
    (:1793-1872), reading the switches at call time: the whole-layer
    backward :func:`_layer_backward` where :func:`layer_bwd_supported`;
    else the FF half by :func:`_ff_backward` where :func:`ff_bwd_mode` says
    ``full`` or ``hybrid``, or by autograd through :func:`ff_reference` (the
    default), then the attention-block backward on dy."""

    @staticmethod
    def forward(ctx, ops, heads, dim_head, scale, eps, x, w_qkv, b_qkv, w_out, b_out,
                ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2):
        out, y = _layer_forward(ops, x, w_qkv, b_qkv, w_out, b_out, ln1s, ln1b, ln2s, ln2b,
                                w1, b1, w2, b2, heads, dim_head, scale, eps)
        ctx.save_for_backward(x, y, w_qkv, b_qkv, w_out, b_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2)
        ctx.ops, ctx.cfg = ops, dict(heads=heads, dim_head=dim_head, scale=scale, eps=eps)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        x, y, w_qkv, b_qkv, w_out, b_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2 = saved
        g = g.contiguous()
        dim, mlp_dim, eps = x.shape[-1], w1.shape[0], ctx.cfg["eps"]
        if layer_bwd_supported(x.shape, x.dtype, ctx.cfg["heads"], ctx.cfg["dim_head"], dim, mlp_dim):
            return (None,) * 5 + _layer_backward(ctx.ops, x, y, g, *saved[2:], **ctx.cfg)
        mode = ff_bwd_mode(x.shape, x.dtype, dim, mlp_dim)
        if mode:
            dy, dln2s, dln2b, dW1, db1, dW2, db2 = _ff_backward(ctx.ops, y, g, ln2s, ln2b, w1, b1, w2, eps=eps,
                                                                hybrid=mode == "hybrid")
            db2 = db2.to(b2.dtype)
        else:
            ff_in = (y, ln2s, ln2b, w1, b1, w2, b2)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in ff_in]
                ff_out = ff_reference(*leaves, eps=eps)
            dy, dln2s, dln2b, dW1, db1, dW2, db2 = torch.autograd.grad(ff_out, leaves, g)
            dy = dy.contiguous()
        attn = _attention_block_bwd(
            ctx.ops, x, dy, w_qkv, b_qkv, w_out, ln1s, ln1b, residual=dy, **ctx.cfg,
        )
        db_out = dy.float().sum((0, 1)).to(b_out.dtype) if b_out is not None else None
        db_qkv = attn.db_qkv.to(b_qkv.dtype) if b_qkv is not None else None
        return (
            None, None, None, None, None,
            attn.dx, attn.dW_qkv.to(w_qkv.dtype), db_qkv, attn.dW_out.to(w_out.dtype), db_out,
            attn.dgamma.to(ln1s.dtype), attn.dbeta.to(ln1b.dtype),
            dln2s, dln2b, dW1, db1, dW2, db2,
        )


def _layer(ops, x, w_qkv, w_out, ln1_scale, ln1_bias, ln2_scale, ln2_bias, w1, b1, w2, b2,
           heads, dim_head, b_qkv, b_out, scale, eps):
    scale = dim_head**-0.5 if scale is None else float(scale)
    args = (x, w_qkv, b_qkv, w_out, b_out, ln1_scale, ln1_bias, ln2_scale, ln2_bias, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return _FusedLayer.apply(ops, heads, dim_head, scale, eps, *args)
    return _layer_forward(ops, *args, heads, dim_head, scale, eps)[0]


def layer_reference(
    x, w_qkv, w_out, ln1_scale, ln1_bias, ln2_scale, ln2_bias, w1, b1, w2, b2,
    *, heads: int, dim_head: int, b_qkv=None, b_out=None,
    scale: Optional[float] = None, eps: float = LN_EPS,
):
    """Plain PyTorch twin of :func:`fused_transformer_layer`, forward and
    backward: the same chain and the same autograd Function with every
    kernel swapped for its twin.  Its forward is the JAX ``_xla_reference``
    (fused_block.py:377-422) followed by ``_ff_reference`` (:1759-1770), with
    the rounding points of ``_layer_rows``."""
    return _layer(TWINS, x, w_qkv, w_out, ln1_scale, ln1_bias, ln2_scale, ln2_bias, w1, b1, w2, b2,
                  heads, dim_head, b_qkv, b_out, scale, eps)


def fused_transformer_layer(
    x, w_qkv, w_out, ln1_scale, ln1_bias, ln2_scale, ln2_bias, w1, b1, w2, b2,
    *, heads: int, dim_head: int, b_qkv=None, b_out=None,
    scale: Optional[float] = None, eps: float = LN_EPS,
):
    """x -> x + Attn(LN(x)) -> . + FF(LN(.)): one pre-norm layer (reference
    vit.py:66-83 loop body), differentiable in every operand.  On the CPU it
    is :func:`layer_reference`; on a CUDA tensor the forward is seven kernel
    launches, the backward six more plus plain PyTorch for the FF vjp and the
    weight gradients, and it raises for a shape :func:`whole_layer_supported`
    refuses."""
    if x.device.type != "cpu":
        dim, mlp_dim = x.shape[-1], w1.shape[0]
        if not whole_layer_supported(x.shape, x.dtype, heads, dim_head, dim, mlp_dim):
            raise ValueError(
                f"fused_transformer_layer: x {tuple(x.shape)} {x.dtype} with heads={heads}, "
                f"dim_head={dim_head}, mlp_dim={mlp_dim} is not supported by the kernels"
            )
    return _layer(KERNELS, x, w_qkv, w_out, ln1_scale, ln1_bias, ln2_scale, ln2_bias, w1, b1, w2, b2,
                  heads, dim_head, b_qkv, b_out, scale, eps)


# ---------------------------------------------------------------------------
# the attention block alone: LN -> qkv -> attention (+dropout) -> out (+dropout)
# -> +residual, the port of _kernel and its custom_vjp _fused
# ---------------------------------------------------------------------------


def _attention_block_forward(ops, x, residual, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias, gamma_q, gamma_k, *,
                             heads, dim_head, scale, eps, dropout_rate, seed):
    """The four launches of ``_kernel``'s body (fused_block.py:298-374)."""
    h = ops.layernorm_rows(x, ln_scale, ln_bias, eps=eps)
    qkv = ops.gemm_bf16(h, w_qkv, "qkv", bias=b_qkv)
    m = ops.attention_rows(qkv, heads=heads, dim_head=dim_head, scale=scale, dropout_rate=dropout_rate, seed=seed,
                           gamma_q=gamma_q, gamma_k=gamma_k)
    return ops.gemm_bf16(m, w_out, "block_out", bias=b_out, residual=residual, dropout_rate=dropout_rate,
                         seed=seed, heads=heads)


class _FusedAttentionBlock(torch.autograd.Function):
    """The counterpart of the JAX ``_fused`` custom_vjp (fused_block.py:
    820-916): the forward saves x, the weights, the gammas and the seed; the
    backward replays both dropout masks and returns d_residual = g unmasked
    (:894), and dgamma_q/dgamma_k in the gammas' shape and dtype (:908-911).
    When the residual is x itself (the ``Transformer``'s call), the
    LayerNorm backward adds g to dx_ln in its own epilogue, rounded once as
    the JAX package's bf16 add of the two cotangents, and the residual gets
    no gradient of its own."""

    @staticmethod
    def forward(ctx, ops, kw, residual_is_x, x, residual, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias, gamma_q,
                gamma_k):
        res = x if residual_is_x else residual
        out = _attention_block_forward(ops, x, res, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias, gamma_q, gamma_k,
                                       **kw)
        ctx.save_for_backward(x, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias, gamma_q, gamma_k)
        ctx.ops, ctx.kw, ctx.residual_is_x, ctx.has_residual = ops, kw, residual_is_x, residual is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias, gamma_q, gamma_k = ctx.saved_tensors
        g = g.contiguous()
        attn = _attention_block_bwd(ctx.ops, x, g, w_qkv, b_qkv, w_out, ln_scale, ln_bias,
                                    residual=g if ctx.residual_is_x else None, gamma_q=gamma_q, gamma_k=gamma_k,
                                    **ctx.kw)
        db_out = attn.gm.float().sum((0, 1)).to(b_out.dtype) if b_out is not None else None
        db_qkv = attn.db_qkv.to(b_qkv.dtype) if b_qkv is not None else None
        d_residual = g if ctx.has_residual else None
        as_param = lambda d, p: None if p is None else d.reshape(p.shape).to(p.dtype)
        return (
            None, None, None, attn.dx, d_residual, attn.dW_qkv.to(w_qkv.dtype), db_qkv,
            attn.dW_out.to(w_out.dtype), db_out, attn.dgamma.to(ln_scale.dtype), attn.dbeta.to(ln_bias.dtype),
            as_param(attn.dgamma_q, gamma_q), as_param(attn.dgamma_k, gamma_k),
        )


def _attention_block(ops, x, residual, w_qkv, w_out, ln_scale, ln_bias, *, heads, dim_head, b_qkv, b_out, gamma_q,
                     gamma_k, scale, eps, dropout_rate, dropout_seed):
    if (gamma_q is None) != (gamma_k is None):
        raise ValueError("gamma_q and gamma_k must be given together")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"fused_attention_block: dropout_rate {dropout_rate} is not in [0, 1)")
    if scale is None:  # the sqrt(dh) factor lives in the qk-norm (fused_block.py:2184-2188)
        scale = 1.0 if gamma_q is not None else dim_head**-0.5
    kw = dict(
        heads=heads, dim_head=dim_head, scale=float(scale), eps=eps,
        dropout_rate=float(dropout_rate), seed=None if dropout_rate == 0.0 else int(dropout_seed),
    )
    operands = (x, residual, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias, gamma_q, gamma_k)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        # a residual that is x rides as a flag: its gradient joins dx inside
        # the LayerNorm backward instead of autograd's add
        residual_is_x = residual is x
        return _FusedAttentionBlock.apply(ops, kw, residual_is_x, x, None if residual_is_x else residual,
                                          w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias, gamma_q, gamma_k)
    return _attention_block_forward(ops, x, residual, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias, gamma_q, gamma_k,
                                    **kw)


def attention_block_reference(
    x, residual, w_qkv, w_out, ln_scale, ln_bias, *, heads: int, dim_head: int, b_qkv=None, b_out=None,
    gamma_q=None, gamma_k=None, scale: Optional[float] = None, eps: float = LN_EPS, dropout_rate: float = 0.0,
    dropout_seed=None,
):
    """Plain PyTorch twin of :func:`fused_attention_block`, forward and
    backward: the same chain and the same autograd Function with every
    kernel swapped for its twin.  Its forward is the JAX ``_kernel``
    (fused_block.py:260-374) with its masks drawn from the port's Philox
    streams; at rate 0 it is ``_xla_reference`` (:377-422) with ``_kernel``'s
    rounding points."""
    return _attention_block(TWINS, x, residual, w_qkv, w_out, ln_scale, ln_bias, heads=heads, dim_head=dim_head,
                            b_qkv=b_qkv, b_out=b_out, gamma_q=gamma_q, gamma_k=gamma_k, scale=scale, eps=eps,
                            dropout_rate=dropout_rate, dropout_seed=dropout_seed)


def fused_attention_block(
    x, residual, w_qkv, w_out, ln_scale, ln_bias, *, heads: int, dim_head: int, b_qkv=None, b_out=None,
    gamma_q=None, gamma_k=None, scale: Optional[float] = None, eps: float = LN_EPS, dropout_rate: float = 0.0,
    dropout_seed=None,
):
    """``residual + Dropout(OutProj(Attention(LN(x) @ Wqkv)))``, the JAX
    ``fused_attention_block`` (fused_block.py:2140), differentiable in every
    tensor operand.  ``dropout_rate`` > 0 applies train-time dropout at both
    reference sites (after the softmax, vit.py:60; after the out projection,
    vit.py:47-49) inside the kernels, from the Philox streams of the int
    ``dropout_seed``, which the backward replays.  ``gamma_q``/``gamma_k``
    (any shape of heads * dim_head values, e.g. the module's (heads, 1,
    dim_head)) turn on the qk-norm of q and k inside the attention kernels,
    forward and backward; ``scale`` then defaults to 1.  On the CPU it is
    :func:`attention_block_reference`; on a CUDA tensor the forward is four
    kernel launches and the backward six (seven with dropout) plus plain
    PyTorch for the weight gradients, and it raises for a shape
    :func:`fused_block_supported` or, with dropout,
    :func:`fused_dropout_supported` refuses."""
    if x.device.type != "cpu" and not (
        fused_block_supported(x.shape, x.dtype, heads, dim_head, x.shape[-1])
        and (dropout_rate == 0.0 or fused_dropout_supported(x.shape, heads, dim_head))
    ):
        raise ValueError(
            f"fused_attention_block: x {tuple(x.shape)} {x.dtype} with heads={heads}, dim_head={dim_head}, "
            f"dropout_rate={dropout_rate} is not supported by the kernels"
        )
    return _attention_block(KERNELS, x, residual, w_qkv, w_out, ln_scale, ln_bias, heads=heads, dim_head=dim_head,
                            b_qkv=b_qkv, b_out=b_out, gamma_q=gamma_q, gamma_k=gamma_k, scale=scale, eps=eps,
                            dropout_rate=dropout_rate, dropout_seed=dropout_seed)


# ---------------------------------------------------------------------------
# several whole layers in one launch: the port of _stack_kernel and its
# custom_vjp _fused_stack
# ---------------------------------------------------------------------------


def whole_layer_stack_group(x_shape, dtype, heads: int, dim_head: int, dim: int, mlp_dim: int, depth: int) -> int:
    """Layers a ``stack_layers`` launch for the whole-layer route (1: one
    layer a call), the JAX ``whole_layer_stack_group`` (fused_block.py:
    1939-1976) read at call time: 1 with ``VIT_TPU_DISABLE_STACK`` set, for
    a shape :func:`whole_layer_supported` refuses, or with
    ``VIT_TPU_STACK_LAYERS`` unset (the default, as JAX's
    ``_STACK_DEFAULT_GROUP``); a value that is not an integer raises
    ``ValueError`` naming the variable; else ``min(value, 6, depth)``, and 1
    for a value <= 1.  JAX's loop that then shrinks the group until its
    resident weights fit the ``_STACK_EST_LIMIT`` of VMEM is a TPU
    calibration and is not ported (ROADMAP §1 item 12): the H100 kernel
    holds no weights on chip, so every group of up to 6 runs."""
    if os.environ.get(DISABLE_STACK_ENV):
        return 1
    if not whole_layer_supported(x_shape, dtype, heads, dim_head, dim, mlp_dim):
        return 1
    forced = os.environ.get(STACK_ENV)
    if not forced:
        return 1
    try:
        want = int(forced)
    except ValueError:
        raise ValueError(f"{STACK_ENV} must be an integer, got {forced!r}") from None
    return 1 if want <= 1 else min(want, STACK_MAX_LAYERS, depth)


def _uniform_biases(layers) -> bool:
    """Whether the optional biases (b_qkv, b_out) are each present in every
    layer or in none, as ``fused_transformer_stack`` requires."""
    return all((lw[1] is None) == (layers[0][1] is None) and (lw[3] is None) == (layers[0][3] is None)
               for lw in layers)


def stack_supported(x_shape, dtype, heads: int, dim_head: int, dim: int, mlp_dim: int, layers) -> bool:
    """Static eligibility of ``stack_layers`` on an H100: the whole layer's
    (:func:`whole_layer_supported`; the stack runs its tile bodies), 1 to
    :data:`STACK_MAX_LAYERS` layers, and uniform optional biases."""
    return (
        whole_layer_supported(x_shape, dtype, heads, dim_head, dim, mlp_dim)
        and 1 <= len(layers) <= STACK_MAX_LAYERS
        and _uniform_biases(layers)
    )


def stack_layers_reference(x, layers, *, heads: int, dim_head: int, scale: float, eps: float = LN_EPS,
                           epilogues: str = "package"):
    """Plain twin of :func:`stack_layers`: the seven-step chain of every layer
    on the twins, one layer after another (``layers`` and ``epilogues`` as
    there)."""
    for lw in layers:
        x = _layer_forward(TWINS, x, *lw, heads, dim_head, scale, eps, epilogues)[0]
    return x


def stack_layers(x, layers, *, heads: int, dim_head: int, scale: float, eps: float = LN_EPS,
                 epilogues: str = "package"):
    """``len(layers)`` consecutive pre-norm layers' forward in one launch,
    the port of ``_stack_kernel`` (fused_block.py:1979).  ``layers`` is a
    sequence of per-layer tuples ``(w_qkv, b_qkv, w_out, b_out, ln1s, ln1b,
    ln2s, ln2b, w1, b1, w2, b2)``, the JAX layer tuple with the weights in
    ``nn.Linear``'s (out, in) layout; b_qkv and b_out may be None (in every
    layer or in none).  Every step of every layer runs the chain's tile
    bodies, so the result is bitwise that of the 7g-launch chain.
    ``epilogues="tools"`` (the ``stack_layers[tools]`` instantiation) is the
    port of the stack prototype ``tools/bench_stack_fusion.py::make_stack``
    (:105): the out projection and fc2 add in f32 and cast once, fc1 adds
    its bias in f32 before its cast (:data:`LAYER_EPILOGUES`), and b_qkv and
    b_out must be None, as that layer has neither.  See
    :func:`stack_layers_reference`."""
    if epilogues not in LAYER_EPILOGUES:
        raise ValueError(f"stack_layers: unknown epilogues {epilogues!r}")
    if epilogues == "tools" and any(lw[1] is not None or lw[3] is not None for lw in layers):
        raise ValueError("stack_layers[tools]: the prototype's layer has no b_qkv or b_out")
    if x.device.type == "cpu":
        return stack_layers_reference(x, layers, heads=heads, dim_head=dim_head, scale=scale, eps=eps,
                                      epilogues=epilogues)
    dim = x.shape[-1]
    mlp_dim = layers[0][8].shape[0] if layers else 0
    if not stack_supported(x.shape, x.dtype, heads, dim_head, dim, mlp_dim, layers):
        raise ValueError(f"stack_layers: x {tuple(x.shape)} {x.dtype} with {len(layers)} layers, heads={heads}, "
                         f"dim_head={dim_head}, mlp_dim={mlp_dim} is not supported by the kernel")
    inner = heads * dim_head
    shapes = ((3 * inner, dim), (3 * inner,), (dim, inner), (dim,), (dim,), (dim,), (dim,), (dim,),
              (mlp_dim, dim), (mlp_dim,), (dim, mlp_dim), (dim,))
    for lw in layers:
        if len(lw) != 12 or any(t is not None and tuple(t.shape) != s for t, s in zip(lw, shapes)):
            raise ValueError(f"stack_layers: a layer's operands {[None if t is None else tuple(t.shape) for t in lw]}"
                             f", expected {list(shapes)}")
        if any(lw[i] is None for i in (0, 2, 4, 5, 6, 7, 8, 10)):
            raise ValueError("stack_layers: only b_qkv, b_out, b1 and b2 may be None")
    _check_operands("stack_layers", x.device, x, *(t for lw in layers for t in lw))
    b, n, _ = x.shape
    rows = b * n
    out = torch.empty_like(x)
    scratch = [torch.empty((rows, width), dtype=x.dtype, device=x.device)
               for width in (dim, 3 * inner, inner, dim, mlp_dim)]  # h, qkv, m, y, a
    barrier = torch.empty((2,), dtype=torch.int32, device=x.device)
    ptrs = (ctypes.c_void_p * (12 * len(layers)))(*(None if t is None else t.data_ptr() for lw in layers for t in lw))
    lib = load_library()
    err = lib.lib.vit_stack_layers(
        x.data_ptr(), out.data_ptr(), ptrs, len(layers), *(t.data_ptr() for t in scratch), barrier.data_ptr(),
        b, n, dim, heads, dim_head, mlp_dim, scale * _LOG2E, eps, int(epilogues == "tools"), _stream(x.device),
    )
    name = "stack_layers[tools]" if epilogues == "tools" else "stack_layers"
    lib.check(name, err)
    LAUNCHES[name] += 1
    return out


def fused_transformer_stack(x, layers, *, heads: int, dim_head: int, scale: Optional[float] = None,
                            eps: float = LN_EPS):
    """``len(layers)`` consecutive pre-norm layers, the JAX
    ``fused_transformer_stack`` (fused_block.py:2096-2137), differentiable in
    every operand; ``layers`` as in :func:`stack_layers`.  One layer is
    :func:`fused_transformer_layer`.  Under autograd it runs the per-layer
    Functions (:func:`fused_transformer_layer` a layer), as JAX's
    ``_fused_stack`` custom_vjp runs the per-layer grad path, so gradients
    and launches are exactly the per-layer route's; otherwise one
    :func:`stack_layers` launch (on the CPU its twin).  On a CUDA tensor it
    raises for what :func:`stack_supported` refuses."""
    scale = dim_head**-0.5 if scale is None else float(scale)
    layers = tuple(tuple(lw) for lw in layers)

    def one(x, lw):
        w_qkv, b_qkv, w_out, b_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2 = lw
        return fused_transformer_layer(x, w_qkv, w_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2, heads=heads,
                                       dim_head=dim_head, b_qkv=b_qkv, b_out=b_out, scale=scale, eps=eps)

    if len(layers) == 1:
        return one(x, layers[0])
    if not _uniform_biases(layers):
        raise ValueError("fused_transformer_stack: optional biases must be uniformly present or absent across the "
                         "stacked layers")
    if x.device.type != "cpu" and not stack_supported(x.shape, x.dtype, heads, dim_head, x.shape[-1],
                                                      layers[0][8].shape[0], layers):
        raise ValueError(f"fused_transformer_stack: x {tuple(x.shape)} {x.dtype} with {len(layers)} layers, "
                         f"heads={heads}, dim_head={dim_head} is not supported by the kernel")
    operands = (x, *(t for lw in layers for t in lw))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        for lw in layers:
            x = one(x, lw)
        return x
    return stack_layers(x, layers, heads=heads, dim_head=dim_head, scale=scale, eps=eps)
