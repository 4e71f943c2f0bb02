"""Flash attention with segment-id (packed-sequence) masking on Hopper.

Port of ``vit_pytorch_tpu/ops/flash_attention.py`` for the options of the
packed NaViT path.  Its three TPU kernels are hand-written CUDA kernels in
``csrc/flash_attention.cu``:

    flash_fwd      (_fwd_kernel, :202)      q, k, v            -> o, lse (f32)
    flash_bwd_dq   (_bwd_dq_kernel, :298)   q, k, v, dO, lse, delta -> dq
    flash_bwd_dkv  (_bwd_dkv_kernel, :376)  q, k, v, dO, lse, delta -> dk, dv

Each tiles the (n, m) attention into 64 x 64 tiles that never leave the
chip, masks by segment id (token i attends j iff both ids are equal and
non-negative; -1 pads, -2 empty pooling slots) and skips a whole tile whose
two id ranges cannot overlap (:func:`tile_admitted`).  ``flash_attention``
is an autograd Function, the counterpart of the JAX ``_flash_attention_core``
custom_vjp without bias: the forward saves q, k, v, the ids, o and the f32
LSE; the backward forms ``delta = rowsum(dO * o)`` in f32 outside the kernels
(:680-685) and launches the two backward kernels.

Attention dropout (``dropout_rate`` > 0 with an int ``seed``) runs inside
all three kernels, their ``[dropout]`` instantiations, on the normalized
attention matrix (reference vit.py:60): the forward's row sum takes the
undropped p, p.v the dropped one, and both backward kernels replay the
mask.  The keep bit of (query i, key j) in pack b, head h is a pure function
of (seed, b, h, i, j): word ``j % 4`` of Philox4x32-10 at counter (i, j // 4,
0, 0), key (seed, b * 1024 + h), the function of the attention-block kernels
(``ops/fused_block.py::_attn_keep``).  The TPU keys its bits by its tile
(``_tile_keep`` :84-98), so the bits are not the TPU's, and not tied to a
tile size: :func:`flash_dropout_masks` (:897) replays them, and equals
``fused_block.dropout_masks``' attention mask at n = m.  Heads >= 1024 would
share a stream and are refused.

The in-tile qk-norm (``gamma_q``/``gamma_k``, the JAX opt-in
``VIT_TPU_FUSE_QKNORM``: its dispatcher hands the gammas here instead of
normalising q and k itself) runs inside all three kernels, their
``[qknorm]`` and ``[dropout,qknorm]`` instantiations: each normalises q and k
with the reference's per-head RMSNorm at ``_rms_tile``'s rounding points
(:135-142; :func:`rms_tile_reference`), and the backward kernels emit dq and
dk of the normalised q and k, as the TPU kernels do.  The Function closes the
RMSNorm VJP on the host in plain PyTorch (:func:`rms_norm_vjp`, JAX ``_bwd``
:859-876), dgamma included.  Gammas with a bias are refused, as in JAX.

Each wrapper has a plain PyTorch twin at the kernel's rounding points
(``flash_fwd_reference``, ``flash_bwd_reference``,
``flash_dropout_masks_reference``), which CPU tensors take; on a CUDA tensor
it launches its kernel or raises.  Each launch adds one to
``LAUNCHES[kernel]``, each instantiation to its own entry (``[dropout]``,
``[qknorm]``, ``[dropout,qknorm]``).
:func:`flash_attention_twins` runs the same Function on the twins on any
device.  :func:`flash_attention_reference` is the twin of the whole op, the
JAX ``_reference_attention`` (:809-815): the materialized composite with the
segment mask (and the same keep mask), differentiated by autograd.

The kernels take bf16 with ``dim_head == 64`` (their one head dim) on a
CUDA device; :func:`flash_supported` is the gate the dispatcher asks.  The
options the NaViT path does not use (bias, causal) raise
``NotImplementedError`` naming the ROADMAP item that brings them.  The
TPU's block sizes (1024/512 and the ``VIT_TPU_FLASH_BLOCK_Q/K`` knobs) are
not ported: the H100 kernels' tiles are fixed at 64 x 64
(:func:`default_blocks`).
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.helpers import default_device
from ._build import load_library
from .fused_block import STREAM_STRIDE, _attn_keep, _dropout_args

BLOCK_Q = BLOCK_K = 64  # kFlashTile: the kernels' query and key tiles
DIM_HEAD = 64  # kFlashDh: the one head dim the kernels are built for
NEG_INF = -1e30  # _NEG_INF: the LSE of a row with no key to attend
_BIG_ID = 1 << 30

# launches per kernel since the last reset_launch_counts(); each
# instantiation ([dropout], [qknorm], [dropout,qknorm]) counts apart from its
# kernel's plain launches
LAUNCHES = {
    **{f"{name}{tag}": 0 for tag in ("", "[dropout]", "[qknorm]", "[dropout,qknorm]")
       for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
    "flash_dropout_masks": 0,
}

_FLASH_ITEM = "ROADMAP: TPU kernels to port, item 4"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rms_norm(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """The reference's per-head qk RMSNorm (na_vit.py:93-103): l2-normalize
    the head dim, scale by gamma * sqrt(d).  ``gamma`` broadcasts (the
    parameter is (heads, 1, d)).  It computes in x's own dtype, as the JAX
    ``rms_norm`` (:122-132) does: in bf16 the sum of squares and the product
    round to bf16."""
    d = x.shape[-1]
    normed = x * torch.rsqrt(x.square().sum(-1, keepdim=True) + 1e-12)
    return normed * gamma * (d**0.5)


def rms_tile_reference(x: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernels' in-tile qk-norm, the JAX ``_rms_tile``
    (:135-142): statistics in f32 from x as it is, ``r = rsqrt(sum(x^2) +
    1e-12)``, ``(x * r) * (gamma * sqrt(d))`` in f32, one cast to x's dtype.
    ``x`` is (b, h, rows, d); ``gamma`` any shape reshaping to (h, d)."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).sum(-1, keepdim=True) + 1e-12)
    g = gamma.float().reshape(x.shape[1], 1, x.shape[-1])
    return (x32 * r * (g * x.shape[-1] ** 0.5)).to(x.dtype)


def rms_norm_vjp(x: torch.Tensor, gamma: torch.Tensor, d_normed: torch.Tensor):
    """The host epilogue of the qk-norm backward (JAX ``_bwd`` :859-876):
    the VJP of :func:`rms_norm` on f32 ``x`` (b, h, rows, d) and f32
    ``gamma`` (reshaped to (h, 1, d)), fed the kernels' gradient of the
    normalised x upcast to f32.  Returns (dx in x's dtype, dgamma in gamma's
    dtype and shape)."""
    with torch.enable_grad():
        x32 = x.detach().float().requires_grad_()
        g32 = gamma.detach().float().reshape(x.shape[1], 1, x.shape[-1]).requires_grad_()
        dx, dg = torch.autograd.grad(rms_norm(x32, g32), (x32, g32), d_normed.float())
    return dx.to(x.dtype), dg.reshape(gamma.shape).to(gamma.dtype)


def default_blocks(n: int, m: int):
    """(block_q, block_k) of the H100 kernels for an (n, m) problem: their
    fixed 64 x 64 tiles, chosen from the register and shared-memory budget
    at dh = 64 (4 warps of 16 query rows; two 64-row ring stages of k and v
    in 37 KB), not from the TPU's VMEM."""
    del n, m
    return BLOCK_Q, BLOCK_K


def _tile_ranges(ids: torch.Tensor, block: int):
    """Per tile of ``block`` rows of (b, L) ids: the min of the non-negative
    ids (2^30 when none) and the max of all ids, rows past L read as -1."""
    ids = F.pad(ids.to(torch.int64), (0, (-ids.shape[1]) % block), value=-1)
    tiles = ids.view(ids.shape[0], -1, block)
    lo = torch.where(tiles >= 0, tiles, _BIG_ID).amin(-1)
    return lo, tiles.amax(-1)


def tile_admitted(q_segment_ids, kv_segment_ids, *, block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """(b, n tiles, m tiles) bool: the tiles the kernels run, the skip test
    of ``_seg_overlap`` (:173-188) as a plain function of the ids.  A tile
    runs iff some id of each side is >= 0 and the two ranges of non-negative
    ids overlap.  It is conservative for any ids (a tile holding a pair that
    shares an id always runs) and exact for packed sequences, whose ids rise
    along the sequence."""
    q_lo, q_hi = _tile_ranges(q_segment_ids, block_q)
    k_lo, k_hi = _tile_ranges(kv_segment_ids, block_k)
    q_lo, q_hi, k_lo, k_hi = q_lo[:, :, None], q_hi[:, :, None], k_lo[:, None, :], k_hi[:, None, :]
    return (q_hi >= 0) & (k_hi >= 0) & (q_lo <= k_hi) & (k_lo <= q_hi)


def flash_supported(q_shape, k_shape, dtype) -> bool:
    """Whether the kernels take (b, h, n, d) q and (b, h, m, d) k, v of
    ``dtype`` on a CUDA device: bf16, ``d == 64`` and at most 65,535 (b, h)
    pairs (the grid's y axis).  The dispatcher sends everything else to the
    materialized composite."""
    b, h, n, d = q_shape
    return (
        dtype == torch.bfloat16
        and d == DIM_HEAD
        and len(k_shape) == 4
        and tuple(k_shape[:2]) == (b, h)
        and k_shape[3] == d
        and n > 0
        and k_shape[2] > 0
        and b * h <= 65535
    )


# ---------------------------------------------------------------------------
# the plain twins, at the kernels' rounding points
# ---------------------------------------------------------------------------


def _valid(q_segment_ids, kv_segment_ids, n: int, m: int):
    """(b, 1, n, m) bool of the pairs that may attend, or None for all."""
    from .attention import build_segment_mask

    return build_segment_mask(q_segment_ids, kv_segment_ids, n, m)


def _logits(q, k, scale, valid):
    """s = (q.k^T in f32) * scale, the masked entries at the sentinel."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return s if valid is None else s.masked_fill(~valid, NEG_INF)


def _dropout(name: str, rate: float, seed, heads: int):
    """The kernels' dropout arguments (drop, seed bits, threshold, 1/(1 -
    rate)); with dropout, heads must fit the Philox stream key img * 1024 +
    head."""
    drop = _dropout_args(name, rate, seed)
    if drop[0] and heads >= STREAM_STRIDE:
        raise ValueError(f"{name}: {heads} heads; dropout keys a Philox stream by img * {STREAM_STRIDE} + head, "
                         f"so at most {STREAM_STRIDE - 1} heads")
    return drop


def _keep(q, k, rate: float, seed):
    """(b, h, n, m) bool keep mask of the kernels' dropout on q (b, h, n, d)
    and k (b, h, m, d): (query i, key j) of pack b, head h is the Philox bit
    of stream b * 1024 + h at (row i, column j), the attention block's."""
    b, h, n, _ = q.shape
    return _attn_keep(seed, b, n, h, rate, q.device, k.shape[2])


def _normed(q, k, gamma_q, gamma_k):
    """q and k through the kernels' in-tile qk-norm, or as they are."""
    if gamma_q is None:
        return q, k
    return rms_tile_reference(q, gamma_q), rms_tile_reference(k, gamma_k)


def flash_fwd_reference(q, k, v, *, scale: float, q_segment_ids=None, kv_segment_ids=None, dropout_rate: float = 0.0,
                        seed=None, gamma_q=None, gamma_k=None):
    """Plain twin of :func:`flash_fwd`: ``(o, lse)``, o (b, h, n, d) in q's
    dtype and lse (b, h, n) f32.  The rounding points of ``_fwd_kernel``
    with the whole row at once: p = exp(s - max) zeroed where masked (after
    the exp), cast to v's dtype before p.v in f32, o = acc * (1/l) cast once.
    A row with no key to attend gives o = 0 and lse = -1e30.  With dropout
    l sums the undropped p, p is masked before its cast, and o = acc *
    (inv_keep / l), one f32 factor (:255-290).  With gammas q and k first
    go through :func:`rms_tile_reference` (:229-235)."""
    drop = _dropout("flash_fwd", dropout_rate, seed, q.shape[1])
    q, k = _normed(q, k, gamma_q, gamma_k)
    valid = _valid(q_segment_ids, kv_segment_ids, q.shape[2], k.shape[2])
    s = _logits(q, k, scale, valid)
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - mx)
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    if drop[0]:
        p = p.masked_fill(~_keep(q, k, dropout_rate, seed), 0.0)
        factor = safe_l.new_tensor(drop[3]) / safe_l  # inv_keep in f32, one division
    else:
        factor = 1.0 / safe_l
    o = torch.matmul(p.to(v.dtype).float(), v.float()) * factor
    lse = torch.where(l == 0.0, NEG_INF, mx + torch.log(safe_l)).squeeze(-1)
    return o.to(q.dtype), lse


def flash_bwd_reference(q, k, v, do, lse, delta, *, scale: float, q_segment_ids=None, kv_segment_ids=None,
                        dropout_rate: float = 0.0, seed=None, gamma_q=None, gamma_k=None):
    """Plain twin of :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`:
    ``(dq, dk, dv)`` at the rounding points of ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``: p = exp(s - lse) zeroed where masked after the exp
    (in a fully masked row that exp is 1), dv = bf16(p)^T.dO, ds = p * (dO.v^T
    - delta) in f32, dq = scale * bf16(ds).k, dk = scale * bf16(ds)^T.q, each
    accumulated in f32 and cast once.  With dropout dv takes bf16(where(keep,
    p, 0) * inv), scaled before the cast, and dp = where(keep, dO.v^T, 0) *
    inv in f32 (:352-361, :425-456); ds keeps the undropped p.  With gammas
    q and k are normalised first (:324-329, :404-406), so dq and dk are the
    gradients of the normalised q and k."""
    drop = _dropout("flash_bwd", dropout_rate, seed, q.shape[1])
    q, k = _normed(q, k, gamma_q, gamma_k)
    valid = _valid(q_segment_ids, kv_segment_ids, q.shape[2], k.shape[2])
    p = torch.exp(_logits(q, k, scale, valid) - lse[..., None])
    if valid is not None:
        p = p.masked_fill(~valid, 0.0)
    pd, dp = p, torch.matmul(do.float(), v.float().transpose(-1, -2))
    if drop[0]:
        keep = _keep(q, k, dropout_rate, seed)
        pd = torch.where(keep, p, 0.0) * drop[3]
        dp = torch.where(keep, dp, 0.0) * drop[3]
    dv = torch.matmul(pd.to(do.dtype).float().transpose(-1, -2), do.float())
    ds = p * (dp - delta[..., None])
    dq = scale * torch.matmul(ds.to(k.dtype).float(), k.float())
    dk = scale * torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_dropout_masks_reference(seed, b: int, h: int, n: int, m: int, rate: float, *, device=None):
    """Plain twin of :func:`flash_dropout_masks`: (b, h, n, m) int32 0/1."""
    _dropout("flash_dropout_masks", rate, seed, h)
    device = torch.device("cpu") if device is None else torch.device(device)
    return _attn_keep(seed, b, n, h, rate, device, m).to(torch.int32)


def flash_attention_reference(q, k, v, *, scale: Optional[float] = None, q_segment_ids=None, kv_segment_ids=None,
                              dropout_rate: float = 0.0, dropout_seed=None, gamma_q=None, gamma_k=None):
    """The plain twin of :func:`flash_attention`: the JAX
    ``_reference_attention`` (:809-815), the materialized composite
    (``xla_attention``, logits stored in the input dtype) under the segment
    mask of ``build_segment_mask``, differentiated by autograd.  Rows with no
    key to attend give zeros (``xla_attention``'s ``mask.any``).  With
    dropout the composite drops the normalized matrix with the kernels' keep
    mask of ``dropout_seed``.  With gammas q and k first go through the eager
    :func:`rms_norm`, as the JAX dispatcher's composite route takes them."""
    from .attention import xla_attention

    _check_gammas(gamma_q, gamma_k, None)
    if gamma_q is not None:
        q, k = rms_norm(q, gamma_q), rms_norm(k, gamma_k)

    mask = _valid(q_segment_ids, kv_segment_ids, q.shape[2], k.shape[2])
    keep = None
    if dropout_rate > 0.0:
        _check_dropout_request(dropout_rate, dropout_seed, None)
        keep = _keep(q, k, dropout_rate, dropout_seed)
    return xla_attention(q, k, v, scale=scale, mask=mask, dropout_rate=dropout_rate, keep=keep)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, tensors, ids) -> None:
    """The kernels' operand contract: CUDA bf16 (b, h, rows, 64) with a
    contiguous head dim and 16-byte aligned rows; int32 contiguous ids."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on a CUDA device, not {dev}")
    for t in (*tensors, *ids):
        if torch.is_grad_enabled() and t.requires_grad:
            raise ValueError(f"{name}: a kernel call outside autograd; an operand requires grad")
        if t.device != dev:
            raise ValueError(f"{name}: operand on {t.device}, expected {dev}")
    for t in tensors:
        if t.dtype != torch.bfloat16 or t.dim() != 4 or t.shape[-1] != DIM_HEAD:
            raise ValueError(f"{name}: operand {t.dtype} {tuple(t.shape)}; the kernel takes bf16 (b, h, rows, {DIM_HEAD})")
        if not kernel_layout(t):
            raise ValueError(f"{name}: operand strides {t.stride()}: the head dim must be contiguous, rows 16-byte aligned")
    for t in ids:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: segment ids must be contiguous int32")


def kernel_layout(t: torch.Tensor) -> bool:
    """Whether the kernels read ``t`` as it lies: unit stride on the head
    dim, the other strides multiples of 8 elements, a 16-byte aligned base."""
    return t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0


def _strides(*tensors):
    """The 18 (b, h, row) strides of q, k, v, dO, out0, out1 (None: zeros)."""
    flat = []
    for t in tensors:
        flat += [0, 0, 0] if t is None else list(t.stride()[:3])
    return (ctypes.c_longlong * 18)(*flat)


def _ids(q_segment_ids, kv_segment_ids):
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("segment ids must be given for both q and kv")
    if q_segment_ids is None:
        return ()
    return q_segment_ids, kv_segment_ids


def _ptr(t):
    return None if t is None else t.data_ptr()


def _gamma_kw(rows):
    return dict(zip(("gamma_q", "gamma_k"), rows))


def _gamma_ptrs(rows):
    return tuple(g.data_ptr() for g in rows) if rows else (None, None)


def _merged_heads(b: int, h: int, rows: int, like: torch.Tensor):
    """An empty (b, h, rows, 64) bf16 view of a (b, rows, h, 64) buffer: the
    merged-heads layout, so ``.transpose(1, 2).reshape(b, rows, h * 64)``
    downstream is free."""
    return torch.empty((b, rows, h, DIM_HEAD), dtype=like.dtype, device=like.device).transpose(1, 2)


def _counter(name: str, drop, gammas) -> str:
    tags = [tag for tag, on in (("dropout", drop[0]), ("qknorm", gammas)) if on]
    return f"{name}[{','.join(tags)}]" if tags else name


def gamma_rows(gamma_q, gamma_k, q):
    """The kernels' qk-norm operands for q (b, h, n, d): each gamma (any
    shape reshaping to (h, d)) as contiguous f32 (h, d) rows, the JAX
    ``_gamma_specs_inputs`` (:511-523); ``()`` without gammas."""
    _check_gammas(gamma_q, gamma_k, None)
    if gamma_q is None:
        return ()
    h, d = q.shape[1], q.shape[-1]
    return tuple(g.detach().to(torch.float32).reshape(h, d).contiguous() for g in (gamma_q, gamma_k))


def _check_gamma_rows(name: str, rows, q) -> None:
    for g in rows:
        if g.device != q.device:
            raise ValueError(f"{name}: gammas on {g.device}, expected {q.device}")


def flash_fwd(q, k, v, *, scale: float, q_segment_ids=None, kv_segment_ids=None, dropout_rate: float = 0.0,
              seed=None, gamma_q=None, gamma_k=None):
    """``(o, lse)`` of softmax attention: o (b, h, n, 64) bf16 in the
    merged-heads layout, lse (b, h, n) f32 (-1e30 for a row with no key);
    with ``dropout_rate`` > 0 (the ``[dropout]`` instantiation) the
    attention matrix is dropped with the keep mask of ``seed``; with gammas
    (the ``[qknorm]`` instantiations) q and k are normalised in the kernel.
    See :func:`flash_fwd_reference`."""
    ids = _ids(q_segment_ids, kv_segment_ids)
    drop = _dropout("flash_fwd", dropout_rate, seed, q.shape[1])
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale=scale, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                                   dropout_rate=dropout_rate, seed=seed, gamma_q=gamma_q, gamma_k=gamma_k)
    _check("flash_fwd", (q, k, v), ids)
    b, h, n, d = q.shape
    m = k.shape[2]
    rows = gamma_rows(gamma_q, gamma_k, q)
    _check_gamma_rows("flash_fwd", rows, q)
    o = _merged_heads(b, h, n, q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lib = load_library()
    err = lib.lib.vit_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _ptr(q_segment_ids), _ptr(kv_segment_ids), *_gamma_ptrs(rows), b, h, n, m, d, float(scale), *drop,
        _strides(q, k, v, None, o, None), torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = _counter("flash_fwd", drop, rows)
    lib.check(name, err)
    LAUNCHES[name] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float, q_segment_ids=None, kv_segment_ids=None,
                 dropout_rate: float = 0.0, seed=None, gamma_q=None, gamma_k=None):
    """dq (b, h, n, 64) bf16, merged-heads layout, replaying the forward's
    keep mask with ``dropout_rate`` > 0; with gammas the gradient of the
    normalised q; see :func:`flash_bwd_reference`."""
    ids = _ids(q_segment_ids, kv_segment_ids)
    drop = _dropout("flash_bwd_dq", dropout_rate, seed, q.shape[1])
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, scale=scale, q_segment_ids=q_segment_ids,
                                   kv_segment_ids=kv_segment_ids, dropout_rate=dropout_rate, seed=seed,
                                   gamma_q=gamma_q, gamma_k=gamma_k)[0]
    _check("flash_bwd_dq", (q, k, v, do), ids)
    _check_stats("flash_bwd_dq", q, lse, delta)
    b, h, n, d = q.shape
    rows = gamma_rows(gamma_q, gamma_k, q)
    _check_gamma_rows("flash_bwd_dq", rows, q)
    dq = _merged_heads(b, h, n, q)
    lib = load_library()
    err = lib.lib.vit_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        _ptr(q_segment_ids), _ptr(kv_segment_ids), *_gamma_ptrs(rows), dq.data_ptr(), b, h, n, k.shape[2], d,
        float(scale), *drop, _strides(q, k, v, do, dq, None), torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = _counter("flash_bwd_dq", drop, rows)
    lib.check(name, err)
    LAUNCHES[name] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, scale: float, q_segment_ids=None, kv_segment_ids=None,
                  dropout_rate: float = 0.0, seed=None, gamma_q=None, gamma_k=None):
    """``(dk, dv)``, each (b, h, m, 64) bf16 in the merged-heads layout,
    replaying the forward's keep mask with ``dropout_rate`` > 0; with gammas
    dk is the gradient of the normalised k; see :func:`flash_bwd_reference`."""
    ids = _ids(q_segment_ids, kv_segment_ids)
    drop = _dropout("flash_bwd_dkv", dropout_rate, seed, q.shape[1])
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, scale=scale, q_segment_ids=q_segment_ids,
                                   kv_segment_ids=kv_segment_ids, dropout_rate=dropout_rate, seed=seed,
                                   gamma_q=gamma_q, gamma_k=gamma_k)[1:]
    _check("flash_bwd_dkv", (q, k, v, do), ids)
    _check_stats("flash_bwd_dkv", q, lse, delta)
    b, h, n, d = q.shape
    m = k.shape[2]
    rows = gamma_rows(gamma_q, gamma_k, q)
    _check_gamma_rows("flash_bwd_dkv", rows, q)
    dk, dv = _merged_heads(b, h, m, k), _merged_heads(b, h, m, v)
    lib = load_library()
    err = lib.lib.vit_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        _ptr(q_segment_ids), _ptr(kv_segment_ids), *_gamma_ptrs(rows), dk.data_ptr(), dv.data_ptr(), b, h, n, m, d,
        float(scale), *drop, _strides(q, k, v, do, dk, dv), torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = _counter("flash_bwd_dkv", drop, rows)
    lib.check(name, err)
    LAUNCHES[name] += 1
    return dk, dv


def flash_dropout_masks(seed, b: int, h: int, n: int, m: int, rate: float, *, device=None):
    """Replay of the flash kernels' keep masks, the JAX
    ``flash_dropout_masks`` (:897): (b, h, n, m) int32 0/1, for equivalence
    tests.  The masks do not depend on a tile size, so the JAX ``block_q``/
    ``block_k`` have no counterpart.  On a CUDA ``device`` (the default, see
    :func:`~vit_pytorch_tpu_torch.utils.helpers.default_device`) one launch
    of the replay kernel; on ``device="cpu"``
    :func:`flash_dropout_masks_reference`."""
    device = default_device(device)
    if device.type == "cpu":
        return flash_dropout_masks_reference(seed, b, h, n, m, rate, device=device)
    if device.type != "cuda":
        raise ValueError(f"flash_dropout_masks: the kernel runs on a CUDA device, not {device}")
    if not (0 < b <= 65535 and n > 0 and m > 0 and h > 0):
        raise ValueError(f"flash_dropout_masks: b={b}, h={h}, n={n}, m={m}")
    _, seed_bits, threshold, _ = _dropout("flash_dropout_masks", rate, seed, h)
    keep = torch.empty((b, h, n, m), dtype=torch.int32, device=device)
    lib = load_library()
    err = lib.lib.vit_flash_dropout_masks(keep.data_ptr(), b, h, n, m, seed_bits, threshold,
                                          torch.cuda.current_stream(device).cuda_stream)
    lib.check("flash_dropout_masks", err)
    LAUNCHES["flash_dropout_masks"] += 1
    return keep


def _check_stats(name: str, q, lse, delta) -> None:
    b, h, n, _ = q.shape
    for t in (lse, delta):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, n) or not t.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous f32 ({b}, {h}, {n})")


# ---------------------------------------------------------------------------
# the op: autograd Function and public entry point
# ---------------------------------------------------------------------------


def _kernel_ready(t):
    """``t`` itself where the kernels read it as it lies, else a contiguous
    copy (a CPU tensor goes to the twins as it is)."""
    return t if t.device.type == "cpu" or kernel_layout(t) else t.contiguous()


def _kernels_bwd(q, k, v, do, lse, delta, **kw):
    return (flash_bwd_dq(q, k, v, do, lse, delta, **kw), *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))


# the kernels (each falls to its twin for a CPU tensor) and their twins, in
# the one Function that runs the op either way
KERNELS = SimpleNamespace(fwd=flash_fwd, bwd=_kernels_bwd)
TWINS = SimpleNamespace(fwd=flash_fwd_reference, bwd=flash_bwd_reference)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of ``_flash_attention_core``'s custom_vjp without
    bias (:818-877).  The dropout rate and seed ride as Python numbers: the
    backward replays the forward's mask from them.  With qk-norm gammas the
    kernels take their f32 rows, the Function saves the raw q and k, and its
    backward closes the RMSNorm VJP on the kernels' normalised-space dq and
    dk in plain PyTorch (:func:`rms_norm_vjp`, JAX ``_bwd`` :859-876)."""

    @staticmethod
    def forward(ctx, ops, scale, dropout_rate, seed, q, k, v, q_segment_ids, kv_segment_ids, gamma_q, gamma_k):
        rows = gamma_rows(gamma_q, gamma_k, q)
        kw = _gamma_kw(rows)
        o, lse = ops.fwd(q, k, v, scale=scale, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                         dropout_rate=dropout_rate, seed=seed, **kw)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, o, lse, gamma_q, gamma_k, *rows)
        ctx.ops, ctx.scale, ctx.dropout_rate, ctx.seed = ops, scale, dropout_rate, seed
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, qs, ks, o, lse, gamma_q, gamma_k, *rows = ctx.saved_tensors
        g = _kernel_ready(g)
        delta = (g.float() * o.float()).sum(-1).contiguous()  # (b, h, n) f32, :680-685; exact under dropout
        dq, dk, dv = ctx.ops.bwd(q, k, v, g, lse, delta, scale=ctx.scale, q_segment_ids=qs, kv_segment_ids=ks,
                                 dropout_rate=ctx.dropout_rate, seed=ctx.seed,
                                 **_gamma_kw(rows))
        dgq = dgk = None
        if rows:
            dq, dgq = rms_norm_vjp(q, gamma_q, dq)
            dk, dgk = rms_norm_vjp(k, gamma_k, dk)
        return None, None, None, None, dq, dk, dv, None, None, dgq, dgk


def _flash(ops, q, k, v, scale, q_segment_ids, kv_segment_ids, dropout_rate, seed, gamma_q, gamma_k):
    ids = _ids(q_segment_ids, kv_segment_ids)
    if ids:
        q_segment_ids, kv_segment_ids = (t.to(torch.int32).contiguous() for t in ids)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    dropout_rate = float(dropout_rate)
    seed = int(seed) if dropout_rate > 0.0 else None
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    operands = (q, k, v) if gamma_q is None else (q, k, v, gamma_q, gamma_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _FlashAttention.apply(ops, scale, dropout_rate, seed, q, k, v, q_segment_ids, kv_segment_ids, gamma_q,
                                     gamma_k)
    rows = gamma_rows(gamma_q, gamma_k, q)
    return ops.fwd(q, k, v, scale=scale, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                   dropout_rate=dropout_rate, seed=seed, **_gamma_kw(rows))[0]


def _check_gammas(gamma_q, gamma_k, bias) -> None:
    """The JAX ``flash_attention``'s refusals of qk-norm gammas (:977-980)."""
    if (gamma_q is None) != (gamma_k is None):
        raise ValueError("qk-norm gammas must be given for both q and k")
    if gamma_q is not None and bias is not None:
        raise ValueError("fused qk-norm is unsupported with bias")


def _check_dropout_request(dropout_rate: float, dropout_seed, bias) -> None:
    """The JAX ``flash_attention``'s refusals of a dropout call (:981-989)."""
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("flash_attention: dropout_rate > 0 requires dropout_seed")
        if bias is not None:
            raise ValueError("flash_attention: flash dropout is unsupported with bias")


def flash_attention_twins(q, k, v, *, scale: Optional[float] = None, q_segment_ids=None, kv_segment_ids=None,
                          dropout_rate: float = 0.0, dropout_seed=None, gamma_q=None, gamma_k=None):
    """The plain path of :func:`flash_attention` on any device: the same
    Function with every kernel swapped for its plain twin (the counterpart
    of ``ops/fused_block.py::layer_reference``), the same keep masks from
    the same seed, the same qk-norm epilogue.  Like the kernels it keeps only
    o and the LSE for the backward, so it trains where the materialized
    :func:`flash_attention_reference` would not fit."""
    _check_gammas(gamma_q, gamma_k, None)
    _check_dropout_request(dropout_rate, dropout_seed, None)
    return _flash(TWINS, q, k, v, scale, q_segment_ids, kv_segment_ids, dropout_rate, dropout_seed, gamma_q, gamma_k)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
    gamma_q: Optional[torch.Tensor] = None,
    gamma_k: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    interpret: Optional[bool] = None,
) -> torch.Tensor:
    """Flash attention, q (b, h, n, d), k/v (b, h, m, d) -> (b, h, n, d),
    with the JAX keywords (flash_attention.py:933-1003).

    ``q_segment_ids`` (b, n) / ``kv_segment_ids`` (b, m): token i attends j
    iff their ids are equal and non-negative; a row with none gives zeros.
    ``gamma_q``/``gamma_k`` (both or neither; any shape reshaping to (h, d),
    the modules keep (h, 1, d)): the reference's per-head qk RMSNorm runs
    inside the kernels (their ``[qknorm]`` instantiations), and the backward
    closes its VJP on the host; callers pass ``scale=1.0`` with it.  With a
    ``bias`` they raise ``ValueError``, as in JAX.
    ``dropout_rate`` > 0 drops the normalized attention matrix inside the
    kernels with the keep mask of the int ``dropout_seed`` (required; see
    :func:`flash_dropout_masks`), and the backward replays it; with a
    ``bias`` it raises ``ValueError``, as the JAX function does.
    Differentiable in q, k and v.  On the CPU it runs the Function on the
    plain twins; on a CUDA tensor it launches the kernels and raises for
    what :func:`flash_supported` refuses.  ``block_q``/``block_k`` may only
    name the kernels' own 64 x 64 tiles, and ``interpret`` (the Pallas
    interpreter switch) has no meaning here: CPU tensors take the twins.
    ``bias`` and ``causal`` raise ``NotImplementedError``."""
    _check_gammas(gamma_q, gamma_k, bias)
    _check_dropout_request(dropout_rate, dropout_seed, bias)
    if bias is not None:
        raise NotImplementedError(f"flash_attention: an additive bias is not ported yet ({_FLASH_ITEM}, bias variant)")
    if causal:
        raise NotImplementedError(f"flash_attention: causal masking is not ported yet ({_FLASH_ITEM}, causal variant)")
    del interpret
    if (block_q or BLOCK_Q) != BLOCK_Q or (block_k or BLOCK_K) != BLOCK_K:
        raise ValueError(f"flash_attention: the kernels' tiles are {BLOCK_Q} x {BLOCK_K}")
    if q.device.type != "cpu" and not flash_supported(q.shape, k.shape, q.dtype):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} is not supported by the kernels "
            f"(bf16, dim_head {DIM_HEAD})"
        )
    return _flash(KERNELS, q, k, v, scale, q_segment_ids, kv_segment_ids, dropout_rate, dropout_seed, gamma_q,
                  gamma_k)
