"""Flash attention with segment-id (packed-sequence) masking on Hopper.

Port of ``vit_pytorch_tpu/ops/flash_attention.py`` with all its options.
Its three TPU kernels are hand-written CUDA kernels in
``csrc/flash_attention.cu``:

    flash_fwd      (_fwd_kernel, :202)      q, k, v            -> o, lse (f32)
    flash_bwd_dq   (_bwd_dq_kernel, :298)   q, k, v, dO, lse, delta -> dq
    flash_bwd_dkv  (_bwd_dkv_kernel, :376)  q, k, v, dO, lse, delta -> dk, dv

Each tiles the (n, m) attention into 64 x 64 tiles that never leave the
chip, masks by segment id (token i attends j iff both ids are equal and
non-negative; -1 pads, -2 empty pooling slots) and skips a whole tile whose
two id ranges cannot overlap (:func:`tile_admitted`).  ``flash_attention``
is an autograd Function, the counterpart of the JAX ``_flash_attention_core``
custom_vjp: without a bias the forward saves q, k, v, the ids, o and the f32
LSE, and the backward forms ``delta = rowsum(dO * o)`` in f32 outside the
kernels (:680-685) and launches the two backward kernels.

``causal`` masks key j from query i unless j <= i (absolute positions,
top-left aligned also when n != m, as ``_tile_mask`` :161-164), in all three
kernels, with every other option: the kernels stop their tile loops at the
diagonal tile (:func:`tile_admitted` with ``causal``).  An additive ``bias``
of shape (1|b, 1|h, n, m) (any float dtype; f32 and bf16 reach the kernel as
they are, its broadcast dims as zero strides) is added in f32 after the scale
and before the mask by the forward's ``[bias]`` instantiation; as in JAX
(:839-845, :879-891) the forward keeps no LSE then, and the backward is
autograd through the composite (segment mask, causal triangle, bias) on the
saved inputs, dbias in the bias's own shape.  A bias with gammas or dropout
raises ``ValueError``, as in JAX.

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
:859-876), dgamma included.

Each wrapper has a plain PyTorch twin at the kernel's rounding points
(``flash_fwd_reference``, ``flash_bwd_reference``,
``flash_dropout_masks_reference``), which CPU tensors take; on a CUDA tensor
it launches its kernel or raises.  Each launch adds one to
``LAUNCHES[kernel]``, each variant to its own entry, tagged in the order
bias, dropout, qknorm, causal (``flash_fwd[dropout,qknorm]``,
``flash_bwd_dq[causal]``, ``flash_fwd[bias,causal]``, ...).
:func:`flash_attention_twins` runs the same Function on the twins on any
device.  :func:`flash_attention_reference` is the twin of the whole op, the
JAX ``_reference_attention`` (:809-815): the materialized composite with the
segment mask and causal triangle, the bias (and the same keep mask),
differentiated by autograd.

The kernels take bf16 with ``dim_head == 64`` (their one head dim) on a
CUDA device; :func:`flash_supported` is the gate the dispatcher asks.  The
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
BWD_ROWS = 2 * BLOCK_Q  # kBwdRows: a backward work item's rows, two warpgroups' tiles
DIM_HEAD = 64  # kFlashDh: the one head dim the kernels are built for
NEG_INF = -1e30  # _NEG_INF: the LSE of a row with no key to attend
_BIG_ID = 1 << 30


def _counter(name: str, drop=False, gammas=False, causal=False, bias=False) -> str:
    """A kernel's launch counter: its name with the variant's tags."""
    tags = [tag for tag, on in (("bias", bias), ("dropout", drop), ("qknorm", gammas), ("causal", causal)) if on]
    return f"{name}[{','.join(tags)}]" if tags else name


# launches per kernel since the last reset_launch_counts(); each variant
# counts apart from its kernel's plain launches
LAUNCHES = {
    **{_counter(name, drop, qk, causal): 0 for causal in (False, True) for drop in (False, True)
       for qk in (False, True) for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
    "flash_fwd[bias]": 0,
    "flash_fwd[bias,causal]": 0,
    "flash_dropout_masks": 0,
}


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
    at dh = 64 (a warpgroup of 4 warps of 16 query rows a 64-query tile;
    flash_fwd's blocks hold one or two such warpgroups), not from the TPU's
    VMEM."""
    del n, m
    return BLOCK_Q, BLOCK_K


def _tile_ranges(ids: torch.Tensor, block: int):
    """Per tile of ``block`` rows of (b, L) ids: the min of the non-negative
    ids (2^30 when none) and the max of all ids, rows past L read as -1."""
    ids = F.pad(ids.to(torch.int64), (0, (-ids.shape[1]) % block), value=-1)
    tiles = ids.view(ids.shape[0], -1, block)
    lo = torch.where(tiles >= 0, tiles, _BIG_ID).amin(-1)
    return lo, tiles.amax(-1)


def tile_admitted(q_segment_ids, kv_segment_ids, *, block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                  causal: bool = False):
    """(b, n tiles, m tiles) bool: the tiles the kernels run, the skip test
    of ``_seg_overlap`` (:173-188) as a plain function of the ids.  A tile
    runs iff some id of each side is >= 0 and the two ranges of non-negative
    ids overlap.  It is conservative for any ids (a tile holding a pair that
    shares an id always runs) and exact for packed sequences, whose ids rise
    along the sequence.  With ``causal`` a tile runs only if its first key
    is at most its last query (:220-221): the kernels' loops end at the
    diagonal tile."""
    q_lo, q_hi = _tile_ranges(q_segment_ids, block_q)
    k_lo, k_hi = _tile_ranges(kv_segment_ids, block_k)
    q_lo, q_hi, k_lo, k_hi = q_lo[:, :, None], q_hi[:, :, None], k_lo[:, None, :], k_hi[:, None, :]
    admitted = (q_hi >= 0) & (k_hi >= 0) & (q_lo <= k_hi) & (k_lo <= q_hi)
    if causal:
        qi = torch.arange(admitted.shape[1], device=admitted.device)[:, None]
        kj = torch.arange(admitted.shape[2], device=admitted.device)[None, :]
        admitted = admitted & (kj * block_k <= qi * block_q + block_q - 1)
    return admitted


def bwd_tile_lists(n: int, m: int, q_segment_ids=None, kv_segment_ids=None, *, dkv: bool = False,
                   causal: bool = False):
    """The tiles each work item of the backward kernels walks, in its
    order: per image (one list, every image alike, without ids), per item
    of ``BWD_ROWS`` rows (queries for flash_bwd_dq, keys with ``dkv`` for
    flash_bwd_dkv), the ascending indices of the other side's 64-row tiles
    it admits.  The host mirror of the kernels' admission (``admit_chunk``
    in csrc/flash_attention.cu, whose masks the loader walks in ascending
    order): a tile is admitted iff
    the ranges of the item's ids (all its rows) and of the tile's overlap
    (``_seg_overlap``'s test, as :func:`tile_admitted`, on a block of
    ``BWD_ROWS`` rows); with ``causal`` flash_bwd_dq's walk ends at the
    item's last query tile and flash_bwd_dkv's starts at its first key
    tile."""
    own_len, other_len = (m, n) if dkv else (n, m)
    items, tiles = -(-own_len // BWD_ROWS), -(-other_len // BLOCK_Q)
    if q_segment_ids is None:
        admitted = torch.ones((1, items, tiles), dtype=torch.bool)
    else:
        own, other = (kv_segment_ids, q_segment_ids) if dkv else (q_segment_ids, kv_segment_ids)
        lo, hi = (t[:, :, None] for t in _tile_ranges(own.cpu(), BWD_ROWS))
        tlo, thi = (t[:, None, :] for t in _tile_ranges(other.cpu(), BLOCK_Q))
        admitted = (hi >= 0) & (thi >= 0) & (lo <= thi) & (tlo <= hi)
    if causal:
        item, tile = torch.arange(items)[:, None], torch.arange(tiles)[None, :]
        first_own_tile = item * (BWD_ROWS // BLOCK_Q)
        admitted = admitted & (tile >= first_own_tile if dkv else tile <= first_own_tile + BWD_ROWS // BLOCK_Q - 1)
    return [[row.nonzero().flatten().tolist() for row in image] for image in admitted]


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


def _valid(q_segment_ids, kv_segment_ids, n: int, m: int, causal: bool = False, device=None):
    """(b, 1, n, m) (or (n, m), causal alone) bool of the pairs that may
    attend, or None for all."""
    from .attention import build_segment_mask

    return build_segment_mask(q_segment_ids, kv_segment_ids, n, m, causal=causal, device=device)


def _logits(q, k, scale, valid, bias=None):
    """s = (q.k^T in f32) * scale (+ the bias in f32), the masked entries at
    the sentinel."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
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
                        seed=None, gamma_q=None, gamma_k=None, causal: bool = False, bias=None):
    """Plain twin of :func:`flash_fwd`: ``(o, lse)``, o (b, h, n, d) in q's
    dtype and lse (b, h, n) f32.  The rounding points of ``_fwd_kernel``
    with the whole row at once: p = exp(s - max) zeroed where masked (after
    the exp), cast to v's dtype before p.v in f32, o = acc * (1/l) cast once.
    A row with no key to attend gives o = 0 and lse = -1e30.  With dropout
    l sums the undropped p, p is masked before its cast, and o = acc *
    (inv_keep / l), one f32 factor (:255-290).  With gammas q and k first
    go through :func:`rms_tile_reference` (:229-235).  ``causal`` masks key j
    from query i unless j <= i; ``bias`` (broadcasting against (b, h, n, m))
    is added in f32 after the scale, before the mask (:241-248)."""
    drop = _dropout("flash_fwd", dropout_rate, seed, q.shape[1])
    q, k = _normed(q, k, gamma_q, gamma_k)
    valid = _valid(q_segment_ids, kv_segment_ids, q.shape[2], k.shape[2], causal, q.device)
    s = _logits(q, k, scale, valid, bias)
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
                        dropout_rate: float = 0.0, seed=None, gamma_q=None, gamma_k=None, causal: bool = False):
    """Plain twin of :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`:
    ``(dq, dk, dv)`` at the rounding points of ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``: p = exp(s - lse) zeroed where masked after the exp
    (in a fully masked row that exp is 1), dv = bf16(p)^T.dO, ds = p * (dO.v^T
    - delta) in f32, dq = scale * bf16(ds).k, dk = scale * bf16(ds)^T.q, each
    accumulated in f32 and cast once.  With dropout dv takes bf16(where(keep,
    p, 0) * inv), scaled before the cast, and dp = where(keep, dO.v^T, 0) *
    inv in f32 (:352-361, :425-456); ds keeps the undropped p.  With gammas
    q and k are normalised first (:324-329, :404-406), so dq and dk are the
    gradients of the normalised q and k.  ``causal`` as in the forward."""
    drop = _dropout("flash_bwd", dropout_rate, seed, q.shape[1])
    q, k = _normed(q, k, gamma_q, gamma_k)
    valid = _valid(q_segment_ids, kv_segment_ids, q.shape[2], k.shape[2], causal, q.device)
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


def flash_attention_reference(q, k, v, *, scale: Optional[float] = None, bias=None, q_segment_ids=None,
                              kv_segment_ids=None, causal: bool = False, dropout_rate: float = 0.0, dropout_seed=None,
                              gamma_q=None, gamma_k=None):
    """The plain twin of :func:`flash_attention`: the JAX
    ``_reference_attention`` (:809-815), the materialized composite
    (``xla_attention``, logits stored in the input dtype) under the segment
    mask and causal triangle of ``build_segment_mask``, with the bias,
    differentiated by autograd.  Rows with no key to attend give zeros
    (``xla_attention``'s ``mask.any``).  With dropout the composite drops the
    normalized matrix with the kernels' keep mask of ``dropout_seed``.  With
    gammas q and k first go through the eager :func:`rms_norm`, as the JAX
    dispatcher's composite route takes them."""
    from .attention import xla_attention

    _check_gammas(gamma_q, gamma_k, bias)
    if gamma_q is not None:
        q, k = rms_norm(q, gamma_q), rms_norm(k, gamma_k)

    mask = _valid(q_segment_ids, kv_segment_ids, q.shape[2], k.shape[2], causal, q.device)
    keep = None
    if dropout_rate > 0.0:
        _check_dropout_request(dropout_rate, dropout_seed, bias)
        keep = _keep(q, k, dropout_rate, dropout_seed)
    return xla_attention(q, k, v, scale=scale, bias=bias, mask=mask, dropout_rate=dropout_rate, keep=keep)


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


def _strides(*tensors, bias=None):
    """The 21 (b, h, row) strides of q, k, v, dO, out0, out1 (None: zeros)
    and the bias (4-D; 0 on its broadcast dims)."""
    flat = []
    for t in tensors:
        flat += [0, 0, 0] if t is None else list(t.stride()[:3])
    flat += [0, 0, 0] if bias is None else [0 if bias.shape[i] == 1 else bias.stride(i) for i in range(3)]
    return (ctypes.c_longlong * 21)(*flat)


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


def check_bias(bias, q_shape, m: int):
    """The JAX flash bias checks (:563-573) on a 4-D bias against q (b, h,
    n, d) and m keys."""
    b, h, n, _ = q_shape
    if bias.ndim != 4 or tuple(bias.shape[2:]) != (n, m):
        raise ValueError(f"flash attention bias must have shape (b|1, h|1, {n}, {m}); got {tuple(bias.shape)}")
    if bias.shape[0] not in (1, b) or bias.shape[1] not in (1, h):
        raise ValueError(f"flash attention bias leading dims must broadcast against (b={b}, h={h}); got "
                         f"{tuple(bias.shape[:2])}")


def bias_operand(bias, device):
    """A bias as a kernel reads it: f32 or bf16 as it is (any other float
    dtype upcast to f32), on ``device``, its last dim contiguous.  Returns
    (tensor, 1 if bf16 else 0)."""
    if bias.device != device:
        raise ValueError(f"bias on {bias.device}, expected {device}")
    bias = bias.detach()
    if bias.dtype not in (torch.float32, torch.bfloat16):
        bias = bias.float()
    if bias.stride(-1) != 1:
        bias = bias.contiguous()
    return bias, int(bias.dtype == torch.bfloat16)


def flash_fwd(q, k, v, *, scale: float, q_segment_ids=None, kv_segment_ids=None, dropout_rate: float = 0.0,
              seed=None, gamma_q=None, gamma_k=None, causal: bool = False, bias=None):
    """``(o, lse)`` of softmax attention: o (b, h, n, 64) bf16 in the
    merged-heads layout, lse (b, h, n) f32 (-1e30 for a row with no key);
    with ``dropout_rate`` > 0 (the ``[dropout]`` instantiation) the
    attention matrix is dropped with the keep mask of ``seed``; with gammas
    (the ``[qknorm]`` instantiations) q and k are normalised in the kernel;
    ``causal`` masks key j from query i unless j <= i; ``bias`` (4-D,
    (1|b, 1|h, n, m), the ``[bias]`` instantiation, without dropout or
    gammas) is added after the scale.  See :func:`flash_fwd_reference`."""
    ids = _ids(q_segment_ids, kv_segment_ids)
    drop = _dropout("flash_fwd", dropout_rate, seed, q.shape[1])
    if bias is not None:
        check_bias(bias, q.shape, k.shape[2])
        _check_gammas(gamma_q, gamma_k, bias)
        _check_dropout_request(dropout_rate, seed, bias)
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, scale=scale, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                                   dropout_rate=dropout_rate, seed=seed, gamma_q=gamma_q, gamma_k=gamma_k,
                                   causal=causal, bias=bias)
    _check("flash_fwd", (q, k, v), ids)
    b, h, n, d = q.shape
    m = k.shape[2]
    rows = gamma_rows(gamma_q, gamma_k, q)
    _check_gamma_rows("flash_fwd", rows, q)
    bias_bf16 = 0
    if bias is not None:
        bias, bias_bf16 = bias_operand(bias, q.device)
    o = _merged_heads(b, h, n, q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    lib = load_library()
    err = lib.lib.vit_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _ptr(q_segment_ids), _ptr(kv_segment_ids), *_gamma_ptrs(rows), _ptr(bias), bias_bf16, b, h, n, m, d,
        float(scale), int(causal), *drop, _strides(q, k, v, None, o, None, bias=bias),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = _counter("flash_fwd", drop[0], bool(rows), causal, bias is not None)
    lib.check(name, err)
    LAUNCHES[name] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float, q_segment_ids=None, kv_segment_ids=None,
                 dropout_rate: float = 0.0, seed=None, gamma_q=None, gamma_k=None, causal: bool = False):
    """dq (b, h, n, 64) bf16, merged-heads layout, replaying the forward's
    keep mask with ``dropout_rate`` > 0; with gammas the gradient of the
    normalised q; see :func:`flash_bwd_reference`."""
    ids = _ids(q_segment_ids, kv_segment_ids)
    drop = _dropout("flash_bwd_dq", dropout_rate, seed, q.shape[1])
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, scale=scale, q_segment_ids=q_segment_ids,
                                   kv_segment_ids=kv_segment_ids, dropout_rate=dropout_rate, seed=seed,
                                   gamma_q=gamma_q, gamma_k=gamma_k, causal=causal)[0]
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
        float(scale), int(causal), *drop, _strides(q, k, v, do, dq, None),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = _counter("flash_bwd_dq", drop[0], bool(rows), causal)
    lib.check(name, err)
    LAUNCHES[name] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, scale: float, q_segment_ids=None, kv_segment_ids=None,
                  dropout_rate: float = 0.0, seed=None, gamma_q=None, gamma_k=None, causal: bool = False):
    """``(dk, dv)``, each (b, h, m, 64) bf16 in the merged-heads layout,
    replaying the forward's keep mask with ``dropout_rate`` > 0; with gammas
    dk is the gradient of the normalised k; see :func:`flash_bwd_reference`."""
    ids = _ids(q_segment_ids, kv_segment_ids)
    drop = _dropout("flash_bwd_dkv", dropout_rate, seed, q.shape[1])
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, do, lse, delta, scale=scale, q_segment_ids=q_segment_ids,
                                   kv_segment_ids=kv_segment_ids, dropout_rate=dropout_rate, seed=seed,
                                   gamma_q=gamma_q, gamma_k=gamma_k, causal=causal)[1:]
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
        float(scale), int(causal), *drop, _strides(q, k, v, do, dk, dv),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = _counter("flash_bwd_dkv", drop[0], bool(rows), causal)
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


def _composite_bwd(q, k, v, bias, q_segment_ids, kv_segment_ids, scale, causal, g):
    """dq, dk, dv, dbias of the composite (JAX ``_bwd`` with a bias,
    :879-891): autograd through ``_reference_attention`` on the saved
    inputs; dbias comes back in the bias's own (broadcast) shape."""
    from .attention import xla_attention

    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        mask = _valid(q_segment_ids, kv_segment_ids, q.shape[2], k.shape[2], causal, q.device)
        out = xla_attention(*leaves[:3], scale=scale, bias=leaves[3], mask=mask)
        return torch.autograd.grad(out, leaves, g)


class _FlashAttention(torch.autograd.Function):
    """The counterpart of ``_flash_attention_core``'s custom_vjp (:818-891).
    The dropout rate and seed ride as Python numbers: the backward replays
    the forward's mask from them.  With qk-norm gammas the kernels take their
    f32 rows, the Function saves the raw q and k, and its backward closes the
    RMSNorm VJP on the kernels' normalised-space dq and dk in plain PyTorch
    (:func:`rms_norm_vjp`, JAX ``_bwd`` :859-876).  With a bias the forward
    keeps no o or LSE and the backward is :func:`_composite_bwd`."""

    @staticmethod
    def forward(ctx, ops, scale, dropout_rate, seed, causal, q, k, v, q_segment_ids, kv_segment_ids, gamma_q, gamma_k,
                bias):
        rows = gamma_rows(gamma_q, gamma_k, q)
        kw = _gamma_kw(rows)
        o, lse = ops.fwd(q, k, v, scale=scale, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                         dropout_rate=dropout_rate, seed=seed, causal=causal, bias=bias, **kw)
        if bias is not None:
            ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, bias)
        else:
            ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, o, lse, gamma_q, gamma_k, *rows)
        ctx.ops, ctx.scale, ctx.dropout_rate, ctx.seed, ctx.causal = ops, scale, dropout_rate, seed, causal
        ctx.has_bias = bias is not None
        return o

    @staticmethod
    def backward(ctx, g):
        if ctx.has_bias:
            q, k, v, qs, ks, bias = ctx.saved_tensors
            dq, dk, dv, dbias = _composite_bwd(q, k, v, bias, qs, ks, ctx.scale, ctx.causal, g)
            return None, None, None, None, None, dq, dk, dv, None, None, None, None, dbias
        q, k, v, qs, ks, o, lse, gamma_q, gamma_k, *rows = ctx.saved_tensors
        g = _kernel_ready(g)
        delta = (g.float() * o.float()).sum(-1).contiguous()  # (b, h, n) f32, :680-685; exact under dropout
        dq, dk, dv = ctx.ops.bwd(q, k, v, g, lse, delta, scale=ctx.scale, q_segment_ids=qs, kv_segment_ids=ks,
                                 dropout_rate=ctx.dropout_rate, seed=ctx.seed, causal=ctx.causal,
                                 **_gamma_kw(rows))
        dgq = dgk = None
        if rows:
            dq, dgq = rms_norm_vjp(q, gamma_q, dq)
            dk, dgk = rms_norm_vjp(k, gamma_k, dk)
        return None, None, None, None, None, dq, dk, dv, None, None, dgq, dgk, None


def _flash(ops, q, k, v, scale, q_segment_ids, kv_segment_ids, dropout_rate, seed, gamma_q, gamma_k, causal=False,
           bias=None):
    ids = _ids(q_segment_ids, kv_segment_ids)
    if ids:
        q_segment_ids, kv_segment_ids = (t.to(torch.int32).contiguous() for t in ids)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    dropout_rate = float(dropout_rate)
    seed = int(seed) if dropout_rate > 0.0 else None
    causal = bool(causal)
    if bias is not None:
        while bias.ndim < 4:  # JAX :990-992
            bias = bias[None]
        check_bias(bias, q.shape, k.shape[2])
    q, k, v = (_kernel_ready(t) for t in (q, k, v))
    operands = [t for t in (q, k, v, gamma_q, gamma_k, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _FlashAttention.apply(ops, scale, dropout_rate, seed, causal, q, k, v, q_segment_ids, kv_segment_ids,
                                     gamma_q, gamma_k, bias)
    rows = gamma_rows(gamma_q, gamma_k, q)
    return ops.fwd(q, k, v, scale=scale, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                   dropout_rate=dropout_rate, seed=seed, causal=causal, bias=bias, **_gamma_kw(rows))[0]


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


def flash_attention_twins(q, k, v, *, scale: Optional[float] = None, bias=None, q_segment_ids=None,
                          kv_segment_ids=None, causal: bool = False, dropout_rate: float = 0.0, dropout_seed=None,
                          gamma_q=None, gamma_k=None):
    """The plain path of :func:`flash_attention` on any device: the same
    Function with every kernel swapped for its plain twin (the counterpart
    of ``ops/fused_block.py::layer_reference``), the same keep masks from
    the same seed, the same qk-norm epilogue, the same composite backward
    with a bias.  Like the kernels it keeps only o and the LSE for the
    backward, so it trains where the materialized
    :func:`flash_attention_reference` would not fit."""
    _check_gammas(gamma_q, gamma_k, bias)
    _check_dropout_request(dropout_rate, dropout_seed, bias)
    return _flash(TWINS, q, k, v, scale, q_segment_ids, kv_segment_ids, dropout_rate, dropout_seed, gamma_q, gamma_k,
                  causal, bias)


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
    ``causal``: token i attends j only if j <= i (top-left aligned).
    ``bias``: an additive logits bias broadcasting as (1|b, 1|h, n, m)
    (fewer dims gain leading ones, as in JAX), differentiable; its backward is
    the composite's, and its shape checks raise ``ValueError`` as JAX's do.
    ``gamma_q``/``gamma_k`` (both or neither; any shape reshaping to (h, d),
    the modules keep (h, 1, d)): the reference's per-head qk RMSNorm runs
    inside the kernels (their ``[qknorm]`` instantiations), and the backward
    closes its VJP on the host; callers pass ``scale=1.0`` with it.  With a
    ``bias`` they raise ``ValueError``, as in JAX.
    ``dropout_rate`` > 0 drops the normalized attention matrix inside the
    kernels with the keep mask of the int ``dropout_seed`` (required; see
    :func:`flash_dropout_masks`), and the backward replays it; with a
    ``bias`` it raises ``ValueError``, as the JAX function does.
    Differentiable in q, k and v (and the gammas, the bias).  On the CPU it
    runs the Function on the plain twins; on a CUDA tensor it launches the
    kernels and raises for what :func:`flash_supported` refuses.
    ``block_q``/``block_k`` may only name the kernels' own 64 x 64 tiles, and
    ``interpret`` (the Pallas interpreter switch) has no meaning here: CPU
    tensors take the twins."""
    _check_gammas(gamma_q, gamma_k, bias)
    _check_dropout_request(dropout_rate, dropout_seed, bias)
    del interpret
    if (block_q or BLOCK_Q) != BLOCK_Q or (block_k or BLOCK_K) != BLOCK_K:
        raise ValueError(f"flash_attention: the kernels' tiles are {BLOCK_Q} x {BLOCK_K}")
    if q.device.type != "cpu" and not flash_supported(q.shape, k.shape, q.dtype):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} is not supported by the kernels "
            f"(bf16, dim_head {DIM_HEAD})"
        )
    return _flash(KERNELS, q, k, v, scale, q_segment_ids, kv_segment_ids, dropout_rate, dropout_seed, gamma_q,
                  gamma_k, causal, bias)
