// Hopper (sm_90a) flash attention with segment-id (packed-sequence) masking:
// forward and the two backward kernels.
//
// They replace the TPU kernels of vit_pytorch_tpu/ops/flash_attention.py:
//
//   flash_fwd      _fwd_kernel      (:202, called at :630)  q, k, v -> o, lse
//   flash_bwd_dq   _bwd_dq_kernel   (:298, called at :739)  ... , do, lse, delta -> dq
//   flash_bwd_dkv  _bwd_dkv_kernel  (:376, called at :776)  ... , do, lse, delta -> dk, dv
//
// with every option of the JAX kernels: segment ids or none, attention
// dropout or none, the in-tile qk-norm or none, the causal mask or none, and
// in the forward an additive bias or none.  Each kernel has four
// instantiations, kDropout x kQkNorm (the launch counters' "flash_fwd",
// "flash_fwd[dropout]", "flash_fwd[qknorm]" and "flash_fwd[dropout,qknorm]");
// an instantiation without an option holds none of its code.  flash_fwd has
// a fifth, kBias (rate 0, no qk-norm: "flash_fwd[bias]").  Causal is a
// runtime flag of every instantiation ("[...,causal]" in the counters): it
// bounds the tile loops, and only the diagonal tile, behind a branch uniform
// across the block, hides its future keys' logits (-inf) before the element
// mask, which is the one a call without the flag runs.
//
// Causal (_tile_mask :161-164, the tile tests :220-221, :315-316, :394-396):
// top-left aligned in absolute positions, key c visible to query r iff c <=
// r, for n != m too (PyTorch's tril and SDPA's is_causal align the same way).
// With 64 x 64 tiles query tile i sees key tiles 0 .. i: flash_fwd and
// flash_bwd_dq loop over those and no further, flash_bwd_dkv's key tile j
// starts its loop at query tile j; the element test runs on the diagonal tile
// (i, i) alone, every key of an earlier tile being visible to every query of
// a later one.  Keys past n reach no query: their dk and dv are 0.
//
// Bias (_fwd_kernel :241-242, its index map :559-587): a (1|b, 1|h, n, m)
// f32 or bf16 table, the broadcast dims given zero strides (never copied),
// staged tile by tile in flash_fwd's ring (rows past n and keys past m are
// never read) and read from there by each thread for its own accumulator
// elements; upcast to f32 and added after the scale, before the mask.  The
// head-ordered grid runs a batch-stride-0 table's images side by side.  Its backward is the composite (JAX _bwd :879-891), so only the
// forward has the variant, and the lse it writes is not kept.
//
// The TPU kernels walk a (b*h, q-tile, kv-tile) grid whose last axis is
// sequential and carry the online-softmax state (or the dq / dk, dv sums) in
// VMEM scratch from one grid step to the next.  An H100 runs blocks in no
// order, so here the sequential axis is a loop inside the block: one block
// of 4 warps per (q-tile, b*h) for flash_bwd_dq and per (q-tile, image,
// head) for flash_fwd, looping over kv-tiles, and one per (kv-tile, b*h) for
// flash_bwd_dkv, looping over q-tiles.  Every sum a block makes stays in its registers, so the result
// does not depend on block order.
//
// Bound on this card: at NaViT-B's 2048-token packs the products are
// 4*d flops per (query, key) pair of one image against a few bytes per row
// of q, k, v, far above the ~295 flop/byte ridge inside the diagonal tiles;
// the (n, m) logits, 805 M per layer over 16 packs x 12 heads, would be
// gigabytes in device memory, so they never leave the registers.  The
// limit is tensor-core throughput and the tiles a block must visit.
//
// Design (of the backward kernels; flash_fwd's is in its section below and
// in attn_wgmma.cuh: wgmma on both products, a three-stage ring):
//  - Tiles are the H100's own, 64 query rows x 64 keys (not the TPU's
//    1024/512): each warp owns 16 query rows (16 keys in flash_bwd_dkv), and
//    a 64x64 tile of s = q.k^T is 8 x 4 mma.sync m16n8k16 a warp, with f32
//    accumulators in registers.  dh = 64 is the one instantiation.
//  - The operands each warp keeps for the whole loop (its q and dO rows, or
//    its k and v rows) are read once from device memory straight into mma
//    A fragments.  The tiles the loop walks (k and v, or q and dO with their
//    LSE, delta and ids) go through a two-stage cp.async ring in shared
//    memory (rows 72 bf16 apart, off the bank period), so the next admitted
//    tile lands while the block computes on this one.  Rows past n or m are
//    zero-filled: a masked p is exactly 0, and 0 * a zero row stays 0 (a
//    stale row could hold a NaN).
//  - The accumulator layout of one product is the A-operand layout of the
//    next (acc_to_a_frag), so p, ds and their transposes go from f32
//    registers to bf16 operands without a trip through memory.
//  - Tile skip (_seg_overlap, :173-188): a (q-tile, kv-tile) pair runs only
//    if the ranges of the two tiles' non-negative ids overlap.  Each warp
//    computes a tile's range with shuffles, the same in all four warps, so
//    the skip is uniform across the block and needs no barrier; the ring
//    prefetches the next admitted tile.  The test is conservative: the
//    element mask still decides every (query, key) pair.  The same
//    predicate is ops/flash_attention.py::tile_admitted on the host
//    (flash_fwd's blocks of two 64-query tiles run a key tile that either
//    admits).
//  - Strided operands: q, k, v, o, dO, dq, dk, dv are (b, h, rows, 64) with
//    any (b, h, row) strides and a contiguous head dim, so the merged-heads
//    (b, n, h*dh) layout of the model's projections needs no copy.
//
// Masking and its hazards (named in the tests too):
//  - An element (query r, key c) is valid iff r < n, c < m and, with ids,
//    qseg[r] == kseg[c] >= 0 (_tile_mask, :150-165).  Without ids every
//    row and key in range is segment 0, so one test serves both.
//  - Fully masked rows: pad tokens carry id -1 and empty attn_pool slots -2.
//    As in _fwd_kernel (:284-290) such a row keeps l = 0 and m = -1e30, so
//    o = acc / 1 = 0 and lse = -1e30, the sentinel.  A block whose tiles
//    are all skipped writes exactly that, and flash_bwd_dkv writes dk = dv
//    = 0 for keys no query reaches.
//  - The backward recomputes p = exp(s - lse).  At a masked element of a
//    fully masked row that is exp(-1e30 - (-1e30)) = 1 in the TPU kernel,
//    which zeroes p after the exp (:344-346, :421-423).  Here p is never
//    taken from a masked logit: it is 0 wherever the element mask says so,
//    after the exp or instead of it, or pad rows would leak gradient.
//  - Segments are per image, not per head: block (x, bh) reads the ids of
//    image bh / heads.
//
// Dropout (_fwd_kernel :255-290, _bwd_dq_kernel :352-361, _bwd_dkv_kernel
// :425-456), applied to the normalized attention matrix as the reference
// does (vit.py:60):
//  - Keep bits are keyed by element, not by the TPU's tile id (_tile_keep
//    :84-98 seeds its PRNG per (seed, tile), so its masks depend on its
//    1024/512 tiles): the bit of (query i, key j) in pack b, head h is word
//    j % 4 of Philox4x32-10 at counter (i, j / 4, 0, 0) and key (seed, b *
//    1024 + h), kept iff >= the rate's threshold (keep_nibble, common.cuh),
//    the function the attention-block kernels draw from.  So the three
//    kernels, whose loops walk the tiles in different orders, and the
//    replay kernel flash_dropout_masks (dropout.cu) see one mask.
//  - Each ring stage carries the keep tile of its (q-tile, kv-tile) pair,
//    64 x 64 bits keyed (query, key) in 128 words of shared memory, filled
//    by all 128 threads (8 Philox calls each) right after the stage's
//    copies are issued, so the barrier that publishes the copies publishes
//    the bits; a skipped tile draws none.  The register-bound bodies read
//    one 32-bit mask a thread a tile (keep_bits_rows), and flash_bwd_dkv,
//    whose accumulators are (key, query), reads the same tile transposed
//    (keep_bits_cols).
//  - flash_fwd: l sums the UNDROPPED p (:260-263); where(keep, p, 0) is
//    cast to bf16 before p.v (:265-276); o = acc * (inv_keep / l), one f32
//    factor (:286-287); the lse is that of the undropped softmax.
//  - flash_bwd_dq: dp = where(keep, dO.v^T, 0) * inv in f32, then ds = p *
//    (dp - delta); delta = rowsum(dO * o) stays exact, since o already
//    holds the dropped p (:352-361).
//  - flash_bwd_dkv: pd = where(keep, p, 0) * inv, cast to bf16 after the
//    scale, dv += pd^T.dO; dp masked as in dq; ds from the undropped p.
//
// In-tile qk-norm (the JAX opt-in VIT_TPU_FUSE_QKNORM; _fwd_kernel :229-235,
// _bwd_dq_kernel :324-329, _bwd_dkv_kernel :404-406), the reference's
// per-head RMSNorm (na_vit.py:93-103) at _rms_tile's rounding points
// (:135-142): statistics in f32 from the bf16 row, r = rsqrt(sum(x^2) +
// 1e-12), each element (x * r) * (gamma * sqrt(64)) in f32, one cast to bf16
// before the products.  The gammas are (heads, 64) f32; block (x, bh) reads
// row bh % heads.  The TPU renormalises q and k for every (q, kv) tile of all
// three grids; here each operand is normalised once where it lives:
//  - the operand a block keeps for its whole loop (q in flash_fwd and
//    flash_bwd_dq, k in flash_bwd_dkv), in its A fragments, once before the
//    loop (rms_norm_a_rows: a quad holds a row);
//  - each tile the loop walks (k, or q in flash_bwd_dkv), in place in its
//    ring stage once it has landed, behind one more barrier
//    (rms_norm_rows, common.cuh, with the gammas in shared memory); a tile
//    the skip test refuses is neither loaded nor normalised.
// Every product reads the normalised operands: dq = ds.k^, dk = ds^T.q^.
// So dq and dk come out in normalised space, as the TPU kernels emit them;
// the host closes the RMSNorm VJP, dgamma included
// (ops/flash_attention.py::_FlashAttention, JAX _bwd :859-876).
//
// Rounding points of the TPU kernels: s = (q.k^T in f32) * scale (NaViT's
// scale is 1 after qk-norm); p is cast to bf16 before p.v and o = acc * (1/l)
// is cast once; ds = p * (dp - delta) in f32 with delta = rowsum(dO * o)
// computed in f32 outside the kernels (_flash_backward :680-685), cast to
// bf16 before ds.k and ds^T.q; dq, dk, dv accumulate in f32 and are cast
// once (scale applied to the f32 sums).  exp is 2^x of the argument times
// log2(e): exp2f in the backward, exp2_ftz (attn_wgmma.cuh) for flash_fwd's
// p.  No result depends on the tile size except f32 summation order.

#include <type_traits>

#include "attn_wgmma.cuh"

namespace {

constexpr int kBigId = 1 << 30;
constexpr int kFlashKeepWords = kFlashTile / 32;                  // 32-key words of one keep row
constexpr int kFlashKeepTile = kFlashTile * kFlashKeepWords;      // 128 words: one tile's keep bits
constexpr int kKeepSmem = 2 * kFlashKeepTile * 4;                 // a keep tile per ring stage
constexpr int kGammaSmem = kFlashDh * 4;                          // qk-norm: the ring operand's f32 gammas

// shared memory of the backward kernels: two ring stages of two bf16
// tiles, and per stage 64 ids (flash_bwd_dkv also 64 lse and 64 delta);
// with dropout a keep tile a stage; with qk-norm the 64 gammas of the
// operand the ring carries
constexpr int kDqSmem = 4 * kTileElems * static_cast<int>(sizeof(bf16)) + 2 * kFlashTile * 4;
constexpr int kDkvSmem = 4 * kTileElems * static_cast<int>(sizeof(bf16)) + 2 * 3 * kFlashTile * 4;

struct FlashArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* out0;  // flash_fwd: o; flash_bwd_dq: dq; flash_bwd_dkv: dk
  bf16* out1;  // flash_bwd_dkv: dv
  float* lse;  // (b*h, n) f32; written by flash_fwd, read by the backward
  const float* delta;  // (b*h, n) f32
  const int* qseg;     // (b, n) int32, or null
  const int* kseg;     // (b, m) int32, or null
  const float* gq;     // (heads, 64) f32 qk-norm gammas, read by the kQkNorm instantiations only
  const float* gk;
  const void* bias;  // (1|b, 1|h, n, m) f32 or bf16, read by flash_fwd's kBias instantiation only
  int bias_bf16;
  Strides sq, sk, sv, sdo, s0, s1, sbias;  // sbias: 0 on a broadcast dim
  int heads, n, m;
  int causal;  // key c visible to query r iff c <= r (top-left aligned)
  float scale;
  DropoutArgs drop;  // read by the kDropout instantiations only
  int batch;        // flash_fwd's grid (grid_pos)
};

// The segment id of row r of a (b, len) id array: -1 past len; without ids
// every row in range is segment 0.
__device__ __forceinline__ int seg_id(const int* seg, int r, int len) {
  return r < len ? (seg ? seg[r] : 0) : -1;
}

// The range of the non-negative ids of rows r0 .. r0 + 63 (lo = 2^30 when
// none) and their max over all ids (negative when none is >= 0): the
// reductions of _seg_overlap.  Every lane of the warp gets the result.
__device__ __forceinline__ void seg_range(const int* seg, int r0, int len, int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  const int a = seg_id(seg, r0 + lane, len), c = seg_id(seg, r0 + 32 + lane, len);
  hi = max(a, c);
  lo = min(a >= 0 ? a : kBigId, c >= 0 ? c : kBigId);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
  }
}

// _seg_overlap: can any (query, key) pair of the two tiles share an id?
// (Symmetric in the two tiles.)
__device__ __forceinline__ bool tiles_overlap(int qlo, int qhi, int klo, int khi) {
  return qhi >= 0 && khi >= 0 && qlo <= khi && klo <= qhi;
}

// The first tile j' >= j of the other side (`tiles` tiles over the `len`
// ids of `seg`) that overlaps this block's tile, whose id range is [lo, hi];
// without ids every tile runs.  Uniform across the block.
__device__ __forceinline__ int next_admitted(const int* seg, int len, int tiles, int j, int lo, int hi) {
  if (seg == nullptr) return j;
  for (; j < tiles; ++j) {
    int l, h;
    seg_range(seg, j * kFlashTile, len, l, h);
    if (tiles_overlap(lo, hi, l, h)) break;
  }
  return j;
}

// The causal mask (_tile_mask :161-164), top-left aligned in absolute
// positions: whether key c is visible to query r.  The flag is read from the
// kernel's parameters at each test, so a call without the mask holds no
// limit in a register.
__device__ __forceinline__ bool causal_visible(const FlashArgs& a, int c, int r) { return !a.causal || c <= r; }

// Causal tile bounds (_fwd_kernel :220-221, _bwd_dq_kernel :315-316,
// _bwd_dkv_kernel :394-396) for 64 x 64 tiles: query tile i sees key tiles
// 0 .. i, key tile j is seen by query tiles j .. end.  The loops are bounded,
// not skipped: a tile past the diagonal is never visited.
__device__ __forceinline__ int causal_key_tiles(int qtile, int nk) { return min(nk, qtile + 1); }
__device__ __forceinline__ int causal_first_query_tile(int ktile) { return ktile; }

// s * scale + bias in f32, two roundings, after the scale and before the
// mask (_fwd_kernel :237-248)
__device__ __forceinline__ float scaled_biased(float s, float scale, float bias) {
  return __fadd_rn(__fmul_rn(s, scale), bias);
}

// The causal triangle of the diagonal tile, applied before the element mask:
// each raw logit the triangle hides becomes -inf, so that the mask below,
// the one a call without the flag runs, leaves it out of the row max and
// turns it into p = 0 (the scale is positive).  Rows r0 and r0 + 8 of this
// thread are queries and columns c0 + 8jj + 2t, +1 keys (flash_fwd,
// flash_bwd_dq); in flash_bwd_dkv's transposed tile (kTransposed) the rows
// are keys and the columns queries.
template <bool kTransposed>
__device__ __forceinline__ void hide_above_diagonal(float (&s)[8][4], const FlashArgs& a, int r0, int c0, int t) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + jj * 8 + 2 * t + e;
      const bool v0 = kTransposed ? causal_visible(a, r0, c) : causal_visible(a, c, r0);
      const bool v1 = kTransposed ? causal_visible(a, r0 + 8, c) : causal_visible(a, c, r0 + 8);
      if (!v0) s[jj][e] = -CUDART_INF_F;
      if (!v1) s[jj][2 + e] = -CUDART_INF_F;
    }
  }
}

// Ring stage `stage` of flash_fwd and flash_bwd_dq: kv-tile j of k and v
// (at 2 * stage and 2 * stage + 1) and its 64 key ids.  All threads.
__device__ __forceinline__ void prefetch_kv(bf16* ring, int* kids, int stage, int j, const bf16* kb, const bf16* vb,
                                            const int* kseg, const FlashArgs& a) {
  load_tile_async(ring + 2 * stage * kTileElems, kb, a.sk.row, j * kFlashTile, a.m);
  load_tile_async(ring + (2 * stage + 1) * kTileElems, vb, a.sv.row, j * kFlashTile, a.m);
  if (threadIdx.x < kFlashTile) kids[stage * kFlashTile + threadIdx.x] = seg_id(kseg, j * kFlashTile + threadIdx.x, a.m);
}

__device__ __forceinline__ float2 unpack_pair(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// qk-norm of the rows held as A fragments by load_a_rows, in place: fragment
// [kk][i] is row row_lo (i even) or row_lo + 8 (i odd), columns 16kk + 8(i /
// 2) + 2t, +1, so the quad of lanes t = 0..3 holds a row.  Its sum of squares
// is taken in f32 and reduced over the quad; each element becomes (x * r) *
// (gamma * sqrt(64)) in f32, cast once (_rms_tile :135-142).  gamma: the
// head's 64 f32 gammas.  A zero row (past n or m) stays zero.
__device__ __forceinline__ void rms_norm_a_rows(uint32_t (&a)[kFlashDh / 16][4], const float* gamma, int t) {
  float ss0 = 0.f, ss1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < kFlashDh / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const float2 x0 = unpack_pair(a[kk][i]), x1 = unpack_pair(a[kk][i + 1]);
      ss0 += x0.x * x0.x + x0.y * x0.y;
      ss1 += x1.x * x1.x + x1.y * x1.y;
    }
  }
  const float r0 = rsqrtf(quad_sum(ss0) + kRmsEps), r1 = rsqrtf(quad_sum(ss1) + kRmsEps);
#pragma unroll
  for (int kk = 0; kk < kFlashDh / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = unpack_pair(a[kk][i]);
      const float2 g = *reinterpret_cast<const float2*>(gamma + kk * 16 + (i >> 1) * 8 + 2 * t);
      const float r = i & 1 ? r1 : r0;
      a[kk][i] = pack_floats(x.x * r * (g.x * kRmsRoot), x.y * r * (g.y * kRmsRoot));
    }
  }
}

// Ring stage `stage`'s keep tile: the keep bits of queries q0.. x keys
// k0.. of this block's (image, head) stream.  All threads, beside the
// stage's copies; the barrier after the ring's wait publishes it.
__device__ __forceinline__ void fill_flash_keep(uint32_t* keep, int stage, const FlashArgs& a, uint32_t stream, int q0,
                                                int k0) {
  fill_keep_tile<kFlashTile, kFlashKeepWords, kFlashThreads>(keep + stage * kFlashKeepTile, a.drop, stream, q0, k0,
                                                             a.n, a.m);
}

// qk-norm: the head's 64 gammas of the operand the ring carries into shared
// memory (threads 0..63); the loop's first barrier publishes them
__device__ __forceinline__ void stage_gammas(float* dst, const float* gamma) {
  if (threadIdx.x < kFlashDh) dst[threadIdx.x] = gamma[threadIdx.x];
}

// qk-norm of ring stage `stage`'s first tile (k, or q in flash_bwd_dkv) in
// place, once it has landed, then a barrier, so that every warp reads it
// normalised.  All threads; rows past n or m are zeros and stay zeros.
__device__ __forceinline__ void rms_norm_stage(bf16* ring, int stage, const float* gammas) {
  rms_norm_rows<kFlashTile, kFlashLd, kFlashThreads>(ring + 2 * stage * kTileElems, gammas, nullptr, nullptr);
  __syncthreads();
}

// The keep bits of this thread's accumulator elements, rows g, g + 8 of the
// warp's 16 from tile row `row`, columns 8j + 2t, +1: bit 4j + i for acc[j][i]
// (the layout of flash_fwd's element mask).  The tile is keyed (query, key)
// and so is the accumulator (flash_fwd, flash_bwd_dq).
__device__ __forceinline__ uint32_t keep_bits_rows(const uint32_t* tile, int row, int t) {
  const uint32_t* k0 = tile + row * kFlashKeepWords;
  const uint32_t* k1 = k0 + 8 * kFlashKeepWords;
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;  // even: c and c + 1 share a word
    bits |= (((k0[c >> 5] >> (c & 31)) & 3u) << (4 * j)) | (((k1[c >> 5] >> (c & 31)) & 3u) << (4 * j + 2));
  }
  return bits;
}

// The same bits for flash_bwd_dkv's transposed accumulator, whose rows are
// keys (g, g + 8 of the warp's 16 from tile key `key`) and whose columns are
// queries: the tile, keyed (query, key) as the forward draws it, read
// transposed, word (query c, key / 32), bit key % 32.
__device__ __forceinline__ uint32_t keep_bits_cols(const uint32_t* tile, int key, int t) {
  const uint32_t* kw = tile + (key >> 5);
  const int sh = key & 31;  // key % 16 < 8, so key + 8 sits in the same word
  uint32_t bits = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const uint32_t w0 = kw[c * kFlashKeepWords] >> sh, w1 = kw[(c + 1) * kFlashKeepWords] >> sh;
    bits |= ((w0 & 1u) | ((w1 & 1u) << 1) | (((w0 >> 8) & 1u) << 2) | (((w1 >> 8) & 1u) << 3)) << (4 * j);
  }
  return bits;
}

// acc = where(keep, acc, 0) * mul, with the keep bits of keep_bits_rows/cols
__device__ __forceinline__ void apply_keep_bits(float (&acc)[8][4], uint32_t bits, float mul) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = (bits >> (4 * j + i)) & 1u ? acc[j][i] * mul : 0.f;
  }
}

// the four bf16 A fragments of where(keep, acc, 0) * mul (scaled in f32,
// then cast), acc left as it is
__device__ __forceinline__ void keep_to_a_frags(uint32_t (&f)[4][4], const float (&acc)[8][4], uint32_t bits,
                                                float mul) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    float lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lo[i] = (bits >> (8 * kc + i)) & 1u ? acc[2 * kc][i] * mul : 0.f;
      hi[i] = (bits >> (8 * kc + 4 + i)) & 1u ? acc[2 * kc + 1][i] * mul : 0.f;
    }
    acc_to_a_frag(f[kc], lo, hi);
  }
}

// ---------------------------------------------------------------------------
// flash_fwd: one block of one warpgroup per (64-query tile, image, head), in
// grid_pos's head-ordered 1-D grid (heaviest query tiles first when causal);
// loops over the admitted kv-tiles with the online softmax of _fwd_kernel in
// registers: per tile m_new = max(m, rowmax(s)), p = exp(s - m_new) (0 where
// masked), l = exp(m - m_new) * l + rowsum(p), acc = acc * exp(m - m_new) +
// bf16(p).v; with dropout p is masked after l takes its sum, and o = acc *
// (inv / l).  Both products are wgmma (attn_wgmma.cuh): s = q.k^T with q in
// registers (read once) and the ring's k tile, acc += bf16(p).v with p in
// registers and the v tile MN-major, p.v of one tile beside the softmax of
// the next.  The ring holds three stages, each a k and a v tile, their 64
// key ids, with dropout their keep tile and with a bias its 64 x 64 tile.
// With qk-norm q is normalised in registers once (rms_norm_a_rows), and
// each k stage in place once it has landed (rms_norm_tile_sw, the order of
// rms_norm_rows through the swizzle).
// ---------------------------------------------------------------------------

// warpgroups a block (64 queries each, sharing the ring), by instantiation
__host__ __device__ constexpr int fwd_wgs(bool drop, bool qknorm, bool bias) { return drop || bias ? 1 : 2; }

// ring stages, by instantiation: the tiles of iteration i + stages - 1 are
// copied while iteration i computes (a bias stage is large: with two,
// three blocks fit an SM)
__host__ __device__ constexpr int fwd_ring(bool drop, bool qknorm, bool bias) { return bias ? 2 : 3; }

// the ring's K and V tiles (stage s's K at 2s, V at 2s + 1), then per stage
// the bias tile of 64 * wgs query rows, the K and V mbarriers, the 64 key
// ids, the keep tile
constexpr int fwd_smem(bool drop, bool qknorm, bool bias) {
  return kWgAlign +
         fwd_ring(drop, qknorm, bias) *
             (2 * kSwTileBytes + (bias ? fwd_wgs(drop, qknorm, bias) * kBiasTileBytes : 0) + 2 * 8 + kFlashTile * 4 +
              (drop ? fwd_wgs(drop, qknorm, bias) * kFlashKeepTile * 4 : 0)) +
         (qknorm ? kGammaSmem : 0);
}

// blocks an SM an instantiation is built for: the dropout ones four (128
// registers; at NaViT's packs a block walks a few tiles, and its fixed
// costs want more blocks in flight), the others as wg_blocks
__host__ __device__ constexpr int fwd_blocks(bool drop, bool qknorm, bool bias) {
  return drop ? 4 : wg_blocks(fwd_wgs(drop, qknorm, bias));
}

template <bool kDropout, bool kQkNorm, bool kBias>
__global__ void __launch_bounds__(kFlashThreads * fwd_wgs(kDropout, kQkNorm, kBias),
                                  fwd_blocks(kDropout, kQkNorm, kBias))
    flash_fwd_kernel(FlashArgs a, const __grid_constant__ TmaMaps maps) {
  constexpr int kWgs = fwd_wgs(kDropout, kQkNorm, kBias), kThreads = kFlashThreads * kWgs;
  constexpr int kRows = kFlashTile * kWgs, kBiasStage = kWgs * kBiasTileBytes, kKeepStage = kWgs * kFlashKeepTile;
  constexpr int kStages = fwd_ring(kDropout, kQkNorm, kBias), kAhead = kStages - 1;
  extern __shared__ unsigned char flash_fwd_raw[];
  unsigned char* smem = aligned_smem(flash_fwd_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem);                  // stage s: K at 2s, V at 2s + 1
  unsigned char* bias_ring = smem + 2 * kStages * kSwTileBytes;  // stage s: its bias tile (bias)
  // stage s's mbarriers: its K (and bias) copies at kfull[s], its V at vfull[s]
  uint64_t* kfull = reinterpret_cast<uint64_t*>(bias_ring + (kBias ? kStages * kBiasStage : 0));
  uint64_t* vfull = kfull + kStages;
  int* kids = reinterpret_cast<int*>(vfull + kStages);  // stage s: 64 key ids
  uint32_t* keep = reinterpret_cast<uint32_t*>(kids + kStages * kFlashTile);  // stage s: its keep tile (dropout)
  float* gring = reinterpret_cast<float*>(keep + (kDropout ? kStages * kKeepStage : 0));  // qk-norm: k's gammas

  const int nkt = (a.m + kFlashTile - 1) / kFlashTile;
  const GridPos pos = grid_pos(a.batch, (a.n + kRows - 1) / kRows, a.causal);
  const int b = pos.b, h = pos.h, q0 = pos.qt * kRows, bh = b * a.heads + h;
  const int wg = threadIdx.x / kFlashThreads, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qt = (q0 + wg * kFlashTile) / kFlashTile;  // this warpgroup's 64-query tile
  const bool segs = a.qseg != nullptr;
  const int* qseg = segs ? a.qseg + b * a.n : nullptr;
  const int* kseg = segs ? a.kseg + b * a.m : nullptr;
  // the block's last 64-query tile bounds the causal loop
  const int nk = a.causal ? causal_key_tiles((q0 + kRows - 1) / kFlashTile, nkt) : nkt;
  // this (image, head)'s bias rows from the query tile's first, 0 strides on
  // the broadcast dims
  const BiasTable bt{kBias ? static_cast<const char*>(a.bias) +
                                 (b * a.sbias.b + h * a.sbias.h + q0 * a.sbias.row) * (a.bias_bf16 ? 2 : 4)
                           : nullptr,
                     a.sbias.row, a.bias_bf16, a.sbias.h ? h : 0, a.sbias.b ? b : 0};

  const uint32_t stream = dropout_stream(b, h);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(kfull + i);
    mbar_fence_init();
  }
  __syncthreads();
  uint32_t kphase = 0u, vphase = 0u;  // bit s: the parity stage s's barrier is waited for next

  // ring stage `stage` for kv-tile jt: k and the bias tile (the TMA, one
  // thread), the key ids, the keep tile (prefetch), and v (prefetch_v, one
  // iteration later: the pipelined loop of attn_wgmma.cuh)
  auto prefetch = [&](int stage, int jt) {
    [[maybe_unused]] const bool bias_tma = kBias && maps.bias_tma;
    if (threadIdx.x == 0) {
      uint32_t bytes = kSwTileBytes;
      if constexpr (kBias) bytes += bias_tma ? bias_tile_bytes<kRows>(a.bias_bf16) : 0u;
      mbar_expect(kfull + stage, bytes);
      tma_load(ring + 2 * stage * kSwTile, maps.k, 0, jt * kFlashTile, h, b, kfull + stage);
      if constexpr (kBias)
        if (bias_tma)
          tma_bias_tile<kRows>(bias_ring + stage * kBiasStage, maps, bt, q0, jt * kFlashTile, kfull + stage);
    }
    if (threadIdx.x < kFlashTile)
      kids[stage * kFlashTile + threadIdx.x] = seg_id(kseg, jt * kFlashTile + threadIdx.x, a.m);
    if constexpr (kDropout)
      fill_keep_tile<kRows, kFlashKeepWords, kThreads>(keep + stage * kKeepStage, a.drop, stream, q0, jt * kFlashTile,
                                                       a.n, a.m);
    if constexpr (kBias)
      if (!bias_tma)
        load_bias_elems<kRows, kThreads>(bias_ring + stage * kBiasStage, bt, jt * kFlashTile, a.n - q0, a.m);
  };
  auto prefetch_v = [&](int stage, int jt) {
    if (threadIdx.x == 0) {
      mbar_expect(vfull + stage, kSwTileBytes);
      tma_load(ring + (2 * stage + 1) * kSwTile, maps.v, 0, jt * kFlashTile, h, b, vfull + stage);
    }
  };
  auto wait_v = [&](int stage) {
    mbar_wait(vfull + stage, (vphase >> stage) & 1u);
    vphase ^= 1u << stage;
  };

  int qlo = 0, qhi = 0;
  if (segs) {
    seg_range(qseg, q0, a.n, qlo, qhi);
    for (int r = kFlashTile; r < kRows; r += kFlashTile) {  // the id range of all the block's queries
      int lo, hi;
      seg_range(qseg, q0 + r, a.n, lo, hi);
      qlo = min(qlo, lo);
      qhi = max(qhi, hi);
    }
  }
  // jq[i]: the admitted tile of iteration it + i (nk or more: none);
  // iteration it fills k of jq[kAhead] and v of jq[kAhead - 1]
  int jq[kAhead + 1];
  jq[0] = next_admitted(kseg, a.m, nk, 0, qlo, qhi);
#pragma unroll
  for (int i = 1; i <= kAhead; ++i) jq[i] = next_admitted(kseg, a.m, nk, jq[i - 1] + 1, qlo, qhi);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (jq[i] < nk) prefetch(i, jq[i]);
    if (i > 0 && jq[i - 1] < nk) prefetch_v(i - 1, jq[i - 1]);
  }

  const int lr = wg * kFlashTile + warp * 16 + g, row_lo = q0 + lr;  // rows lr, lr + 8 of the block's tile
  if constexpr (kQkNorm) stage_gammas(gring, a.gk + h * kFlashDh);
  uint32_t qf[kFlashDh / 16][4];
  load_a_rows(qf, head_ptr(a.q, a.sq, b, h), a.sq.row, row_lo, a.n, t);
  if constexpr (kQkNorm) rms_norm_a_rows(qf, a.gq + h * kFlashDh, t);
  const int qs0 = seg_id(qseg, row_lo, a.n), qs1 = seg_id(qseg, row_lo + 8, a.n);

  float o[8][4];
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) o[dj][0] = o[dj][1] = o[dj][2] = o[dj][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  uint32_t pf[4][4];  // bf16(p) of the previous tile, the A operand of its p.v

  // the top of iteration it: every reader of the stages refilled here is
  // done; then tile jq[0]'s k (ids, keep, bias) have landed (with qk-norm k
  // is normalised in place, behind one more barrier)
  auto top = [&](int it) {
    fence_proxy_async();  // generic reads and writes of the stages before the copies' async writes
    __syncthreads();
    if (jq[kAhead] < nk) prefetch((it + kAhead) % kStages, jq[kAhead]);
    if (jq[kAhead - 1] < nk) prefetch_v((it + kAhead - 1) % kStages, jq[kAhead - 1]);
    const int stage = it % kStages;
    mbar_wait(kfull + stage, (kphase >> stage) & 1u);
    kphase ^= 1u << stage;
    if constexpr (kQkNorm) {
      rms_norm_tile_sw<kThreads>(ring + 2 * stage * kSwTile, gring);
      fence_proxy_async();
      __syncthreads();
    }
  };

  // tile jq[0]'s logits (in s) to p: scale, bias, element mask, the online
  // max and l; returns the factor acc must be rescaled by, row g (x) and
  // g + 8 (y).  A tile with no ids and every key below m (kFull, a
  // std::bool_constant) tests no element: rows past n are not stored.
  auto softmax_tile = [&](float (&s)[8][4], int stage, auto full) {
    constexpr bool kFull = decltype(full)::value;
    const int j = jq[0];
    const int* ids = kids + stage * kFlashTile;
    [[maybe_unused]] const unsigned char* bstage = bias_ring + stage * kBiasStage;
    // the causal triangle on the warpgroup's diagonal tile (and, for the
    // block's first warpgroups, the tiles past it: every key hidden); every
    // earlier key is visible to the whole tile (a branch uniform across
    // the warpgroup)
    if (a.causal && j >= qt) hide_above_diagonal<false>(s, a, row_lo, j * kFlashTile, t);

    // scale, bias, element mask: a masked logit becomes -inf, so that its p
    // = 2^(-inf) is exactly 0 and the max and l never see it (a row with no
    // key keeps m = -1e30 and l = 0)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      [[maybe_unused]] float2 bias0, bias1;
      if constexpr (kBias) {
        bias0 = bias_pair<kRows>(bstage, a.bias_bf16, lr, jj * 8 + 2 * t);
        bias1 = bias_pair<kRows>(bstage, a.bias_bf16, lr + 8, jj * 8 + 2 * t);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool v0 = true, v1 = true;
        if constexpr (!kFull) {
          const int id = ids[jj * 8 + 2 * t + e];
          v0 = qs0 >= 0 && id == qs0;
          v1 = qs1 >= 0 && id == qs1;
        }
        if constexpr (kBias) {
          s[jj][e] = v0 ? scaled_biased(s[jj][e], a.scale, e ? bias0.y : bias0.x) : -CUDART_INF_F;
          s[jj][2 + e] = v1 ? scaled_biased(s[jj][2 + e], a.scale, e ? bias1.y : bias1.x) : -CUDART_INF_F;
        } else {
          s[jj][e] = v0 ? __fmul_rn(s[jj][e], a.scale) : -CUDART_INF_F;
          s[jj][2 + e] = v1 ? __fmul_rn(s[jj][2 + e], a.scale) : -CUDART_INF_F;
        }
        mx0 = fmaxf(mx0, s[jj][e]);
        mx1 = fmaxf(mx1, s[jj][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[jj][e] = exp2_ftz((s[jj][e] - mn0) * kLog2e);
        s[jj][2 + e] = exp2_ftz((s[jj][2 + e] - mn1) * kLog2e);
        sum0 += s[jj][e];
        sum1 += s[jj][2 + e];
      }
    }
    const float al0 = exp2f((m0 - mn0) * kLog2e), al1 = exp2f((m1 - mn1) * kLog2e);
    l0 = al0 * l0 + quad_sum(sum0);
    l1 = al1 * l1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
    return make_float2(al0, al1);
  };

  // acc (holding every earlier tile's p.v) rescaled, then bf16(p) of tile j
  // for its p.v; dropout: l has summed the undropped p, only p.v sees the mask
  auto finish_tile = [&](float (&s)[8][4], float2 al, int stage) {
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) {
      o[dj][0] *= al.x;
      o[dj][1] *= al.x;
      o[dj][2] *= al.y;
      o[dj][3] *= al.y;
    }
    if constexpr (kDropout) apply_keep_bits(s, keep_bits_rows(keep + stage * kKeepStage, lr, t), 1.f);
    to_a_frags(pf, s);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) jq[i] = jq[i + 1];
    jq[kAhead] = next_admitted(kseg, a.m, nk, jq[kAhead - 1] + 1, qlo, qhi);
  };
  auto softmax = [&](float (&s)[8][4], int stage) {
    return !segs && (jq[0] + 1) * kFlashTile <= a.m ? softmax_tile(s, stage, std::true_type{})
                                                     : softmax_tile(s, stage, std::false_type{});
  };

  // the loop, peeled so that every wgmma issue and wait is unconditional:
  // the first admitted tile (no p.v yet), the rest (q.k^T of this tile beside
  // p.v of the previous one), the last p.v
  int it = 0;
  if (jq[0] < nk) {
    top(0);
    float s[8][4];
    wgmma_fence();
    qk_issue(s, qf, ring);
    wgmma_wait<0>();
    fence_acc(s);
    const float2 al = softmax(s, 0);
    finish_tile(s, al, 0);
    it = 1;
  }
  for (; jq[0] < nk; ++it) {
    const int stage = it % kStages;
    top(it);
    float s[8][4];
    wait_v((it - 1) % kStages);
    wgmma_fence();
    qk_issue(s, qf, ring + 2 * stage * kSwTile);
    pv_issue(o, pf, ring + (2 * ((it - 1) % kStages) + 1) * kSwTile);
    wgmma_wait<1>();
    fence_acc(s);
    const float2 al = softmax(s, stage);
    wgmma_wait<0>();
    fence_acc(o);
    fence_frags(pf);
    finish_tile(s, al, stage);
  }
  if (it > 0) {  // the last tile's p.v
    wait_v((it - 1) % kStages);
    wgmma_fence();
    pv_issue(o, pf, ring + (2 * ((it - 1) % kStages) + 1) * kSwTile);
    wgmma_wait<0>();
    fence_acc(o);
  }

  // _finish (:283-290): a row that met no key has l = 0: o = 0, lse = -1e30;
  // dropout's 1/(1 - rate) joins 1/l as one f32 factor
  const float num = kDropout ? a.drop.inv : 1.f;
  const float inv0 = num / (l0 == 0.f ? 1.f : l0), inv1 = num / (l1 == 0.f ? 1.f : l1);
  store_rows(head_ptr(a.out0, a.s0, b, h), a.s0.row, o, inv0, inv1, row_lo, a.n, t);
  if (t == 0) {
    float* lse = a.lse + static_cast<long long>(bh) * a.n;
    if (row_lo < a.n) lse[row_lo] = l0 == 0.f ? kNegInf : m0 + logf(l0);
    if (row_lo + 8 < a.n) lse[row_lo + 8] = l1 == 0.f ? kNegInf : m1 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_dq: one block per (64-query tile, b*h); loops over the admitted
// kv-tiles: p = exp(s - lse) (0 where masked), dp = dO.v^T, ds = p * (dp -
// delta), dq += bf16(ds).k; dq = scale * dq, cast once.  With dropout dp =
// where(keep, dp, 0) * inv in f32 before ds.  With qk-norm q and k are
// normalised (s and dq read q^ and k^), and dq is the gradient of q^.
// ---------------------------------------------------------------------------

// Three blocks an SM at rate 0 (at most 170 registers a thread), as the
// kernel ran before the causal flag: left to itself ptxas gives the flagged
// kernel 238 registers, two blocks an SM and +27% at NaViT-B's packs.  The
// [dropout] instantiations keep their two blocks.
template <bool kDropout, bool kQkNorm>
__global__ void __launch_bounds__(kFlashThreads, kDropout ? 2 : 3) flash_bwd_dq_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char flash_smem[];
  bf16* ring = reinterpret_cast<bf16*>(flash_smem);
  int* kids = reinterpret_cast<int*>(ring + 4 * kTileElems);
  uint32_t* keep = reinterpret_cast<uint32_t*>(kids + 2 * kFlashTile);
  float* gring = reinterpret_cast<float*>(keep + (kDropout ? 2 * kFlashKeepTile : 0));  // qk-norm: k's gammas

  const int q0 = blockIdx.x * kFlashTile, bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool segs = a.qseg != nullptr;
  const int* qseg = segs ? a.qseg + b * a.n : nullptr;
  const int* kseg = segs ? a.kseg + b * a.m : nullptr;
  const bf16* kb = head_ptr(a.k, a.sk, b, h);
  const bf16* vb = head_ptr(a.v, a.sv, b, h);
  const int nk = a.causal ? causal_key_tiles(blockIdx.x, (a.m + kFlashTile - 1) / kFlashTile)
                          : (a.m + kFlashTile - 1) / kFlashTile;

  const uint32_t stream = dropout_stream(b, h);

  int qlo = 0, qhi = 0;
  if (segs) seg_range(qseg, q0, a.n, qlo, qhi);
  int j = next_admitted(kseg, a.m, nk, 0, qlo, qhi);
  if (j < nk) {
    prefetch_kv(ring, kids, 0, j, kb, vb, kseg, a);
    if constexpr (kDropout) fill_flash_keep(keep, 0, a, stream, q0, j * kFlashTile);
  }
  cp_async_commit();
  if constexpr (kQkNorm) stage_gammas(gring, a.gk + h * kFlashDh);

  const int row_lo = q0 + warp * 16 + g;
  uint32_t qf[kFlashDh / 16][4], df[kFlashDh / 16][4];
  load_a_rows(qf, head_ptr(a.q, a.sq, b, h), a.sq.row, row_lo, a.n, t);
  if constexpr (kQkNorm) rms_norm_a_rows(qf, a.gq + h * kFlashDh, t);
  load_a_rows(df, head_ptr(a.dout, a.sdo, b, h), a.sdo.row, row_lo, a.n, t);
  const int qs0 = seg_id(qseg, row_lo, a.n), qs1 = seg_id(qseg, row_lo + 8, a.n);
  const float* lse = a.lse + static_cast<long long>(bh) * a.n;
  const float* delta = a.delta + static_cast<long long>(bh) * a.n;
  const float lse0 = row_lo < a.n ? lse[row_lo] : 0.f, lse1 = row_lo + 8 < a.n ? lse[row_lo + 8] : 0.f;
  const float dl0 = row_lo < a.n ? delta[row_lo] : 0.f, dl1 = row_lo + 8 < a.n ? delta[row_lo + 8] : 0.f;

  float dq[8][4];
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) dq[dj][0] = dq[dj][1] = dq[dj][2] = dq[dj][3] = 0.f;

  for (int stage = 0; j < nk; stage ^= 1) {
    const int jn = next_admitted(kseg, a.m, nk, j + 1, qlo, qhi);
    if (jn < nk) {
      prefetch_kv(ring, kids, stage ^ 1, jn, kb, vb, kseg, a);
      if constexpr (kDropout) fill_flash_keep(keep, stage ^ 1, a, stream, q0, jn * kFlashTile);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQkNorm) rms_norm_stage(ring, stage, gring);

    const bf16* ks = ring + 2 * stage * kTileElems;
    const bf16* vs = ks + kTileElems;
    const int* ids = kids + stage * kFlashTile;
    float p[8][4], dp[8][4];
    mma_rows_t(p, qf, ks, g, t);
    mma_rows_t(dp, df, vs, g, t);
    // dropout: d softmax rides the mask (:352-361)
    if constexpr (kDropout)
      apply_keep_bits(dp, keep_bits_rows(keep + stage * kFlashKeepTile, warp * 16 + g, t), a.drop.inv);
    if (a.causal && j == static_cast<int>(blockIdx.x)) hide_above_diagonal<false>(p, a, row_lo, j * kFlashTile, t);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int id = ids[jj * 8 + 2 * t + e];
        // p = exp(s - lse), 0 where masked (see the top: never exp of the
        // masked logit, which is 1 in a fully masked row)
        p[jj][e] = qs0 >= 0 && id == qs0 ? exp2f((p[jj][e] * a.scale - lse0) * kLog2e) : 0.f;
        p[jj][2 + e] = qs1 >= 0 && id == qs1 ? exp2f((p[jj][2 + e] * a.scale - lse1) * kLog2e) : 0.f;
        dp[jj][e] = p[jj][e] * (dp[jj][e] - dl0);
        dp[jj][2 + e] = p[jj][2 + e] * (dp[jj][2 + e] - dl1);
      }
    }
    uint32_t dsf[4][4];
    to_a_frags(dsf, dp);
    mma_acc(dq, dsf, ks, g, t);
    __syncthreads();
    j = jn;
  }
  cp_async_wait<0>();
  store_rows(head_ptr(a.out0, a.s0, b, h), a.s0.row, dq, a.scale, a.scale, row_lo, a.n, t);
}

// ---------------------------------------------------------------------------
// flash_bwd_dkv: one block per (64-key tile, b*h); each warp owns 16 keys
// and loops over the admitted q-tiles with the transposed products:
// p^T = exp(k.q^T * scale - lse) (0 where masked), dv += bf16(p^T).dO,
// dp^T = v.dO^T, ds^T = p^T * (dp^T - delta), dk += bf16(ds^T).q; dk =
// scale * dk, cast once.  With dropout dv takes bf16(where(keep, p^T, 0) *
// inv) and dp^T is masked as in flash_bwd_dq; ds^T takes the undropped p^T.
// With qk-norm k (resident) and each q stage are normalised: p^T and dk read
// k^ and q^ (JAX :451-456), and dk is the gradient of k^.
// ---------------------------------------------------------------------------

template <bool kDropout, bool kQkNorm>
__global__ void __launch_bounds__(kFlashThreads) flash_bwd_dkv_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char flash_smem[];
  bf16* ring = reinterpret_cast<bf16*>(flash_smem);  // stage s: q at 2s, dO at 2s + 1
  int* qids = reinterpret_cast<int*>(ring + 4 * kTileElems);             // stage s: 64 query ids
  float* lses = reinterpret_cast<float*>(qids + 2 * kFlashTile);         // stage s: 64 lse
  float* deltas = lses + 2 * kFlashTile;                                 // stage s: 64 delta
  uint32_t* keep = reinterpret_cast<uint32_t*>(deltas + 2 * kFlashTile);  // stage s: its keep tile (dropout)
  float* gring = reinterpret_cast<float*>(keep + (kDropout ? 2 * kFlashKeepTile : 0));  // qk-norm: q's gammas

  const int k0 = blockIdx.x * kFlashTile, bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool segs = a.qseg != nullptr;
  const int* qseg = segs ? a.qseg + b * a.n : nullptr;
  const int* kseg = segs ? a.kseg + b * a.m : nullptr;
  const bf16* qb = head_ptr(a.q, a.sq, b, h);
  const bf16* db = head_ptr(a.dout, a.sdo, b, h);
  const float* lse = a.lse + static_cast<long long>(bh) * a.n;
  const float* delta = a.delta + static_cast<long long>(bh) * a.n;
  const int nq = (a.n + kFlashTile - 1) / kFlashTile;

  const uint32_t stream = dropout_stream(b, h);

  int klo = 0, khi = 0;
  if (segs) seg_range(kseg, k0, a.m, klo, khi);
  auto prefetch = [&](int stage, int i) {
    load_tile_async(ring + 2 * stage * kTileElems, qb, a.sq.row, i * kFlashTile, a.n);
    load_tile_async(ring + (2 * stage + 1) * kTileElems, db, a.sdo.row, i * kFlashTile, a.n);
    if (threadIdx.x < kFlashTile) {
      const int r = i * kFlashTile + threadIdx.x;
      qids[stage * kFlashTile + threadIdx.x] = seg_id(qseg, r, a.n);
      lses[stage * kFlashTile + threadIdx.x] = r < a.n ? lse[r] : 0.f;
      deltas[stage * kFlashTile + threadIdx.x] = r < a.n ? delta[r] : 0.f;
    }
    // keyed (query, key), as the forward draws it
    if constexpr (kDropout) fill_flash_keep(keep, stage, a, stream, i * kFlashTile, k0);
  };

  int i = next_admitted(qseg, a.n, nq, a.causal ? causal_first_query_tile(blockIdx.x) : 0, klo, khi);
  if (i < nq) prefetch(0, i);
  cp_async_commit();
  if constexpr (kQkNorm) stage_gammas(gring, a.gq + h * kFlashDh);

  const int key_lo = k0 + warp * 16 + g;
  uint32_t kf[kFlashDh / 16][4], vf[kFlashDh / 16][4];
  load_a_rows(kf, head_ptr(a.k, a.sk, b, h), a.sk.row, key_lo, a.m, t);
  if constexpr (kQkNorm) rms_norm_a_rows(kf, a.gk + h * kFlashDh, t);
  load_a_rows(vf, head_ptr(a.v, a.sv, b, h), a.sv.row, key_lo, a.m, t);
  const int ks0 = seg_id(kseg, key_lo, a.m), ks1 = seg_id(kseg, key_lo + 8, a.m);

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) {
    dk[dj][0] = dk[dj][1] = dk[dj][2] = dk[dj][3] = 0.f;
    dv[dj][0] = dv[dj][1] = dv[dj][2] = dv[dj][3] = 0.f;
  }

  for (int stage = 0; i < nq; stage ^= 1) {
    const int in = next_admitted(qseg, a.n, nq, i + 1, klo, khi);
    if (in < nq) prefetch(stage ^ 1, in);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQkNorm) rms_norm_stage(ring, stage, gring);

    const bf16* qs = ring + 2 * stage * kTileElems;
    const bf16* dos = qs + kTileElems;
    const int* ids = qids + stage * kFlashTile;
    const float* ls = lses + stage * kFlashTile;
    const float* dls = deltas + stage * kFlashTile;
    // p^T: rows = this warp's keys (g, g + 8), columns = the tile's queries
    float p[8][4];
    mma_rows_t(p, kf, qs, g, t);
    if (a.causal && i == static_cast<int>(blockIdx.x)) hide_above_diagonal<true>(p, a, key_lo, i * kFlashTile, t);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = jj * 8 + 2 * t + e;
        const int id = ids[c];
        const float l = ls[c];
        p[jj][e] = ks0 >= 0 && id == ks0 ? exp2f((p[jj][e] * a.scale - l) * kLog2e) : 0.f;
        p[jj][2 + e] = ks1 >= 0 && id == ks1 ? exp2f((p[jj][2 + e] * a.scale - l) * kLog2e) : 0.f;
      }
    }
    uint32_t f[4][4];
    uint32_t kbits = 0u;
    if constexpr (kDropout) {
      kbits = keep_bits_cols(keep + stage * kFlashKeepTile, warp * 16 + g, t);
      keep_to_a_frags(f, p, kbits, a.drop.inv);  // pd^T, scaled before its cast
    } else {
      to_a_frags(f, p);
    }
    mma_acc(dv, f, dos, g, t);  // dv += bf16(p^T) . dO
    float dp[8][4];
    mma_rows_t(dp, vf, dos, g, t);  // dp^T = v . dO^T
    if constexpr (kDropout) apply_keep_bits(dp, kbits, a.drop.inv);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dl = dls[jj * 8 + 2 * t + e];
        dp[jj][e] = p[jj][e] * (dp[jj][e] - dl);
        dp[jj][2 + e] = p[jj][2 + e] * (dp[jj][2 + e] - dl);
      }
    }
    to_a_frags(f, dp);
    mma_acc(dk, f, qs, g, t);  // dk += bf16(ds^T) . q (q^ with qk-norm)
    __syncthreads();
    i = in;
  }
  cp_async_wait<0>();
  store_rows(head_ptr(a.out0, a.s0, b, h), a.s0.row, dk, a.scale, a.scale, key_lo, a.m, t);
  store_rows(head_ptr(a.out1, a.s1, b, h), a.s1.row, dv, 1.f, 1.f, key_lo, a.m, t);
}

// strides[3 * i .. 3 * i + 2]: the (b, h, row) strides of q, k, v, dO, out0,
// out1 and the bias in turn (those of an operand a kernel does not take are
// not read)
FlashArgs make_args(const void* q, const void* k, const void* v, const void* dout, void* out0, void* out1, void* lse,
                    const void* delta, const void* qseg, const void* kseg, const void* gq, const void* gk,
                    const void* bias, int bias_bf16, int heads, int n, int m, float scale, int causal,
                    DropoutArgs drop, const long long* strides) {
  FlashArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.out0 = static_cast<bf16*>(out0);
  a.out1 = static_cast<bf16*>(out1);
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.gq = static_cast<const float*>(gq);
  a.gk = static_cast<const float*>(gk);
  a.bias = bias;
  a.bias_bf16 = bias_bf16;
  Strides* s[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.s0, &a.s1, &a.sbias};
  for (int i = 0; i < 7; ++i) *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.heads = heads;
  a.n = n;
  a.m = m;
  a.causal = causal;
  a.scale = scale;
  a.drop = drop;
  return a;
}

// heads >= 1024 would share Philox streams (dropout_stream is img * 1024 + head)
bool bad_shape(int batch, int heads, int n, int m, int dim_head, const void* qseg, const void* kseg, const void* gq,
               const void* gk, int drop) {
  return dim_head != kFlashDh || batch <= 0 || heads <= 0 || n <= 0 || m <= 0 ||
         static_cast<long long>(batch) * heads > 65535 || (qseg == nullptr) != (kseg == nullptr) ||
         (gq == nullptr) != (gk == nullptr) || (drop && heads >= 1024);
}

typedef void (*FlashKernel)(FlashArgs);

// a kernel's instantiation for the options: kernels[drop + 2 * qknorm] (rate
// 0, [dropout], [qknorm], [dropout,qknorm]); causal is a runtime flag of each
FlashKernel pick(const FlashKernel (&kernels)[4], int drop, const FlashArgs& a) {
  return kernels[(drop ? 1 : 0) + (a.gq != nullptr ? 2 : 0)];
}

// one launch on a (tiles, b*h) grid, with a keep tile a ring stage for
// dropout and a gamma row for qk-norm beside the kernel's own shared memory
int launch(FlashKernel kernel, const FlashArgs& a, int drop, int tiles, int batch, int smem, void* stream) {
  const dim3 grid(tiles, batch * a.heads);
  smem += (drop ? kKeepSmem : 0) + (a.gq != nullptr ? kGammaSmem : 0);
  kernel<<<grid, kFlashThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

typedef void (*FwdKernel)(FlashArgs, TmaMaps);

// flash_fwd's instantiations, kFwdKernels[drop + 2 * qknorm]
const FwdKernel kFwdKernels[4] = {flash_fwd_kernel<false, false, false>, flash_fwd_kernel<true, false, false>,
                                  flash_fwd_kernel<false, true, false>, flash_fwd_kernel<true, true, false>};
// the bias variant: rate 0, no qk-norm (the dispatcher never sends a bias
// with dropout or gammas, JAX :882-883)
const FwdKernel kFwdBiasKernel = flash_fwd_kernel<false, false, true>;
const FlashKernel kDqKernels[4] = {flash_bwd_dq_kernel<false, false>, flash_bwd_dq_kernel<true, false>,
                                   flash_bwd_dq_kernel<false, true>, flash_bwd_dq_kernel<true, true>};
const FlashKernel kDkvKernels[4] = {flash_bwd_dkv_kernel<false, false>, flash_bwd_dkv_kernel<true, false>,
                                    flash_bwd_dkv_kernel<false, true>, flash_bwd_dkv_kernel<true, true>};

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes).  Operands are device pointers: q, k, v, dO and the
// outputs bf16 (b, h, rows, 64) with the (b, h, row) strides given (in
// elements, a contiguous head dim, 16-byte aligned rows); lse and delta f32
// (b*h, n) contiguous; segment ids int32 (b, n) and (b, m) contiguous, both
// null for no ids; qk-norm gammas f32 (heads, 64) contiguous, both null for
// none; flash_fwd's bias (1|b, 1|h, n, m) f32 or bf16 (bias_bf16) with a
// contiguous last dim, null for none, never with dropout or gammas; causal
// (0/1); dropout: drop (0/1), the int32 seed's bits, the keep threshold and
// 1/(1 - rate), heads < 1024 with drop; strides: 21 (b, h, row) strides of
// q, k, v, dO, out0, out1 and the bias (0 on its broadcast dims; see
// make_args).  The wrappers in ops/flash_attention.py check all of it.
// ---------------------------------------------------------------------------

extern "C" {

int vit_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, const void* qseg, const void* kseg,
                  const void* gq, const void* gk, const void* bias, int bias_bf16, int batch, int heads, int n, int m,
                  int dim_head, float scale, int causal, int drop, unsigned seed, unsigned threshold, float inv,
                  const long long* strides, void* stream) {
  if (bad_shape(batch, heads, n, m, dim_head, qseg, kseg, gq, gk, drop) || (bias && (drop || gq)))
    return cudaErrorInvalidValue;
  const FlashArgs a = make_args(q, k, v, nullptr, o, nullptr, lse, nullptr, qseg, kseg, gq, gk, bias, bias_bf16, heads,
                                n, m, scale, causal, DropoutArgs{seed, threshold, inv}, strides);
  FlashArgs fa = a;
  fa.batch = batch;
  const int wgs = fwd_wgs(drop, gq != nullptr, bias != nullptr), rows = kFlashTile * wgs;
  TmaMaps maps{};
  if (!encode_operand_map(maps.k, k, a.sk, m, heads, batch) || !encode_operand_map(maps.v, v, a.sv, m, heads, batch))
    return cudaErrorInvalidValue;
  if (bias) {  // (1|b, 1|h, n, m): a dim of stride 0 is broadcast, of size 1 in the map
    const Strides& sb = a.sbias;
    maps.bias_tma = bias_tma_ok(bias, bias_bf16, sb.b, sb.h, sb.row) &&
                    encode_bias_map(maps.bias, bias, bias_bf16, n, m, sb.h ? heads : 1, sb.b ? batch : 1, sb.row, sb.h,
                                    sb.b, rows);
  }
  const FwdKernel kernel = bias ? kFwdBiasKernel : kFwdKernels[(drop ? 1 : 0) + (gq != nullptr ? 2 : 0)];
  const long long blocks = static_cast<long long>((n + rows - 1) / rows) * batch * heads;
  return launch_attention(kernel, fa, maps, blocks, kFlashThreads * wgs, fwd_smem(drop, gq != nullptr, bias != nullptr),
                          stream);
}

int vit_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
                     const void* qseg, const void* kseg, const void* gq, const void* gk, void* dq, int batch,
                     int heads, int n, int m, int dim_head, float scale, int causal, int drop, unsigned seed,
                     unsigned threshold, float inv, const long long* strides, void* stream) {
  if (bad_shape(batch, heads, n, m, dim_head, qseg, kseg, gq, gk, drop)) return cudaErrorInvalidValue;
  const FlashArgs a = make_args(q, k, v, dout, dq, nullptr, const_cast<void*>(lse), delta, qseg, kseg, gq, gk, nullptr,
                                0, heads, n, m, scale, causal, DropoutArgs{seed, threshold, inv}, strides);
  return launch(pick(kDqKernels, drop, a), a, drop, (n + kFlashTile - 1) / kFlashTile, batch, kDqSmem, stream);
}

int vit_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, const void* qseg, const void* kseg, const void* gq, const void* gk, void* dk,
                      void* dv, int batch, int heads, int n, int m, int dim_head, float scale, int causal, int drop,
                      unsigned seed, unsigned threshold, float inv, const long long* strides, void* stream) {
  if (bad_shape(batch, heads, n, m, dim_head, qseg, kseg, gq, gk, drop)) return cudaErrorInvalidValue;
  const FlashArgs a = make_args(q, k, v, dout, dk, dv, const_cast<void*>(lse), delta, qseg, kseg, gq, gk, nullptr, 0,
                                heads, n, m, scale, causal, DropoutArgs{seed, threshold, inv}, strides);
  return launch(pick(kDkvKernels, drop, a), a, drop, (m + kFlashTile - 1) / kFlashTile, batch, kDkvSmem, stream);
}

}  // extern "C"
