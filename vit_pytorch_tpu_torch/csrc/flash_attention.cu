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
// order, so here the sequential axis is a loop inside the block: flash_fwd
// runs one block per (q-tile, image, head), looping over kv-tiles; the
// backward kernels run a persistent grid whose blocks each take 128-row
// work items, flash_bwd_dq's of queries looping over kv-tiles,
// flash_bwd_dkv's of keys looping over q-tiles.  Every sum a block makes
// stays in its registers, so the result does not depend on block order.
//
// Bound on this card: at NaViT-B's 2048-token packs the products are
// 4*d flops per (query, key) pair of one image against a few bytes per row
// of q, k, v, far above the ~295 flop/byte ridge inside the diagonal tiles;
// the (n, m) logits, 805 M per layer over 16 packs x 12 heads, would be
// gigabytes in device memory, so they never leave the registers.  The
// limit is tensor-core throughput and the tiles a block must visit.
//
// Design: every product is wgmma (attn_wgmma.cuh) on 64 x 64 tiles (not
// the TPU's 1024/512; dh = 64 is the one instantiation), the tiles a loop
// walks come through a TMA-fed ring of shared-memory stages, and the
// accumulator layout of one product is the A-operand layout of the next
// (acc_to_a_frag), so p, ds and their transposes go from f32 registers to
// bf16 operands without a trip through memory.  flash_fwd's design is in
// its section below; the backward kernels' (a producer warp, two consumer
// warpgroups, a persistent grid) in theirs.
//  - Tile skip (_seg_overlap, :173-188): a (q-tile, kv-tile) pair runs only
//    if the ranges of the two tiles' non-negative ids overlap (a block of
//    128 rows: the range of all its rows).  flash_fwd walks it tile by tile
//    (next_admitted); the backward kernels find a block's admitted tiles 32
//    at a time (admit_chunk).  The test is conservative: the element mask
//    still decides every (query, key) pair.  The same predicate is
//    ops/flash_attention.py::tile_admitted on the host, and
//    bwd_tile_lists gives the tiles each backward block walks.
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
//  - The bits of a (q-tile, kv-tile) pair are drawn once into a keep tile,
//    64 x 64 bits keyed (query, key) in 128 words of shared memory (8
//    Philox calls a thread of a warpgroup; a skipped tile draws none): in
//    flash_fwd's ring stage, in each backward consumer's own tile.  The
//    register-bound bodies read one 32-bit mask a thread a tile
//    (keep_bits_rows), and flash_bwd_dkv, whose accumulators are (key,
//    query), reads the same tile transposed (keep_bits_cols).
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
// three grids; here each operand is normalised once where it lives (the
// operand a block keeps for its whole loop before the loop, each tile the
// loop walks in its ring stage once it has landed; a tile the skip test
// refuses is neither loaded nor normalised), and in one f32 sum order an
// operand in all three kernels: q^ in rms_norm_a_rows' (a quad of lanes a
// row; flash_fwd's q fragments, rms_norm_tile_quads in the backward's
// shared tiles), k^ in rms_norm_tile_sw's (eight lanes a row).
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
// log2(e), exp2_ftz (attn_wgmma.cuh) for every p.  No result depends on the
// tile size except f32 summation order.

#include <type_traits>

#include "attn_wgmma.cuh"
#include "wgmma_wide.cuh"

namespace {

constexpr int kBigId = 1 << 30;
constexpr int kFlashKeepWords = kFlashTile / 32;                  // 32-key words of one keep row
constexpr int kFlashKeepTile = kFlashTile * kFlashKeepWords;      // 128 words: one tile's keep bits
constexpr int kGammaSmem = kFlashDh * 4;                          // qk-norm: the ring operand's f32 gammas

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
  int batch;        // the grid: flash_fwd's (grid_pos), the backward kernels' work items
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

// qk-norm: the head's 64 gammas of the operand the ring carries into shared
// memory (threads 0..63); the loop's first barrier publishes them
__device__ __forceinline__ void stage_gammas(float* dst, const float* gamma) {
  if (threadIdx.x < kFlashDh) dst[threadIdx.x] = gamma[threadIdx.x];
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
// each k stage in place once it has landed (rms_norm_tile_sw: eight lanes
// a row, through the swizzle).
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
// The backward kernels, flash_bwd_dq and flash_bwd_dkv: one warp-specialised
// design for both.
//
// A block holds three warpgroups: two consumers, each owning 64 rows of the
// block's 128 (queries in flash_bwd_dq, keys in flash_bwd_dkv), then a
// producer, of which two warps work.  The grid is persistent: min(work
// items, SMs) blocks, one an SM, and block x takes items x, x + grid, ...,
// an item being one 128-row block of one (image, head), row blocks fastest
// (with causal, the heaviest first within each (image, head)).
//
// The producer warpgroup has two working warps:
//  - the admission warp finds each item's admitted tiles of the other side,
//    32 at a time (admit_chunk): the id range of the item's 128 rows, then
//    each candidate tile's 64 ids read by the warp in two coalesced loads a
//    lane and reduced by redux.sync, its range held to the item's by
//    _seg_overlap's test (tiles_overlap).  A chunk's admitted tiles are a
//    32-bit mask; each chunk (at least one an item) goes into a queue of
//    kBwdQueue entries in shared memory, so the admission runs ahead of the
//    copies and no tile is tested twice or scanned after the item's last.
//    Without ids every tile runs; with causal the chunks end after the
//    item's last diagonal tile (flash_bwd_dq) or start at its first
//    (flash_bwd_dkv), as causal_key_tiles and causal_first_query_tile;
//  - the loader warp, for each item: the resident operands (the item's 128
//    rows of q and dO in flash_bwd_dq, of k and v in flash_bwd_dkv) by the
//    TMA, four 64 x 64 boxes in the 128-byte swizzle, into one of two
//    resident slots (so the next item's land while the consumers finish
//    this one), with the rows' ids (and, in flash_bwd_dq, their lse and
//    delta) by 4-byte cp.async copies that arrive on the same mbarrier;
//    then, walking the queue's masks in ascending order (__ffs), each
//    admitted tile into the ring (kBwdStages stages): its two 64 x 64
//    operand tiles by the TMA (k and v, or q and dO) and its 64 ids (and in
//    flash_bwd_dkv its 64 lse and delta) by cp.async, on the stage's full
//    mbarrier, with the tile's index in the stage; then one stage marked
//    -1, the item's end.  A stage is refilled once its empty mbarrier has
//    the arrivals of all 8 consumer warps.
// Rows past n or m are zero-filled by the copies (a masked p stays exactly
// 0, and 0 times a zero row stays 0); the element mask also tests each
// row and key against n and m, since cp.async fills ids past the sequence
// with 0, not -1.
//
// Each consumer warpgroup runs, a tile, every product on wgmma with its
// resident operand as A from shared memory and the stage's tiles as B:
//  - flash_bwd_dq: s = q.k^T and dp = dO.v^T (k, v K-major), both issued at
//    once; p = exp(s - lse) where the mask allows (0 elsewhere, never the
//    exp of a masked logit); ds = p * (dp - delta) in f32; dq += bf16(ds).k
//    with ds in registers and k MN-major (the tile flash_fwd reads v as);
//  - flash_bwd_dkv: s^T = k.q^T and dp^T = v.dO^T at once; p^T as above with
//    the stage's lse; dv += bf16(p^T).dO, issued before ds^T = p^T * (dp^T -
//    delta) is formed; dk += bf16(ds^T).q (dO and q MN-major).
// The last product of a tile (dq's, or dv's and dk's) retires while the
// next tile's s and dp run: the wait that retires it follows their issue,
// and only then is its stage released.  No wgmma issue or wait sits in a
// branch of its own.  p is 2^(s * scale * log2(e) - lse * log2(e)), one
// fused multiply-add before the 2^x (exp2_ftz: a p below 2^-126 is 0, far
// under a bf16 ulp of any sum it enters).  The two consumers walk the same
// stages; each sum stays in one warpgroup's registers in a fixed order (no
// atomics), so dq, dk and dv are the same bits from run to run.  dq = scale
// * dq, dk = scale * dk and dv are cast once and stored from registers.
//
// Dropout: each consumer draws the keep bits of its own 64 rows x the
// tile's 64 columns into a keep tile of its own (keyed (query, key) as the
// forward draws them; flash_bwd_dkv reads it transposed), while its first
// two products run, behind one barrier of its warpgroup; two such tiles a
// warpgroup alternate, so no second barrier is needed.  dp = where(keep,
// dp, 0) * inv in f32 in both kernels; flash_bwd_dkv's dv takes
// bf16(where(keep, p^T, 0) * inv), ds the undropped p.
//
// qk-norm: each operand is normalised once where it lives, in the order of
// the forward kernel (suspect 6): q^ in rms_norm_a_rows' (a quad of lanes a
// row, rms_norm_tile_quads), k^ in rms_norm_tile_sw_at's (eight lanes a
// row): the resident operand (q in flash_bwd_dq, k in
// flash_bwd_dkv) by its warpgroup once an item, each ring tile (k, or q) by
// both consumers once it has landed, behind a barrier of the 256 and a
// generic-to-async proxy fence (wgmma reads through the async proxy); one
// warp of the producer normalising each ring tile instead was slower (the
// tile a consumer step waits on takes the warp 16 rounds).  dq and dk come
// out in normalised space.
// ---------------------------------------------------------------------------

constexpr int kBwdWgs = 2;                          // consumer warpgroups, 64 rows each
constexpr int kBwdRows = kBwdWgs * kFlashTile;      // 128: a work item's resident rows
constexpr int kBwdThreads = 128 * (kBwdWgs + 1);    // the consumers, then the producer warpgroup
constexpr int kBwdStages = 6;                       // ring stages
constexpr int kBwdQueue = 8;                        // admitted chunks the admission warp may run ahead
constexpr int kBwdConsumerWarps = 4 * kBwdWgs;      // each releases a stage and a resident slot
constexpr int kBwdFullArrivals = 33;                // the loader warp's 32 lanes + lane 0's expect_tx
constexpr int kBwdConsumerRegs = 224, kBwdProducerRegs = 56;  // 2 x 128 x 224 + 128 x 56 <= 65,536

// shared memory of both kernels (bytes from the swizzle-aligned base): two
// resident slots of four tiles (slot s: own operand A of warpgroup w at 4s
// + w, B at 4s + 2 + w), the ring (stage s: X at 2s, Y at 2s + 1), the
// ring's 64 ids, lse, delta a stage, the slots' 128 ids, lse, delta, the
// admission queue (an int4 an entry), the ring's tile indices, the
// mbarriers (full, empty a stage; full, empty a slot; full, empty a queue
// entry), then with dropout two keep tiles a consumer
constexpr int kBwdRes = 0;
constexpr int kBwdRing = kBwdRes + 2 * 4 * kSwTileBytes;
constexpr int kBwdRingVec = kBwdRing + kBwdStages * 2 * kSwTileBytes;
constexpr int kBwdResVec = kBwdRingVec + kBwdStages * 3 * kFlashTile * 4;
constexpr int kBwdQueueAt = kBwdResVec + 2 * 3 * kBwdRows * 4;
constexpr int kBwdTileIdx = kBwdQueueAt + kBwdQueue * 16;
constexpr int kBwdBars = (kBwdTileIdx + kBwdStages * 4 + 7) / 8 * 8;
constexpr int kBwdKeep = kBwdBars + (2 * kBwdStages + 4 + 2 * kBwdQueue) * 8;
__host__ __device__ constexpr int bwd_smem(bool drop) {
  return kWgAlign + kBwdKeep + (drop ? kBwdWgs * 2 * kFlashKeepTile * 4 : 0);
}

// The tensor maps of a backward launch: the resident operands A and B (q
// and dO, or k and v) and the ring's X and Y (k and v, or q and dO), each a
// strided (b, h, rows, 64) bf16 view in 64 x 64 boxes
struct alignas(64) BwdMaps {
  TileMap a, b, x, y;
};

// One work item of a block: (image, head) and its 128-row block.
struct BwdItem {
  int b, h, bh, r0;
};

__device__ __forceinline__ BwdItem bwd_item(const FlashArgs& a, int item, int rblocks, bool heavy_last) {
  BwdItem it;
  it.bh = item / rblocks;
  int r = item % rblocks;
  if (heavy_last) r = rblocks - 1 - r;
  it.b = it.bh / a.heads;
  it.h = it.bh % a.heads;
  it.r0 = r * kBwdRows;
  return it;
}

// The id range of a block's 128 rows from r0 (_seg_overlap's reductions;
// rows past len read -1): one warp, every lane gets it
__device__ __forceinline__ void block_range(const int* seg, int r0, int len, int lane, int& lo, int& hi) {
  lo = kBigId;
  hi = -1;
#pragma unroll
  for (int i = 0; i < kBwdRows / 32; ++i) {
    const int v = seg_id(seg, r0 + 32 * i + lane, len);
    hi = max(hi, v);
    lo = min(lo, v >= 0 ? v : kBigId);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

// The tiles base .. base + 31 (those below end) of the other side that a
// block of id range [lo, hi] admits, as a mask (bit i: tile base + i): each
// tile's 64 ids read by the warp, two coalesced loads a lane, reduced by
// redux.sync; every tile without ids.  One warp.
__device__ __forceinline__ uint32_t admit_chunk(const int* seg, int len, int base, int end, int lo, int hi, int lane) {
  if (end <= base) return 0u;
  const uint32_t live = end - base >= 32 ? 0xffffffffu : (1u << (end - base)) - 1u;
  if (seg == nullptr) return live;
  uint32_t mask = 0u;
#pragma unroll 16
  for (int i = 0; i < 32; ++i) {
    const int r = (base + i) * kFlashTile + lane;
    const int x = seg_id(seg, r, len), y = seg_id(seg, r + 32, len);
    const int thi = __reduce_max_sync(0xffffffffu, max(x, y));
    const int tlo = __reduce_min_sync(0xffffffffu, min(x >= 0 ? x : kBigId, y >= 0 ? y : kBigId));
    if (tiles_overlap(lo, hi, tlo, thi)) mask |= 1u << i;
  }
  return mask & live;
}

// q^ of a swizzled 64-row tile in place, in rms_norm_a_rows' sum order (the
// order flash_fwd normalises q in): a quad of lanes a row, lane t adding
// the pair sums x[c]^2 + x[c+1]^2 at columns c = 8j + 2t for j = 0..7 in
// turn, the quad adding (s0 + s1) + (s2 + s3); each element (x * r) *
// (gamma * sqrt(64)) in f32, cast once.  THREADS threads numbered from tid
// (a multiple of 32 below threadIdx.x); zero rows stay zero.
template <int THREADS>
__device__ __forceinline__ void rms_norm_tile_quads(int tid, bf16* tile, const float* gamma) {
  static_assert((kFlashTile * 4) % THREADS == 0, "4 lanes a row, every lane busy");
  const int t = tid & 3;
#pragma unroll
  for (int i = tid; i < kFlashTile * 4; i += THREADS) {
    const int row = i >> 2;
    uint32_t x[8];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j] = *reinterpret_cast<const uint32_t*>(tile + sw_off(row, 8 * j + 2 * t));
      const float2 f = unpack_pair(x[j]);
      ss += f.x * f.x + f.y * f.y;
    }
    const float r = rsqrtf(quad_sum(ss) + kRmsEps);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 f = unpack_pair(x[j]);
      const float2 g = *reinterpret_cast<const float2*>(gamma + 8 * j + 2 * t);
      *reinterpret_cast<uint32_t*>(tile + sw_off(row, 8 * j + 2 * t)) =
          pack_floats(f.x * r * (g.x * kRmsRoot), f.y * r * (g.y * kRmsRoot));
    }
  }
}

// d = A(64 x 16) . B(16 x 64), both K-major in shared memory, d written and
// not read (scale-d false): the first k16 step of a product, whose
// accumulators are fresh registers, so no copy of a stale value (which
// ptxas would have to wait for) precedes the wgmma
__device__ __forceinline__ void wgmma_ss_first(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]), "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]),
        "=f"(d[1][3]), "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]), "=f"(d[3][0]), "=f"(d[3][1]),
        "=f"(d[3][2]), "=f"(d[3][3]), "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]), "=f"(d[4][3]), "=f"(d[5][0]),
        "=f"(d[5][1]), "=f"(d[5][2]), "=f"(d[5][3]), "=f"(d[6][0]), "=f"(d[6][1]), "=f"(d[6][2]), "=f"(d[6][3]),
        "=f"(d[7][0]), "=f"(d[7][1]), "=f"(d[7][2]), "=f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d = A.B^T over dh = 64 (A: 64 rows of a swizzled K-major tile, B: the 64
// rows of another), f32: four k16 steps committed as one group (not waited
// for), after a wgmma_fence
__device__ __forceinline__ void ss_issue(float (&d)[8][4], const bf16* as, const bf16* bs) {
  wgmma_ss_first(d, desc_k_major(as), desc_k_major(bs));
#pragma unroll
  for (int kk = 1; kk < kFlashDh / 16; ++kk)
    WgmmaSS<8>::mma(d, desc_k_major(as + kk * 16), desc_k_major(bs + kk * 16), 1);
  wgmma_commit();
}

// keep a register-A operand allocated and unchanged until here (a read,
// not a write: the wgmma that reads it may still be in flight)
__device__ __forceinline__ void hold_frags(const uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(f[i][0]), "r"(f[i][1]), "r"(f[i][2]), "r"(f[i][3]) : "memory");
}

__device__ __forceinline__ void zero_acc(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
}

template <bool kDkv, bool kDropout, bool kQkNorm>
__device__ __forceinline__ void flash_bwd_block(const FlashArgs& a, const BwdMaps& maps) {
  extern __shared__ unsigned char flash_bwd_raw[];
  unsigned char* smem = aligned_smem(flash_bwd_raw);
  bf16* res = reinterpret_cast<bf16*>(smem + kBwdRes);
  bf16* ring = reinterpret_cast<bf16*>(smem + kBwdRing);
  int* ring_vec = reinterpret_cast<int*>(smem + kBwdRingVec);  // stage s: ids, lse, delta at 3 * 64 * s
  int* res_vec = reinterpret_cast<int*>(smem + kBwdResVec);    // slot s: ids, lse, delta at 3 * 128 * s
  int4* queue = reinterpret_cast<int4*>(smem + kBwdQueueAt);   // (mask, first tile, last chunk of its item)
  int* tile_at = reinterpret_cast<int*>(smem + kBwdTileIdx);   // stage s: its tile, or -1 (the item's end)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBwdBars);
  uint64_t* empty = full + kBwdStages;
  uint64_t* res_full = empty + kBwdStages;
  uint64_t* res_empty = res_full + 2;
  uint64_t* q_full = res_empty + 2;
  uint64_t* q_empty = q_full + kBwdQueue;
  uint32_t* keep = reinterpret_cast<uint32_t*>(smem + kBwdKeep);  // consumer w: tiles at 2w, 2w + 1 (dropout)

  const int own_len = kDkv ? a.m : a.n, other_len = kDkv ? a.n : a.m;
  const int rblocks = (own_len + kBwdRows - 1) / kBwdRows, items = rblocks * a.batch * a.heads;
  const int other_tiles = (other_len + kFlashTile - 1) / kFlashTile;
  const bool heavy_last = !kDkv && a.causal;  // causal dq: the last query blocks see the most keys
  const bool segs = a.qseg != nullptr;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBwdStages; ++i) {
      mbar_init(full + i, kBwdFullArrivals);
      mbar_init(empty + i, kBwdConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(res_full + i, kBwdFullArrivals);
      mbar_init(res_empty + i, kBwdConsumerWarps);
    }
    for (int i = 0; i < kBwdQueue; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;

  if (threadIdx.x >= 128 * kBwdWgs) {
    // ---- the producer warpgroup: a loader warp and an admission warp ----
    regs_dec<kBwdProducerRegs>();
    const int pw = (threadIdx.x >> 5) - 4 * kBwdWgs;
    int qslot = 0;
    uint32_t qphase = 0;
    if (pw == 1) {
      // the admission: each item's tiles a queue entry a chunk of 32 (one at
      // least), running ahead of the loader by up to kBwdQueue entries
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const BwdItem it = bwd_item(a, item, rblocks, heavy_last);
        const int* own_seg = segs ? (kDkv ? a.kseg + it.b * a.m : a.qseg + it.b * a.n) : nullptr;
        const int* other_seg = segs ? (kDkv ? a.qseg + it.b * a.n : a.kseg + it.b * a.m) : nullptr;
        int lo = 0, hi = 0, base = 0, end = other_tiles;
        if (a.causal) {  // the tiles of the block's first key tile on, or up to its last query tile
          if constexpr (kDkv) base = causal_first_query_tile(it.r0 / kFlashTile);
          else end = causal_key_tiles((it.r0 + kBwdRows - 1) / kFlashTile, other_tiles);
        }
        if (segs) block_range(own_seg, it.r0, own_len, lane, lo, hi);
        for (;; base += 32) {
          const uint32_t mask = admit_chunk(other_seg, other_len, base, end, lo, hi, lane);
          const bool last = base + 32 >= end;
          mbar_wait(q_empty + qslot, qphase ^ 1u);
          if (lane == 0) {
            queue[qslot] = make_int4(static_cast<int>(mask), base, last, 0);
            mbar_arrive(q_full + qslot);
          }
          if (++qslot == kBwdQueue) qslot = 0, qphase ^= 1u;
          if (last) break;
        }
      }
      return;
    }
    if (pw != 0) return;

    // the loader: each item's resident operands, then its admitted tiles
    // into the ring in ascending order, then the item's end
    int stage = 0, c = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++c) {
      const BwdItem it = bwd_item(a, item, rblocks, heavy_last);
      const int slot = c & 1;
      const int* own_seg = segs ? (kDkv ? a.kseg + it.b * a.m : a.qseg + it.b * a.n) : nullptr;
      const int* other_seg = segs ? (kDkv ? a.qseg + it.b * a.n : a.kseg + it.b * a.m) : nullptr;
      const long long stat = static_cast<long long>(it.bh) * a.n;  // this (image, head)'s lse and delta

      mbar_wait(res_empty + slot, ((c >> 1) & 1) ^ 1u);
      if (lane == 0) {
        mbar_expect(res_full + slot, 4 * kSwTileBytes);
#pragma unroll
        for (int w = 0; w < kBwdWgs; ++w) {
          tma_load(res + (4 * slot + w) * kSwTile, maps.a, 0, it.r0 + w * kFlashTile, it.h, it.b, res_full + slot);
          tma_load(res + (4 * slot + 2 + w) * kSwTile, maps.b, 0, it.r0 + w * kFlashTile, it.h, it.b,
                   res_full + slot);
        }
      }
      int* rv = res_vec + slot * 3 * kBwdRows;
#pragma unroll
      for (int i = 0; i < kBwdRows / 32; ++i) {
        const int r = 32 * i + lane, row = it.r0 + r;
        const bool ok = row < own_len;
        if (segs) cp_async_4_zfill(rv + r, own_seg + (ok ? row : 0), ok);
        if constexpr (!kDkv) {
          cp_async_4_zfill(rv + kBwdRows + r, a.lse + stat + (ok ? row : 0), ok);
          cp_async_4_zfill(rv + 2 * kBwdRows + r, a.delta + stat + (ok ? row : 0), ok);
        }
      }
      cp_async_arrive_noinc(res_full + slot);

      // stage j (or, for j < 0, the item's end) once its slot is free
      auto publish = [&](int j) {
        mbar_wait(empty + stage, phase ^ 1u);
        if (lane == 0) {
          tile_at[stage] = j;
          if (j >= 0) {
            mbar_expect(full + stage, 2 * kSwTileBytes);
            tma_load(ring + 2 * stage * kSwTile, maps.x, 0, j * kFlashTile, it.h, it.b, full + stage);
            tma_load(ring + (2 * stage + 1) * kSwTile, maps.y, 0, j * kFlashTile, it.h, it.b, full + stage);
          } else {
            mbar_arrive(full + stage);
          }
        }
        if (j >= 0) {
          int* sv = ring_vec + stage * 3 * kFlashTile;
#pragma unroll
          for (int i = 0; i < kFlashTile / 32; ++i) {
            const int r = 32 * i + lane, row = j * kFlashTile + r;
            const bool ok = row < other_len;
            if (segs) cp_async_4_zfill(sv + r, other_seg + (ok ? row : 0), ok);
            if constexpr (kDkv) {
              cp_async_4_zfill(sv + kFlashTile + r, a.lse + stat + (ok ? row : 0), ok);
              cp_async_4_zfill(sv + 2 * kFlashTile + r, a.delta + stat + (ok ? row : 0), ok);
            }
          }
          cp_async_arrive_noinc(full + stage);
        } else {
          mbar_arrive(full + stage);
        }
        if (++stage == kBwdStages) stage = 0, phase ^= 1u;
      };
      for (bool last = false; !last;) {
        mbar_wait(q_full + qslot, qphase);
        const int4 e = queue[qslot];
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty + qslot);
        if (++qslot == kBwdQueue) qslot = 0, qphase ^= 1u;
        for (uint32_t mask = static_cast<uint32_t>(e.x); mask != 0u; mask &= mask - 1u) publish(e.y + __ffs(mask) - 1);
        last = e.z != 0;
      }
      publish(-1);
    }
    return;
  }

  // ---- a consumer warpgroup: 64 of each item's 128 rows ----
  regs_inc<kBwdConsumerRegs>();
  const int wg = threadIdx.x >> 7, wtid = threadIdx.x & 127, warp = wtid >> 5, g = lane >> 2, t = lane & 3;
  const int lr = wg * kFlashTile + warp * 16 + g;  // rows lr, lr + 8 of the item's 128
  const float sl2 = a.scale * kLog2e;              // p = 2^(s * scale * log2(e) - lse * log2(e))
  int stage = 0, c = 0, par = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++c) {
    const BwdItem it = bwd_item(a, item, rblocks, heavy_last);
    const int slot = c & 1, row0 = it.r0 + lr, own_tile = (it.r0 + wg * kFlashTile) / kFlashTile;
    bf16* ra = res + (4 * slot + wg) * kSwTile;      // q (dq) or k (dkv): A of the first product
    bf16* rb = res + (4 * slot + 2 + wg) * kSwTile;  // dO (dq) or v (dkv): A of the second
    const int* rv = res_vec + slot * 3 * kBwdRows;
    [[maybe_unused]] const uint32_t stream = dropout_stream(it.b, it.h);
    mbar_wait(res_full + slot, (c >> 1) & 1);
    if constexpr (kQkNorm) {
      if constexpr (kDkv) rms_norm_tile_sw_at<128>(wtid, ra, a.gk + it.h * kFlashDh);
      else rms_norm_tile_quads<128>(wtid, ra, a.gq + it.h * kFlashDh);
      fence_proxy_async();
      named_sync(2 + wg, 128);
    }
    // the own rows' ids (-1 past the sequence; 0 for every row without ids)
    const int id0 = row0 < own_len ? (segs ? rv[lr] : 0) : -1;
    const int id1 = row0 + 8 < own_len ? (segs ? rv[lr + 8] : 0) : -1;
    [[maybe_unused]] const float lse0 = reinterpret_cast<const float*>(rv)[kBwdRows + lr] * kLog2e;
    [[maybe_unused]] const float lse1 = reinterpret_cast<const float*>(rv)[kBwdRows + lr + 8] * kLog2e;
    [[maybe_unused]] const float dl0 = reinterpret_cast<const float*>(rv)[2 * kBwdRows + lr];
    [[maybe_unused]] const float dl1 = reinterpret_cast<const float*>(rv)[2 * kBwdRows + lr + 8];

    float acc0[8][4], acc1[8][4];  // dq (acc0), or dk (acc0) and dv (acc1)
    uint32_t df[4][4] = {}, pf[4][4] = {};  // the A operands of the last products, in flight into the next tile
    zero_acc(acc0);
    if constexpr (kDkv) zero_acc(acc1);
    int prev = -1;  // the stage those products read: released once they retire
    for (;;) {
      mbar_wait(full + stage, phase);
      const int j = tile_at[stage];
      if (j < 0) break;  // the item's end
      bf16* xs = ring + 2 * stage * kSwTile;  // k (dq) or q (dkv)
      bf16* ys = xs + kSwTile;                // v (dq) or dO (dkv)
      const int* sv = ring_vec + stage * 3 * kFlashTile;
      const float* ls = reinterpret_cast<const float*>(sv) + kFlashTile;
      const float* dls = ls + kFlashTile;
      if constexpr (kQkNorm) {
        if constexpr (kDkv) rms_norm_tile_quads<128 * kBwdWgs>(threadIdx.x, xs, a.gq + it.h * kFlashDh);
        else rms_norm_tile_sw_at<128 * kBwdWgs>(threadIdx.x, xs, a.gk + it.h * kFlashDh);
        fence_proxy_async();
        named_sync(1, 128 * kBwdWgs);
      }
      float s[8][4], dp[8][4];
      wgmma_fence();
      ss_issue(s, ra, xs);   // s = q.k^T, or s^T = k.q^T
      ss_issue(dp, rb, ys);  // dp = dO.v^T, or dp^T = v.dO^T
      [[maybe_unused]] const uint32_t* kt = keep + (2 * wg + par) * kFlashKeepTile;
      if constexpr (kDropout) {  // keyed (query, key), as the forward draws it
        if constexpr (kDkv)
          fill_keep_tile_at<kFlashTile, kFlashKeepWords, 128>(wtid, keep + (2 * wg + par) * kFlashKeepTile, a.drop,
                                                               stream, j * kFlashTile, it.r0 + wg * kFlashTile, a.n,
                                                               a.m);
        else
          fill_keep_tile_at<kFlashTile, kFlashKeepWords, 128>(wtid, keep + (2 * wg + par) * kFlashKeepTile, a.drop,
                                                               stream, it.r0 + wg * kFlashTile, j * kFlashTile, a.n,
                                                               a.m);
        named_sync(2 + wg, 128);
      }
      // the previous tile's last products have retired: release its stage
      wgmma_wait<2>();
      hold_frags(df);
      if constexpr (kDkv) hold_frags(pf);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + prev);
      }
      wgmma_wait<1>();
      fence_acc(s);
      // the causal triangle on the warpgroup's diagonal tile (every element
      // hidden on a tile past it), a branch uniform across the warpgroup
      if constexpr (kDkv) {
        if (a.causal && j <= own_tile) hide_above_diagonal<true>(s, a, row0, j * kFlashTile, t);
      } else {
        if (a.causal && j >= own_tile) hide_above_diagonal<false>(s, a, row0, j * kFlashTile, t);
      }
      // p = exp(s - lse), 0 where masked (never exp of the masked logit,
      // which is 1 in a fully masked row); a tile with no ids and every
      // column below the sequence's end (kFull) tests only its rows
      auto probs = [&](auto full_tile) {
        constexpr bool kFull = decltype(full_tile)::value;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c0 = jj * 8 + 2 * t;  // even: the pair's ids (and lse) are one 8-byte read
          [[maybe_unused]] const int2 ids = segs ? *reinterpret_cast<const int2*>(sv + c0) : make_int2(0, 0);
          [[maybe_unused]] const float2 lsp = kDkv ? *reinterpret_cast<const float2*>(ls + c0) : make_float2(0.f, 0.f);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bool v0 = id0 >= 0, v1 = id1 >= 0;
            if constexpr (!kFull) {
              const bool in = j * kFlashTile + c0 + e < other_len;
              const int id = e ? ids.y : ids.x;
              v0 = v0 && in && id == id0;
              v1 = v1 && in && id == id1;
            }
            const float l0 = kDkv ? (e ? lsp.y : lsp.x) * kLog2e : lse0, l1 = kDkv ? l0 : lse1;
            s[jj][e] = v0 ? exp2_ftz(fmaf(s[jj][e], sl2, -l0)) : 0.f;
            s[jj][2 + e] = v1 ? exp2_ftz(fmaf(s[jj][2 + e], sl2, -l1)) : 0.f;
          }
        }
      };
      if (!segs && (j + 1) * kFlashTile <= other_len) probs(std::true_type{});
      else probs(std::false_type{});
      [[maybe_unused]] uint32_t kbits = 0u;
      if constexpr (kDkv) {  // dv += bf16(p^T).dO (with dropout, where(keep, p^T, 0) * inv)
        if constexpr (kDropout) {
          kbits = keep_bits_cols(kt, warp * 16 + g, t);
          keep_to_a_frags(pf, s, kbits, a.drop.inv);  // scaled before its cast
        } else {
          to_a_frags(pf, s);
        }
        wgmma_fence();
        pv_issue(acc1, pf, ys);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
        if constexpr (kDropout) kbits = keep_bits_rows(kt, warp * 16 + g, t);
      }
      fence_acc(dp);
      if constexpr (kDropout) apply_keep_bits(dp, kbits, a.drop.inv);  // d softmax rides the mask
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        [[maybe_unused]] const float2 dl2 = kDkv ? *reinterpret_cast<const float2*>(dls + jj * 8 + 2 * t)
                                                 : make_float2(0.f, 0.f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (kDkv) {
            const float dl = e ? dl2.y : dl2.x;
            dp[jj][e] = s[jj][e] * (dp[jj][e] - dl);
            dp[jj][2 + e] = s[jj][2 + e] * (dp[jj][2 + e] - dl);
          } else {
            dp[jj][e] = s[jj][e] * (dp[jj][e] - dl0);
            dp[jj][2 + e] = s[jj][2 + e] * (dp[jj][2 + e] - dl1);
          }
        }
      }
      to_a_frags(df, dp);
      wgmma_fence();
      pv_issue(acc0, df, xs);  // dq += bf16(ds).k, or dk += bf16(ds^T).q (q^ with qk-norm); retired next tile
      prev = stage;
      if (++stage == kBwdStages) stage = 0, phase ^= 1u;
      par ^= 1;
    }
    // the item's end: its last products retire, their stage and the end's
    // stage and the resident slot are released, the sums stored
    wgmma_wait<0>();
    fence_acc(acc0);
    hold_frags(df);
    if constexpr (kDkv) {
      fence_acc(acc1);
      hold_frags(pf);
    }
    __syncwarp();
    if (lane == 0) {
      if (prev >= 0) mbar_arrive(empty + prev);
      mbar_arrive(empty + stage);
      mbar_arrive(res_empty + slot);
    }
    if (++stage == kBwdStages) stage = 0, phase ^= 1u;
    if constexpr (kDkv) {
      store_rows(head_ptr(a.out0, a.s0, it.b, it.h), a.s0.row, acc0, a.scale, a.scale, row0, a.m, t);
      store_rows(head_ptr(a.out1, a.s1, it.b, it.h), a.s1.row, acc1, 1.f, 1.f, row0, a.m, t);
    } else {
      store_rows(head_ptr(a.out0, a.s0, it.b, it.h), a.s0.row, acc0, a.scale, a.scale, row0, a.n, t);
    }
  }
}

// flash_bwd_dq: each item's 128 queries against their admitted key tiles;
// dq = scale * sum of bf16(ds).k (with qk-norm the gradient of q^)
template <bool kDropout, bool kQkNorm>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dq_kernel(const __grid_constant__ FlashArgs a,
                                                                    const __grid_constant__ BwdMaps maps) {
  flash_bwd_block<false, kDropout, kQkNorm>(a, maps);
}

// flash_bwd_dkv: each item's 128 keys against their admitted query tiles;
// dk = scale * sum of bf16(ds^T).q (with qk-norm the gradient of k^), dv =
// sum of bf16(p^T).dO
template <bool kDropout, bool kQkNorm>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dkv_kernel(const __grid_constant__ FlashArgs a,
                                                                     const __grid_constant__ BwdMaps maps) {
  flash_bwd_block<true, kDropout, kQkNorm>(a, maps);
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

typedef void (*FwdKernel)(FlashArgs, TmaMaps);

// flash_fwd's instantiations, kFwdKernels[drop + 2 * qknorm]
const FwdKernel kFwdKernels[4] = {flash_fwd_kernel<false, false, false>, flash_fwd_kernel<true, false, false>,
                                  flash_fwd_kernel<false, true, false>, flash_fwd_kernel<true, true, false>};
// the bias variant: rate 0, no qk-norm (the dispatcher never sends a bias
// with dropout or gammas, JAX :882-883)
const FwdKernel kFwdBiasKernel = flash_fwd_kernel<false, false, true>;
typedef void (*BwdKernel)(FlashArgs, BwdMaps);
// the backward kernels' instantiations, k*Kernels[drop + 2 * qknorm]
const BwdKernel kDqKernels[4] = {flash_bwd_dq_kernel<false, false>, flash_bwd_dq_kernel<true, false>,
                                 flash_bwd_dq_kernel<false, true>, flash_bwd_dq_kernel<true, true>};
const BwdKernel kDkvKernels[4] = {flash_bwd_dkv_kernel<false, false>, flash_bwd_dkv_kernel<true, false>,
                                  flash_bwd_dkv_kernel<false, true>, flash_bwd_dkv_kernel<true, true>};

// One launch of a backward kernel for the options: the persistent grid,
// min(work items, SMs) blocks, over the items of `own_len` rows (n for dq,
// m for dkv) a (image, head).
int launch_bwd(const BwdKernel (&kernels)[4], const FlashArgs& a, const BwdMaps& maps, int own_len, int drop,
               void* stream) {
  const BwdKernel kernel = kernels[(drop ? 1 : 0) + (a.gq != nullptr ? 2 : 0)];
  const long long items = static_cast<long long>((own_len + kBwdRows - 1) / kBwdRows) * a.batch * a.heads;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = bwd_smem(drop);
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(items < sm_count() ? items : sm_count());
  kernel<<<grid, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, maps);
  return cudaGetLastError();
}

// the tensor maps of a backward launch: resident a and b of `own` rows,
// ring x and y of `other` rows
bool encode_bwd_maps(BwdMaps& maps, const void* pa, const Strides& sa, const void* pb, const Strides& sb, int own,
                     const void* px, const Strides& sx, const void* py, const Strides& sy, int other, int heads,
                     int batch) {
  return encode_operand_map(maps.a, pa, sa, own, heads, batch) && encode_operand_map(maps.b, pb, sb, own, heads, batch) &&
         encode_operand_map(maps.x, px, sx, other, heads, batch) &&
         encode_operand_map(maps.y, py, sy, other, heads, batch);
}

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
  FlashArgs a = make_args(q, k, v, dout, dq, nullptr, const_cast<void*>(lse), delta, qseg, kseg, gq, gk, nullptr, 0,
                          heads, n, m, scale, causal, DropoutArgs{seed, threshold, inv}, strides);
  a.batch = batch;
  BwdMaps maps{};
  if (!encode_bwd_maps(maps, q, a.sq, dout, a.sdo, n, k, a.sk, v, a.sv, m, heads, batch)) return cudaErrorInvalidValue;
  return launch_bwd(kDqKernels, a, maps, n, drop, stream);
}

int vit_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, const void* qseg, const void* kseg, const void* gq, const void* gk, void* dk,
                      void* dv, int batch, int heads, int n, int m, int dim_head, float scale, int causal, int drop,
                      unsigned seed, unsigned threshold, float inv, const long long* strides, void* stream) {
  if (bad_shape(batch, heads, n, m, dim_head, qseg, kseg, gq, gk, drop)) return cudaErrorInvalidValue;
  FlashArgs a = make_args(q, k, v, dout, dk, dv, const_cast<void*>(lse), delta, qseg, kseg, gq, gk, nullptr, 0, heads,
                          n, m, scale, causal, DropoutArgs{seed, threshold, inv}, strides);
  a.batch = batch;
  BwdMaps maps{};
  if (!encode_bwd_maps(maps, k, a.sk, v, a.sv, m, q, a.sq, dout, a.sdo, n, heads, batch)) return cudaErrorInvalidValue;
  return launch_bwd(kDkvKernels, a, maps, m, drop, stream);
}

}  // extern "C"
