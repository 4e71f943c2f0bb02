// Hopper (sm_90a) kernels of the wide attention path: attention_rows and
// attention_bwd_rows at the head widths and token counts past ViT-B's (dh
// 64, n <= 208; those stay on attention_rows.cu's and
// attention_bwd_rows.cuh's kernels, one instantiation per key-chunk count).
// Here dh is a template parameter (VIT_ATTN_WIDE_DIM_HEADS: 32, 64, 80, 88,
// 128) and the token count a runtime one, n <= kAttnWideMaxKeys: the JAX
// width ladder (ViT-L/14, ViT-H/14 and ViT-g/14 at 257 tokens, ViT-B/16 at
// 384 with 577, bench_d128.py's ViT-B at 24 heads x 32 and 6 x 128).
//
// Replaces: the per-head loops of vit_pytorch_tpu/ops/fused_block.py::
// _layer_kernel (_layer_rows :1021-1037) and of the attention-block kernel
// _kernel (:323-348, with its qk-norm and dropout) for the forward, and of
// _bwd_kernel (:608-692) for the backward, at the shapes those TPU kernels
// take past ViT-B's (their gates :232-258, :959-978 and :841 admit any
// dim_head and token count whose VMEM estimate fits).
//
// Bound on this card: the bytes of q, k, v and the output (forward; with dm,
// m and dqkv the backward), ~100 flops a byte at n = 257, under the ~295
// flop/byte ridge; the (n, n) logits never leave the SM.
//
// Why not the narrow kernels' design: they hold a query tile's logits
// against every key in registers, 8 KT floats a thread (104 at 208 keys),
// and the backward holds q, k, v and dm of a head resident in shared memory
// (4 x 16 KT x dh x 2 bytes: ~209 KB at 257 keys of dh 96 padded, more at dh
// 128).  Past 208 keys or dh 64 neither fits.  Here the keys stream in
// 64-key chunks through a two-stage TMA ring, and the softmax is the exact
// two-pass one of _softmax_from_dots: a first sweep over the chunks takes
// each row's max and sum (the sum rescaled as the max grows), a second
// recomputes q.k^T and forms p = exp2(s - max) * (1 / sum), normalised
// before its bf16 cast as the JAX kernels and the plain twins cast it, so
// the backward rebuilds the forward's p bit for bit from the same two
// statistics.  (An online rescale of the output, flash style, would cast p
// unnormalised: another rounding point, and a backward that could not
// rebuild it.)  The price is q.k^T computed twice in the forward and three
// times in the backward's row pass.
//
// Layout: a 64-row tile of a head is ceil(dh / 64) blocks of 64 rows x 64
// bf16 columns in the 128-byte swizzle (attn_wgmma.cuh's sw_off), loaded by
// TMA boxes of 64 columns through 3-D (columns, rows, images) maps, so rows
// past n read zero and never the next image.  A box that reaches past the
// head (dh 80, 88, 32) reads the next head's columns (zero past the row's
// end): the products over dh read only columns < 16 ceil(dh / 16), and at
// dh 88 columns 88..95 are zeroed in shared memory before any product reads
// them (zero_pad_cols); the products of width dh (p.v, ds.k, pd^T.dm,
// ds^T.q) read exactly dh columns (wgmma n = dh, MN-major B).
//
// The kernels, one warpgroup (128 threads) a block:
//  - attention_wide_fwd: a block a (query tile, image, head).  Sweep 0 over
//    the key chunks: s = q.k^T (wgmma m64n64k16, k16 steps over dh), the
//    rows' max and sum.  Sweep 1: s again, p, dropout (the keep words of
//    the block's 64 rows drawn once, fill_keep_rows), o += bf16(p).v
//    (wgmma m64n(dh)k16 with A from registers, wgmma_rs.cuh).
//  - attention_wide_bwd_q (the row pass): a block a (query tile, image,
//    head), with q and dm resident.  Sweep 0 the statistics, as the
//    forward; sweep 1 dp = dm.v^T, D = rowsum(dp * p), m += bf16(pd).v;
//    sweep 2 dp again, ds = bf16(p (dp - D)), dq += ds.k.  It stores each
//    row's max, 1/sum and D ((b, heads, 3, 64 ceil(n / 64)) f32, 0 past n)
//    for
//  - attention_wide_bwd_kv (the key pass), launched after it: a block a
//    (key tile, image, head), with k and v resident and the queries
//    streaming: p^T = k.q^T rebuilt from the statistics, dp^T = v.dm^T,
//    dv += bf16(pd^T).dm, dk += ds^T.q.  At dh > 88 dv and dk take a sweep
//    each (their accumulators would not fit the registers together).
//  - qk-norm: q and k normalised in shared memory as they land, in one sum
//    order (rms_norm_wide), so every pass sees the forward's bits; the
//    root is sqrt(dh) rounded to f32 (the JAX kernels' float(dim_head) **
//    0.5); dq and dk closed with the raw rows and the rsqrt; dgamma as
//    per-block column sums into a (b * tiles, 2, inner) f32 buffer that
//    launch_column_sum adds in a fixed order: no atomics.
//  - Dropout: keep bits drawn from the (seed, img * 1024 + head) Philox
//    stream of every other attention kernel (common.cuh), so the mask is
//    the narrow kernels' and dropout_masks' mask.
// Every product is one committed group waited on in straight-line code.
//
// attention_wide.cu has the C entry points' dispatch over dh;
// attention_wide_d<dh>.cu each instantiate one dh's 12 kernels, so nvcc
// builds the five in parallel.

#pragma once

#include "layer_tiles.cuh"
#include "wgmma_rs.cuh"

// the head widths built (ops/fused_block.py::ATTN_WIDE_DIM_HEADS mirrors
// the list); each has its attention_wide_d<dh>.cu
#define VIT_ATTN_WIDE_DIM_HEADS(X) X(32) X(64) X(80) X(88) X(128)

constexpr int kAttnWideMaxKeys = 577;  // ViT-B/16 @384; the design has no lower limit of its own past 208
constexpr int kAttnWideTile = 64;      // query rows, or keys, of a tile

struct WideArgs {
  int batch, n, n_keys, heads;
  float scale_log2e, scale, root;  // root: sqrt(dh) in f32, the qk-norm's factor
  DropoutArgs drop;
  const bf16* qkv;  // (b, n, 3 inner)
  const bf16* dm;   // backward: (b, n, inner)
  const bf16* gq;   // qk-norm gammas, (inner) bf16 each, or null
  const bf16* gk;
  bf16* out;          // forward: o (b, n, inner); backward: m
  bf16* dqkv;         // backward: (b, n, 3 inner)
  float* stats;       // backward: (b, heads, 3, 64 ceil(n / 64)) f32 scratch
  float* dg_partial;  // backward with qk-norm: (b ceil(n / 64), 2, inner) f32 scratch
};

// qkv as (3 inner, n, b) and dm as (inner, n, b), boxes of 64 columns x 64 rows
struct alignas(64) WideMaps {
  CUtensorMap qkv, dm;
};

// the wide path of the C entry points vit_attention_rows (attention_rows.cu)
// and vit_attention_bwd_rows (attention_bwd_rows.cu), their arguments as
// there; attention_wide.cu dispatches over dh
cudaError_t attention_wide_forward(const void* qkv, void* out, int batch, int n, int n_keys, int heads, int dim_head,
                                   float scale_log2e, int drop, unsigned seed, unsigned threshold, float inv,
                                   const void* gq, const void* gk, cudaStream_t stream);
cudaError_t attention_wide_backward(const void* qkv, const void* dm, void* m, void* dqkv, void* stats, int batch, int n,
                                    int heads, int dim_head, float scale_log2e, float scale, int drop, unsigned seed,
                                    unsigned threshold, float inv, const void* gq, const void* gk, void* dg_partial,
                                    void* dg, cudaStream_t stream);

#define VIT_ATTN_WIDE_DECLARE(DH)                                                                               \
  cudaError_t attention_wide_fwd_d##DH(const WideArgs& a, const WideMaps& maps, bool drop, bool qk,            \
                                        cudaStream_t stream);                                                  \
  cudaError_t attention_wide_bwd_d##DH(const WideArgs& a, const WideMaps& maps, bool drop, bool qk,            \
                                        cudaStream_t stream);
VIT_ATTN_WIDE_DIM_HEADS(VIT_ATTN_WIDE_DECLARE)
#undef VIT_ATTN_WIDE_DECLARE

namespace {

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <int DH>
struct Wide {
  static_assert(DH % 8 == 0 && DH <= 128, "dh a multiple of 8, at most 128");
  static constexpr int CB = (DH + 63) / 64;  // 64-column blocks of a tile
  static constexpr int KS = (DH + 15) / 16;  // k16 steps of a product over dh
  static constexpr int NT = DH / 8;          // 8-column accumulator tiles of a product of width dh
  static constexpr int TILE = CB * kSwTile;  // elements of a 64-row tile
  static constexpr int BYTES = TILE * static_cast<int>(sizeof(bf16));
  static constexpr bool SPLIT_KV = DH > 88;  // the key pass's dv and dk in a sweep each
};

// the CB boxes of a 64-row tile: columns c0.. of rows r0.. of image img
template <int DH>
__device__ __forceinline__ void load_wide_tile(bf16* dst, const CUtensorMap* map, int c0, int r0, int img,
                                               uint64_t* bar) {
#pragma unroll
  for (int cb = 0; cb < Wide<DH>::CB; ++cb) tma_load_3d(dst + cb * kSwTile, map, c0 + cb * 64, r0, img, bar);
}

// columns dh .. 16 ceil(dh / 16) - 1 of a tile (dh 88: 88..95, the next
// head's) to zero, before a product over dh reads them; all 128 threads
template <int DH>
__device__ __forceinline__ void zero_pad_cols(bf16* tile, int tid) {
  if constexpr (DH % 16 != 0) {
    bf16* blk = tile + (DH / 64) * kSwTile;
    if (tid < kAttnWideTile) *reinterpret_cast<uint4*>(blk + sw_off(tid, DH % 64)) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The qk-norm of a 64-row tile in place: lane c of a row's 8 takes the
// row's 16-byte chunks c, c + 8 (one a 64-column block), adds their squares
// in turn, and the shuffles add the lanes' sums; rows of zeros stay zero.
// gamma: the head's dh gammas (bf16); root: sqrt(dh) in f32; with r, each
// row's rsqrt is stored there.  All 128 threads.
template <int DH>
__device__ __forceinline__ void rms_norm_wide(bf16* tile, const bf16* gamma, float root, int tid, float* r) {
  constexpr int CB = Wide<DH>::CB, CH = DH / 8;
  const int c = tid & 7;
  float g8[CB][8];
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) {
    if (8 * cb + c < CH) {
      load_gamma8(g8[cb], gamma + (8 * cb + c) * 8);
#pragma unroll
      for (int i = 0; i < 8; ++i) g8[cb][i] *= root;
    }
  }
#pragma unroll 1
  for (int i = tid; i < kAttnWideTile * 8; i += kAttnThreads) {
    const int row = i >> 3;
    float f[CB][8];
    float ss = 0.f;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      if (8 * cb + c < CH) {
        unpack8(f[cb], *reinterpret_cast<const uint4*>(tile + cb * kSwTile + sw_off(row, c * 8)));
#pragma unroll
        for (int j = 0; j < 8; ++j) ss += f[cb][j] * f[cb][j];
      }
    }
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 4);
    const float rr = rsqrtf(ss + kRmsEps);
    if (r && c == 0) r[row] = rr;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      if (8 * cb + c < CH) {
        uint4 o;
        uint32_t* po = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          po[j] = pack_floats(f[cb][2 * j] * rr * g8[cb][2 * j], f[cb][2 * j + 1] * rr * g8[cb][2 * j + 1]);
        *reinterpret_cast<uint4*>(tile + cb * kSwTile + sw_off(row, c * 8)) = o;
      }
    }
  }
}

// The norm's backward on one warp's 16 rows of f32 gradients d of the normed
// rows (common.cuh's rms_norm_bwd_rows with the root an argument): colsum
// gets the warp's column sums of d * xhat, d <- r (d g8 - xhat <d g8, xhat>)
template <int NT>
__device__ __forceinline__ void rms_close_wide(float (&d)[NT][4], const uint32_t (&raw0)[NT],
                                               const uint32_t (&raw1)[NT], float r0, float r1,
                                               const bf16* __restrict__ gamma, float root, float* colsum, int g,
                                               int t) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int dj = 0; dj < NT; ++dj) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw0[dj]));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw1[dj]));
    const float2 gg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gamma + dj * 8 + 2 * t));
    const float x0 = a.x * r0, y0 = a.y * r0, x1 = b.x * r1, y1 = b.y * r1;
    float px = d[dj][0] * x0 + d[dj][2] * x1, py = d[dj][1] * y0 + d[dj][3] * y1;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {  // over g: the lanes of one t
      px += __shfl_xor_sync(0xffffffffu, px, o);
      py += __shfl_xor_sync(0xffffffffu, py, o);
    }
    if (g == 0) colsum[dj * 8 + 2 * t] = px, colsum[dj * 8 + 2 * t + 1] = py;
    d[dj][0] *= gg.x * root, d[dj][1] *= gg.y * root;
    d[dj][2] *= gg.x * root, d[dj][3] *= gg.y * root;
    s0 += d[dj][0] * x0 + d[dj][1] * y0;
    s1 += d[dj][2] * x1 + d[dj][3] * y1;
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
#pragma unroll
  for (int dj = 0; dj < NT; ++dj) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw0[dj]));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw1[dj]));
    d[dj][0] = r0 * (d[dj][0] - a.x * r0 * s0);
    d[dj][1] = r0 * (d[dj][1] - a.y * r0 * s0);
    d[dj][2] = r1 * (d[dj][2] - b.x * r1 * s1);
    d[dj][3] = r1 * (d[dj][3] - b.y * r1 * s1);
  }
}

// the pairs of one raw row's dh columns at the accumulator layout's columns
template <int NT>
__device__ __forceinline__ void load_raw_wide(uint32_t (&raw)[NT], const bf16* row, int t) {
#pragma unroll
  for (int dj = 0; dj < NT; ++dj) raw[dj] = *reinterpret_cast<const uint32_t*>(row + dj * 8 + 2 * t);
}

// d = A(64 rows) . B(64 rows)^T over dh, both K-major wide tiles in shared
// memory: KS k16 steps (the first overwriting), committed and waited for
template <int DH>
__device__ __forceinline__ void dots_wide(float (&d)[8][4], const bf16* a_rows, const bf16* b_rows) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Wide<DH>::KS; ++kk) {
    const int off = (kk >> 2) * kSwTile + (kk & 3) * 16;
    WgmmaSS<8>::mma(d, desc_k_major(a_rows + off), desc_k_major(b_rows + off), kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(&d[0][0], 32);
}

// acc (+)= bf16 A(64 x 64, the four k16 fragments f) . B(64 rows x dh), B
// an MN-major wide tile (its rows the k axis); committed and waited for,
// the fragments kept live until then
template <int DH>
__device__ __forceinline__ void accumulate_wide(float (&acc)[Wide<DH>::NT][4], uint32_t (&f)[4][4], const bf16* b_rows) {
  fence_operands(&acc[0][0], 4 * Wide<DH>::NT);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) WgmmaRS<Wide<DH>::NT>::mma(acc, f[kc], desc_mn_major(b_rows + kc * 16 * 64), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_frags(f);
  fence_operands(&acc[0][0], 4 * Wide<DH>::NT);
}

// the keep words of query rows r0 .. r0 + 63 of a head's stream against
// keys 0 .. 64 words - 1: words[r * WORDS + w] bit i = key 32 w + i; rows >= n
// and keys >= n read 0.  All 128 threads.
__device__ __forceinline__ void fill_keep_rows(uint32_t* words, int words_row, const DropoutArgs& d, uint32_t stream,
                                               int r0, int n, int tid) {
  for (int i = tid; i < kAttnWideTile * words_row; i += kAttnThreads) {
    const int r = i / words_row, col = 32 * (i % words_row);
    uint32_t bits = 0u;
    if (r0 + r < n && col < n) {
#pragma unroll
      for (int q = 0; q < 8; ++q) bits |= keep_nibble(d, stream, r0 + r, col / 4 + q) << (4 * q);
      if (n - col < 32) bits &= (1u << (n - col)) - 1u;
    }
    words[i] = bits;
  }
}

// The row statistics of one 64-key chunk (keys k0..) folded into the running
// max (of the scaled logits) and the thread's partial sum of the rows g, g + 8.
// Every scaled logit here and where p is rebuilt is __fmul_rn(s, scale):
// a product that the compiler cannot fuse into the subtraction of the max,
// so the row's largest logit gives p = exp2(0) * (1 / sum) exactly in every
// pass (one key: p = 1 and ds = 0, as the twin gives them)
__device__ __forceinline__ void fold_stats(float (&s)[8][4], int k0, int n_keys, int t, float scale_log2e, float& mx0,
                                           float& mx1, float& l0, float& l1) {
  float c0 = -CUDART_INF_F, c1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = k0 + j * 8 + 2 * t + e < n_keys;
      s[j][e] = valid ? __fmul_rn(s[j][e], scale_log2e) : -CUDART_INF_F;
      s[j][2 + e] = valid ? __fmul_rn(s[j][2 + e], scale_log2e) : -CUDART_INF_F;
      c0 = fmaxf(c0, s[j][e]);
      c1 = fmaxf(c1, s[j][2 + e]);
    }
  }
  const float m0 = fmaxf(mx0, quad_max(c0)), m1 = fmaxf(mx1, quad_max(c1));
  l0 *= exp2f(mx0 - m0);  // 0 before the first chunk (mx = -inf)
  l1 *= exp2f(mx1 - m1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l0 += exp2f(s[j][e] - m0);
      l1 += exp2f(s[j][2 + e] - m1);
    }
  }
  mx0 = m0;
  mx1 = m1;
}

// p = exp2(s * scale_log2e - max) * (1 / sum) of one chunk, keys >= n_keys 0
__device__ __forceinline__ void chunk_probs(float (&s)[8][4], int k0, int n_keys, int t, float scale_log2e, float mx0,
                                            float mx1, float inv0, float inv1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = k0 + j * 8 + 2 * t + e < n_keys;
      s[j][e] = valid ? exp2f(__fmul_rn(s[j][e], scale_log2e) - mx0) * inv0 : 0.f;
      s[j][2 + e] = valid ? exp2f(__fmul_rn(s[j][2 + e], scale_log2e) - mx1) * inv1 : 0.f;
    }
  }
}

__device__ __forceinline__ void store_pair_wide(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_floats(a, b);
}

// the block's shared memory: the resident tiles, the two ring stages, the
// mbarriers (resident, stage 0, stage 1), then the tail
template <int DH>
__host__ __device__ constexpr int wide_smem(int resident, int stage_tiles, int tail_bytes) {
  return kWgAlign + (resident + 2 * stage_tiles) * Wide<DH>::BYTES + 3 * 8 + tail_bytes;
}

// keep words a row at n keys: two a 64-key chunk
__host__ __device__ constexpr int wide_keep_words(int n) { return 2 * ((n + 63) / 64); }

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

template <int DH, bool DROP, bool QKNORM>
__global__ void __launch_bounds__(kAttnThreads, 2)
    attention_wide_fwd_kernel(WideArgs a, const __grid_constant__ WideMaps maps) {
  using W = Wide<DH>;
  extern __shared__ unsigned char wide_fwd_raw[];
  unsigned char* smem = aligned_smem(wide_fwd_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + W::TILE;  // stage s: k at ring + 2s TILE, v after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 4 * W::TILE);
  uint32_t* keep = reinterpret_cast<uint32_t*>(bars + 3);  // DROP: 64 x wide_keep_words(n)

  const int n = a.n, nq = (n + kAttnWideTile - 1) / kAttnWideTile;
  const int qt = blockIdx.x % nq, ih = blockIdx.x / nq, h = ih % a.heads, img = ih / a.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int inner = a.heads * DH, q0 = qt * kAttnWideTile;
  const int nc = (a.n_keys + kAttnWideTile - 1) / kAttnWideTile, total = 2 * nc;
  const int kw = wide_keep_words(n);

  // item it of the ring: sweep it / nc's chunk it % nc (k; with v in sweep 1)
  auto issue = [&](int it) {
    bf16* st = ring + (it & 1) * 2 * W::TILE;
    uint64_t* bar = bars + 1 + (it & 1);
    const int c = it % nc;
    const bool with_v = it >= nc;
    mbar_expect(bar, (with_v ? 2 : 1) * W::BYTES);
    load_wide_tile<DH>(st, &maps.qkv, inner + h * DH, c * kAttnWideTile, img, bar);
    if (with_v) load_wide_tile<DH>(st + W::TILE, &maps.qkv, 2 * inner + h * DH, c * kAttnWideTile, img, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    mbar_fence_init();
    mbar_expect(bars, W::BYTES);
    load_wide_tile<DH>(qs, &maps.qkv, h * DH, q0, img, bars);
    issue(0);
    if (total > 1) issue(1);
  }
  __syncthreads();  // the barriers are initialised before any thread waits on them
  if constexpr (DROP) fill_keep_rows(keep, kw, a.drop, dropout_stream(img, h), q0, n, tid);
  mbar_wait(bars, 0);
  zero_pad_cols<DH>(qs, tid);
  if constexpr (QKNORM) rms_norm_wide<DH>(qs, a.gq + h * DH, a.root, tid, nullptr);
  fence_proxy_async();
  __syncthreads();  // q (and the keep words) in place

  // a stage's k tile ready for the products: landed, padded, normed
  auto ready_k = [&](int it) -> bf16* {
    bf16* st = ring + (it & 1) * 2 * W::TILE;
    mbar_wait(bars + 1 + (it & 1), (it >> 1) & 1);
    if constexpr (DH % 16 != 0 || QKNORM) {
      zero_pad_cols<DH>(st, tid);
      if constexpr (QKNORM) rms_norm_wide<DH>(st, a.gk + h * DH, a.root, tid, nullptr);
      fence_proxy_async();
      __syncthreads();
    }
    return st;
  };
  // every thread is done with item it's stage: refill it with item it + 2
  auto release = [&](int it) {
    __syncthreads();
    if (tid == 0 && it + 2 < total) issue(it + 2);
  };

  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {  // sweep 0: the rows' max and sum
    const bf16* ks = ready_k(c);
    float s[8][4];
    dots_wide<DH>(s, qs, ks);
    fold_stats(s, c * kAttnWideTile, a.n_keys, t, a.scale_log2e, mx0, mx1, l0, l1);
    release(c);
  }
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

  const uint32_t* krow0 = keep + (warp * 16 + g) * kw;  // DROP: keep rows g, g + 8 of the warp
  const uint32_t* krow1 = krow0 + 8 * kw;
  float o[W::NT][4];
#pragma unroll
  for (int dj = 0; dj < W::NT; ++dj) o[dj][0] = o[dj][1] = o[dj][2] = o[dj][3] = 0.f;
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {  // sweep 1: p and o += bf16(p).v
    const int it = nc + c;
    const bf16* ks = ready_k(it);
    float s[8][4];
    dots_wide<DH>(s, qs, ks);
    chunk_probs(s, c * kAttnWideTile, a.n_keys, t, a.scale_log2e, mx0, mx1, inv0, inv1);
    if constexpr (DROP) {
#pragma unroll
      for (int j = 0; j < 8; ++j) apply_keep(s[j], krow0 + 2 * c, krow1 + 2 * c, j, t, a.drop.inv);
    }
    uint32_t pf[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a_frag(pf[kc], s[2 * kc], s[2 * kc + 1]);
    accumulate_wide<DH>(o, pf, ks + W::TILE);
    release(it);
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  bf16* orow = a.out + static_cast<size_t>(img) * n * inner + h * DH + 2 * t;
#pragma unroll
  for (int dj = 0; dj < W::NT; ++dj) {
    if (r0 < n) store_pair_wide(orow + static_cast<size_t>(r0) * inner + dj * 8, o[dj][0], o[dj][1]);
    if (r1 < n) store_pair_wide(orow + static_cast<size_t>(r1) * inner + dj * 8, o[dj][2], o[dj][3]);
  }
}

// ---------------------------------------------------------------------------
// the backward's row pass: m, dq and the statistics
// ---------------------------------------------------------------------------

template <int DH, bool DROP, bool QKNORM>
__global__ void __launch_bounds__(kAttnThreads, 2)
    attention_wide_bwd_q_kernel(WideArgs a, const __grid_constant__ WideMaps maps) {
  using W = Wide<DH>;
  constexpr int NT = W::NT;
  extern __shared__ unsigned char wide_bwd_q_raw[];
  unsigned char* smem = aligned_smem(wide_bwd_q_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dms = qs + W::TILE;
  bf16* ring = dms + W::TILE;  // stage s: k at ring + 2s TILE, v after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 4 * W::TILE);
  float* rq = reinterpret_cast<float*>(bars + 3);  // QKNORM: [64]
  float* colsum = rq + kAttnWideTile;              // QKNORM: [4][DH]
  uint32_t* keep = reinterpret_cast<uint32_t*>(colsum + 4 * DH);  // DROP: 64 x wide_keep_words(n)

  const int n = a.n, nq = (n + kAttnWideTile - 1) / kAttnWideTile, np = nq * kAttnWideTile;
  const int qt = blockIdx.x % nq, ih = blockIdx.x / nq, h = ih % a.heads, img = ih / a.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int inner = a.heads * DH, q0 = qt * kAttnWideTile, nc = nq, total = 3 * nc, kw = wide_keep_words(n);
  const size_t rstride = 3 * static_cast<size_t>(inner), img_row = static_cast<size_t>(img) * n;

  auto issue = [&](int it) {  // sweep 0: k; sweeps 1, 2: k and v
    bf16* st = ring + (it & 1) * 2 * W::TILE;
    uint64_t* bar = bars + 1 + (it & 1);
    const int c = it % nc;
    const bool with_v = it >= nc;
    mbar_expect(bar, (with_v ? 2 : 1) * W::BYTES);
    load_wide_tile<DH>(st, &maps.qkv, inner + h * DH, c * kAttnWideTile, img, bar);
    if (with_v) load_wide_tile<DH>(st + W::TILE, &maps.qkv, 2 * inner + h * DH, c * kAttnWideTile, img, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    mbar_fence_init();
    mbar_expect(bars, 2 * W::BYTES);
    load_wide_tile<DH>(qs, &maps.qkv, h * DH, q0, img, bars);
    load_wide_tile<DH>(dms, &maps.dm, h * DH, q0, img, bars);
    issue(0);
    if (total > 1) issue(1);
  }
  __syncthreads();
  if constexpr (DROP) fill_keep_rows(keep, kw, a.drop, dropout_stream(img, h), q0, n, tid);
  mbar_wait(bars, 0);
  zero_pad_cols<DH>(qs, tid);
  zero_pad_cols<DH>(dms, tid);
  if constexpr (QKNORM) rms_norm_wide<DH>(qs, a.gq + h * DH, a.root, tid, rq);
  fence_proxy_async();
  __syncthreads();

  auto ready = [&](int it) -> bf16* {  // the stage's k (and v) padded, k normed
    bf16* st = ring + (it & 1) * 2 * W::TILE;
    mbar_wait(bars + 1 + (it & 1), (it >> 1) & 1);
    if constexpr (DH % 16 != 0 || QKNORM) {
      zero_pad_cols<DH>(st, tid);
      if (it >= nc) zero_pad_cols<DH>(st + W::TILE, tid);
      if constexpr (QKNORM) rms_norm_wide<DH>(st, a.gk + h * DH, a.root, tid, nullptr);
      fence_proxy_async();
      __syncthreads();
    }
    return st;
  };
  auto release = [&](int it) {
    __syncthreads();
    if (tid == 0 && it + 2 < total) issue(it + 2);
  };

  // sweep 0: the statistics, as the forward takes them
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    const bf16* ks = ready(c);
    float s[8][4];
    dots_wide<DH>(s, qs, ks);
    fold_stats(s, c * kAttnWideTile, n, t, a.scale_log2e, mx0, mx1, l0, l1);
    release(c);
  }
  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int wr0 = warp * 16 + g, wr1 = wr0 + 8;
  const uint32_t* krow0 = keep + wr0 * kw;
  const uint32_t* krow1 = keep + wr1 * kw;

  // sweep 1: dp = dm.v^T, D = rowsum(dp * p), m += bf16(pd).v
  float mo[NT][4];
#pragma unroll
  for (int dj = 0; dj < NT; ++dj) mo[dj][0] = mo[dj][1] = mo[dj][2] = mo[dj][3] = 0.f;
  float d0 = 0.f, d1 = 0.f;
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    const int it = nc + c;
    const bf16* ks = ready(it);
    const bf16* vs = ks + W::TILE;
    float s[8][4], dp[8][4];
    dots_wide<DH>(s, qs, ks);
    dots_wide<DH>(dp, dms, vs);
    chunk_probs(s, c * kAttnWideTile, n, t, a.scale_log2e, mx0, mx1, inv0, inv1);
    uint32_t pf[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kc + jj;
        if constexpr (DROP) apply_keep(dp[j], krow0 + 2 * c, krow1 + 2 * c, j, t, a.drop.inv);
        d0 += s[j][0] * dp[j][0] + s[j][1] * dp[j][1];
        d1 += s[j][2] * dp[j][2] + s[j][3] * dp[j][3];
      }
      if constexpr (DROP) {
        float lo[4] = {s[2 * kc][0], s[2 * kc][1], s[2 * kc][2], s[2 * kc][3]};
        float hi[4] = {s[2 * kc + 1][0], s[2 * kc + 1][1], s[2 * kc + 1][2], s[2 * kc + 1][3]};
        apply_keep(lo, krow0 + 2 * c, krow1 + 2 * c, 2 * kc, t, a.drop.inv);
        apply_keep(hi, krow0 + 2 * c, krow1 + 2 * c, 2 * kc + 1, t, a.drop.inv);
        acc_to_a_frag(pf[kc], lo, hi);
      } else {
        acc_to_a_frag(pf[kc], s[2 * kc], s[2 * kc + 1]);
      }
    }
    accumulate_wide<DH>(mo, pf, vs);
    release(it);
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  const int r0 = q0 + wr0, r1 = q0 + wr1;
  {
    bf16* mrow = a.out + img_row * inner + h * DH + 2 * t;
#pragma unroll
    for (int dj = 0; dj < NT; ++dj) {
      if (r0 < n) store_pair_wide(mrow + static_cast<size_t>(r0) * inner + dj * 8, mo[dj][0], mo[dj][1]);
      if (r1 < n) store_pair_wide(mrow + static_cast<size_t>(r1) * inner + dj * 8, mo[dj][2], mo[dj][3]);
    }
    if (t == 0) {  // the key pass's statistics; a row past n gets p = 0 there
      float* st = a.stats + (static_cast<size_t>(img) * a.heads + h) * 3 * np;
      st[r0] = r0 < n ? mx0 : 0.f, st[np + r0] = r0 < n ? inv0 : 0.f, st[2 * np + r0] = r0 < n ? d0 : 0.f;
      st[r1] = r1 < n ? mx1 : 0.f, st[np + r1] = r1 < n ? inv1 : 0.f, st[2 * np + r1] = r1 < n ? d1 : 0.f;
    }
  }

  // sweep 2: dp again, ds = bf16(p (dp - D)), dq += ds.k
  uint32_t raw0[NT], raw1[NT];  // QKNORM: the raw q rows the closing reads, in flight under the sweep
  if constexpr (QKNORM) {
    const bf16* raw = a.qkv + img_row * rstride + h * DH;
    load_raw_wide(raw0, raw + (r0 < n ? r0 : n - 1) * rstride, t);
    load_raw_wide(raw1, raw + (r1 < n ? r1 : n - 1) * rstride, t);
  }
  float dq[NT][4];
#pragma unroll
  for (int dj = 0; dj < NT; ++dj) dq[dj][0] = dq[dj][1] = dq[dj][2] = dq[dj][3] = 0.f;
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    const int it = 2 * nc + c;
    const bf16* ks = ready(it);
    const bf16* vs = ks + W::TILE;
    float s[8][4], dp[8][4];
    dots_wide<DH>(s, qs, ks);
    dots_wide<DH>(dp, dms, vs);
    chunk_probs(s, c * kAttnWideTile, n, t, a.scale_log2e, mx0, mx1, inv0, inv1);
    uint32_t sf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (DROP) apply_keep(dp[j], krow0 + 2 * c, krow1 + 2 * c, j, t, a.drop.inv);
      dp[j][0] = s[j][0] * (dp[j][0] - d0);
      dp[j][1] = s[j][1] * (dp[j][1] - d0);
      dp[j][2] = s[j][2] * (dp[j][2] - d1);
      dp[j][3] = s[j][3] * (dp[j][3] - d1);
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a_frag(sf[kc], dp[2 * kc], dp[2 * kc + 1]);
    accumulate_wide<DH>(dq, sf, ks);
    release(it);
  }
#pragma unroll
  for (int dj = 0; dj < NT; ++dj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dj][e] *= a.scale;
  }
  if constexpr (QKNORM) {
#pragma unroll
    for (int dj = 0; dj < NT; ++dj) {  // rows past n out of the column sums
      if (r0 >= n) dq[dj][0] = dq[dj][1] = 0.f;
      if (r1 >= n) dq[dj][2] = dq[dj][3] = 0.f;
    }
    rms_close_wide(dq, raw0, raw1, r0 < n ? rq[wr0] : 0.f, r1 < n ? rq[wr1] : 0.f, a.gq + h * DH, a.root,
                   colsum + warp * DH, g, t);
    __syncthreads();
    if (tid < DH)
      a.dg_partial[(static_cast<size_t>(img) * nq + qt) * 2 * inner + h * DH + tid] =
          ((colsum[tid] + colsum[DH + tid]) + colsum[2 * DH + tid]) + colsum[3 * DH + tid];
  }
  bf16* dqrow = a.dqkv + img_row * rstride + h * DH + 2 * t;
#pragma unroll
  for (int dj = 0; dj < NT; ++dj) {
    if (r0 < n) store_pair_wide(dqrow + r0 * rstride + dj * 8, dq[dj][0], dq[dj][1]);
    if (r1 < n) store_pair_wide(dqrow + r1 * rstride + dj * 8, dq[dj][2], dq[dj][3]);
  }
}

// ---------------------------------------------------------------------------
// the backward's key pass: dk and dv
// ---------------------------------------------------------------------------

template <int DH, bool DROP, bool QKNORM>
__global__ void __launch_bounds__(kAttnThreads, 2)
    attention_wide_bwd_kv_kernel(WideArgs a, const __grid_constant__ WideMaps maps) {
  using W = Wide<DH>;
  constexpr int NT = W::NT;
  extern __shared__ unsigned char wide_bwd_kv_raw[];
  unsigned char* smem = aligned_smem(wide_bwd_kv_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + W::TILE;
  bf16* ring = vs + W::TILE;  // stage s: q at ring + 2s TILE, dm after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 4 * W::TILE);
  float* st = reinterpret_cast<float*>(bars + 3);  // [3][64]: a query chunk's max, 1/sum, D
  float* rk = st + 3 * kAttnWideTile;              // QKNORM: [64]
  float* colsum = rk + kAttnWideTile;              // QKNORM: [4][DH]
  uint32_t* keep = reinterpret_cast<uint32_t*>(colsum + 4 * DH);  // DROP: [64 ceil(n / 64)][2]

  const int n = a.n, nq = (n + kAttnWideTile - 1) / kAttnWideTile, np = nq * kAttnWideTile;
  const int kt = blockIdx.x % nq, ih = blockIdx.x / nq, h = ih % a.heads, img = ih / a.heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int inner = a.heads * DH, k0 = kt * kAttnWideTile, nc = nq;
  constexpr int SWEEPS = W::SPLIT_KV ? 2 : 1;
  const int total = SWEEPS * nc;
  const size_t rstride = 3 * static_cast<size_t>(inner), img_row = static_cast<size_t>(img) * n;
  const float* stats = a.stats + (static_cast<size_t>(img) * a.heads + h) * 3 * np;

  auto issue = [&](int it) {  // every sweep: the chunk's q and dm
    bf16* sq = ring + (it & 1) * 2 * W::TILE;
    uint64_t* bar = bars + 1 + (it & 1);
    const int c = it % nc;
    mbar_expect(bar, 2 * W::BYTES);
    load_wide_tile<DH>(sq, &maps.qkv, h * DH, c * kAttnWideTile, img, bar);
    load_wide_tile<DH>(sq + W::TILE, &maps.dm, h * DH, c * kAttnWideTile, img, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + i);
    mbar_fence_init();
    mbar_expect(bars, 2 * W::BYTES);
    load_wide_tile<DH>(ks, &maps.qkv, inner + h * DH, k0, img, bars);
    load_wide_tile<DH>(vs, &maps.qkv, 2 * inner + h * DH, k0, img, bars);
    issue(0);
    if (total > 1) issue(1);
  }
  __syncthreads();
  if constexpr (DROP) {  // every query's keep bits against the tile's 64 keys, words (query, 2)
    for (int i = tid; i < np * 2; i += kAttnThreads) {
      const int q = i >> 1, col = k0 + 32 * (i & 1);
      uint32_t bits = 0u;
      if (q < n && col < n) {
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) bits |= keep_nibble(a.drop, dropout_stream(img, h), q, col / 4 + qq) << (4 * qq);
        if (n - col < 32) bits &= (1u << (n - col)) - 1u;
      }
      keep[i] = bits;
    }
  }
  mbar_wait(bars, 0);
  zero_pad_cols<DH>(ks, tid);
  zero_pad_cols<DH>(vs, tid);
  if constexpr (QKNORM) rms_norm_wide<DH>(ks, a.gk + h * DH, a.root, tid, rk);
  fence_proxy_async();
  __syncthreads();

  auto ready = [&](int it) -> bf16* {  // the stage's q and dm padded, q normed, the chunk's statistics in place
    bf16* sq = ring + (it & 1) * 2 * W::TILE;
    const int c = it % nc;
    for (int i = tid; i < 3 * kAttnWideTile; i += kAttnThreads)
      st[i] = stats[(i >> 6) * np + c * kAttnWideTile + (i & 63)];
    mbar_wait(bars + 1 + (it & 1), (it >> 1) & 1);
    zero_pad_cols<DH>(sq, tid);
    zero_pad_cols<DH>(sq + W::TILE, tid);
    if constexpr (QKNORM) rms_norm_wide<DH>(sq, a.gq + h * DH, a.root, tid, nullptr);
    fence_proxy_async();
    __syncthreads();
    return sq;
  };
  auto release = [&](int it) {
    __syncthreads();
    if (tid == 0 && it + 2 < total) issue(it + 2);
  };

  // this thread's keys wr0, wr1 of the tile share one 32-key word
  const int wr0 = warp * 16 + g, wr1 = wr0 + 8, kword = wr0 >> 5, kbit0 = wr0 & 31, kbit1 = kbit0 + 8;
  const bool kv0 = k0 + wr0 < n, kv1 = k0 + wr1 < n;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int dj = 0; dj < NT; ++dj) {
    dk[dj][0] = dk[dj][1] = dk[dj][2] = dk[dj][3] = 0.f;
    dv[dj][0] = dv[dj][1] = dv[dj][2] = dv[dj][3] = 0.f;
  }

  // one sweep over the query chunks: dv and / or dk (compile-time flags, so
  // no product sits in a branch)
  auto sweep = [&](int first, auto dv_flag, auto dk_flag) {
    constexpr bool do_dv = decltype(dv_flag)::value, do_dk = decltype(dk_flag)::value;
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const int it = first + c;
      const bf16* sq = ready(it);
      const bf16* sdm = sq + W::TILE;
      float pt[8][4], dpt[8][4];  // keys (rows) x the chunk's queries
      dots_wide<DH>(pt, ks, sq);
      if constexpr (do_dk) dots_wide<DH>(dpt, vs, sdm);
      uint32_t pf[4][4], sf[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = j * 8 + 2 * t + e;  // in the chunk
          const float mx = st[q], iv = st[kAttnWideTile + q], dd = st[2 * kAttnWideTile + q];
          const float p0 = kv0 ? exp2f(__fmul_rn(pt[j][e], a.scale_log2e) - mx) * iv : 0.f;
          const float p1 = kv1 ? exp2f(__fmul_rn(pt[j][2 + e], a.scale_log2e) - mx) * iv : 0.f;
          if constexpr (DROP) {  // ds takes the unmasked p; pd = where(keep, p, 0) * inv feeds dv
            const uint32_t kw = keep[2 * (c * kAttnWideTile + q) + kword];
            const bool keep0 = (kw >> kbit0) & 1u, keep1 = (kw >> kbit1) & 1u;
            if constexpr (do_dk) {
              dpt[j][e] = p0 * ((keep0 ? dpt[j][e] * a.drop.inv : 0.f) - dd);
              dpt[j][2 + e] = p1 * ((keep1 ? dpt[j][2 + e] * a.drop.inv : 0.f) - dd);
            }
            pt[j][e] = keep0 ? p0 * a.drop.inv : 0.f;
            pt[j][2 + e] = keep1 ? p1 * a.drop.inv : 0.f;
          } else {
            if constexpr (do_dk) {
              dpt[j][e] = p0 * (dpt[j][e] - dd);
              dpt[j][2 + e] = p1 * (dpt[j][2 + e] - dd);
            }
            pt[j][e] = p0;
            pt[j][2 + e] = p1;
          }
        }
      }
      if constexpr (do_dv) {
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a_frag(pf[kc], pt[2 * kc], pt[2 * kc + 1]);
        accumulate_wide<DH>(dv, pf, sdm);
      }
      if constexpr (do_dk) {
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a_frag(sf[kc], dpt[2 * kc], dpt[2 * kc + 1]);
        accumulate_wide<DH>(dk, sf, sq);
      }
      release(it);
    }
  };
  if constexpr (W::SPLIT_KV) {
    sweep(0, Flag<true>{}, Flag<false>{});
    sweep(nc, Flag<false>{}, Flag<true>{});
  } else {
    sweep(0, Flag<true>{}, Flag<true>{});
  }

  const int r0 = k0 + wr0, r1 = k0 + wr1;
#pragma unroll
  for (int dj = 0; dj < NT; ++dj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dj][e] *= a.scale;
  }
  if constexpr (QKNORM) {
    uint32_t raw0[NT], raw1[NT];
    const bf16* raw = a.qkv + img_row * rstride + inner + h * DH;
    load_raw_wide(raw0, raw + (r0 < n ? r0 : n - 1) * rstride, t);
    load_raw_wide(raw1, raw + (r1 < n ? r1 : n - 1) * rstride, t);
#pragma unroll
    for (int dj = 0; dj < NT; ++dj) {
      if (r0 >= n) dk[dj][0] = dk[dj][1] = 0.f;
      if (r1 >= n) dk[dj][2] = dk[dj][3] = 0.f;
    }
    rms_close_wide(dk, raw0, raw1, r0 < n ? rk[wr0] : 0.f, r1 < n ? rk[wr1] : 0.f, a.gk + h * DH, a.root,
                   colsum + warp * DH, g, t);
    __syncthreads();
    if (tid < DH)
      a.dg_partial[(static_cast<size_t>(img) * nq + kt) * 2 * inner + inner + h * DH + tid] =
          ((colsum[tid] + colsum[DH + tid]) + colsum[2 * DH + tid]) + colsum[3 * DH + tid];
  }
  bf16* krow = a.dqkv + img_row * rstride + inner + h * DH + 2 * t;
#pragma unroll
  for (int dj = 0; dj < NT; ++dj) {
    if (r0 < n) {
      store_pair_wide(krow + r0 * rstride + dj * 8, dk[dj][0], dk[dj][1]);
      store_pair_wide(krow + inner + r0 * rstride + dj * 8, dv[dj][0], dv[dj][1]);
    }
    if (r1 < n) {
      store_pair_wide(krow + r1 * rstride + dj * 8, dk[dj][2], dk[dj][3]);
      store_pair_wide(krow + inner + r1 * rstride + dj * 8, dv[dj][2], dv[dj][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_wide(K kernel, const WideArgs& a, const WideMaps& maps, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // two blocks an SM
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(a.batch) * a.heads * ((a.n + kAttnWideTile - 1) / kAttnWideTile);
  kernel<<<static_cast<unsigned>(blocks), kAttnThreads, smem, stream>>>(a, maps);
  return cudaGetLastError();
}

template <int DH>
cudaError_t wide_fwd(const WideArgs& a, const WideMaps& maps, bool drop, bool qk, cudaStream_t stream) {
  const int smem = wide_smem<DH>(1, 2, kAttnWideTile * wide_keep_words(a.n) * 4);
  auto kernel = drop ? (qk ? attention_wide_fwd_kernel<DH, true, true> : attention_wide_fwd_kernel<DH, true, false>)
                     : (qk ? attention_wide_fwd_kernel<DH, false, true> : attention_wide_fwd_kernel<DH, false, false>);
  return launch_wide(kernel, a, maps, smem, stream);
}

// the row pass, then the key pass (which reads the row pass's statistics)
template <int DH>
cudaError_t wide_bwd(const WideArgs& a, const WideMaps& maps, bool drop, bool qk, cudaStream_t stream) {
  const int np = (a.n + kAttnWideTile - 1) / kAttnWideTile * kAttnWideTile;
  const int norm_tail = (kAttnWideTile + 4 * DH) * 4;
  const int smem_q = wide_smem<DH>(2, 2, norm_tail + kAttnWideTile * wide_keep_words(a.n) * 4);
  const int smem_kv = wide_smem<DH>(2, 2, 3 * kAttnWideTile * 4 + norm_tail + np * 2 * 4);
  auto kq = drop ? (qk ? attention_wide_bwd_q_kernel<DH, true, true> : attention_wide_bwd_q_kernel<DH, true, false>)
                 : (qk ? attention_wide_bwd_q_kernel<DH, false, true> : attention_wide_bwd_q_kernel<DH, false, false>);
  auto kkv = drop ? (qk ? attention_wide_bwd_kv_kernel<DH, true, true> : attention_wide_bwd_kv_kernel<DH, true, false>)
                  : (qk ? attention_wide_bwd_kv_kernel<DH, false, true>
                        : attention_wide_bwd_kv_kernel<DH, false, false>);
  cudaError_t err = launch_wide(kq, a, maps, smem_q, stream);
  if (err != cudaSuccess) return err;
  return launch_wide(kkv, a, maps, smem_kv, stream);
}

}  // namespace

// one dh's two entry points (attention_wide_d<dh>.cu)
#define VIT_ATTN_WIDE_DEFINE(DH)                                                                                \
  cudaError_t attention_wide_fwd_d##DH(const WideArgs& a, const WideMaps& maps, bool drop, bool qk,            \
                                        cudaStream_t stream) {                                                 \
    return wide_fwd<DH>(a, maps, drop, qk, stream);                                                            \
  }                                                                                                            \
  cudaError_t attention_wide_bwd_d##DH(const WideArgs& a, const WideMaps& maps, bool drop, bool qk,            \
                                        cudaStream_t stream) {                                                 \
    return wide_bwd<DH>(a, maps, drop, qk, stream);                                                            \
  }
