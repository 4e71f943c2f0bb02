// Helpers and shapes shared by the port's Hopper kernels (fused_layer.cu,
// gemm_bf16.cu, attention_rows.cu, fused_layer_bwd.cu, gemm_wgrad.cu,
// dropout.cu, flash_attention.cu, short_attention.cu, stack_layers.cu).
// Everything here has internal linkage (each source that includes it gets its
// own copy), apart from launch_column_sum, declared here and defined once in
// fused_layer_bwd.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// attention kernels (attention_rows and attention_bwd_rows): one head of
// dim 64, at most 16 * kAttnKT = 208 keys (ViT-B/16 @224 has 197 tokens);
// attention_rows runs ceil(n / 16) chunks of 16 (attention_rows.cu),
// attention_bwd_rows all 13
constexpr int kAttnQT = 64;        // rows (queries, or keys in the key pass) per block
constexpr int kAttnThreads = 128;  // 4 warps x 16 rows
constexpr int kAttnDh = 64;
constexpr int kAttnLd = kAttnDh + 8;  // shared-memory row stride: 144 bytes, off the bank period
constexpr int kAttnKT = 13;           // 16-row chunks of the padded sequence
constexpr int kKeepWords = (16 * kAttnKT + 31) / 32;  // 32-key words of one keep row (7)

// In-kernel dropout (the JAX package's _kernel / _bwd_kernel / dropout_masks,
// ops/fused_block.py:150-222).  The TPU kernels seed the TPU PRNG per
// (seed, img * 1024 + head) and draw uint32 bits; here the same pair is the
// key of a counter-based Philox4x32-10, and the counter is (row, col / 4, 0,
// 0): word col % 4 of the result is the element's bits, kept iff bits >=
// threshold = min(int(rate * 2^32), 2^32 - 1) (_dropout_threshold :150-152).
// So a keep bit is a pure function of (seed, img, head, row, col): the
// forward, both backward passes and the replay kernel draw the same mask in
// any order.  The output dropout after the projection is stream head =
// heads (_out_keep :182-187).  The bits are not the TPU's.
struct DropoutArgs {
  uint32_t seed;       // the int32 seed's bit pattern
  uint32_t threshold;  // keep iff bits >= threshold
  float inv;           // 1 / (1 - rate), applied in f32
};

// sums[c] = factor * sum over r of partial[r][c] for a (rows, width) f32
// buffer, in a fixed order (deterministic): the second pass of every
// column sum that blocks write as per-block partial rows (fused_layer_bwd.cu)
cudaError_t launch_column_sum(const float* partial, float* sums, int rows, int width, float factor,
                              cudaStream_t stream);

namespace {

// the SMs of the current device (132 on an H100 SXM if the query fails)
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                cudaSuccess)
    return 132;
  return sms;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}

// 16 bytes, or 16 zero bytes when !valid (gmem is then not read)
__device__ __forceinline__ void cp_async_16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32 with 10 rounds)
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// the Philox key's second word for (image, head); head = heads is the
// output-dropout stream
__device__ __forceinline__ uint32_t dropout_stream(int img, int head) {
  return static_cast<uint32_t>(img) * 1024u + static_cast<uint32_t>(head);
}

// keep bits of columns 4*c4 .. 4*c4 + 3 of one row of a stream, in bits 0..3
__device__ __forceinline__ uint32_t keep_nibble(const DropoutArgs& d, uint32_t stream, int row, int c4) {
  const uint4 r = philox4x32_10(make_uint4(static_cast<uint32_t>(row), static_cast<uint32_t>(c4), 0u, 0u),
                                make_uint2(d.seed, stream));
  return static_cast<uint32_t>(r.x >= d.threshold) | (static_cast<uint32_t>(r.y >= d.threshold) << 1) |
         (static_cast<uint32_t>(r.z >= d.threshold) << 2) | (static_cast<uint32_t>(r.w >= d.threshold) << 3);
}

// A block's keep tile, bit-packed in shared memory: words[r * WORDS + w] bit
// i is the keep bit of row r0 + r, column c0 + 32w + i (c0 a multiple of 4);
// rows >= n_rows and columns >= n_cols read 0.  All THREADS threads of the
// block; each word is 8 Philox calls, so the attention loops read one shared
// word per element pair instead of drawing bits in their register-bound
// bodies.
template <int ROWS, int WORDS, int THREADS = kAttnThreads>
__device__ __forceinline__ void fill_keep_tile(uint32_t* words, const DropoutArgs& d, uint32_t stream, int r0, int c0,
                                               int n_rows, int n_cols) {
  for (int i = threadIdx.x; i < ROWS * WORDS; i += THREADS) {
    const int r = i / WORDS, w = i % WORDS;
    const int col = c0 + 32 * w;
    uint32_t bits = 0u;
    if (r0 + r < n_rows && col < n_cols) {
#pragma unroll
      for (int q = 0; q < 8; ++q) bits |= keep_nibble(d, stream, r0 + r, col / 4 + q) << (4 * q);
      if (n_cols - col < 32) bits &= (1u << (n_cols - col)) - 1u;
    }
    words[i] = bits;
  }
}

// f32 accumulator tile j of rows (g, g+8) x columns (8j + 2t, +1) times the
// keep bits of those columns in the keep rows krow0, krow1, and inv:
// where(keep, v, 0) * inv (_kernel :345-348, _bwd_kernel :634-654)
__device__ __forceinline__ void apply_keep(float v[4], const uint32_t* krow0, const uint32_t* krow1, int j, int t,
                                           float inv) {
  const int c = 8 * j + 2 * t;
  const uint32_t b0 = krow0[c >> 5] >> (c & 31), b1 = krow1[c >> 5] >> (c & 31);
  v[0] = (b0 & 1u) ? v[0] * inv : 0.f;
  v[1] = (b0 & 2u) ? v[1] * inv : 0.f;
  v[2] = (b1 & 1u) ? v[2] * inv : 0.f;
  v[3] = (b1 & 2u) ? v[3] * inv : 0.f;
}

// D = A(16x16, row) . B(16x8, col) + D, bf16 operands, f32 accumulators.
// Fragment layout (g = lane / 4, t = lane % 4): A holds rows (g, g+8) x
// columns (2t, 2t+1) and (2t+8, 2t+9); B holds k rows (2t, 2t+1) and
// (2t+8, 2t+9) of column g; D holds rows (g, g+8) x columns (2t, 2t+1).
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two neighbouring bf16 (the lower index in the low half), as one register
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the 4 lanes of a quad (one accumulator row) share a row statistic
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A fragment of a 16x16 tile whose rows sit in shared memory with leading
// dimension ld, from its top-left element p
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const bf16* p, int ld, int g, int t) {
  const bf16* r = p + g * ld + 2 * t;
  a[0] = ld_pair(r);
  a[1] = ld_pair(r + 8 * ld);
  a[2] = ld_pair(r + 8);
  a[3] = ld_pair(r + 8 * ld + 8);
}

// B fragment (16 k x 8 n) of X^T, X row-major in shared memory with rows
// indexed by n and columns by k: two contiguous pairs of row g
__device__ __forceinline__ void load_b_frag_rows(uint32_t b[2], const bf16* p, int ld, int g, int t) {
  const bf16* r = p + g * ld + 2 * t;
  b[0] = ld_pair(r);
  b[1] = ld_pair(r + 8);
}

// B fragment (16 k x 8 n) of X, X row-major in shared memory with rows
// indexed by k and columns by n: column g, k rows (2t, 2t+1), (2t+8, 2t+9)
__device__ __forceinline__ void load_b_frag_cols(uint32_t b[2], const bf16* p, int ld, int g, int t) {
  const bf16* c = p + (2 * t) * ld + g;
  b[0] = pack_bf16(c[0], c[ld]);
  b[1] = pack_bf16(c[8 * ld], c[9 * ld]);
}

// Accumulator tiles 2j, 2j+1 (16 rows x 16 columns) as the A fragment of
// the next product: the column axis of one product is the k axis of the next.
__device__ __forceinline__ void acc_to_a_frag(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_floats(lo[0], lo[1]);
  a[1] = pack_floats(lo[2], lo[3]);
  a[2] = pack_floats(hi[0], hi[1]);
  a[3] = pack_floats(hi[2], hi[3]);
}

// ROWS rows from r0 of one head's 64 columns into shared memory (leading
// dimension kAttnLd), zero-filled from row n on; all kAttnThreads threads of
// the block (tid their index in it; a warpgroup of a larger block passes its
// own).  The trip count is a constant, so the loop unrolls and every
// thread's loads are in flight at once.
template <int ROWS>
__device__ __forceinline__ void load_head_rows(bf16* dst, const bf16* src, size_t stride, int r0, int n, int tid) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int c = tid; c < ROWS * (kAttnDh / 8); c += kAttnThreads) {
    const int r = c / (kAttnDh / 8), d = (c % (kAttnDh / 8)) * 8;
    uint4 v = zero;
    if (r0 + r < n) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + d);
    *reinterpret_cast<uint4*>(dst + r * kAttnLd + d) = v;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_head_rows(bf16* dst, const bf16* src, size_t stride, int r0, int n) {
  load_head_rows<ROWS>(dst, src, stride, r0, n, threadIdx.x);
}

// qk-norm: the per-head RMSNorm of _kernel (:323-338) and _bwd_kernel
// (:614-627), reference na_vit.py:93-103.  Each 64-wide q or k row x becomes
//   bf16((x * rsqrt(sum(x^2) + 1e-12)) * (gamma * sqrt(64)))
// with the statistic in f32 (a sum, not a mean) and both products in f32.
constexpr float kRmsEps = 1e-12f;
constexpr float kRmsRoot = 8.0f;  // sqrt(kAttnDh)

__device__ __forceinline__ void unpack8(float f[8], uint4 u) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x, f[2 * i + 1] = v.y;
  }
}

// gammas c .. c + 7 of a head's row as f32: bf16 (the attention block's) or
// f32 (the flash kernels')
__device__ __forceinline__ void load_gamma8(float g[8], const bf16* p) {
  unpack8(g, *reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void load_gamma8(float g[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p), hi = *reinterpret_cast<const float4*>(p + 4);
  g[0] = lo.x, g[1] = lo.y, g[2] = lo.z, g[3] = lo.w, g[4] = hi.x, g[5] = hi.y, g[6] = hi.z, g[7] = hi.w;
}

// Normalise ROWS rows (64 bf16 each, leading dimension LD) of shared memory
// in place.  All THREADS threads of the block, 8 to a row, each one 16-byte
// chunk; the row's sum of squares is reduced over its 8 lanes by shuffles,
// so ROWS * 8 is a multiple of the block and every lane takes part.  gamma:
// the head's 64 gammas (bf16 or f32; device or shared memory).  With raw,
// each row's input is copied there first (leading dimension LD); with r, its
// rsqrt is stored there (the backward's closing of the norm needs both).
template <int ROWS, int LD = kAttnLd, int THREADS = kAttnThreads, typename G = bf16>
__device__ __forceinline__ void rms_norm_rows(bf16* rows, const G* __restrict__ gamma, bf16* raw, float* r) {
  static_assert((ROWS * 8) % THREADS == 0, "8 lanes a row, every lane busy");
  const int c = (threadIdx.x & 7) * 8;
  float g8[8];
  load_gamma8(g8, gamma + c);
#pragma unroll
  for (int i = 0; i < 8; ++i) g8[i] *= kRmsRoot;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * 8; i += THREADS) {
    const int row = i >> 3;
    bf16* p = rows + row * LD + c;
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    if (raw) *reinterpret_cast<uint4*>(raw + row * LD + c) = u;
    float f[8];
    unpack8(f, u);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 4);
    const float rr = rsqrtf(ss + kRmsEps);
    if (r && c == 0) r[row] = rr;
    uint4 o;
    uint32_t* po = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) po[j] = pack_floats(f[2 * j] * rr * g8[2 * j], f[2 * j + 1] * rr * g8[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = o;
  }
}

// The norm's backward (_bwd_kernel :665-673) on one warp's 16 rows of f32
// gradients d of the normed rows, in the accumulator layout (rows g, g + 8;
// columns 8dj + 2t, +1).  With xhat = raw * r (f32, as the forward computed
// it) and g8 = gamma * sqrt(64):
//   colsum[c] = sum over the warp's rows of d * xhat      (dgamma / sqrt(64))
//   d        <- r * (d*g8 - xhat * sum_c(d*g8 * xhat))
// raw_rows: the warp's 16 raw rows in shared memory (ld kAttnLd), r_rows
// their rsqrt, colsum the warp's 64 floats of shared memory.
template <int DT>
__device__ __forceinline__ void rms_norm_bwd_rows(float (&d)[DT][4], const bf16* raw_rows, const float* r_rows,
                                                  const bf16* __restrict__ gamma, float* colsum, int g, int t) {
  const float r0 = r_rows[g], r1 = r_rows[g + 8];
  const bf16* raw0 = raw_rows + g * kAttnLd + 2 * t;
  const bf16* raw1 = raw0 + 8 * kAttnLd;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int dj = 0; dj < DT; ++dj) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(raw0 + dj * 8));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(raw1 + dj * 8));
    const float2 gg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gamma + dj * 8 + 2 * t));
    const float x0 = a.x * r0, y0 = a.y * r0, x1 = b.x * r1, y1 = b.y * r1;
    float px = d[dj][0] * x0 + d[dj][2] * x1, py = d[dj][1] * y0 + d[dj][3] * y1;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {  // over g: the lanes of one t
      px += __shfl_xor_sync(0xffffffffu, px, o);
      py += __shfl_xor_sync(0xffffffffu, py, o);
    }
    if (g == 0) colsum[dj * 8 + 2 * t] = px, colsum[dj * 8 + 2 * t + 1] = py;
    d[dj][0] *= gg.x * kRmsRoot, d[dj][1] *= gg.y * kRmsRoot;
    d[dj][2] *= gg.x * kRmsRoot, d[dj][3] *= gg.y * kRmsRoot;
    s0 += d[dj][0] * x0 + d[dj][1] * y0;
    s1 += d[dj][2] * x1 + d[dj][3] * y1;
  }
  s0 = quad_sum(s0);
  s1 = quad_sum(s1);
#pragma unroll
  for (int dj = 0; dj < DT; ++dj) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(raw0 + dj * 8));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(raw1 + dj * 8));
    d[dj][0] = r0 * (d[dj][0] - a.x * r0 * s0);
    d[dj][1] = r0 * (d[dj][1] - a.y * r0 * s0);
    d[dj][2] = r1 * (d[dj][2] - b.x * r1 * s1);
    d[dj][3] = r1 * (d[dj][3] - b.y * r1 * s1);
  }
}

// The block's dgamma partial of one head: the 4 warps' column sums (4 x 64
// floats of shared memory) added in warp order by threads 0..63, into
// out[0..63] (device memory).  After a __syncthreads.
__device__ __forceinline__ void store_colsum(float* __restrict__ out, const float* colsum) {
  if (threadIdx.x < kAttnDh) {
    const float* c = colsum + threadIdx.x;
    out[threadIdx.x] = ((c[0] + c[kAttnDh]) + c[2 * kAttnDh]) + c[3 * kAttnDh];
  }
}

// One warp's logits for its 16 rows q_rows (shared memory, ld kAttnLd)
// against the NT * 8 rows k_rows: s[j] holds rows (g, g+8) x keys
// (8j + 2t, 8j + 2t + 1), f32.
template <int NT>
__device__ __forceinline__ void qk_logits(float (&s)[NT][4], const bf16* q_rows, const bf16* k_rows, int g, int t) {
  uint32_t qf[kAttnDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kAttnDh / 16; ++kk) load_a_frag(qf[kk], q_rows + kk * 16, kAttnLd, g, t);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kAttnDh / 16; ++kk) {
      uint32_t b[2];
      load_b_frag_rows(b, k_rows + j * 8 * kAttnLd + kk * 16, kAttnLd, g, t);
      mma_16816(s[j], qf[kk], b);
    }
  }
}

// The exact two-pass softmax of _softmax_from_dots (ops/fused_block.py:82-93)
// over the logits in registers, in place: scale*log2(e) folded into one
// multiply, keys >= n masked to -inf, max, exp2, one reciprocal of the row
// sum.  Leaves s = p in f32 and each row's max (of the scaled logits) and
// 1/sum, for the rows g (mx0, inv0) and g+8 (mx1, inv1).
template <int NT>
__device__ __forceinline__ void softmax_rows(float (&s)[NT][4], int n, int t, float scale_log2e, float& mx0,
                                             float& mx1, float& inv0, float& inv1) {
  mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool valid = j * 8 + 2 * t + e < n;
      s[j][e] = valid ? s[j][e] * scale_log2e : -CUDART_INF_F;
      s[j][2 + e] = valid ? s[j][2 + e] * scale_log2e : -CUDART_INF_F;
      mx0 = fmaxf(mx0, s[j][e]);
      mx1 = fmaxf(mx1, s[j][2 + e]);
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = exp2f(s[j][e] - mx0);
      s[j][2 + e] = exp2f(s[j][2 + e] - mx1);
      sum0 += s[j][e];
      sum1 += s[j][2 + e];
    }
  }
  inv0 = 1.f / quad_sum(sum0);
  inv1 = 1.f / quad_sum(sum1);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] *= inv0;
    s[j][1] *= inv0;
    s[j][2] *= inv1;
    s[j][3] *= inv1;
  }
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a): gemm_bf16 (gemm_bf16.cu, stack_layers.cu) and gemm_wgrad
// (gemm_wgrad.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async writes shared memory through the generic proxy; wgmma reads it
// through the async proxy
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// keep the compiler from moving accumulator reads across the async wgmma
__device__ __forceinline__ void fence_operands(float* d, int n) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (bits 16-29 and 32-45, in 16-byte units).
// K-major tiles (rows of 64 bf16 along K): lbo unused, sbo = 1024, the 8-row
// group stride.  MN-major tiles (rows of 64 bf16 along M or N, one row a k):
// lbo = the stride between 64-wide groups along M or N, sbo = the stride
// between 8-row groups along K.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const bf16* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// D(64x128, f32 regs) += A(64x16) . B(16x128), both in 128B-swizzled shared
// memory given by descriptors; TRANS_A/TRANS_B = 0: the operand is K-major,
// 1: MN-major (the transpose wgmma takes for 16-bit types); accumulates
// (scale-d = 1)
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float d[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

}  // namespace
