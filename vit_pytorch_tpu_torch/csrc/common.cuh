// Helpers and shapes shared by the port's Hopper kernels (fused_layer.cu,
// fused_layer_bwd.cu).  Everything here has internal linkage: each source
// that includes it gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// attention kernels (attention_rows and attention_bwd_rows): one head of
// dim 64, keys padded to 16 * kAttnKT = 208 (ViT-B/16 @224 has 197 tokens)
constexpr int kAttnQT = 64;        // rows (queries, or keys in the key pass) per block
constexpr int kAttnThreads = 128;  // 4 warps x 16 rows
constexpr int kAttnDh = 64;
constexpr int kAttnLd = kAttnDh + 8;  // shared-memory row stride: 144 bytes, off the bank period
constexpr int kAttnKT = 13;           // 16-row chunks of the padded sequence

namespace {

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
// the block.  The trip count is a constant, so the loop unrolls and every
// thread's loads are in flight at once.
template <int ROWS>
__device__ __forceinline__ void load_head_rows(bf16* dst, const bf16* src, size_t stride, int r0, int n) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * (kAttnDh / 8); c += kAttnThreads) {
    const int r = c / (kAttnDh / 8), d = (c % (kAttnDh / 8)) * 8;
    uint4 v = zero;
    if (r0 + r < n) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + d);
    *reinterpret_cast<uint4*>(dst + r * kAttnLd + d) = v;
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

}  // namespace
