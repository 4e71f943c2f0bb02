// The 64-row tile machinery of the port's flash backward kernels
// (flash_attention.cu; the forward kernels take its shapes and row helpers
// into attn_wgmma.cuh's wgmma machinery): one block of 4 warps a 64-row
// tile of queries (or keys), each warp 16 rows; the operand a warp keeps for
// its whole loop read once from device memory into mma A fragments; the
// tiles the loop walks brought through a cp.async ring in shared memory (rows
// kFlashLd apart, off the bank period), zero-filled past the sequence; the
// accumulator layout of one product reused as the A fragment of the next.
// Internal linkage, as common.cuh.
#pragma once

#include "common.cuh"

namespace {

constexpr int kFlashTile = 64;      // query rows and keys of one tile
constexpr int kFlashThreads = 128;  // 4 warps x 16 rows
constexpr int kFlashDh = kAttnDh;   // 64
constexpr int kFlashLd = kAttnLd;   // 72: shared-memory row stride
constexpr int kTileElems = kFlashTile * kFlashLd;
constexpr float kNegInf = -1e30f;  // _NEG_INF, the LSE of a fully masked row
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, row;  // elements; the head dim (or a bias row) is contiguous
};

template <typename T>
__device__ __forceinline__ T* head_ptr(T* p, const Strides& s, int b, int h) {
  return p + b * s.b + h * s.h;
}

// One 64-row tile of a (b, h) slice into shared memory (ld kFlashLd), rows
// r0.. of row stride `stride`; rows >= len are zero-filled.  All threads.
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long stride, int r0, int len) {
#pragma unroll
  for (int i = 0; i < kFlashTile * (kFlashDh / 8) / kFlashThreads; ++i) {
    const int c = threadIdx.x + i * kFlashThreads;
    const int r = c / (kFlashDh / 8), d = (c % (kFlashDh / 8)) * 8;
    const bool ok = r0 + r < len;
    cp_async_16_zfill(dst + r * kFlashLd + d, ok ? src + (r0 + r) * stride + d : src, ok);
  }
}

// The A fragments (16 rows x 64 columns, four k16 steps) of rows row_lo and
// row_lo + 8 of a strided (rows, 64) operand in device memory, read once;
// rows >= len read as zeros.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[kFlashDh / 16][4], const bf16* base, long long stride,
                                            int row_lo, int len, int t) {
  const bool ok0 = row_lo < len, ok1 = row_lo + 8 < len;
  const bf16* p0 = base + row_lo * stride + 2 * t;
  const bf16* p1 = p0 + 8 * stride;
#pragma unroll
  for (int kk = 0; kk < kFlashDh / 16; ++kk) {
    a[kk][0] = ok0 ? ld_pair(p0 + kk * 16) : 0u;
    a[kk][1] = ok1 ? ld_pair(p1 + kk * 16) : 0u;
    a[kk][2] = ok0 ? ld_pair(p0 + kk * 16 + 8) : 0u;
    a[kk][3] = ok1 ? ld_pair(p1 + kk * 16 + 8) : 0u;
  }
}

// acc (16 rows x 64 columns as 8 tiles of 16x8) = A . X^T, X a 64-row tile
// in shared memory whose rows are the columns of the product
__device__ __forceinline__ void mma_rows_t(float (&acc)[8][4], const uint32_t (&a)[kFlashDh / 16][4], const bf16* x,
                                           int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kFlashDh / 16; ++kk) {
      uint32_t b[2];
      load_b_frag_rows(b, x + j * 8 * kFlashLd + kk * 16, kFlashLd, g, t);
      mma_16816(acc[j], a[kk], b);
    }
  }
}

// acc (16 rows x 64 head columns) += P . X, P given as four bf16 A fragments
// over the 64 rows of the tile X (shared memory)
__device__ __forceinline__ void mma_acc(float (&acc)[8][4], const uint32_t (&p)[4][4], const bf16* x, int g, int t) {
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t b[2];
      load_b_frag_cols(b, x + kc * 16 * kFlashLd + dj * 8, kFlashLd, g, t);
      mma_16816(acc[dj], p[kc], b);
    }
  }
}

// the 64 columns of 16 accumulator rows as four bf16 A fragments
__device__ __forceinline__ void to_a_frags(uint32_t (&f)[4][4], const float (&acc)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) acc_to_a_frag(f[kc], acc[2 * kc], acc[2 * kc + 1]);
}

// a 16-row x 64 accumulator block (rows row_lo, row_lo + 8 of this thread),
// times mul, cast to bf16 into rows < len of a strided operand
__device__ __forceinline__ void store_rows(bf16* base, long long stride, const float (&acc)[8][4], float mul0,
                                           float mul1, int row_lo, int len, int t) {
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) {
    const int col = dj * 8 + 2 * t;
    if (row_lo < len)
      *reinterpret_cast<uint32_t*>(base + row_lo * stride + col) = pack_floats(acc[dj][0] * mul0, acc[dj][1] * mul0);
    if (row_lo + 8 < len)
      *reinterpret_cast<uint32_t*>(base + (row_lo + 8) * stride + col) =
          pack_floats(acc[dj][2] * mul1, acc[dj][3] * mul1);
  }
}

}  // namespace
