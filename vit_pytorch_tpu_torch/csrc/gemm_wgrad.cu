// Hopper (sm_90a) weight-gradient product of the whole-layer and FF
// backwards: C[M, N] (f32) = A^T . B = sum over k of A[k, m] B[k, n], with A
// (K, M) and B (K, N) bf16 row-major, K the row axis of the batch (b*n).
//
// Replaces: the dW accumulators of ops/fused_block.py::_ff_bwd_kernel (full
// mode, :1573-1580: dW2 += act^T . g, dW1 += y2^T . dh1) and of
// _layer_bwd_kernel (:1245-1252, :1321-1333: the same two, dW_out += m^T .
// dy, dW_qkv += h^T . dqkv).  Those kernels add a rank-(row tile) update to an
// f32 VMEM accumulator at every step of a sequential grid.  Here one launch
// computes the whole sum over K; the port's (out, in) weight layout is the
// transpose of JAX's (in, out), which is had by swapping the operands (dW1 =
// dh1^T . y2), never by copying one.
// Bound on this card: tensor-core throughput.  At ViT-B bs=1024 K = 201,728
// and a (768 x 3072) dW is 0.952 TFLOP against ~0.8 GB of operands, ~1,200
// flops a byte, far above the ~295 flop/byte ridge.
// Design: the first port's gemm_bf16 main loop (layer_tiles.cuh's
// gemm_tile) with both operands MN-major: a 64 (k) x 128 (m or n) tile of A or B is 64 rows of 256
// contiguous bytes in device memory, so it loads as is (16-byte cp.async,
// neighbouring threads on neighbouring chunks) into 128-byte-swizzle atoms of
// 8 k rows x 64 elements, and wgmma reads it with its transpose flag set: no
// transposed copy of the (K, M) activations (1.24 GB at bs=1024) is made.
// 128x128x64 block tiles, two warpgroups of 64 rows, the 3-stage ring.  The
// output has few tiles (dW_out: 36 of 128x128) against 132 SMs and a long K,
// so K is split: grid.z = splits contiguous ranges of k-tiles, each block
// writes its f32 partial tile to its own slice of a (splits, M, N) scratch
// buffer, and a second kernel adds the slices in split order.  No atomics:
// the result is bitwise deterministic.  The split count is a function of the
// shape and the SM count only (at least two waves of blocks, the count with
// the least idle tail).  The K edge is zero-filled (cp.async with src-size
// 0); M and N must be multiples of 8 (ragged edges clamp and mask).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 64;
constexpr int kWgStages = 3, kWgPrefetch = kWgStages - 2;  // the stage a load fills is not read by the wgmma in flight
constexpr int kWgThreads = 256;                            // 2 warpgroups of 64 rows of C
constexpr int kWgATile = kWgBK * kWgBM, kWgBTile = kWgBK * kWgBN;  // elements
constexpr int kWgSmem = kWgStages * (kWgATile + kWgBTile) * static_cast<int>(sizeof(bf16)) + 1024;
constexpr int kWgAtom = 8 * 64;  // elements of one swizzle atom: 8 k rows x 64 bf16, 1024 bytes
// descriptor strides of the tiles below: 64-wide MN groups 8 atoms apart,
// 8-row K groups one atom apart
constexpr uint32_t kWgLbo = 8 * kWgAtom * sizeof(bf16), kWgSbo = kWgAtom * sizeof(bf16);
constexpr int kWgBlocksPerSm = 2;

// Element (k, c) of a 64 x 128 tile (c along M or N) sits in atom (c / 64) *
// 8 + k / 8, row k % 8, 16-byte chunk ((c % 64) / 8) ^ (k % 8): the same
// 128-byte swizzle as gemm_bf16's K-major tiles, with k as the row.
__device__ __forceinline__ int wgrad_tile_offset(int k, int c16) {
  return ((c16 >> 3) * 8 + (k >> 3)) * kWgAtom + (k & 7) * 64 + (((c16 & 7) ^ (k & 7)) << 3);
}

__global__ void __launch_bounds__(kWgThreads, kWgBlocksPerSm)
gemm_wgrad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ out, int M, int N, int K,
                  int tiles_per_split) {
  extern __shared__ unsigned char wgrad_smem[];
  bf16* As = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(wgrad_smem) + 1023) & ~uintptr_t(1023));
  bf16* Bs = As + kWgStages * kWgATile;

  const int tid = threadIdx.x, wg = tid >> 7, wwarp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kWgBN, m0 = blockIdx.y * kWgBM;
  const int ktiles = (K + kWgBK - 1) / kWgBK;
  const int kt0 = blockIdx.z * tiles_per_split, nt = min(ktiles, kt0 + tiles_per_split) - kt0;
  float* dst = out + static_cast<size_t>(blockIdx.z) * M * N;  // this split's slice

  // 16 chunks of 16 bytes a k row; rows past K read as zeros
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * kWgBK;
    bf16* as = As + stage * kWgATile;
    bf16* bs = Bs + stage * kWgBTile;
#pragma unroll
    for (int i = 0; i < kWgATile / 8 / kWgThreads; ++i) {
      const int q = tid + i * kWgThreads, k = q >> 4, c16 = q & 15;
      const bool valid = k0 + k < K;
      const size_t row = static_cast<size_t>(valid ? k0 + k : 0);
      cp_async_16_zfill(as + wgrad_tile_offset(k, c16), A + row * M + min(m0 + c16 * 8, M - 8), valid);
      cp_async_16_zfill(bs + wgrad_tile_offset(k, c16), B + row * N + min(n0 + c16 * 8, N - 8), valid);
    }
  };

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_operands(d, 64);

#pragma unroll
  for (int s = 0; s < kWgPrefetch; ++s) {
    if (s < nt) load_tile(s, kt0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kWgPrefetch - 1>();
    fence_proxy_async();
    __syncthreads();  // tile i landed; every warpgroup is done with tile i-2's stage
    const int ni = i + kWgPrefetch;
    if (ni < nt) load_tile(ni % kWgStages, kt0 + ni);
    cp_async_commit();

    const bf16* as = As + (i % kWgStages) * kWgATile + wg * 8 * kWgAtom;  // this warpgroup's 64 columns of A
    const bf16* bs = Bs + (i % kWgStages) * kWgBTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)  // k16 step kk: the atoms of k rows 16kk .. 16kk + 15
      wgmma_m64n128k16<1, 1>(d, wgmma_desc_sw128(as + 2 * kk * kWgAtom, kWgLbo, kWgSbo),
                             wgmma_desc_sw128(bs + 2 * kk * kWgAtom, kWgLbo, kWgSbo));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_operands(d, 64);

  // accumulator layout: warp w of the warpgroup holds rows 16w + (g, g+8),
  // and d[4j..4j+3] their columns 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    if (col >= N) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wg * 64 + wwarp * 16 + g + half * 8;
      if (row < M)
        *reinterpret_cast<float2*>(dst + static_cast<size_t>(row) * N + col) =
            make_float2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
    }
  }
}

// out[i] = sum over s of partial[s][i], s in order (float4 a thread)
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const float4* __restrict__ partial, float4* __restrict__ out, size_t n4, int splits) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float4 acc = partial[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v = partial[s * n4 + i];
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    out[i] = acc;
  }
}

// k-tiles of one split, for `splits` splits of `ktiles`
int tiles_per_split(int ktiles, int splits) { return (ktiles + splits - 1) / splits; }

int wgrad_splits(int M, int N, int K) {
  const int tiles = ((M + kWgBM - 1) / kWgBM) * ((N + kWgBN - 1) / kWgBN);
  const int ktiles = (K + kWgBK - 1) / kWgBK;
  const int slots = kWgBlocksPerSm * sm_count();
  const int lo = std::min(ktiles, std::max(1, (2 * slots + tiles - 1) / tiles));
  int best = 1;
  double best_eff = -1.0;
  for (int s = lo; s <= std::min(2 * lo, ktiles); ++s) {
    const int used = (ktiles + tiles_per_split(ktiles, s) - 1) / tiles_per_split(ktiles, s);  // non-empty splits
    const long long blocks = static_cast<long long>(tiles) * used;
    const long long waves = (blocks + slots - 1) / slots;
    const double eff = static_cast<double>(blocks) / static_cast<double>(waves * slots);
    if (eff > best_eff + 1e-9) best = used, best_eff = eff;
  }
  return best;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes).  a (K, M) and b (K, N) bf16, out (M, N) f32, partial
// a (splits, M, N) f32 scratch buffer when splits > 1 (else null); the
// wrapper in ops/fused_block.py asks vit_gemm_wgrad_splits for the count.
// ---------------------------------------------------------------------------

extern "C" {

int vit_gemm_wgrad_splits(int M, int N, int K) { return (M > 0 && N > 0 && K > 0) ? wgrad_splits(M, N, K) : 0; }

int vit_gemm_wgrad(const void* a, const void* b, void* out, void* partial, int M, int N, int K, int splits,
                   void* stream) {
  if (M < 8 || N < 8 || K <= 0 || M % 8 || N % 8 || (M + kWgBM - 1) / kWgBM > 65535 || splits < 1 ||
      splits > 65535 || (splits > 1) != (partial != nullptr))
    return cudaErrorInvalidValue;
  const int ktiles = (K + kWgBK - 1) / kWgBK;
  const int per = tiles_per_split(ktiles, splits);
  if ((ktiles + per - 1) / per != splits) return cudaErrorInvalidValue;  // an empty split
  cudaError_t err = cudaFuncSetAttribute(gemm_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  const dim3 grid((N + kWgBN - 1) / kWgBN, (M + kWgBM - 1) / kWgBM, splits);
  gemm_wgrad_kernel<<<grid, kWgThreads, kWgSmem, s>>>(static_cast<const bf16*>(a), static_cast<const bf16*>(b), dst,
                                                       M, N, K, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n4 = static_cast<size_t>(M) * N / 4;
  const int blocks = static_cast<int>(std::min(static_cast<size_t>(8 * sm_count()), (n4 + 255) / 256));
  wgrad_reduce_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(partial), static_cast<float4*>(out), n4,
                                             splits);
  return cudaGetLastError();
}

}  // extern "C"
