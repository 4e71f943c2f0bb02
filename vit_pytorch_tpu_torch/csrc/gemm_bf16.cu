// Hopper (sm_90a) kernel gemm_bf16: C = A . W^T of bf16 operands (W in
// nn.Linear's (out, in) layout) with the epilogue of its call site, every
// site of the layer chain: qkv (and cast), out, fc1, fc2, the attention
// block's block_out (with and without dropout), the tools' fc1_f32, the f32
// store of gemm_f32out, and the FF backward's fc1_save and gelu_bwd.
//
// Replaces: the jnp.dot sites of vit_pytorch_tpu/ops/fused_block.py::
// _layer_kernel (qkv :1015, out-proj :1040, fc1 :1046, fc2 :1048), the out
// projection of _kernel (:357-374), dh = dqkv . Wqkv^T of _bwd_kernel
// (:695-700), the fc1 recompute and dact/GELU' lines of _ff_bwd_kernel
// (:1553-1567) and _layer_bwd_kernel (:1229-1243), and the products of the
// layer prototypes in tools/ (layer_tiles.cuh's notes on each epilogue).
//
// Bound on this card: tensor-core throughput.  At ViT-B bs=128 (M = 25,216,
// K = 768) each output element takes 2K = 1,536 flops against a few bytes,
// above the ~295 flop/byte ridge at every site.
//
// Design: a warp-specialised, persistent kernel.
//  - Tiles: 128 x 128 output tiles (layer_tiles.cuh's kGemmBM x kGemmBN),
//    k-tiles of 64.  A block of three warpgroups: one producer and two
//    consumers of 64 rows each.  One block an SM (its shared memory is
//    ~200 KB), the grid min(tiles, SMs); block b takes tiles b, b + grid,
//    ... with N fastest, so the tiles in flight at any time share a few A
//    row tiles and sweep W, which stays in L2.
//  - Copies: one thread of the producer issues every copy, by the TMA from
//    2-D tensor maps in the 128-byte swizzle the wgmma descriptors name: the
//    A (128 x 64) and W (128 x 64) boxes of each k-tile into a ring of
//    stages (6; 5 where the staging is f32 or two tiles, or gelu_bwd's
//    column partials take shared memory), each with a full mbarrier (the
//    copies' bytes) and an empty one (both consumers' release).  Rows past M
//    and N are zero-filled by the copy.  The ring runs over the block's
//    tiles in order, so the producer runs ahead into the next tile while the
//    consumers finish this tile's epilogue.  No block-wide barrier is met
//    after the set-up.
//  - Products: each consumer issues, a k-tile, four wgmma.m64n128k16 from
//    the stage into 64 f32 accumulators, committed as one group, keeps one
//    group in flight, and releases a stage as soon as the wait retires the
//    group that read it.  These are gemm_tile's products in gemm_tile's
//    order (the same instruction, the same k16 steps in ascending k, no
//    split-K), so every epilogue's output is the same bits as the first
//    port's kernel.  setmaxnreg gives the consumers 232 registers and the
//    producer 40 (the launch is checked for the 168 a thread it needs).
//    (Consumers taking whole tiles in turns, "ping-pong", so one's epilogue
//    runs under the other's products, need 128 accumulators a thread: at
//    the 168-register launch ptxas spilled 300-600 bytes a thread and every
//    site ran slower.)
//  - Epilogue: layer_tiles.cuh's epilogue_pair, operation for operation,
//    in the accumulator layout.  The bias is read a tile at a time into
//    registers; the residual (or gelu_bwd's h1) arrives by the TMA as the
//    consumer's 64 x 128 tile in its staging buffer, issued by the producer
//    after the tile's last k-tile once the buffer's last store has read it;
//    each output pair overwrites its residual pair there, and one thread
//    stores the tile by the TMA (rows past M and columns past N clipped),
//    which overlaps the next tile's main loop.  gelu_bwd's dh1 column
//    partials keep their order: within a thread, over g by shuffles, then
//    the 8 consumer warps in order, into the (ceil(M / 128), N) buffer, so
//    db1 stays bitwise deterministic.
// The weights' tensor maps are encoded once for each (pointer, shape) and
// kept; the activations' are encoded at each call.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a), bound
// with ctypes: each entry point returns the launch's cudaError_t.

#include <mutex>

#include "layer_tiles.cuh"

namespace {

constexpr int kConsumers = 2;                       // warpgroups of 64 rows: the tile's 128
constexpr int kWsThreads = 128 * (1 + kConsumers);  // the producer warpgroup first
constexpr int kStageBytes = (kGemmATile + kGemmBTile) * static_cast<int>(sizeof(bf16));  // 32 KB
constexpr int kBoxBytes = 64 * 128;  // one TMA box of 64 rows x 128 bytes (64 bf16 or 32 f32)
constexpr int kColBufBytes = 2 * 4 * kGemmBN * static_cast<int>(sizeof(float));  // gelu_bwd: 8 warps x 128
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kConsumerRegs = 232, kProducerRegs = 40, kLaunchRegs = 168;  // 2 x 128 x 232 + 128 x 40 <= 384 x 168

// a consumer's staging: its 64 rows x 128 columns of output, bf16 (two
// boxes) or f32 (four), and fc1_save's h1 beside its act
__host__ __device__ constexpr int staging_bytes(int epi) {
  return (epi == kEpiF32 || epi == kEpiFc1Save) ? 4 * kBoxBytes : 2 * kBoxBytes;
}

__host__ __device__ constexpr int fixed_bytes(int epi) {
  return kWgAlign + kConsumers * staging_bytes(epi) + (epi == kEpiGeluBwd ? kColBufBytes : 0) + 8 * 20;  // + mbarriers
}

// the ring's stages: as many as shared memory holds, at most 6
__host__ __device__ constexpr int ring_stages(int epi) {
  return (kMaxSmem - fixed_bytes(epi)) / kStageBytes < 6 ? (kMaxSmem - fixed_bytes(epi)) / kStageBytes : 6;
}

__host__ __device__ constexpr int gemm_smem(int epi) { return fixed_bytes(epi) + ring_stages(epi) * kStageBytes; }

// The tensor maps of a launch: A (M, K), W (N, K) in 64 x 128 boxes; the
// residual or h1 (M, N) read, the output (M, N) and fc1_save's h1 written,
// in 64 x 64 boxes (32 x 64 for the f32 output)
struct alignas(64) GemmMaps {
  CUtensorMap a, w, res, out, aux;
};

struct GemmArgs {
  const bf16* bias;  // or null
  int M, N, K;
  int has_res;       // maps.res is read (out, fc2, block_out with a residual; gelu_bwd's h1)
  BlockOutArgs bo;
  float* colpart;    // gelu_bwd: (ceil(M / 128), N) f32
};

// byte offset of the pair (r, c), c even, in a consumer's staging: boxes of
// 64 bf16 (F32: 32 f32) columns x 64 rows, each row 128 bytes in the
// 128-byte swizzle the store's map names
template <bool F32>
__device__ __forceinline__ int staging_off(int r, int c) {
  return F32 ? (c >> 5) * kBoxBytes + r * 128 + (((((c & 31) >> 2) ^ (r & 7))) << 4) + (c & 3) * 4
             : (c >> 6) * kBoxBytes + r * 128 + (((((c & 63) >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

template <int EPI>
__global__ void __launch_bounds__(kWsThreads, 1) gemm_bf16_kernel(GemmArgs p, const __grid_constant__ GemmMaps maps) {
  constexpr int S = ring_stages(EPI), SB = staging_bytes(EPI);
  constexpr bool kF32 = EPI == kEpiF32;
  extern __shared__ unsigned char gemm_raw[];
  unsigned char* smem = aligned_smem(gemm_raw);
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + S * kGemmATile;
  unsigned char* staging = reinterpret_cast<unsigned char*>(Bs + S * kGemmBTile);
  float* colbuf = reinterpret_cast<float*>(staging + kConsumers * SB);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(colbuf) +
                                               (EPI == kEpiGeluBwd ? kColBufBytes : 0));
  uint64_t* empty = full + S;
  uint64_t* res_full = empty + S;             // a consumer's residual tile landed
  uint64_t* res_free = res_full + kConsumers;  // a consumer's staging was read by its last store

  const int nt = (p.N + kGemmBN - 1) / kGemmBN, tiles = ((p.M + kGemmBM - 1) / kGemmBM) * nt;
  const int ktiles = p.K / kGemmBK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    for (int i = 0; i < kConsumers; ++i) {
      mbar_init(res_full + i, 1);
      mbar_init(res_free + i, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- the producer: one thread issues every copy ----
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      int c = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++c) {
        const int m0 = (tile / nt) * kGemmBM, n0 = (tile % nt) * kGemmBN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty + stage, phase ^ 1u);
          mbar_expect(full + stage, kStageBytes);
          tma_load_2d(As + stage * kGemmATile, &maps.a, kt * kGemmBK, m0, full + stage);
          tma_load_2d(Bs + stage * kGemmBTile, &maps.w, kt * kGemmBK, n0, full + stage);
          if (++stage == S) stage = 0, phase ^= 1u;
        }
        if (p.has_res) {  // after the tile's last k-tile: both consumers are in its main loop
          for (int w = 0; w < kConsumers; ++w) {
            mbar_wait(res_free + w, (c + 1) & 1);
            mbar_expect(res_full + w, 2 * kBoxBytes);
            unsigned char* st = staging + w * SB;
            tma_load_2d(st, &maps.res, n0, m0 + 64 * w, res_full + w);
            tma_load_2d(st + kBoxBytes, &maps.res, n0 + 64, m0 + 64 * w, res_full + w);
          }
        }
      }
    }
    return;
  }

  // ---- a consumer: 64 rows of each tile ----
  regs_inc<kConsumerRegs>();
  const int cw = (threadIdx.x >> 7) - 1, wtid = threadIdx.x & 127;
  const int wq = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
  unsigned char* st = staging + cw * SB;
  const bool has_bias = p.bias != nullptr;
  int stage = 0;
  uint32_t phase = 0;
  int c = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++c) {
    const int m0 = (tile / nt) * kGemmBM, n0 = (tile % nt) * kGemmBN, r0 = m0 + 64 * cw;

    // gemm_tile's product: the same wgmma k16 steps in the same order
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    fence_operands(d, 64);
    int prev = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full + stage, phase);
      const bf16* as = As + stage * kGemmATile + cw * 64 * kGemmBK;
      const bf16* bs = Bs + stage * kGemmBTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk)
        wgmma_m64n128k16<0, 0>(d, wgmma_desc(as + kk * 16), wgmma_desc(bs + kk * 16));
      wgmma_commit();
      wgmma_wait<1>();  // k-tile kt-1's group is done: its stage is free
      if (wtid == 0) {
        if (kt > 0) {
          mbar_arrive(empty + prev);
        } else if (c > 0) {  // the last tile's store has read the staging
          bulk_wait_read();
          if (p.has_res) mbar_arrive(res_free + cw);
        }
      }
      prev = stage;
      if (++stage == S) stage = 0, phase ^= 1u;
    }
    wgmma_wait<0>();
    fence_operands(d, 64);
    if (wtid == 0) mbar_arrive(empty + prev);

    // accumulator layout: warp wq holds rows 16wq + (g, g+8) of the
    // consumer's 64, and d[4j..4j+3] their columns 8j + 2t, 8j + 2t + 1
    if (p.has_res) {
      mbar_wait(res_full + cw, c & 1);  // the residual tile (which the last store has read)
      if constexpr (EPI == kEpiGeluBwd) named_sync(3, 128 * kConsumers);  // the last tile's partials are read
    } else {
      named_sync(1 + cw, 128);  // thread 0's bulk_wait_read is behind every write
    }
    if constexpr (EPI == kEpiGeluBwd) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cl = j * 8 + 2 * t, col = n0 + cl;  // N % 8 == 0: col < N is the same for the whole warp
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = wq * 16 + g + half * 8;
          if (r0 + rl < p.M && col < p.N) {
            uint32_t* pair = reinterpret_cast<uint32_t*>(st + staging_off<false>(rl, cl));
            const float2 h = load_pair_f32(reinterpret_cast<const bf16*>(pair));
            const float2 v = make_float2(d[4 * j + 2 * half] * gelu_tanh_grad(h.x),
                                         d[4 * j + 2 * half + 1] * gelu_tanh_grad(h.y));  // dh1 in f32
            *pair = pack_floats(v.x, v.y);
            p0 += v.x;
            p1 += v.y;
          }
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {  // over g: the lanes of one column pair
          p0 += __shfl_xor_sync(0xffffffffu, p0, o);
          p1 += __shfl_xor_sync(0xffffffffu, p1, o);
        }
        const int warp8 = cw * 4 + wq;
        if (g == 0) colbuf[warp8 * kGemmBN + cl] = p0, colbuf[warp8 * kGemmBN + cl + 1] = p1;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int cl = j * 8 + 2 * t, col = n0 + cl;
        [[maybe_unused]] const float2 bb =
            has_bias && col < p.N ? load_pair_f32(p.bias + col) : make_float2(0.f, 0.f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = wq * 16 + g + half * 8;
          const float v0 = d[4 * j + 2 * half], v1 = d[4 * j + 2 * half + 1];
          unsigned char* pair = st + staging_off<kF32>(rl, cl);
          if constexpr (kF32) {
            *reinterpret_cast<float2*>(pair) = make_float2(v0, v1);
          } else {
            const float2 r = p.has_res ? load_pair_f32(reinterpret_cast<const bf16*>(pair)) : make_float2(0.f, 0.f);
            uint32_t h1 = 0u;
            *reinterpret_cast<uint32_t*>(pair) =
                epilogue_pair<EPI>(v0, v1, r0 + rl, col, has_bias, bb, p.has_res, r, p.bo, &h1);
            if constexpr (EPI == kEpiFc1Save) *reinterpret_cast<uint32_t*>(pair + 2 * kBoxBytes) = h1;
          }
        }
      }
    }
    fence_proxy_async();  // the staging's generic stores, before the TMA reads them
    if constexpr (EPI == kEpiGeluBwd) {
      named_sync(3, 128 * kConsumers);  // both consumers' column partials, and this one's staging
    } else {
      named_sync(1 + cw, 128);
    }
    if (wtid == 0) {
      constexpr int kCols = kF32 ? 32 : 64, kBoxes = kGemmBN / kCols;
      if (r0 < p.M) {
#pragma unroll
        for (int b = 0; b < kBoxes; ++b) {
          if (n0 + b * kCols < p.N) {
            tma_store_2d(&maps.out, st + b * kBoxBytes, n0 + b * kCols, r0);
            if constexpr (EPI == kEpiFc1Save) tma_store_2d(&maps.aux, st + (2 + b) * kBoxBytes, n0 + b * kCols, r0);
          }
        }
      }
      bulk_commit();
    }
    if constexpr (EPI == kEpiGeluBwd) {
      if (cw == 0 && n0 + wtid < p.N) {  // the tile's 8 warps in order, a column a thread
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 2 * 4; ++w) s += colbuf[w * kGemmBN + wtid];
        p.colpart[static_cast<size_t>(m0 / kGemmBM) * p.N + n0 + wtid] = s;
      }
    }
  }
  if (wtid == 0) bulk_wait();  // the last store is done before the block's shared memory goes
}

// A map over a row-major (rows, cols) matrix of bf16 (or f32): boxes of
// box_cols x box_rows
inline bool matrix_map(CUtensorMap& map, const void* p, bool f32, long long rows, long long cols, int box_cols,
                       int box_rows) {
  const long long sizes[2] = {cols, rows}, strides[1] = {cols};
  return encode_map(map, p, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, f32 ? 4 : 2, 2,
                    sizes, strides, box_cols, box_rows);
}

// The W map of a weight (N, K): encoded once for each (pointer, shape) and
// kept (a map holds only the address, the shape and the box, so a reused
// address of the same shape keeps a right map)
inline bool weight_map(CUtensorMap& map, const void* w, int N, int K) {
  struct Entry {
    CUtensorMap map;
    const void* p;
    int n, k;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.p == w && e.n == N && e.k == K) {
      map = e.map;
      return true;
    }
  if (!matrix_map(map, w, false, N, K, kGemmBK, kGemmBN)) return false;
  cache[next] = Entry{map, w, N, K};
  next = (next + 1) % 64;
  return true;
}

template <int EPI>
cudaError_t launch_gemm(const void* a, const void* w, const void* res, void* out, void* aux, GemmArgs p,
                        cudaStream_t stream) {
  // the register hand-over needs the launch's 168 registers a thread
  static const int launch_regs = [] {
    cudaFuncAttributes attr{};
    return cudaFuncGetAttributes(&attr, gemm_bf16_kernel<EPI>) == cudaSuccess ? attr.numRegs : 0;
  }();
  if (launch_regs < kLaunchRegs) return cudaErrorInvalidConfiguration;
  GemmMaps maps{};
  const bool f32 = EPI == kEpiF32;
  if (!matrix_map(maps.a, a, false, p.M, p.K, kGemmBK, kGemmBM) || !weight_map(maps.w, w, p.N, p.K) ||
      !matrix_map(maps.out, out, f32, p.M, p.N, f32 ? 32 : 64, 64) ||
      (p.has_res && !matrix_map(maps.res, res, false, p.M, p.N, 64, 64)) ||
      (aux && !matrix_map(maps.aux, aux, false, p.M, p.N, 64, 64)))
    return cudaErrorInvalidValue;
  constexpr int smem = gemm_smem(EPI);
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  const int tiles = ((p.M + kGemmBM - 1) / kGemmBM) * ((p.N + kGemmBN - 1) / kGemmBN);
  gemm_bf16_kernel<EPI><<<tiles < sms ? tiles : sms, kWsThreads, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// block_out: n = rows of one image, heads = the output stream's head index;
// drop = 0 leaves the mask out (seed, threshold, inv unread), and every other
// epilogue ignores all five.  Pointers are device pointers of contiguous
// tensors, 16-byte aligned (the f32 epilogue's output f32, the rest bf16);
// the wrapper in ops/fused_block.py checks shapes.
int vit_gemm_bf16(const void* a, const void* w, const void* bias, const void* res, void* out, int M, int N, int K,
                  int epilogue, int n, int heads, int drop, unsigned seed, unsigned threshold, float inv,
                  void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || K <= 0 || K % kGemmBK || (M + kGemmBM - 1) / kGemmBM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BlockOutArgs bo{DropoutArgs{seed, threshold, inv}, n, heads, drop};
  GemmArgs p{static_cast<const bf16*>(bias), M, N, K, 0, bo, nullptr};
  switch (epilogue) {
    case kEpiQkv: return launch_gemm<kEpiQkv>(a, w, nullptr, out, nullptr, p, s);
    case kEpiOut:
      if (!res) return cudaErrorInvalidValue;
      p.has_res = 1;
      return launch_gemm<kEpiOut>(a, w, res, out, nullptr, p, s);
    case kEpiFc1: return launch_gemm<kEpiFc1>(a, w, nullptr, out, nullptr, p, s);
    case kEpiFc1F32: return launch_gemm<kEpiFc1F32>(a, w, nullptr, out, nullptr, p, s);
    case kEpiFc2:
      if (!res) return cudaErrorInvalidValue;
      p.has_res = 1;
      return launch_gemm<kEpiFc2>(a, w, res, out, nullptr, p, s);
    case kEpiF32:
      p.bias = nullptr;
      return launch_gemm<kEpiF32>(a, w, nullptr, out, nullptr, p, s);
    case kEpiBlockOut:
      if (n <= 0 || M % n || (drop && (N % 4 || heads < 0))) return cudaErrorInvalidValue;
      p.has_res = res != nullptr;
      return launch_gemm<kEpiBlockOut>(a, w, res, out, nullptr, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// The FF backward's epilogues: epilogue kEpiFc1Save (6): out = act, h1_out =
// h1, bias = b1 or null; kEpiGeluBwd (7): out = dh1, h1 = the saved h1,
// colpart a (ceil(M / 128), N) f32 scratch buffer, colsum (N) f32 = db1
int vit_gemm_ff(const void* a, const void* w, const void* bias, const void* h1, void* out, void* h1_out,
                void* colpart, void* colsum, int M, int N, int K, int epilogue, void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || K <= 0 || K % kGemmBK || (M + kGemmBM - 1) / kGemmBM > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmArgs p{static_cast<const bf16*>(bias), M, N, K, 0, BlockOutArgs{}, nullptr};
  if (epilogue == kEpiFc1Save) {
    if (!h1_out) return cudaErrorInvalidValue;
    return launch_gemm<kEpiFc1Save>(a, w, nullptr, out, h1_out, p, s);
  }
  if (epilogue != kEpiGeluBwd || bias || !h1 || !colpart || !colsum) return cudaErrorInvalidValue;
  p.has_res = 1;
  p.colpart = static_cast<float*>(colpart);
  cudaError_t err = launch_gemm<kEpiGeluBwd>(a, w, h1, out, nullptr, p, s);
  if (err != cudaSuccess) return err;
  return launch_column_sum(p.colpart, static_cast<float*>(colsum), (M + kGemmBM - 1) / kGemmBM, N, 1.f, s);
}

}  // extern "C"
