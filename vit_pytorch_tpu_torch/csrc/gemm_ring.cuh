// The main loop and epilogue of gemm_bf16 (gemm_bf16.cu has the note on its
// design: a TMA producer thread feeding two consumer warpgroups through a
// ring of shared-memory stages, wgmma.m64n128k16 into f32, the epilogue
// staged in shared memory and stored by the TMA), as device functions that
// walk the output tiles blockIdx.x, blockIdx.x + gridDim.x, ... of one
// product.  gemm_bf16_kernel runs one product a launch; stack_layers_kernel
// (stack_layers.cu) runs the four products of each of its layers through the
// same two functions, so that both give the same bits.
//
//   gemm_ring<EPI>(smem)      the ring's carve-out of a block's shared memory
//   gemm_ring_init            its mbarriers (one thread)
//   gemm_produce              the producer thread's copies of one product
//   gemm_consume<EPI>         a consumer warpgroup's products and epilogues
//
// The ring's position (RingPos: its stage and phase, the tiles and residual
// tiles the block has run) is kept by each side and carried from one product
// to the next, so a block may run any number of products through one ring.
// Each side must call its function for every product, in the same order,
// with the same M, N and K.
//
// Internal linkage, as common.cuh; the weight maps' cache (gemm_weight_map)
// is defined once, in gemm_bf16.cu.
#pragma once

#include "layer_tiles.cuh"

namespace {

constexpr int kConsumers = 2;                       // warpgroups of 64 rows: the tile's 128
constexpr int kWsThreads = 128 * (1 + kConsumers);  // the producer warpgroup first
constexpr int kGemmATile = kGemmBM * kGemmBK, kGemmBTile = kGemmBN * kGemmBK;
constexpr int kStageBytes = (kGemmATile + kGemmBTile) * static_cast<int>(sizeof(bf16));  // 32 KB
constexpr int kBoxBytes = 64 * 128;  // one TMA box of 64 rows x 128 bytes (64 bf16 or 32 f32)
constexpr int kColBufBytes = 2 * 4 * kGemmBN * static_cast<int>(sizeof(float));  // gelu_bwd: 8 warps x 128
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kConsumerRegs = 232, kProducerRegs = 40, kLaunchRegs = 168;  // 2 x 128 x 232 + 128 x 40 <= 384 x 168
constexpr int kRingBarriers = 8 * 20;  // the mbarriers' bytes: full and empty a stage, res_full and res_free a consumer

// a consumer's staging: its 64 rows x 128 columns of output, bf16 (two
// boxes) or f32 (four), and fc1_save's h1 beside its act
__host__ __device__ constexpr int staging_bytes(int epi) {
  return (epi == kEpiF32 || epi == kEpiFc1Save) ? 4 * kBoxBytes : 2 * kBoxBytes;
}

__host__ __device__ constexpr int fixed_bytes(int epi) {
  return kWgAlign + kConsumers * staging_bytes(epi) + (epi == kEpiGeluBwd ? kColBufBytes : 0) + kRingBarriers;
}

// the ring's stages: as many as shared memory holds, at most 6
__host__ __device__ constexpr int ring_stages(int epi) {
  return (kMaxSmem - fixed_bytes(epi)) / kStageBytes < 6 ? (kMaxSmem - fixed_bytes(epi)) / kStageBytes : 6;
}

__host__ __device__ constexpr int gemm_smem(int epi) { return fixed_bytes(epi) + ring_stages(epi) * kStageBytes; }

struct GemmArgs {
  const bf16* bias;  // or null
  int M, N, K;
  int has_res;       // the residual map is read (out, fc2, block_out with a residual; gelu_bwd's h1)
  BlockOutArgs bo;
  float* colpart;    // gelu_bwd: (ceil(M / 128), N) f32
};

// The ring in a block's shared memory (from a kWgAlign-aligned base): S
// stages of A (128 x 64) and W (128 x 64) boxes, the consumers' staging,
// gelu_bwd's column partials, then the mbarriers
struct GemmRing {
  bf16* As;
  bf16* Bs;
  unsigned char* staging;
  float* colbuf;
  uint64_t* full;      // [S] a stage's copies landed
  uint64_t* empty;     // [S] both consumers released a stage
  uint64_t* res_full;  // [kConsumers] a consumer's residual tile landed
  uint64_t* res_free;  // [kConsumers] a consumer's staging was read by its last store
  uint64_t* end;       // the first byte past the ring's barriers
};

template <int EPI>
__device__ __forceinline__ GemmRing gemm_ring(unsigned char* smem) {
  constexpr int S = ring_stages(EPI);
  GemmRing r;
  r.As = reinterpret_cast<bf16*>(smem);
  r.Bs = r.As + S * kGemmATile;
  r.staging = reinterpret_cast<unsigned char*>(r.Bs + S * kGemmBTile);
  r.colbuf = reinterpret_cast<float*>(r.staging + kConsumers * staging_bytes(EPI));
  r.full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(r.colbuf) +
                                       (EPI == kEpiGeluBwd ? kColBufBytes : 0));
  r.empty = r.full + S;
  r.res_full = r.empty + S;
  r.res_free = r.res_full + kConsumers;
  r.end = r.res_free + kConsumers;
  return r;
}

// one thread, before the block's first barrier; the caller fences the inits
// (mbar_fence_init) after its own
template <int EPI>
__device__ __forceinline__ void gemm_ring_init(const GemmRing& r) {
  constexpr int S = ring_stages(EPI);
  for (int i = 0; i < S; ++i) {
    mbar_init(r.full + i, 1);
    mbar_init(r.empty + i, kConsumers);
  }
  for (int i = 0; i < kConsumers; ++i) {
    mbar_init(r.res_full + i, 1);
    mbar_init(r.res_free + i, 1);
  }
}

// where each side of a block stands in the ring: the next stage and its
// phase, and the tiles (and residual tiles) it has run so far
struct RingPos {
  int stage;
  uint32_t phase;
  int tiles, res_tiles;
};

// byte offset of the pair (r, c), c even, in a consumer's staging: boxes of
// 64 bf16 (F32: 32 f32) columns x 64 rows, each row 128 bytes in the
// 128-byte swizzle the store's map names
template <bool F32>
__device__ __forceinline__ int staging_off(int r, int c) {
  return F32 ? (c >> 5) * kBoxBytes + r * 128 + (((((c & 31) >> 2) ^ (r & 7))) << 4) + (c & 3) * 4
             : (c >> 6) * kBoxBytes + r * 128 + (((((c & 63) >> 3) ^ (r & 7))) << 4) + (c & 7) * 2;
}

// The producer (one thread) of one product C (M, N) = A (M, K) . W (N, K)^T:
// for each of the block's tiles, its k-tiles' A and W boxes into the ring,
// then (res non-null) the consumers' residual tiles once their staging is
// free.  Runs ahead across the block's tiles as far as the ring allows.
template <int S>
__device__ __forceinline__ void gemm_produce(const GemmRing& r, const CUtensorMap* a, const CUtensorMap* w,
                                             const CUtensorMap* res, int M, int N, int K, RingPos& pos) {
  const int nt = (N + kGemmBN - 1) / kGemmBN, tiles = ((M + kGemmBM - 1) / kGemmBM) * nt;
  const int ktiles = K / kGemmBK;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++pos.tiles) {
    const int m0 = (tile / nt) * kGemmBM, n0 = (tile % nt) * kGemmBN;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(r.empty + pos.stage, pos.phase ^ 1u);
      mbar_expect(r.full + pos.stage, kStageBytes);
      tma_load_2d(r.As + pos.stage * kGemmATile, a, kt * kGemmBK, m0, r.full + pos.stage);
      tma_load_2d(r.Bs + pos.stage * kGemmBTile, w, kt * kGemmBK, n0, r.full + pos.stage);
      if (++pos.stage == S) pos.stage = 0, pos.phase ^= 1u;
    }
    if (res) {  // after the tile's last k-tile: both consumers are in its main loop
      for (int c = 0; c < kConsumers; ++c) {
        // res_free's phase t - 1 completes when the consumer starts tile t
        mbar_wait(r.res_free + c, (pos.tiles + 1) & 1);
        mbar_expect(r.res_full + c, 2 * kBoxBytes);
        unsigned char* st = r.staging + c * 2 * kBoxBytes;  // an epilogue with a residual stages bf16
        tma_load_2d(st, res, n0, m0 + 64 * c, r.res_full + c);
        tma_load_2d(st + kBoxBytes, res, n0 + 64, m0 + 64 * c, r.res_full + c);
      }
    }
  }
}

// A consumer warpgroup (cw = 0, 1: rows 64 cw.. of each tile; wtid its
// thread index in it) of one product: the products in the first port's
// order (the same wgmma k16 steps in ascending k, into f32), then
// epilogue_pair<EPI> on each accumulator pair, the tile staged in shared
// memory and stored by the TMA (out; fc1_save's h1 by aux).  The last
// store is committed, not waited for: the caller waits (bulk_wait) before
// its output is read or the shared memory reused.
template <int EPI, int S>
__device__ __forceinline__ void gemm_consume(const GemmRing& r, const GemmArgs& p, const CUtensorMap* out,
                                             const CUtensorMap* aux, int cw, int wtid, RingPos& pos) {
  constexpr int SB = staging_bytes(EPI);
  constexpr bool kF32 = EPI == kEpiF32;
  const int wq = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
  unsigned char* st = r.staging + cw * SB;
  const bool has_bias = p.bias != nullptr;
  const int nt = (p.N + kGemmBN - 1) / kGemmBN, tiles = ((p.M + kGemmBM - 1) / kGemmBM) * nt;
  const int ktiles = p.K / kGemmBK;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++pos.tiles) {
    const int m0 = (tile / nt) * kGemmBM, n0 = (tile % nt) * kGemmBN, r0 = m0 + 64 * cw;

    // the product: wgmma k16 steps in ascending k, one group a k-tile
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    fence_operands(d, 64);
    int prev = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(r.full + pos.stage, pos.phase);
      const bf16* as = r.As + pos.stage * kGemmATile + cw * 64 * kGemmBK;
      const bf16* bs = r.Bs + pos.stage * kGemmBTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk)
        wgmma_m64n128k16<0, 0>(d, wgmma_desc(as + kk * 16), wgmma_desc(bs + kk * 16));
      wgmma_commit();
      wgmma_wait<1>();  // k-tile kt-1's group is done: its stage is free
      if (wtid == 0) {
        if (kt > 0) {
          mbar_arrive(r.empty + prev);
        } else if (pos.tiles > 0) {  // the last tile's store has read the staging
          bulk_wait_read();
          mbar_arrive(r.res_free + cw);  // every tile; only a residual tile's producer waits on it
        }
      }
      prev = pos.stage;
      if (++pos.stage == S) pos.stage = 0, pos.phase ^= 1u;
    }
    wgmma_wait<0>();
    fence_operands(d, 64);
    if (wtid == 0) mbar_arrive(r.empty + prev);

    // accumulator layout: warp wq holds rows 16wq + (g, g+8) of the
    // consumer's 64, and d[4j..4j+3] their columns 8j + 2t, 8j + 2t + 1
    if (p.has_res) {
      mbar_wait(r.res_full + cw, pos.res_tiles++ & 1);  // the residual tile (which the last store has read)
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
        if (g == 0) r.colbuf[warp8 * kGemmBN + cl] = p0, r.colbuf[warp8 * kGemmBN + cl + 1] = p1;
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
            const float2 rv = p.has_res ? load_pair_f32(reinterpret_cast<const bf16*>(pair)) : make_float2(0.f, 0.f);
            uint32_t h1 = 0u;
            *reinterpret_cast<uint32_t*>(pair) =
                epilogue_pair<EPI>(v0, v1, r0 + rl, col, has_bias, bb, p.has_res, rv, p.bo, &h1);
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
            tma_store_2d(out, st + b * kBoxBytes, n0 + b * kCols, r0);
            if constexpr (EPI == kEpiFc1Save) tma_store_2d(aux, st + (2 + b) * kBoxBytes, n0 + b * kCols, r0);
          }
        }
      }
      bulk_commit();
    }
    if constexpr (EPI == kEpiGeluBwd) {
      if (cw == 0 && n0 + wtid < p.N) {  // the tile's 8 warps in order, a column a thread
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 2 * 4; ++w) s += r.colbuf[w * kGemmBN + wtid];
        p.colpart[static_cast<size_t>(m0 / kGemmBM) * p.N + n0 + wtid] = s;
      }
    }
  }
}

// The registers a thread of KERNEL launches with, read once: a kernel that
// hands registers over with setmaxnreg (gemm_produce's 40, gemm_consume's
// 232) needs kLaunchRegs of them, or setmaxnreg.inc waits forever
template <auto KERNEL>
int launch_regs() {
  static const int regs = [] {
    cudaFuncAttributes attr{};
    return cudaFuncGetAttributes(&attr, KERNEL) == cudaSuccess ? attr.numRegs : 0;
  }();
  return regs;
}

// A map over a row-major (rows, cols) matrix of bf16 (or f32): boxes of
// box_cols x box_rows
inline bool matrix_map(CUtensorMap& map, const void* p, bool f32, long long rows, long long cols, int box_cols,
                       int box_rows) {
  const long long sizes[2] = {cols, rows}, strides[1] = {cols};
  return encode_map(map, p, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, f32 ? 4 : 2, 2,
                    sizes, strides, box_cols, box_rows);
}

}  // namespace

// The W map of a weight (N, K) in the ring's boxes: encoded once for each
// (pointer, shape) and kept, one cache for the library (gemm_bf16.cu)
bool gemm_weight_map(CUtensorMap& map, const void* w, int N, int K);
