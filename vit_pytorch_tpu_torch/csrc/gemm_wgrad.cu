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
//
// Bound on this card: tensor-core throughput.  At ViT-B bs=128 K = 25,216
// and a (768 x 3072) dW is 0.119 TFLOP, 0.120 ms at 989 TFLOP/s, against
// ~0.17 GB of operands (0.05 ms at 3.35 TB/s); at bs=1024 K = 201,728 and
// each such dW is 0.96 ms of tensor work.
//
// Design: gemm_bf16.cu's warp-specialised, persistent shape, with both
// operands MN-major and the K axis shared out across the SMs.
//  - Tiles: 128 x 128 f32 output tiles, k-tiles of 64 rows.  A block of
//    three warpgroups: one producer, two consumers of 64 output rows each.
//    One block an SM (~225 KB of shared memory), `blocks` = the SM count.
//  - Work, in two parts, each walked by every block in step, so that the
//    blocks in flight read the same k rows of A and B at the same time and
//    those rows come from L2 (a block that walked its own k-range alone
//    would read all of A and B from device memory once for each tile):
//    (1) whole tiles, data-parallel: the first `full` x blocks tiles, block
//    b taking b, b + blocks, ...; (2) the `rem` = tiles mod blocks tiles
//    left, K-synchronous stream-K: K is cut into chunks of `chunk` =
//    blocks / gcd(rem, blocks) k-tiles, so that a chunk's rem x chunk
//    (tile, offset) units cut into `blocks` contiguous ranges of one length
//    (or, with fewer units than blocks, one a unit), and block b walks its
//    range (the tail of one tile's chunk and the head of the next's: two
//    pieces, two accumulators) in every chunk in turn.  Every block then
//    has the same number of k-tiles (dW_out's 36 tiles, dW1's 144 against
//    132 SMs) and all are in the same chunk, 11 k-tiles long at 132 SMs.
//    The host picks blocks and chunk from (M, N, K, SM count) alone
//    (ops/fused_block.py::gemm_wgrad_blocks), so the pieces are too.
//  - Copies: one producer thread issues every copy, by the TMA from 2-D
//    tensor maps of A (M inner, K rows) and B (N inner, K rows): a box is 64
//    k rows x 64 M (or N) elements in the 128-byte swizzle, which lands as
//    eight 8-row atoms, the MN-major layout wgmma reads with its transpose
//    flag; rows past K and columns past M or N are zero-filled by the copy.
//    Each k-tile's four boxes (A and B, 128 wide each) fill one stage of a
//    6-stage ring with full/empty mbarriers, in the consumers' order, across
//    tiles and pieces.  No copy instruction runs on a consumer.
//  - Products: each consumer issues, a k-tile, four wgmma.m64n128k16 with
//    both transpose flags into 64 f32 accumulators, one group in flight,
//    releasing a stage when the wait retires the group that read it.
//    setmaxnreg gives the consumers 232 registers and the producer 40.
//  - Split K, deterministic and without float atomics: a stream-K tile's
//    pieces lie in consecutive blocks b0 .. b0 + P - 1; each piece's
//    consumer writes its 64 x 128 f32 partial, in its own accumulator order
//    (coalesced 16-byte stores), to slot `tile + block` of a scratch buffer
//    (no two pieces share one), and adds one to the tile half's integer
//    counter; the consumer that brings it to P adds the slots in block
//    order, 0 + p0 + p1 + ..., whichever block that is, so the sum and its
//    bits depend on the shape alone.
//  - Epilogue: the f32 tile is staged through shared memory in the
//    128-byte swizzle, 64 columns at a time, and leaves by TMA stores
//    (columns past N and rows past M clipped), which overlap the consumer's
//    next tile.
//  - Tried: 128 x 192 tiles (m64n192k16, 96 accumulators a consumer): the
//    two stream-K pieces' 192 accumulators spilled 1,488 bytes a thread and
//    the kernel ran 8-10x slower on an H100.
// M and N must be multiples of 8 (the maps' row strides: 16 bytes).
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a), bound
// with ctypes: vit_gemm_wgrad returns the launch's cudaError_t.

#include "attn_wgmma.cuh"

namespace {

constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 64;
constexpr int kWgConsumers = 2;                        // warpgroups of 64 output rows
constexpr int kWgThreads = 128 * (1 + kWgConsumers);  // the producer warpgroup first
constexpr int kWgBox = 64 * 64;                        // elements of one 64 x 64 bf16 box (8 KB)
constexpr int kWgBoxBytes = kWgBox * static_cast<int>(sizeof(bf16));
constexpr int kWgF32Box = 64 * 128;                    // bytes of one 32-column x 64-row f32 box
constexpr int kWgStagingBytes = 2 * kWgF32Box;         // a consumer's 64 x 64 f32 store, two boxes
constexpr int kWgMaxSmem = 232448;                     // a block's shared memory on sm_90
constexpr int kWgConsumerRegs = 232, kWgProducerRegs = 40, kWgLaunchRegs = 168;
constexpr int kWgAtom = 8 * 64;  // elements of one swizzle atom: 8 k rows x 64 bf16, 1024 bytes
// descriptor strides of the MN-major tiles: 64-wide MN groups a box apart,
// 8-row K groups one atom apart
constexpr uint32_t kWgLbo = kWgBoxBytes, kWgSbo = kWgAtom * sizeof(bf16);

constexpr int kWgStageBytes = 4 * kWgBoxBytes;  // a stage: A's and B's 128 columns of one k-tile, 32 KB
constexpr int kWgFixedBytes = kWgAlign + kWgConsumers * kWgStagingBytes + 2 * 8 * 8 + kWgConsumers * 4;
constexpr int kWgStages = 6;  // (232,448 - kWgFixedBytes) / kWgStageBytes
constexpr int kWgSmem = kWgFixedBytes + kWgStages * kWgStageBytes;
static_assert(kWgSmem <= kWgMaxSmem, "the ring and the staging fit a block's shared memory");

struct alignas(64) WgradMaps {
  CUtensorMap a, b, out;
};

struct WgradArgs {
  int M, N, ktiles, ntn;  // ntn: tiles along N
  int full, rem, chunk;   // whole-tile waves; stream-K tiles; k-tiles a chunk
  float* partial;         // (rem + blocks, 2, 64 x 128) f32 slots
  int* counters;          // (rem, 2), zero on entry
};

// A block's stream-K pieces (at most two: the tail of one tile's chunk
// range and the head of the next's), as offsets within a chunk
// (ops/fused_block.py::gemm_wgrad_pieces is the same walk)
struct WgradPieces {
  int t0, x0, y0;  // piece 0: stream-K tile t0, offsets [x0, y0) of each chunk
  int t1, y1;      // piece 1 (t1 >= 0): tile t1, offsets [0, y1)
};

// the blocks that share a chunk's rem x chunk units: all, or one a unit
// when there are fewer units than blocks (no block's range is empty)
__device__ __forceinline__ int wgrad_sk_blocks(const WgradArgs& p, int blocks) {
  const long long units = static_cast<long long>(p.rem) * p.chunk;
  return units < blocks ? static_cast<int>(units) : blocks;
}

// the block whose range holds chunk unit u: the largest b with floor(b W / G) <= u
__device__ __forceinline__ int wgrad_block_of(long long u, long long units, int blocks) {
  return static_cast<int>(((u + 1) * blocks - 1) / units);
}

__device__ __forceinline__ WgradPieces wgrad_pieces(const WgradArgs& p, int b, int blocks) {
  const long long units = static_cast<long long>(p.rem) * p.chunk;
  const long long s = b * units / blocks, e = (b + 1) * units / blocks;
  WgradPieces w{-1, 0, 0, -1, 0};
  if (b < blocks && s < e) {
    w.t0 = static_cast<int>(s / p.chunk);
    w.x0 = static_cast<int>(s - static_cast<long long>(w.t0) * p.chunk);
    const long long end0 = static_cast<long long>(w.t0 + 1) * p.chunk;
    w.y0 = static_cast<int>((e < end0 ? e : end0) - static_cast<long long>(w.t0) * p.chunk);
    if (e > end0) w.t1 = w.t0 + 1, w.y1 = static_cast<int>(e - end0);
  }
  return w;
}

// the consumers' place in the ring
struct RingPos {
  int stage;
  uint32_t phase;
  int prev;   // the stage of the group in flight
  bool held;  // a group is in flight
};

// One k-tile's products into d: wait for its stage, four wgmma, keep one
// group in flight and release the stage of the one before
__device__ __forceinline__ void wgrad_step(float (&d)[64], const bf16* As, const bf16* Bs, uint64_t* full,
                                           uint64_t* empty, RingPos& r, int cw, int wtid) {
    mbar_wait(full + r.stage, r.phase);
  const bf16* as = As + r.stage * 2 * kWgBox + cw * kWgBox;  // this consumer's 64 columns of A
  const bf16* bs = Bs + r.stage * 2 * kWgBox;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWgBK / 16; ++kk)  // k16 step kk: the atoms of k rows 16kk .. 16kk + 15
    wgmma_m64n128k16<1, 1>(d, wgmma_desc_sw128(as + 2 * kk * kWgAtom, kWgLbo, kWgSbo),
                           wgmma_desc_sw128(bs + 2 * kk * kWgAtom, kWgLbo, kWgSbo));
  wgmma_commit();
  wgmma_wait<1>();  // the group before is done: its stage is free
  if (wtid == 0 && r.held) mbar_arrive(empty + r.prev);
  r.prev = r.stage, r.held = true;
  if (++r.stage == kWgStages) r.stage = 0, r.phase ^= 1u;
}

// every group is done and its stage released
__device__ __forceinline__ void wgrad_drain(uint64_t* empty, RingPos& r, int wtid) {
  wgmma_wait<0>();
  if (wtid == 0 && r.held) mbar_arrive(empty + r.prev);
  r.held = false;
}

__device__ __forceinline__ void zero_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_operands(d, 64);
}

// A consumer's 64 x 128 f32 tile at (m0 + 64 cw, n0) out through its
// staging and the TMA, 64 columns at a time.  accumulator layout: warp wq
// holds rows 16wq + (g, g+8), and d[4j..4j+3] their columns 8j + 2t, 8j +
// 2t + 1; the staging holds two 32-column f32 boxes, rows 128 bytes,
// swizzled
__device__ __forceinline__ void wgrad_store(const float (&d)[64], unsigned char* st, const CUtensorMap* out,
                                            int M, int N, int m0, int n0, int cw, int wtid) {
  const int wq = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = m0 + 64 * cw;
#pragma unroll
  for (int q = 0; q < kWgBN / 64; ++q) {
    if (wtid == 0) bulk_wait_read();  // the last store has read the staging
    named_sync(1 + cw, 128);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wq * 16 + g + half * 8;
        *reinterpret_cast<float2*>(st + (c >> 5) * kWgF32Box + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
                                   (c & 3) * 4) =
            make_float2(d[4 * (8 * q + j) + 2 * half], d[4 * (8 * q + j) + 2 * half + 1]);
      }
    }
    fence_proxy_async();  // the staging's generic stores, before the TMA reads them
    named_sync(1 + cw, 128);
    if (wtid == 0) {
      const int c0 = n0 + 64 * q;
      if (r0 < M) {
        if (c0 < N) tma_store_2d(out, st, c0, r0);
        if (c0 + 32 < N) tma_store_2d(out, st + kWgF32Box, c0 + 32, r0);
      }
      bulk_commit();
    }
  }
}

// A stream-K piece of tile ts (the stream-K tiles' index) held in d: its
// partial into slot ts + block, then, in the consumer that completes the
// tile, the sum of the tile's slots in block order back into d.  True in
// that consumer.
__device__ __forceinline__ bool wgrad_close_piece(float (&d)[64], const WgradArgs& p, int ts, int blocks,
                                                  volatile int* last, int cw, int wtid) {
  constexpr int V = kWgBN / 8;  // float4s a thread
  const long long units = static_cast<long long>(p.rem) * p.chunk;
  const int b0 = wgrad_block_of(static_cast<long long>(ts) * p.chunk, units, blocks);
  const int pieces = wgrad_block_of(static_cast<long long>(ts + 1) * p.chunk - 1, units, blocks) - b0 + 1;
  float4* slot = reinterpret_cast<float4*>(p.partial) + (static_cast<size_t>(ts + blockIdx.x) * kWgConsumers + cw) * V * 128;
#pragma unroll
  for (int i = 0; i < V; ++i)
    __stcg(slot + i * 128 + wtid, make_float4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]));
  __threadfence();
  named_sync(1 + cw, 128);
  if (wtid == 0) last[cw] = atomicAdd(p.counters + 2 * ts + cw, 1) == pieces - 1;
  named_sync(1 + cw, 128);
  if (!last[cw]) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < kWgBN / 2; ++i) d[i] = 0.f;
  const float4* first = reinterpret_cast<const float4*>(p.partial) + (static_cast<size_t>(ts + b0) * kWgConsumers + cw) * V * 128;
  for (int s = 0; s < pieces; ++s) {  // the pieces in block order, which is k order
    const float4* src = first + static_cast<size_t>(s) * kWgConsumers * V * 128;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float4 v = __ldcg(src + i * 128 + wtid);
      d[4 * i] += v.x, d[4 * i + 1] += v.y, d[4 * i + 2] += v.z, d[4 * i + 3] += v.w;
    }
  }
  return true;
}

__global__ void __launch_bounds__(kWgThreads, 1) gemm_wgrad_kernel(WgradArgs p, const __grid_constant__ WgradMaps maps) {
  extern __shared__ unsigned char wgrad_raw[];
  unsigned char* smem = aligned_smem(wgrad_raw);
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kWgStages * 2 * kWgBox;
  unsigned char* staging = reinterpret_cast<unsigned char*>(Bs + kWgStages * 2 * kWgBox);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kWgConsumers * kWgStagingBytes);
  uint64_t* empty = full + 8;
  volatile int* last = reinterpret_cast<volatile int*>(empty + 8);  // [consumer]: closes the tile half

  const int blocks = gridDim.x, ktiles = p.ktiles, chunks = p.rem ? (ktiles + p.chunk - 1) / p.chunk : 0;
  const int sk0 = p.full * blocks;  // the first stream-K tile
  const int skb = wgrad_sk_blocks(p, blocks);
  const WgradPieces w = wgrad_pieces(p, blockIdx.x, skb);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWgConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- the producer: one thread issues every copy, in the consumers' order ----
    regs_dec<kWgProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      auto load = [&](int tile, int kt) {
        const int m0 = (tile / p.ntn) * kWgBM, n0 = (tile % p.ntn) * kWgBN, k0 = kt * kWgBK;
        mbar_wait(empty + stage, phase ^ 1u);
        mbar_expect(full + stage, kWgStageBytes);
        bf16* as = As + stage * 2 * kWgBox;
        bf16* bs = Bs + stage * 2 * kWgBox;
        tma_load_2d(as, &maps.a, m0, k0, full + stage);
        tma_load_2d(as + kWgBox, &maps.a, m0 + 64, k0, full + stage);
        tma_load_2d(bs, &maps.b, n0, k0, full + stage);
        tma_load_2d(bs + kWgBox, &maps.b, n0 + 64, k0, full + stage);
        if (++stage == kWgStages) stage = 0, phase ^= 1u;
      };
      for (int i = 0; i < p.full; ++i)
        for (int kt = 0; kt < ktiles; ++kt) load(blockIdx.x + i * blocks, kt);
      for (int c = 0; c < chunks; ++c) {
        const int k0 = c * p.chunk;
        if (w.t0 >= 0)
          for (int o = w.x0; o < w.y0 && k0 + o < ktiles; ++o) load(sk0 + w.t0, k0 + o);
        if (w.t1 >= 0)
          for (int o = 0; o < w.y1 && k0 + o < ktiles; ++o) load(sk0 + w.t1, k0 + o);
      }
    }
    return;
  }

  // ---- a consumer: 64 rows of each tile ----
  regs_inc<kWgConsumerRegs>();
  const int cw = (threadIdx.x >> 7) - 1, wtid = threadIdx.x & 127;
  unsigned char* st = staging + cw * kWgStagingBytes;
  RingPos ring{0, 0u, 0, false};
  // (1) whole tiles
  for (int i = 0; i < p.full; ++i) {
    const int tile = blockIdx.x + i * blocks;
    float d[64];
    zero_acc(d);
    for (int kt = 0; kt < ktiles; ++kt) wgrad_step(d, As, Bs, full, empty, ring, cw, wtid);
    wgrad_drain(empty, ring, wtid);
    fence_operands(d, 64);
    wgrad_store(d, st, &maps.out, p.M, p.N, (tile / p.ntn) * kWgBM, (tile % p.ntn) * kWgBN, cw, wtid);
  }
  // (2) the stream-K pieces, chunk by chunk
  if (w.t0 >= 0) {
    float d0[64], d1[64];
    zero_acc(d0);
    zero_acc(d1);
    for (int c = 0; c < chunks; ++c) {
      const int k0 = c * p.chunk;
      for (int o = w.x0; o < w.y0 && k0 + o < ktiles; ++o) wgrad_step(d0, As, Bs, full, empty, ring, cw, wtid);
      if (w.t1 >= 0)
        for (int o = 0; o < w.y1 && k0 + o < ktiles; ++o) wgrad_step(d1, As, Bs, full, empty, ring, cw, wtid);
    }
    wgrad_drain(empty, ring, wtid);
    fence_operands(d0, 64);
    fence_operands(d1, 64);
    const int tile0 = sk0 + w.t0;
    if (wgrad_close_piece(d0, p, w.t0, skb, last, cw, wtid))
      wgrad_store(d0, st, &maps.out, p.M, p.N, (tile0 / p.ntn) * kWgBM, (tile0 % p.ntn) * kWgBN, cw, wtid);
    if (w.t1 >= 0) {
      const int tile1 = sk0 + w.t1;
      if (wgrad_close_piece(d1, p, w.t1, skb, last, cw, wtid))
        wgrad_store(d1, st, &maps.out, p.M, p.N, (tile1 / p.ntn) * kWgBM, (tile1 % p.ntn) * kWgBN, cw, wtid);
    }
  }
  if (wtid == 0) bulk_wait();  // the last store is done before the block's shared memory goes
}

// A map over a row-major (rows, cols) matrix, boxes of box_cols x 64 rows
inline bool wgrad_map(CUtensorMap& map, const void* ptr, bool f32, long long rows, long long cols, int box_cols) {
  const long long sizes[2] = {cols, rows}, strides[1] = {cols};
  return encode_map(map, ptr, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, f32 ? 4 : 2,
                    2, sizes, strides, box_cols, 64);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes).  a (K, M) and b (K, N) bf16, out (M, N) f32; blocks
// the persistent grid and chunk the stream-K chunk in k-tiles (the wrapper
// in ops/fused_block.py picks both: gemm_wgrad_blocks); with rem = tiles
// mod blocks > 0 (tiles = ceil(M / 128) ceil(N / 128)), partial a (rem +
// blocks, 2, 64, 128) f32 scratch buffer and counters a (rem, 2) int32 one
// of zeros, else both may be null.
// ---------------------------------------------------------------------------

extern "C" {

int vit_gemm_wgrad(const void* a, const void* b, void* out, void* partial, void* counters, int M, int N, int K,
                   int blocks, int chunk, void* stream) {
  if (M < 8 || N < 8 || K <= 0 || M % 8 || N % 8 || blocks < 1 || blocks > 65535) return cudaErrorInvalidValue;
  const int ntn = (N + kWgBN - 1) / kWgBN, tiles = ((M + kWgBM - 1) / kWgBM) * ntn;
  const int ktiles = (K + kWgBK - 1) / kWgBK, rem = tiles % blocks;
  if (rem && (chunk < 1 || chunk > ktiles || !partial || !counters)) return cudaErrorInvalidValue;
  // the register hand-over needs the launch's 168 registers a thread
  static const int launch_regs = [] {
    cudaFuncAttributes attr{};
    return cudaFuncGetAttributes(&attr, gemm_wgrad_kernel) == cudaSuccess ? attr.numRegs : 0;
  }();
  if (launch_regs < kWgLaunchRegs) return cudaErrorInvalidConfiguration;
  WgradMaps maps{};
  if (!wgrad_map(maps.a, a, false, K, M, 64) || !wgrad_map(maps.b, b, false, K, N, 64) ||
      !wgrad_map(maps.out, out, true, M, N, 32))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return err;
  const WgradArgs args{M, N, ktiles, ntn, tiles / blocks, rem, rem ? chunk : 0, static_cast<float*>(partial),
                       static_cast<int*>(counters)};
  gemm_wgrad_kernel<<<blocks, kWgThreads, kWgSmem, static_cast<cudaStream_t>(stream)>>>(args, maps);
  return cudaGetLastError();
}

}  // extern "C"
