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
//    group that read it.  These are the first port's GEMM tile's products
//    in its order (the same instruction, the same k16 steps in ascending k,
//    no split-K), so every epilogue's output keeps that kernel's bits
//    (chip_gemm_bits.py holds them to a parent's).  setmaxnreg gives the consumers 232 registers and the
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
// The producer's and the consumers' loops are gemm_ring.cuh's (the stack's
// GEMM steps, stack_layers.cu, run the same functions).
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a), bound
// with ctypes: each entry point returns the launch's cudaError_t.

#include <mutex>

#include "gemm_ring.cuh"

namespace {

// The tensor maps of a launch: A (M, K), W (N, K) in 64 x 128 boxes; the
// residual or h1 (M, N) read, the output (M, N) and fc1_save's h1 written,
// in 64 x 64 boxes (32 x 64 for the f32 output)
struct alignas(64) GemmMaps {
  CUtensorMap a, w, res, out, aux;
};

template <int EPI>
__global__ void __launch_bounds__(kWsThreads, 1) gemm_bf16_kernel(GemmArgs p, const __grid_constant__ GemmMaps maps) {
  constexpr int S = ring_stages(EPI);
  extern __shared__ unsigned char gemm_raw[];
  const GemmRing ring = gemm_ring<EPI>(aligned_smem(gemm_raw));
  if (threadIdx.x == 0) {
    gemm_ring_init<EPI>(ring);
    mbar_fence_init();
  }
  __syncthreads();

  RingPos pos{0, 0u, 0, 0};
  if (threadIdx.x < 128) {  // the producer: one thread issues every copy
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) gemm_produce<S>(ring, &maps.a, &maps.w, p.has_res ? &maps.res : nullptr, p.M, p.N, p.K, pos);
    return;
  }
  regs_inc<kConsumerRegs>();  // a consumer: 64 rows of each tile
  const int wtid = threadIdx.x & 127;
  gemm_consume<EPI, S>(ring, p, &maps.out, &maps.aux, (threadIdx.x >> 7) - 1, wtid, pos);
  if (wtid == 0) bulk_wait();  // the last store is done before the block's shared memory goes
}

}  // namespace

// The W map of a weight (N, K): encoded once for each (pointer, shape) and
// kept (a map holds only the address, the shape and the box, so a reused
// address of the same shape keeps a right map); gemm_bf16 and stack_layers
// share the cache
bool gemm_weight_map(CUtensorMap& map, const void* w, int N, int K) {
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

namespace {

template <int EPI>
cudaError_t launch_gemm(const void* a, const void* w, const void* res, void* out, void* aux, GemmArgs p,
                        cudaStream_t stream) {
  if (launch_regs<gemm_bf16_kernel<EPI>>() < kLaunchRegs) return cudaErrorInvalidConfiguration;
  GemmMaps maps{};
  const bool f32 = EPI == kEpiF32;
  if (!matrix_map(maps.a, a, false, p.M, p.K, kGemmBK, kGemmBM) || !gemm_weight_map(maps.w, w, p.N, p.K) ||
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
