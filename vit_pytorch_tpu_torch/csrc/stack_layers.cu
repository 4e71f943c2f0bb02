// Hopper (sm_90a) kernel stack_layers: g consecutive pre-norm ViT layers,
// forward, in one launch (1 <= g <= 6).  Two instantiations: the package's
// layer (stack_layers_kernel<false>) and the f32 epilogues of its prototype
// in tools/ (<true>, stack_layers[tools]; see the kernel).
//
// Replaces: the TPU multi-layer kernel vit_pytorch_tpu/ops/fused_block.py::
// _stack_kernel (:1979, call :2044), which holds g layers' weights resident
// in VMEM and runs each (ips, n, dim) block of images through all g layers in
// the body of the whole layer, _layer_rows, so that its output is bit-equal
// to g single-layer calls.
//
// Bound on this card: tensor-core throughput.  A ViT-B layer at bs=128 is
// ~372 GFLOP of bf16 products (qkv, out, fc1, fc2, q.k^T and p.v) against
// ~14 MB of weights and 39 MB of x in and out: ~0.38 ms a layer at 989
// TFLOP/s.  What one launch can save over the chain of 7g launches
// (fused_layer.cu, gemm_bf16.cu, attention_rows.cu) is the 7g - 1 launch
// gaps and each launch's tail, and the x write and read between layers
// (~0.023 ms a boundary at 3.35 TB/s).
//
// Design: one persistent cooperative grid of gemm_bf16's block: 384 threads,
// a producer warpgroup and two consumer warpgroups, setmaxnreg 40 / 232 from
// a 168-register launch, one block an SM (the grid is the occupancy the card
// reports, launched with cudaLaunchCooperativeKernel, which refuses rather
// than hangs).  The grid walks the chain's seven steps of every layer in
// order, with a grid barrier (grid_sync) between two steps:
//
//   LN1 (x -> h), qkv (h -> qkv), attention (qkv -> m), out (m, +x -> y),
//   LN2 (y -> h), fc1 (h -> a), fc2 (a, +y -> out; the next layer's x)
//
//  - GEMM steps run gemm_ring.cuh's producer and consumers, the code of
//    gemm_bf16's kernel: 128 x 128 tiles, N fastest, block b taking tiles b,
//    b + grid, ...; the producer thread feeds the 6-stage TMA ring and runs
//    ahead across the block's tiles of a step, and the ring's full and empty
//    mbarriers keep their phases (RingPos) from step to step and layer to
//    layer.  The producer issues a step's first copy only after the grid
//    barrier that publishes its A (and residual), since the same thread
//    takes the block through the barriers.  The tiles are the chain's, so
//    each step's output is bitwise gemm_bf16's.
//  - The attention step: a consumer warpgroup an (image, head) item, on its
//    own named barrier and its own 68 KB of the ring's shared memory; one
//    thread of it loads the item's k and v once, and its query tiles
//    through two stages, by the TMA from 3-D maps of the qkv buffer (rows
//    past n zero-filled), as attention_rows does; a tile's output leaves by
//    a TMA store.  The arithmetic is attention_wg_tile<13, false> at every
//    n: the key chunks past the chain's ceil(n / 16) hold masked keys (p =
//    0) against zero-filled v rows, so they add exact zeros and each tile is
//    bitwise the chain's.  (The chain's 13 instantiations inlined here took
//    the first port's kernel to 255 registers with spills, +0.3 ms a layer;
//    called, not inlined, a wgmma pipeline crossing the call makes ptxas
//    serialise every wgmma of the kernel, the GEMM steps' too.)
//  - LN steps: layernorm_row, a consumer warp a row.
//  - grid_sync: thread 0 of each block adds one to a counter in device
//    memory (red.release.gpu) and polls it (ld.acquire.gpu) until the whole
//    grid has arrived; __syncthreads before and after.  The counter only
//    grows: barrier k waits for k * grid arrivals.  A step's output is
//    written through one proxy and read through the other (TMA stores, read
//    by LN's loads; LN's stores, read by TMA loads; the residual tile the
//    out step loads is the fc2 step's output of the layer before, written
//    in place), so each thread fences both proxies (fence.proxy.async.
//    global) before the barrier and after it, and each block's TMA stores
//    have completed (cp.async.bulk.wait_group 0) before it arrives.
// So every intermediate and the output are bitwise the chain's; x rounds to
// bf16 between layers, in the fc2 epilogue, as _layer_rows returns it.  The
// intermediates go to scratch buffers in device memory that the wrapper
// allocates; the layer's output overwrites `out` in place (the fc2 step
// reads only a and y).
//
// Why not a block or a cluster a chunk of images, as the TPU's grid over
// image blocks: at ViT-B a chunk's per-image intermediates are ~3.5 MB a
// layer, far beyond a cluster's shared memory, so they would go through
// device memory all the same; and a chunk of one image on a cluster of 8
// spreads a bucket of 1 over 8 of the 132 SMs, where the cooperative grid
// spreads each of its steps over every SM at any batch.  The cost: 7g - 1
// grid barriers.
// Shared memory: the union of gemm_bf16's ring (6 stages of 32 KB, the
// consumers' 2 x 16 KB staging, its mbarriers) and two attention tiles of q
// (two stages), k and v at 13 key chunks (2 x 68 KB, inside the ring's
// stages), + 48 bytes of attention mbarriers: 230,608 B of 232,448.
// Kernel parameters: 24 weight maps and 11 activation maps of 128 B, passed
// __grid_constant__ with the layers' other pointers: kStackParamBytes =
// 456 + 4,480 = 4,936 B at any g (4,992 with the maps' 64-byte alignment);
// the limit is 32,764 B since CUDA 12.1, 4 KB before.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a), bound
// with ctypes: vit_stack_layers returns the launch's cudaError_t.

#include "gemm_ring.cuh"

#if CUDART_VERSION < 12010
#error "stack_layers passes its tensor maps as a kernel-parameter block over 4 KB: CUDA 12.1 or later"
#endif

namespace {

constexpr int kStackMaxLayers = 6;  // _STACK_MAX_LAYERS
constexpr int kStackRingEpi = kEpiQkv;  // every step's ring (all four epilogues stage bf16)
// one consumer's attention tile: two query stages, k and v (16 * 13 rows), swizzled
constexpr int kStackAttnBytes = 2 * kSwTileBytes + 2 * 16 * kAttnKT * kAttnDh * static_cast<int>(sizeof(bf16));
constexpr int kStackAttnBars = 3 * kConsumers;  // a consumer's kv_full and two q_full
constexpr int kStackSmem = gemm_smem(kStackRingEpi) + kStackAttnBars * 8;
static_assert(kStackSmem <= kMaxSmem, "the ring and the attention barriers fit one block");
static_assert(kConsumers * kStackAttnBytes <= ring_stages(kStackRingEpi) * kStageBytes,
              "the attention tiles fit inside the ring's stages");
static_assert(ring_stages(kEpiOut) == ring_stages(kStackRingEpi) && ring_stages(kEpiFc1) == ring_stages(kStackRingEpi) &&
                  ring_stages(kEpiFc2) == ring_stages(kStackRingEpi) &&
                  ring_stages(kEpiBlockOut) == ring_stages(kStackRingEpi) &&
                  ring_stages(kEpiFc1F32) == ring_stages(kStackRingEpi) &&
                  staging_bytes(kEpiFc1F32) == staging_bytes(kStackRingEpi) &&
                  staging_bytes(kEpiBlockOut) == staging_bytes(kStackRingEpi),
              "one ring layout serves every step's epilogue");

// one layer's operands other than its weights (which go by tensor map):
// b_qkv and b_out may be null
struct StackLayer {
  const bf16 *b_qkv, *b_out, *ln1s, *ln1b, *ln2s, *ln2b, *b1, *b2;
};

struct StackArgs {
  StackLayer layer[kStackMaxLayers];
  const bf16* x;
  bf16* out;
  bf16 *h, *y;    // the LN steps' operands (read and written by generic loads and stores)
  unsigned* bar;  // the grid barrier's arrival count, zeroed before the launch
  int layers, batch, n, dim, heads, mlp;
  float scale_log2e, eps;
};

// The tensor maps: each layer's w_qkv, w_out, w1, w2 (gemm_weight_map's);
// the activations as A operands (64 x 128 boxes), as outputs and residuals
// (64 x 64), and the qkv and m buffers as (columns, n, images) for the
// attention (q and out: 64 rows; k, v: 16 * 13 rows)
struct alignas(64) StackMaps {
  CUtensorMap w[kStackMaxLayers][4];
  CUtensorMap h, qkv, q3, kv3, m3, m, y, a_out, a, x, out;
};

constexpr int kStackParamBytes = static_cast<int>(sizeof(StackArgs) + sizeof(StackMaps));
static_assert(kStackParamBytes <= 32764, "the kernel-parameter block");

__device__ __forceinline__ void red_release_gpu_add(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the (co-resident) grid waits here until all have arrived;
// the writes of each before it, generic or by the TMA (completed), are
// visible to all after it, to both proxies.  `arrivals` counts the grid's
// arrivals this block has waited for; every thread of the block calls it,
// in the same order.  Bounded: a barrier that never opens traps (an error
// the launch reports) instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& arrivals) {
  fence_proxy_async_global();
  __syncthreads();
  arrivals += gridDim.x;
  if (threadIdx.x == 0) {
    red_release_gpu_add(bar, 1u);
    for (int spin = 0; ld_acquire_gpu(bar) < arrivals; ++spin)
      if (spin > (1 << 22)) __trap();
  }
  __syncthreads();
  fence_proxy_async_global();
}

// LN of every row, a consumer warp a row (cw: the consumer warpgroup)
__device__ __forceinline__ void ln_step(const bf16* x, const bf16* w, const bf16* b, bf16* out, int rows, int dim,
                                        float eps, int cw, int wtid) {
  constexpr int kWarps = 4 * kConsumers;
  const int lane = wtid & 31;
  for (int row = blockIdx.x * kWarps + cw * 4 + (wtid >> 5); row < rows; row += gridDim.x * kWarps)
    layernorm_row<true>(x, w, b, out, row, dim, eps, lane);
}

// a consumer's attention mbarriers' parities: kv_full's, and q_full[b]'s in bit b
struct AttnPhase {
  uint32_t kv, q;
};

// every (head, image) of the attention, a consumer warpgroup an item (cw,
// wtid: the warpgroup and the thread's index in it): the item's k and v
// loaded once, its query tiles through two stages; tiles: the warpgroup's
// kStackAttnBytes of shared memory, bars its three mbarriers.  Waits for its
// last store.
__device__ __forceinline__ void attention_step(unsigned char* tiles, uint64_t* bars, const CUtensorMap* q3,
                                               const CUtensorMap* kv3, const CUtensorMap* m3, int batch, int n,
                                               int heads, float scale_log2e, AttnPhase& ph, int cw, int wtid) {
  constexpr int KT = kAttnKT, NP = 16 * KT;
  bf16* qring = reinterpret_cast<bf16*>(tiles);  // two 64-row query stages
  bf16* ks = qring + 2 * kSwTile;
  bf16* vs = ks + NP * kAttnDh;
  uint64_t* kv_full = bars;
  uint64_t* q_full = bars + 1;  // [2]
  const int inner = heads * kAttnDh, items = heads * batch, qtiles = (n + kAttnQT - 1) / kAttnQT;
  const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
  for (int it = kConsumers * blockIdx.x + cw; it < items; it += kConsumers * gridDim.x) {
    const int h = it % heads, img = it / heads;
    named_sync(1 + cw, kAttnThreads);  // every warp is done with the last item's tiles
    if (wtid == 0) {
      bulk_wait_read();  // the last item's stores have read their query stages
      mbar_expect(kv_full, 2 * NP * kAttnDh * static_cast<int>(sizeof(bf16)));
      tma_load_3d(ks, kv3, inner + h * kAttnDh, 0, img, kv_full);
      tma_load_3d(vs, kv3, 2 * inner + h * kAttnDh, 0, img, kv_full);
      for (int i = 0; i < 2 && i < qtiles; ++i) {
        mbar_expect(q_full + i, kSwTileBytes);
        tma_load_3d(qring + i * kSwTile, q3, h * kAttnDh, i * kAttnQT, img, q_full + i);
      }
    }
    mbar_wait(kv_full, ph.kv);
    ph.kv ^= 1u;
    for (int qt = 0; qt < qtiles; ++qt) {
      const int buf = qt & 1, q0 = qt * kAttnQT;
      bf16* qs = qring + buf * kSwTile;
      mbar_wait(q_full + buf, (ph.q >> buf) & 1u);
      ph.q ^= 1u << buf;
      float o[8][4];
      attention_wg_tile<KT, false>(o, qs, ks, vs, nullptr, n, scale_log2e, 1.f, wtid);
      named_sync(1 + cw, kAttnThreads);  // every warp's products have read the query stage

      // the output tile, bf16, into the query stage, then one TMA store
      const int r = warp * 16 + g;
#pragma unroll
      for (int dj = 0; dj < 8; ++dj) {
        *reinterpret_cast<uint32_t*>(qs + sw_off(r, dj * 8 + 2 * t)) = pack_floats(o[dj][0], o[dj][1]);
        *reinterpret_cast<uint32_t*>(qs + sw_off(r + 8, dj * 8 + 2 * t)) = pack_floats(o[dj][2], o[dj][3]);
      }
      fence_proxy_async();
      named_sync(1 + cw, kAttnThreads);
      if (wtid == 0) {
        tma_store_3d(m3, qs, h * kAttnDh, q0, img);
        bulk_commit();
        if (qt + 2 < qtiles) {  // the stage's next query tile, once the store has read it
          bulk_wait_read();
          mbar_expect(q_full + buf, kSwTileBytes);
          tma_load_3d(qs, q3, h * kAttnDh, q0 + 2 * kAttnQT, img, q_full + buf);
        }
      }
    }
  }
  if (wtid == 0) bulk_wait();
}

// TOOLS: the epilogues of the layer prototype in tools/ (bench_stack_fusion.py::
// make_stack, :105, call :129, layer body _layer_rows :72-102), which adds
// in f32 and casts once: the out projection and fc2 are kEpiBlockOut
// without dropout (att + x; dot + b2 + y), fc1 kEpiFc1F32.  Else the
// package's _layer_rows, each product rounded first (kEpiOut, kEpiFc1,
// kEpiFc2).  Either way every tile is the matching chain's body, so the
// result is bitwise that chain's.
template <bool TOOLS>
__global__ void __launch_bounds__(kWsThreads, 1)
    stack_layers_kernel(const __grid_constant__ StackArgs p, const __grid_constant__ StackMaps maps) {
  constexpr int S = ring_stages(kStackRingEpi);
  constexpr int kOut = TOOLS ? kEpiBlockOut : kEpiOut, kFc1 = TOOLS ? kEpiFc1F32 : kEpiFc1;
  constexpr int kFc2 = TOOLS ? kEpiBlockOut : kEpiFc2;
  extern __shared__ unsigned char stack_raw[];
  unsigned char* smem = aligned_smem(stack_raw);
  const GemmRing ring = gemm_ring<kStackRingEpi>(smem);
  uint64_t* attn_bars = ring.end;
  if (threadIdx.x == 0) {
    gemm_ring_init<kStackRingEpi>(ring);
    for (int i = 0; i < kStackAttnBars; ++i) mbar_init(attn_bars + i, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int M = p.batch * p.n, inner = p.heads * kAttnDh;
  RingPos pos{0, 0u, 0, 0};
  unsigned arrivals = 0;
  if (threadIdx.x < 128) {
    // the producer warpgroup: thread 0 issues the GEMM steps' copies and
    // takes the block through the grid barriers; the warp meets before each
    regs_dec<kProducerRegs>();
    const bool issuer = threadIdx.x == 0;
    for (int l = 0; l < p.layers; ++l) {
      grid_sync(p.bar, arrivals);  // h: LN1 done
      if (issuer) gemm_produce<S>(ring, &maps.h, &maps.w[l][0], nullptr, M, 3 * inner, p.dim, pos);
      __syncwarp();
      grid_sync(p.bar, arrivals);  // qkv done
      grid_sync(p.bar, arrivals);  // m: attention done
      if (issuer) gemm_produce<S>(ring, &maps.m, &maps.w[l][1], l == 0 ? &maps.x : &maps.out, M, p.dim, inner, pos);
      __syncwarp();
      grid_sync(p.bar, arrivals);  // y: out projection done
      grid_sync(p.bar, arrivals);  // h: LN2 done
      if (issuer) gemm_produce<S>(ring, &maps.h, &maps.w[l][2], nullptr, M, p.mlp, p.dim, pos);
      __syncwarp();
      grid_sync(p.bar, arrivals);  // a: fc1 done
      if (issuer) gemm_produce<S>(ring, &maps.a, &maps.w[l][3], &maps.y, M, p.dim, p.mlp, pos);
      __syncwarp();
      if (l + 1 < p.layers) grid_sync(p.bar, arrivals);  // out: the next layer's x
    }
    return;
  }

  regs_inc<kConsumerRegs>();  // a consumer warpgroup: 64 rows of each GEMM tile, its own attention items
  const int cw = (threadIdx.x >> 7) - 1, wtid = threadIdx.x & 127;
  AttnPhase ph{0u, 0u};
  for (int l = 0; l < p.layers; ++l) {
    const StackLayer& L = p.layer[l];
    const bf16* x = l == 0 ? p.x : p.out;
    ln_step(x, L.ln1s, L.ln1b, p.h, M, p.dim, p.eps, cw, wtid);
    grid_sync(p.bar, arrivals);  // h: LN1 done
    gemm_consume<kEpiQkv, S>(ring, GemmArgs{L.b_qkv, M, 3 * inner, p.dim, 0, BlockOutArgs{}, nullptr}, &maps.qkv,
                             nullptr, cw, wtid, pos);
    if (wtid == 0) bulk_wait();
    grid_sync(p.bar, arrivals);  // qkv done
    attention_step(smem + cw * kStackAttnBytes, attn_bars + 3 * cw, &maps.q3, &maps.kv3, &maps.m3, p.batch, p.n,
                   p.heads, p.scale_log2e, ph, cw, wtid);
    grid_sync(p.bar, arrivals);  // m: attention done
    gemm_consume<kOut, S>(ring, GemmArgs{L.b_out, M, p.dim, inner, 1, BlockOutArgs{}, nullptr}, &maps.y, nullptr,
                          cw, wtid, pos);
    if (wtid == 0) bulk_wait();
    grid_sync(p.bar, arrivals);  // y: out projection done
    ln_step(p.y, L.ln2s, L.ln2b, p.h, M, p.dim, p.eps, cw, wtid);
    grid_sync(p.bar, arrivals);  // h: LN2 done
    gemm_consume<kFc1, S>(ring, GemmArgs{L.b1, M, p.mlp, p.dim, 0, BlockOutArgs{}, nullptr}, &maps.a_out, nullptr,
                          cw, wtid, pos);
    if (wtid == 0) bulk_wait();
    grid_sync(p.bar, arrivals);  // a: fc1 done
    gemm_consume<kFc2, S>(ring, GemmArgs{L.b2, M, p.dim, p.mlp, 1, BlockOutArgs{}, nullptr}, &maps.out, nullptr, cw,
                          wtid, pos);
    if (wtid == 0) bulk_wait();
    if (l + 1 < p.layers) grid_sync(p.bar, arrivals);  // out: the next layer's x
  }
}

}  // namespace

extern "C" {

// weights: layers x 12 device pointers in the JAX layer tuple's order
// (w_qkv, b_qkv, w_out, b_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2; nn.Linear
// (out, in) weights, b_qkv and b_out may be null); h, qkv, m, y, a: scratch
// of (b*n) rows of dim, 3*inner, inner, dim, mlp; barrier: 2 unsigned ints,
// zeroed here on the stream (the first is the grid barrier's counter);
// tools: 1 for the tools/ prototype's epilogues.  Pointers are device
// pointers of contiguous bf16 tensors, 16-byte aligned.
int vit_stack_layers(const void* x, void* out, const void* const* weights, int layers, void* h, void* qkv, void* m,
                     void* y, void* a, void* barrier, int batch, int n, int dim, int heads, int dim_head, int mlp,
                     float scale_log2e, float eps, int tools, void* stream) {
  if (layers < 1 || layers > kStackMaxLayers || dim_head != kAttnDh || n <= 0 || n > 16 * kAttnKT || batch <= 0 ||
      heads <= 0 || dim % kGemmBK || (heads * kAttnDh) % kGemmBK || mlp % kGemmBK)
    return cudaErrorInvalidValue;
  const auto kernel = tools ? stack_layers_kernel<true> : stack_layers_kernel<false>;
  const int regs = tools ? launch_regs<stack_layers_kernel<true>>() : launch_regs<stack_layers_kernel<false>>();
  if (regs < kLaunchRegs) return cudaErrorInvalidConfiguration;

  const int inner = heads * kAttnDh;
  const long long M = static_cast<long long>(batch) * n;
  StackArgs p{};
  StackMaps maps{};
  for (int l = 0; l < layers; ++l) {
    const bf16* const* w = reinterpret_cast<const bf16* const*>(weights) + 12 * l;
    if (!w[0] || !w[2] || !w[4] || !w[5] || !w[6] || !w[7] || !w[8] || !w[10]) return cudaErrorInvalidValue;
    p.layer[l] = StackLayer{w[1], w[3], w[4], w[5], w[6], w[7], w[9], w[11]};
    if (!gemm_weight_map(maps.w[l][0], w[0], 3 * inner, dim) || !gemm_weight_map(maps.w[l][1], w[2], dim, inner) ||
        !gemm_weight_map(maps.w[l][2], w[8], mlp, dim) || !gemm_weight_map(maps.w[l][3], w[10], dim, mlp))
      return cudaErrorInvalidValue;
  }
  if (!matrix_map(maps.h, h, false, M, dim, kGemmBK, kGemmBM) ||
      !matrix_map(maps.qkv, qkv, false, M, 3 * inner, 64, 64) ||
      !rows_map(maps.q3, qkv, 3 * inner, n, batch, kAttnQT) ||
      !rows_map(maps.kv3, qkv, 3 * inner, n, batch, 16 * kAttnKT) ||
      !rows_map(maps.m3, m, inner, n, batch, kAttnQT) || !matrix_map(maps.m, m, false, M, inner, kGemmBK, kGemmBM) ||
      !matrix_map(maps.y, y, false, M, dim, 64, 64) || !matrix_map(maps.a_out, a, false, M, mlp, 64, 64) ||
      !matrix_map(maps.a, a, false, M, mlp, kGemmBK, kGemmBM) || !matrix_map(maps.x, x, false, M, dim, 64, 64) ||
      !matrix_map(maps.out, out, false, M, dim, 64, 64))
    return cudaErrorInvalidValue;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.h = static_cast<bf16*>(h), p.y = static_cast<bf16*>(y);
  p.bar = static_cast<unsigned*>(barrier);
  p.layers = layers, p.batch = batch, p.n = n, p.dim = dim, p.heads = heads, p.mlp = mlp;
  p.scale_log2e = scale_log2e, p.eps = eps;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStackSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWsThreads, kStackSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(barrier, 0, 2 * sizeof(unsigned), s)) != cudaSuccess) return err;
  void* args[] = {&p, &maps};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(sms * per_sm), dim3(kWsThreads), args,
                                    kStackSmem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
