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
// Design: one persistent cooperative grid.  An H100 block has 227 KB of
// shared memory against a layer's 14 MB of weights, so no block can hold a
// layer; instead the grid (one block of 256 threads an SM, co-resident by
// construction: its size is the occupancy the card reports, launched with
// cudaLaunchCooperativeKernel, which refuses rather than hangs) walks the
// chain's seven steps of every layer in order:
//
//   LN1 (x -> h), qkv (h -> qkv), attention (qkv -> m), out (m, +x -> y),
//   LN2 (y -> h), fc1 (h -> a), fc2 (a, +y -> out; the next layer's x)
//
// Each step spreads its tiles over every block: warps take LN rows, blocks
// take 128x128 GEMM tiles (N fastest, as the chain's grid), warpgroups take
// (head, image) attention items, each with its own named barrier, and load
// the item's k and v once for its query tiles, as the chain's kernel does.
// A grid-wide barrier (grid_sync) separates the steps.  Each tile runs a
// body from layer_tiles.cuh with the chain's arithmetic: the attention tile
// is the chain's own wgmma body (at 13 key chunks, whose extra chunks add
// exact zeros), its q, k and v brought in by generic 16-byte loads where the
// chain's kernel has the TMA; a GEMM tile is the first port's gemm_tile,
// whose main loop (wgmma k16 steps in ascending k into f32) and epilogue
// arithmetic (epilogue_pair) are the chain's gemm_bf16's.  So every
// intermediate and the output are bitwise the chain's; x rounds to bf16
// between layers, in the fc2 epilogue, as _layer_rows returns it.  The
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
// grid barriers, and one block an SM of 256 threads.
// Shared memory: max(the GEMM ring 99,328 B, two attention tiles of q, k
// and v at KT = 13, 2 x 61,440 B, + 1 KB to align them) = 123,904 B.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a), bound
// with ctypes: vit_stack_layers returns the launch's cudaError_t.

#include "layer_tiles.cuh"

namespace {

constexpr int kStackMaxLayers = 6;  // _STACK_MAX_LAYERS
constexpr int kStackThreads = 256;  // two warpgroups: the GEMM tile's block
// one warpgroup's attention tile: q (64 rows), k and v (16 * 13 rows), swizzled
constexpr int kStackAttnBytes = (kAttnQT + 2 * 16 * kAttnKT) * kAttnDh * static_cast<int>(sizeof(bf16));
constexpr int kStackSmem = 2 * kStackAttnBytes + kWgAlign > kGemmSmem ? 2 * kStackAttnBytes + kWgAlign : kGemmSmem;
static_assert(kStackThreads == kGemmThreads && kStackThreads == 2 * kAttnThreads, "one GEMM tile or two attention tiles");

// one layer's operands in the order of the JAX layer tuple; b_qkv, b_out
// may be null
struct StackLayer {
  const bf16 *w_qkv, *b_qkv, *w_out, *b_out, *ln1s, *ln1b, *ln2s, *ln2b, *w1, *b1, *w2, *b2;
};

struct StackArgs {
  StackLayer layer[kStackMaxLayers];
  const bf16* x;
  bf16* out;
  bf16 *h, *qkv, *m, *y, *a;  // scratch: (M, dim), (M, 3 inner), (M, inner), (M, dim), (M, mlp)
  unsigned* bar;              // the grid barrier's arrival count and generation, zeroed before the launch
  int layers, batch, n, dim, heads, mlp;
  float scale_log2e, eps;
};

// Every block of the (co-resident) grid waits here until all have arrived;
// the writes of each before it are visible to all after it.  Thread 0 of a
// block reads the generation, publishes the block's writes (__threadfence),
// arrives; the last to arrive resets the count and opens the next
// generation; the rest spin on it.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// LN of every row, one warp a row
__device__ __forceinline__ void ln_step(const bf16* x, const bf16* w, const bf16* b, bf16* out, int rows, int dim,
                                        float eps) {
  const int warps = gridDim.x * (kStackThreads / 32), lane = threadIdx.x & 31;
  for (int row = blockIdx.x * (kStackThreads / 32) + (threadIdx.x >> 5); row < rows; row += warps)
    layernorm_row(x, w, b, out, row, dim, eps, lane);
}

// every 128x128 tile of A . W^T with the epilogue EPI, a block a tile
template <int EPI>
__device__ __forceinline__ void gemm_step(unsigned char* smem, const bf16* A, const bf16* W, const bf16* bias,
                                          const bf16* res, bf16* out, int M, int N, int K) {
  const int ntiles = (N + kGemmBN - 1) / kGemmBN;
  const int mtiles = (M + kGemmBM - 1) / kGemmBM;
  for (int tile = blockIdx.x; tile < mtiles * ntiles; tile += gridDim.x) {
    __syncthreads();  // both warpgroups are done with the ring of the block's last tile
    gemm_tile<EPI>(smem, A, W, bias, res, out, M, N, K, (tile / ntiles) * kGemmBM, (tile % ntiles) * kGemmBN,
                   BlockOutArgs{}, FfArgs{});
  }
}

// every (head, image) of the attention, a warpgroup an item, each warpgroup
// on its own named barrier: the item's k and v loaded once, then its query
// tiles in order.  One instantiation, the 13 key chunks of n = 208, at every
// n: the chunks past the chain's ceil(n / 16) hold masked keys (p = 0)
// against zero-filled v rows, so they add exact zeros and each tile is
// bitwise the chain's.  (The chain's 13 instantiations inlined here took the
// kernel to 255 registers with spills, +0.3 ms a layer; called, not inlined,
// a wgmma pipeline crossing the call makes ptxas serialise every wgmma of
// the kernel, the GEMM steps' too.)
__device__ __forceinline__ void attention_step(unsigned char* smem, const bf16* qkv, bf16* m, int batch, int n,
                                               int heads, float scale_log2e) {
  constexpr int KT = kAttnKT;
  const int wg = threadIdx.x >> 7, wtid = threadIdx.x & 127;
  bf16* qs = reinterpret_cast<bf16*>(aligned_smem(smem) + wg * kStackAttnBytes);
  bf16* ks = qs + kAttnQT * kAttnDh;
  bf16* vs = ks + 16 * KT * kAttnDh;
  const int inner = heads * kAttnDh, items = heads * batch;
  const size_t rstride = 3 * static_cast<size_t>(inner);
  const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
  for (int it = 2 * blockIdx.x + wg; it < items; it += 2 * gridDim.x) {
    const int h = it % heads, img = it / heads;
    const bf16* base = qkv + static_cast<size_t>(img) * n * rstride + h * kAttnDh;
    named_sync(1 + wg, kAttnThreads);  // the warpgroup is done with its last item's shared memory
    load_head_rows_sw<16 * KT>(ks, base + inner, rstride, 0, n, wtid);
    load_head_rows_sw<16 * KT>(vs, base + 2 * inner, rstride, 0, n, wtid);
    for (int q0 = 0; q0 < n; q0 += kAttnQT) {
      if (q0 > 0) named_sync(1 + wg, kAttnThreads);  // every warp's products have read the last query tile
      load_head_rows_sw<kAttnQT>(qs, base, rstride, q0, n, wtid);
      fence_proxy_async();
      named_sync(1 + wg, kAttnThreads);
      float o[8][4];
      attention_wg_tile<KT, false>(o, qs, ks, vs, nullptr, n, scale_log2e, 1.f, wtid);
      const int row0 = q0 + warp * 16 + g;
      bf16* orow = m + (static_cast<size_t>(img) * n + row0) * inner + h * kAttnDh + 2 * t;
#pragma unroll
      for (int dj = 0; dj < 8; ++dj) {
        if (row0 < n) *reinterpret_cast<uint32_t*>(orow + dj * 8) = pack_floats(o[dj][0], o[dj][1]);
        if (row0 + 8 < n) *reinterpret_cast<uint32_t*>(orow + 8 * inner + dj * 8) = pack_floats(o[dj][2], o[dj][3]);
      }
    }
  }
}

// TOOLS: the epilogues of the layer prototype in tools/ (bench_stack_fusion.py::
// make_stack, :105, call :129, layer body _layer_rows :72-102), which adds
// in f32 and casts once: the out projection and fc2 are kEpiBlockOut
// without dropout (att + x; dot + b2 + y), fc1 kEpiFc1F32.  Else the
// package's _layer_rows, each product rounded first (kEpiOut, kEpiFc1,
// kEpiFc2).  Either way every tile is the matching chain's body, so the
// result is bitwise that chain's.
template <bool TOOLS>
__global__ void __launch_bounds__(kStackThreads, 1) stack_layers_kernel(StackArgs p) {
  extern __shared__ __align__(16) unsigned char stack_smem[];
  constexpr int kOut = TOOLS ? kEpiBlockOut : kEpiOut, kFc1 = TOOLS ? kEpiFc1F32 : kEpiFc1;
  constexpr int kFc2 = TOOLS ? kEpiBlockOut : kEpiFc2;
  const int M = p.batch * p.n, inner = p.heads * kAttnDh;
  for (int l = 0; l < p.layers; ++l) {
    const StackLayer& L = p.layer[l];
    const bf16* x = l == 0 ? p.x : p.out;
    ln_step(x, L.ln1s, L.ln1b, p.h, M, p.dim, p.eps);
    grid_sync(p.bar);  // h: LN1 done
    gemm_step<kEpiQkv>(stack_smem, p.h, L.w_qkv, L.b_qkv, nullptr, p.qkv, M, 3 * inner, p.dim);
    grid_sync(p.bar);  // qkv done
    attention_step(stack_smem, p.qkv, p.m, p.batch, p.n, p.heads, p.scale_log2e);
    grid_sync(p.bar);  // m: attention done
    gemm_step<kOut>(stack_smem, p.m, L.w_out, L.b_out, x, p.y, M, p.dim, inner);
    grid_sync(p.bar);  // y: out projection done
    ln_step(p.y, L.ln2s, L.ln2b, p.h, M, p.dim, p.eps);
    grid_sync(p.bar);  // h: LN2 done
    gemm_step<kFc1>(stack_smem, p.h, L.w1, L.b1, nullptr, p.a, M, p.mlp, p.dim);
    grid_sync(p.bar);  // a: fc1 done
    gemm_step<kFc2>(stack_smem, p.a, L.w2, L.b2, p.y, p.out, M, p.dim, p.mlp);
    if (l + 1 < p.layers) grid_sync(p.bar);  // out: the next layer's x
  }
}

}  // namespace

extern "C" {

// weights: layers x 12 device pointers in the JAX layer tuple's order
// (w_qkv, b_qkv, w_out, b_out, ln1s, ln1b, ln2s, ln2b, w1, b1, w2, b2; nn.Linear
// (out, in) weights, b_qkv and b_out may be null); h, qkv, m, y, a: scratch
// of (b*n) rows of dim, 3*inner, inner, dim, mlp; barrier: 2 unsigned ints,
// zeroed here on the stream; tools: 1 for the tools/ prototype's epilogues
int vit_stack_layers(const void* x, void* out, const void* const* weights, int layers, void* h, void* qkv, void* m,
                     void* y, void* a, void* barrier, int batch, int n, int dim, int heads, int dim_head, int mlp,
                     float scale_log2e, float eps, int tools, void* stream) {
  if (layers < 1 || layers > kStackMaxLayers || dim_head != kAttnDh || n <= 0 || n > 16 * kAttnKT || batch <= 0 ||
      heads <= 0 || dim % kGemmBK || (heads * kAttnDh) % kGemmBK || mlp % kGemmBK)
    return cudaErrorInvalidValue;
  StackArgs p{};
  for (int l = 0; l < layers; ++l) {
    const bf16* const* w = reinterpret_cast<const bf16* const*>(weights) + 12 * l;
    p.layer[l] = StackLayer{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], w[8], w[9], w[10], w[11]};
    if (!w[0] || !w[2] || !w[4] || !w[5] || !w[6] || !w[7] || !w[8] || !w[10]) return cudaErrorInvalidValue;
  }
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.h = static_cast<bf16*>(h), p.qkv = static_cast<bf16*>(qkv), p.m = static_cast<bf16*>(m);
  p.y = static_cast<bf16*>(y), p.a = static_cast<bf16*>(a);
  p.bar = static_cast<unsigned*>(barrier);
  p.layers = layers, p.batch = batch, p.n = n, p.dim = dim, p.heads = heads, p.mlp = mlp;
  p.scale_log2e = scale_log2e, p.eps = eps;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = tools ? stack_layers_kernel<true> : stack_layers_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStackSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kStackThreads, kStackSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(barrier, 0, 2 * sizeof(unsigned), s)) != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(sms * per_sm), dim3(kStackThreads),
                                    args, kStackSmem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
