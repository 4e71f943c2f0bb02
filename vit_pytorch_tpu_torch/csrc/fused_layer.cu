// Hopper (sm_90a) kernels for one pre-norm ViT layer, forward (the backward's
// own kernels are in fused_layer_bwd.cu; the backward also runs gemm_bf16,
// with the f32 epilogue below, and layernorm_rows).
//
// They replace the TPU whole-layer kernel vit_pytorch_tpu/ops/fused_block.py::
// _layer_kernel (body _layer_rows).  That kernel holds a whole layer's weights
// in VMEM and pushes row blocks through LN1 -> qkv -> per-head softmax
// attention -> out-proj (+x) -> LN2 -> fc1 -> GELU -> fc2 (+y) in one call.
// An H100 block has 227 KB of shared memory, far less than a layer's weights,
// so the same function runs here as a chain of seven launches of three
// kernels (see ops/fused_block.py::fused_transformer_layer), whose tile
// bodies live in layer_tiles.cuh (stack_layers.cu runs the same bodies for
// g layers in one launch):
//
//   layernorm_rows  LN1                         x    -> h
//   gemm_bf16<QKV>  h  . Wqkv^T (+bqkv in f32)  h    -> qkv
//   attention_rows  softmax(q k^T * scale) v    qkv  -> m     (logits on chip)
//   gemm_bf16<OUT>  m  . Wout^T + bout + x      m    -> y
//   layernorm_rows  LN2                         y    -> h2
//   gemm_bf16<FC1>  gelu_tanh(h2 . W1^T + b1)   h2   -> a
//   gemm_bf16<FC2>  a  . W2^T + b2 + y          a    -> out
//
// Rounding points follow _layer_rows: every product accumulates in f32; the
// qkv bias is added in f32 before the bf16 cast; the out/fc1/fc2 results are
// cast to bf16 first and their bias and residual adds round to bf16 each.
//
// The attention-block kernel _kernel (fused_block.py:260), which the JAX
// package runs where the whole layer is refused (training with dropout,
// qk-norm, SimpleViT's layers), runs here as layernorm_rows ->
// gemm_bf16<QKV> -> attention_rows<DROP, QKNORM> (qk-norm of the q and k
// tiles, dropout on P) -> gemm_bf16<BLOCK_OUT> (bias, output dropout and
// residual in f32, one cast), the dropout drawn in-kernel from common.cuh's
// Philox.
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c -Xcompiler -fPIC
// each source, linked into one shared library and bound with ctypes: every
// entry point returns cudaGetLastError().

#include "layer_tiles.cuh"

namespace {

// The kernels are thin wrappers over the tile bodies of layer_tiles.cuh (their
// notes: what each replaces, its bound and design): one tile a block, its
// coordinates from blockIdx.

__global__ void __launch_bounds__(kLnThreads)
layernorm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ b,
                      bf16* __restrict__ out, int rows, int dim, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kLnThreads / 32) + warp;
  if (row >= rows) return;
  layernorm_row(x, w, b, out, row, dim, eps, lane);
}

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads, 2)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, const bf16* __restrict__ bias,
                 const bf16* __restrict__ res, void* __restrict__ out, int M, int N, int K, BlockOutArgs bo,
                 FfArgs ff) {
  extern __shared__ unsigned char gemm_smem[];
  gemm_tile<EPI>(gemm_smem, A, W, bias, res, out, M, N, K, blockIdx.y * kGemmBM, blockIdx.x * kGemmBN, bo, ff);
}

template <int EPI>
cudaError_t launch_gemm(const bf16* a, const bf16* w, const bf16* bias, const bf16* res, void* out, int M, int N,
                        int K, const BlockOutArgs& bo, cudaStream_t stream, const FfArgs& ff = FfArgs{}) {
  cudaError_t err =
      cudaFuncSetAttribute(gemm_bf16_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
  gemm_bf16_kernel<EPI><<<grid, kGemmThreads, kGemmSmem, stream>>>(a, w, bias, res, out, M, N, K, bo, ff);
  return cudaGetLastError();
}

template <bool DROP, bool QKNORM>
__global__ void __launch_bounds__(kAttnThreads)
attention_rows_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int n, int n_keys, int heads,
                      float scale_log2e, DropoutArgs drop, const bf16* __restrict__ gq, const bf16* __restrict__ gk) {
  extern __shared__ __align__(16) unsigned char attn_smem[];
  attention_tile<DROP, QKNORM>(attn_smem, qkv, out, n, n_keys, heads, scale_log2e, drop, gq, gk,
                               blockIdx.x * kAttnQT, blockIdx.y, blockIdx.z, threadIdx.x, BlockSync{});
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes).  Pointers are device pointers of contiguous bf16
// tensors (the f32 epilogue's output is f32), 16-byte aligned; the wrapper in
// ops/fused_block.py checks shapes.
// ---------------------------------------------------------------------------

extern "C" {

const char* vit_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int vit_layernorm_rows(const void* x, const void* w, const void* b, void* out, int rows, int dim, float eps,
                       void* stream) {
  if (rows <= 0 || dim % 8) return cudaErrorInvalidValue;
  const int per_block = kLnThreads / 32;
  layernorm_rows_kernel<<<(rows + per_block - 1) / per_block, kLnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(b), static_cast<bf16*>(out),
      rows, dim, eps);
  return cudaGetLastError();
}

// block_out: n = rows of one image, heads = the output stream's head index;
// drop = 0 leaves the mask out (seed, threshold, inv unread), and every other
// epilogue ignores all five
int vit_gemm_bf16(const void* a, const void* w, const void* bias, const void* res, void* out, int M, int N, int K,
                  int epilogue, int n, int heads, int drop, unsigned seed, unsigned threshold, float inv,
                  void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || K % kGemmBK || (M + kGemmBM - 1) / kGemmBM > 65535) return cudaErrorInvalidValue;
  const bf16 *pa = static_cast<const bf16*>(a), *pw = static_cast<const bf16*>(w);
  const bf16 *pb = static_cast<const bf16*>(bias), *pr = static_cast<const bf16*>(res);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BlockOutArgs bo{DropoutArgs{seed, threshold, inv}, n, heads, drop};
  switch (epilogue) {
    case kEpiQkv: return launch_gemm<kEpiQkv>(pa, pw, pb, pr, out, M, N, K, bo, s);
    case kEpiOut: return pr ? launch_gemm<kEpiOut>(pa, pw, pb, pr, out, M, N, K, bo, s) : cudaErrorInvalidValue;
    case kEpiFc1: return launch_gemm<kEpiFc1>(pa, pw, pb, pr, out, M, N, K, bo, s);
    case kEpiFc1F32: return launch_gemm<kEpiFc1F32>(pa, pw, pb, nullptr, out, M, N, K, bo, s);
    case kEpiFc2: return pr ? launch_gemm<kEpiFc2>(pa, pw, pb, pr, out, M, N, K, bo, s) : cudaErrorInvalidValue;
    case kEpiF32: return launch_gemm<kEpiF32>(pa, pw, nullptr, nullptr, out, M, N, K, bo, s);
    case kEpiBlockOut:
      if (n <= 0 || M % n || (drop && (N % 4 || heads < 0))) return cudaErrorInvalidValue;
      return launch_gemm<kEpiBlockOut>(pa, pw, pb, pr, out, M, N, K, bo, s);
    default: return cudaErrorInvalidValue;
  }
}

// The FF backward's epilogues: epilogue kEpiFc1Save (6): out = act, h1_out =
// h1, bias = b1 or null; kEpiGeluBwd (7): out = dh1, h1 = the saved h1,
// colpart a (ceil(M / 128), N) f32 scratch buffer, colsum (N) f32 = db1
int vit_gemm_ff(const void* a, const void* w, const void* bias, const void* h1, void* out, void* h1_out,
                void* colpart, void* colsum, int M, int N, int K, int epilogue, void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || K % kGemmBK || (M + kGemmBM - 1) / kGemmBM > 65535) return cudaErrorInvalidValue;
  const bf16 *pa = static_cast<const bf16*>(a), *pw = static_cast<const bf16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BlockOutArgs bo{};
  if (epilogue == kEpiFc1Save) {
    if (!h1_out) return cudaErrorInvalidValue;
    return launch_gemm<kEpiFc1Save>(pa, pw, static_cast<const bf16*>(bias), nullptr, out, M, N, K, bo, s,
                                    FfArgs{static_cast<bf16*>(h1_out), nullptr});
  }
  if (epilogue != kEpiGeluBwd || bias || !h1 || !colpart || !colsum) return cudaErrorInvalidValue;
  float* part = static_cast<float*>(colpart);
  cudaError_t err = launch_gemm<kEpiGeluBwd>(pa, pw, nullptr, static_cast<const bf16*>(h1), out, M, N, K, bo, s,
                                             FfArgs{nullptr, part});
  if (err != cudaSuccess) return err;
  return launch_column_sum(part, static_cast<float*>(colsum), (M + kGemmBM - 1) / kGemmBM, N, 1.f, s);
}

// n_keys: keys j >= n_keys are masked (1 <= n_keys <= n; n: none); drop = 0:
// no dropout (seed, threshold, inv unread); gq, gk: the qk-norm gammas,
// (heads * dim_head) bf16 each, or both null (no qk-norm)
int vit_attention_rows(const void* qkv, void* out, int batch, int n, int n_keys, int heads, int dim_head,
                       float scale_log2e, int drop, unsigned seed, unsigned threshold, float inv, const void* gq,
                       const void* gk, void* stream) {
  if (dim_head != kAttnDh || n <= 0 || n > 16 * kAttnKT || n_keys < 1 || n_keys > n || batch <= 0 ||
      batch > 65535 || heads <= 0 || (gq == nullptr) != (gk == nullptr))
    return cudaErrorInvalidValue;
  const bool qk = gq != nullptr;
  const auto kernel = drop ? (qk ? attention_rows_kernel<true, true> : attention_rows_kernel<true, false>)
                           : (qk ? attention_rows_kernel<false, true> : attention_rows_kernel<false, false>);
  const int smem = drop ? kAttnDropSmem : kAttnSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n + kAttnQT - 1) / kAttnQT, heads, batch);
  kernel<<<grid, kAttnThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), n, n_keys, heads, scale_log2e,
      DropoutArgs{seed, threshold, inv}, static_cast<const bf16*>(gq), static_cast<const bf16*>(gk));
  return cudaGetLastError();
}

}  // extern "C"
