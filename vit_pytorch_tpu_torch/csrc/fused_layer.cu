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
// kernels (see ops/fused_block.py::fused_transformer_layer): layernorm_rows
// (this file), gemm_bf16 (gemm_bf16.cu) and attention_rows
// (attention_rows.cu), whose arithmetic lives in layer_tiles.cuh
// (stack_layers.cu runs the same arithmetic for g layers in one launch):
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

// A thin wrapper over layer_tiles.cuh's layernorm_row (its note: what it
// replaces, its bound and design): a warp a row.

__global__ void __launch_bounds__(kLnThreads)
layernorm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ b,
                      bf16* __restrict__ out, int rows, int dim, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kLnThreads / 32) + warp;
  if (row >= rows) return;
  layernorm_row(x, w, b, out, row, dim, eps, lane);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes).  Pointers are device pointers of contiguous bf16
// tensors, 16-byte aligned; the wrapper in ops/fused_block.py checks shapes.
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

}  // extern "C"
