// Hopper (sm_90a) kernels of the attention dropout that stand apart from
// the products: the attention block's output-dropout gradient, and the mask
// replays of the attention block and of the flash kernels.  All draw their
// bits from keep_nibble (common.cuh), the Philox4x32-10 function every
// dropout kernel draws from, so they see the masks that attention_rows,
// gemm_bf16[block_out], attention_bwd_rows and the flash kernels'
// [dropout] instantiations (flash_attention.cu) apply.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// dropout_apply
//
// Replaces: the first lines of ops/fused_block.py::_bwd_kernel (:574-580):
//   gm = bf16(where(out_keep, f32(g), 0) * 1/(1 - rate))
// the out projection's gradient after the output dropout, with out_keep the
// (seed, img, heads) stream (_out_keep :182-187).  gm feeds dm = gm . W_out,
// dW_out and db_out.
// Bound on this card: memory.  A read and a write of a (rows, dim) bf16
// matrix, 4 bytes an element, and one Philox call per 4 elements (~200
// integer operations, ~50 an element): at 3.35 TB/s and ~60 T integer
// operations/s the two are of one order, so it is near both bounds.
// Design: one thread per 8 elements of a row (a 16-byte load and store, two
// Philox calls); a grid-stride loop.
// ---------------------------------------------------------------------------

constexpr int kApplyThreads = 256;

__global__ void __launch_bounds__(kApplyThreads)
dropout_apply_kernel(const bf16* __restrict__ g, bf16* __restrict__ gm, long long vecs, int n, int dim, int heads,
                     DropoutArgs drop) {
  const int per_row = dim / 8;
  for (long long v = blockIdx.x * static_cast<long long>(kApplyThreads) + threadIdx.x; v < vecs;
       v += static_cast<long long>(gridDim.x) * kApplyThreads) {
    const long long row = v / per_row;
    const int col = static_cast<int>(v - row * per_row) * 8;
    const int img = static_cast<int>(row / n), r = static_cast<int>(row - static_cast<long long>(img) * n);
    const uint32_t stream = dropout_stream(img, heads);
    const uint32_t keep = keep_nibble(drop, stream, r, col / 4) | (keep_nibble(drop, stream, r, col / 4 + 1) << 4);
    const uint4 u = *reinterpret_cast<const uint4*>(g + v * 8);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    uint4 o;
    uint32_t* po = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      po[i] = pack_floats(((keep >> (2 * i)) & 1u) ? f.x * drop.inv : 0.f,
                          ((keep >> (2 * i + 1)) & 1u) ? f.y * drop.inv : 0.f);
    }
    *reinterpret_cast<uint4*>(gm + v * 8) = o;
  }
}

// ---------------------------------------------------------------------------
// dropout_masks and flash_dropout_masks
//
// Replace: ops/fused_block.py::dropout_masks (:190, its pallas_call :210),
// the replay of the fused kernels' keep masks for equivalence tests:
// attn_keep (b, heads, n, n) and out_keep (b, n, dim), int32 0/1; and
// ops/flash_attention.py::flash_dropout_masks (:897, its pallas_call :923),
// the flash kernels' keep masks (b, heads, n, m), int32 0/1.  The TPU's
// flash masks depend on its tiles (_tile_keep :84-98); these are keyed by
// element, so flash_dropout_masks(seed, b, h, n, n) equals dropout_masks'
// attn_keep bit for bit.
// Bound on this card: the int32 stores, 4 bytes a bit, against one Philox
// call per 4 of them.
// Design: a block row of the grid per (stream, image); one thread per 4
// columns of a row, one Philox call, up to 4 stores (store_keep_rows).  They
// are test tools: the attention kernels draw their bits themselves.
// ---------------------------------------------------------------------------

constexpr int kMaskThreads = 256;

// the (rows, cols) int32 keep bits of one stream into dst, row-major; the
// block row of the grid strides over the (row, 4-column group) pairs
__device__ __forceinline__ void store_keep_rows(int* __restrict__ dst, const DropoutArgs& drop, uint32_t stream,
                                                int rows, int cols) {
  const int groups = (cols + 3) / 4;
  for (int i = blockIdx.x * kMaskThreads + threadIdx.x; i < rows * groups; i += gridDim.x * kMaskThreads) {
    const int row = i / groups, c4 = i % groups;
    const uint32_t keep = keep_nibble(drop, stream, row, c4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * c4 + e;
      if (col < cols) dst[static_cast<size_t>(row) * cols + col] = static_cast<int>((keep >> e) & 1u);
    }
  }
}

// stream < heads an attention head, stream == heads the output dropout
__global__ void __launch_bounds__(kMaskThreads)
dropout_masks_kernel(int* __restrict__ attn_keep, int* __restrict__ out_keep, int n, int dim, int heads,
                     DropoutArgs drop) {
  const int stream = blockIdx.y, img = blockIdx.z;
  int* dst = stream < heads ? attn_keep + (static_cast<size_t>(img) * heads + stream) * n * n
                            : out_keep + static_cast<size_t>(img) * n * dim;
  store_keep_rows(dst, drop, dropout_stream(img, stream), n, stream < heads ? n : dim);
}

__global__ void __launch_bounds__(kMaskThreads)
flash_dropout_masks_kernel(int* __restrict__ keep, int n, int m, int heads, DropoutArgs drop) {
  const int head = blockIdx.y, img = blockIdx.z;
  store_keep_rows(keep + (static_cast<size_t>(img) * heads + head) * n * m, drop, dropout_stream(img, head), n, m);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes).  Pointers are device pointers of contiguous tensors,
// 16-byte aligned; the wrappers in ops/fused_block.py check shapes.
// ---------------------------------------------------------------------------

extern "C" {

// g (rows, dim) bf16 -> gm (rows, dim) bf16; rows a multiple of n
int vit_dropout_apply(const void* g, void* gm, long long rows, int n, int dim, int heads, unsigned seed,
                      unsigned threshold, float inv, void* stream) {
  if (rows <= 0 || n <= 0 || rows % n || dim <= 0 || dim % 8 || heads < 0) return cudaErrorInvalidValue;
  const long long vecs = rows * (dim / 8);
  const long long want = (vecs + kApplyThreads - 1) / kApplyThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  dropout_apply_kernel<<<blocks, kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<bf16*>(gm), vecs, n, dim, heads, DropoutArgs{seed, threshold, inv});
  return cudaGetLastError();
}

// -> attn_keep (batch, heads, n, n) and out_keep (batch, n, dim) int32
int vit_dropout_masks(void* attn_keep, void* out_keep, int batch, int n, int dim, int heads, unsigned seed,
                      unsigned threshold, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || dim <= 0 || heads <= 0 || heads >= 65535) return cudaErrorInvalidValue;
  const int groups = ((n > dim ? n : dim) + 3) / 4;
  const int blocks = (n * groups + kMaskThreads - 1) / kMaskThreads;
  const dim3 grid(blocks < 64 ? blocks : 64, heads + 1, batch);
  dropout_masks_kernel<<<grid, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(attn_keep), static_cast<int*>(out_keep), n, dim, heads, DropoutArgs{seed, threshold, 1.f});
  return cudaGetLastError();
}

// -> keep (batch, heads, n, m) int32; heads < 1024 (one Philox stream a head)
int vit_flash_dropout_masks(void* keep, int batch, int heads, int n, int m, unsigned seed, unsigned threshold,
                            void* stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads >= 1024 || n <= 0 || m <= 0 ||
      static_cast<long long>(n) * ((m + 3) / 4) > 0x7fffffff)
    return cudaErrorInvalidValue;
  const long long blocks = (static_cast<long long>(n) * ((m + 3) / 4) + kMaskThreads - 1) / kMaskThreads;
  const dim3 grid(blocks < 64 ? static_cast<int>(blocks) : 64, heads, batch);
  flash_dropout_masks_kernel<<<grid, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(keep), n, m, heads, DropoutArgs{seed, threshold, 1.f});
  return cudaGetLastError();
}

}  // extern "C"
