// The Hopper (sm_90a) machinery shared by the port's TMA-fed kernels
// (attn_wgmma.cuh's short_attention and flash_fwd; gemm_bf16.cu's GEMM;
// attention_rows.cu): mbarriers, the Tensor Memory Accelerator's tiled
// copies between device and shared memory, named barriers, the register
// hand-over of warp-specialised kernels, and the host's tensor-map encoder.
//
// A TMA copy is issued by one thread and reports its bytes to an mbarrier
// (loads) or to the thread's bulk group (stores).  It reads and writes
// shared memory through the async proxy, which wgmma reads through too;
// generic stores that a copy or a wgmma reads must be followed by
// fence_proxy_async (common.cuh) before the barrier that publishes them.
// Boxes that reach past a dim of the tensor are zero-filled on a load and
// clipped on a store.
//
// Internal linkage, as common.cuh.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder is the driver's, fetched at run time
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

// ---- mbarriers -----------------------------------------------------------------

// `count` arrivals complete a phase (a copy's arrival is its expect_tx)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// after the inits of a block, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the arrival of the thread that issues a stage's copies, expecting their bytes
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` completes (the parity of
// the phase before the first has completed: a wait on parity 1 of a fresh
// barrier passes).  Bounded: a copy that never lands traps (an error the
// launch reports) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1 << 22)) __trap();
  }
}

// ---- TMA copies ----------------------------------------------------------------

// the box at (c0, c1) of a 2-D map into shared memory, its bytes reported to
// `bar`; one thread
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// the box at (c0, c1[, c2]) of a map from shared memory, into the thread's
// bulk group; one thread, after the fence and barrier that publish src
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// the thread's committed stores have read their shared memory (it may be
// written again)
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// the thread's committed stores are done
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// ---- named barriers, register hand-over ------------------------------------------

// `threads` threads (a multiple of 32) meet at barrier `id` (1..15; 0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a warpgroup gives registers back to the block's pool, or takes them
template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---- the host side: tensor maps --------------------------------------------------

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (no link
// against the driver library)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A map over a row-major tensor of `dims` dims (1 < dims <= 3): sizes[0] the
// contiguous dim, strides[d] the element stride of dim d + 1; boxes of box[0]
// x box[1] (x 1) elements, the 128-byte swizzle (box[0] * elem_bytes <=
// 128).  False if the driver refuses it.
inline bool encode_map(CUtensorMap& map, const void* base, CUtensorMapDataType type, int elem_bytes, int dims,
                       const long long* sizes, const long long* strides, int box_cols, int box_rows) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t dim[3], gstride[2];
  cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows), 1u};
  cuuint32_t estride[3] = {1, 1, 1};
  for (int d = 0; d < dims; ++d) dim[d] = static_cast<cuuint64_t>(sizes[d]);
  for (int d = 0; d + 1 < dims; ++d) gstride[d] = static_cast<cuuint64_t>(strides[d] * elem_bytes);
  return encode(&map, type, dims, const_cast<void*>(base), dim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
