// Hopper (sm_90a) kernels for the attention-block backward of one pre-norm
// ViT layer.
//
// They replace the TPU kernel vit_pytorch_tpu/ops/fused_block.py::_bwd_kernel
// (:524, called at :786 by _pallas_backward) with the per-head attention
// backward of attention_bwd_rows.cu and, for gm, dropout.cu.
// That kernel runs one image per sequential grid step with both weight
// matrices resident in VMEM: it recomputes LN1 and qkv, forms dm = dy.Wout^T,
// runs the per-head attention backward with the logits in VMEM, forms
// dh = dqkv.Wqkv^T and the LayerNorm backward, and carries dgamma/dbeta
// across the grid.  Here the same function is a chain of launches (see
// ops/fused_block.py::_attention_block_bwd): the recompute and the two
// products with a weight run the forward's kernels (layernorm_rows,
// gemm_bf16, and gemm_bf16's f32 epilogue for dh: fused_layer.cu,
// gemm_bf16.cu), the attention backward attention_bwd_rows.cu, and this
// file holds the LayerNorm backward and the fixed-order column sum that
// every per-block partial sum ends with (launch_column_sum):
//
//   layernorm_bwd_rows   x, dh (f32), dy -> dx = bf16(bf16(dx_ln) + dy),
//                        dgamma, dbeta (f32, summed over all rows)
//
// Rounding points follow _bwd_kernel :628-717 and the add of :1868.  The
// [res_f32] variant of layernorm_bwd_rows is the LayerNorm backward of the
// row-tiled FF backward _ff_bwd_kernel (:1588-1596) and of the whole-layer
// backward _layer_bwd_kernel (:1253-1261, :1339-1342).

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// layernorm_bwd_rows
//
// Replaces: the LayerNorm backward of _bwd_kernel (fused_block.py:702-717)
// with the dx = dx_ln + dy add of _fused_layer_bwd (:1868):
//   xhat, r recomputed from x in f32 (as layernorm_rows computes them)
//   dxhat = dh * gamma
//   dx    = bf16(f32(bf16(r * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)))) + f32(dy))
//   dgamma = sum over rows of dh * xhat,  dbeta = sum over rows of dh   (f32)
// Bound on this card: memory.  Per row it reads x and dy (bf16) and dh (f32)
// and writes dx, 10 bytes an element against a few tens of flops.
// Design: one warp a row, every lane owning the same 16-byte column chunks
// c = lane, lane + 32, ... of every row (VEC = ceil(dim / 256) chunks).  At
// dim <= 1024 (every model that runs it: ViT-B 768, BASELINE configs 1 and
// 2 at 1024) the lane loads its chunks of x, dh and the residual once, all
// at the row's start, and keeps them in registers: the mean, the centred
// variance, the two sums of dxhat and dx itself come from those registers,
// each sum in the order the chunks are read (so dx keeps the bits of a
// kernel that reads the row once a statistic).  Its dgamma and dbeta (and
// the residual's sum) terms go into partial sums in registers, one a
// column it owns, across all of the warp's rows, and meet the block's other
// warps once, at the end.  On the TPU the sequential grid carries
// dgamma/dbeta from step to step; here blocks run in no order, so the sums
// are two-pass and deterministic, without atomics: a block sums its warps'
// partials in order through shared memory into one row of a (blocks,
// slices, dim) scratch buffer, and a second grid (launch_column_sum) sums
// those rows in a fixed order.  The grid, layernorm_bwd_blocks, is a
// function of the rows alone: min(ceil(rows / 32), 396) blocks of 4 warps
// (3 an SM), warp w of block b taking rows 4b + w + k * 4 * blocks, so the
// result does not change from run to run.  Past dim 1024 the registers would
// not hold a row: layernorm_bwd_loop_kernel walks the row from memory three
// times (its second and third reads hit L1) and adds each row's terms into
// its warp's slice of shared memory.  Limits: dim % 8 == 0 and dim <= 3584
// ([res_f32]: dim <= 2416), the gates of the 8-warp blocks before, kept.
// ---------------------------------------------------------------------------

constexpr int kLnBwdWarps = 4;
constexpr int kLnBwdThreads = 32 * kLnBwdWarps;
constexpr int kLnBwdRowsPerWarp = 8;  // the least rows a warp takes before the grid stops growing
constexpr int kLnBwdBlocksPerSm = 3;  // the register path's occupancy (at most 168 registers a thread)
constexpr int kLnBwdMaxBlocks = 396;  // kLnBwdBlocksPerSm on each of an H100's 132 SMs
constexpr int kLnBwdRegDim = 1024;    // the widest row the registers hold: 4 chunks of 8 a lane
constexpr int kLnBwdMaxDim = 3584;     // the gate the wrapper has kept (the loop's 2 x 4 warps x dim f32 slices hold more)
constexpr int kLnBwdResMaxDim = 2416;  // [res_f32]: its 3 slices' gate, kept as well
constexpr int kLnSumCols = 32, kLnSumSlices = 8;  // the partials' sum: 32 columns x 8 row slices a block

int layernorm_bwd_blocks(int rows) {
  const int want = (rows + kLnBwdRowsPerWarp * kLnBwdWarps - 1) / (kLnBwdRowsPerWarp * kLnBwdWarps);
  return want < kLnBwdMaxBlocks ? want : kLnBwdMaxBlocks;
}

__device__ __forceinline__ void load8_f32(float f[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void load8_bf16(float f[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x, f[2 * i + 1] = v.y;
  }
}

// the row's dx chunk out of out[8] (dx_ln in f32) and the residual rv:
// plain, bf16(bf16(dx_ln) + res) (or bf16(dx_ln) without a residual);
// [res_f32], dx_ln + res in f32, cast once unless dx is f32
template <bool RES_F32>
__device__ __forceinline__ void store_dx(void* dx, size_t off, float out[8], const float rv[8], bool has_res,
                                         int dx_f32) {
  if (RES_F32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] += rv[i];  // in f32, before the one cast
    if (dx_f32) {
      float4* o4 = reinterpret_cast<float4*>(static_cast<float*>(dx) + off);
      o4[0] = make_float4(out[0], out[1], out[2], out[3]);
      o4[1] = make_float4(out[4], out[5], out[6], out[7]);
      return;
    }
  }
  uint4 o;
  uint32_t* po = reinterpret_cast<uint32_t*>(&o);
  if (!RES_F32 && has_res) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(__floats2bfloat162_rn(out[2 * i], out[2 * i + 1]));  // dx_ln in bf16
      po[i] = pack_floats(f.x + rv[2 * i], f.y + rv[2 * i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) po[i] = pack_floats(out[2 * i], out[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(static_cast<bf16*>(dx) + off) = o;
}

// the residual's chunk as f32: bf16, or f32 (res_f32)
__device__ __forceinline__ void load8_res(float f[8], const void* res, size_t off, int res_f32) {
  if (res_f32) {
    load8_f32(f, static_cast<const float*>(res) + off);
  } else {
    load8_bf16(f, static_cast<const bf16*>(res) + off);
  }
}

// The block's partial sums: each warp's slices of shared memory (acc: this
// warp's kSlices x dim), summed over the warps in order into the block's row
// of `partial`
template <int kSlices>
__device__ __forceinline__ void block_partials(const float* smem, float* partial, int dim) {
  __syncthreads();
  for (int c = threadIdx.x; c < kSlices * dim; c += kLnBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kLnBwdWarps; ++wi) s += smem[wi * kSlices * dim + c];
    partial[static_cast<size_t>(blockIdx.x) * kSlices * dim + c] = s;
  }
}

// RES_F32: the [res_f32] variant.
// Replaces: the LayerNorm backward with its residual of _ff_bwd_kernel,
// dy = (dy_ln + g).astype(io) (fused_block.py:1588-1596), and of
// _layer_bwd_kernel, dy = ln_bwd(dyln) + g kept in f32 (:1261) and dx =
// ln_bwd(dh) + dy (:1342): the residual (bf16 g, or the f32 dy) is added to
// the f32 dx_ln before one cast, or none (res_f32 and dx_f32 say which).
// It also sums the f32 residual per column, a third partial: db2 = sum of g
// (:1559) and db_out = sum of dy (:1274).
// Bound on this card: memory, as the plain variant: x, dh and the residual
// in, dx out.
// Design: the plain variant's, with three partials a column.
//
// The register path: VEC 16-byte chunks a lane (dim <= 256 VEC).
template <bool RES_F32, int VEC>
__global__ void __launch_bounds__(kLnBwdThreads, kLnBwdBlocksPerSm)
layernorm_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ dh, const bf16* __restrict__ w,
                          const void* __restrict__ res, int res_f32, void* __restrict__ dx, int dx_f32,
                          float* __restrict__ partial, int rows, int dim, float eps) {
  constexpr int kSlices = RES_F32 ? 3 : 2;
  extern __shared__ float ln_bwd_smem[];  // [warps][kSlices][dim]: dgamma, dbeta (, the residual's sum)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = dim / 8;
  const bool has_res = res != nullptr;
  float pg[VEC][8], pb[VEC][8], pr[RES_F32 ? VEC : 1][8];  // the lane's columns' partial sums
#pragma unroll
  for (int j = 0; j < VEC; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      pg[j][i] = pb[j][i] = 0.f;
      if constexpr (RES_F32) pr[j][i] = 0.f;
    }

  for (int row = blockIdx.x * kLnBwdWarps + warp; row < rows; row += gridDim.x * kLnBwdWarps) {
    const size_t base = static_cast<size_t>(row) * dim;
    uint4 xu[VEC];
    float dv[VEC][8], rv[VEC][8];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {  // every load of the row at once
      const int v = lane + 32 * j;
      if (v < nvec) {
        xu[j] = *reinterpret_cast<const uint4*>(x + base + 8 * v);
        load8_f32(dv[j], dh + base + 8 * v);
        if (has_res) load8_res(rv[j], res, base + 8 * v, RES_F32 ? res_f32 : 0);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (lane + 32 * j < nvec) {
        float xv[8];
        unpack8(xv, xu[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += xv[i];
      }
    }
    const float mu = warp_sum(sum) / dim;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (lane + 32 * j < nvec) {
        float xv[8];
        unpack8(xv, xu[j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) sq += (xv[i] - mu) * (xv[i] - mu);
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / dim + eps);

    float s1 = 0.f, s2 = 0.f;  // sums of dxhat and dxhat * xhat
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int v = lane + 32 * j;
      if (v < nvec) {
        float xv[8], wv[8];
        unpack8(xv, xu[j]);
        load8_bf16(wv, w + 8 * v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float dxh = dv[j][i] * wv[i];
          s1 += dxh;
          s2 += dxh * ((xv[i] - mu) * rstd);
        }
      }
    }
    const float m1 = warp_sum(s1) / dim, m2 = warp_sum(s2) / dim;

#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int v = lane + 32 * j;
      if (v < nvec) {
        float xv[8], wv[8], out[8];
        unpack8(xv, xu[j]);
        load8_bf16(wv, w + 8 * v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xh = (xv[i] - mu) * rstd;
          out[i] = rstd * (dv[j][i] * wv[i] - m1 - xh * m2);
          pg[j][i] += dv[j][i] * xh;
          pb[j][i] += dv[j][i];
          if constexpr (RES_F32) pr[j][i] += rv[j][i];
        }
        store_dx<RES_F32>(dx, base + 8 * v, out, rv[j], has_res, dx_f32);
      }
    }
  }
  float* acc = ln_bwd_smem + warp * kSlices * dim;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int v = lane + 32 * j;
    if (v < nvec) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[8 * v + i] = pg[j][i];
        acc[dim + 8 * v + i] = pb[j][i];
        if constexpr (RES_F32) acc[2 * dim + 8 * v + i] = pr[j][i];
      }
    }
  }
  block_partials<kSlices>(ln_bwd_smem, partial, dim);
}

// The loop path, dim > kLnBwdRegDim: the row read from memory for each
// statistic (the second and third reads hit L1), each row's terms added into
// the warp's slices of shared memory
template <bool RES_F32>
__global__ void __launch_bounds__(kLnBwdThreads)
layernorm_bwd_loop_kernel(const bf16* __restrict__ x, const float* __restrict__ dh, const bf16* __restrict__ w,
                          const void* __restrict__ res, int res_f32, void* __restrict__ dx, int dx_f32,
                          float* __restrict__ partial, int rows, int dim, float eps) {
  constexpr int kSlices = RES_F32 ? 3 : 2;
  extern __shared__ float ln_bwd_smem[];  // [warps][kSlices][dim]: dgamma, dbeta (, the residual's sum)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc = ln_bwd_smem + warp * kSlices * dim;
  const int nvec = dim / 8;
  const bool has_res = res != nullptr;
  for (int v = lane; v < nvec; v += 32) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) acc[sl * dim + 8 * v + i] = 0.f;
  }

  for (int row = blockIdx.x * kLnBwdWarps + warp; row < rows; row += gridDim.x * kLnBwdWarps) {
    const bf16* xr = x + static_cast<size_t>(row) * dim;
    const float* dr = dh + static_cast<size_t>(row) * dim;
    float xv[8], dv[8], wv[8];

    float sum = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      load8_bf16(xv, xr + 8 * v);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += xv[i];
    }
    const float mu = warp_sum(sum) / dim;
    float sq = 0.f;
    for (int v = lane; v < nvec; v += 32) {
      load8_bf16(xv, xr + 8 * v);
#pragma unroll
      for (int i = 0; i < 8; ++i) sq += (xv[i] - mu) * (xv[i] - mu);
    }
    const float rstd = rsqrtf(warp_sum(sq) / dim + eps);

    float s1 = 0.f, s2 = 0.f;  // sums of dxhat and dxhat * xhat
    for (int v = lane; v < nvec; v += 32) {
      load8_bf16(xv, xr + 8 * v);
      load8_f32(dv, dr + 8 * v);
      load8_bf16(wv, w + 8 * v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dxh = dv[i] * wv[i];
        s1 += dxh;
        s2 += dxh * ((xv[i] - mu) * rstd);
      }
    }
    const float m1 = warp_sum(s1) / dim, m2 = warp_sum(s2) / dim;

    for (int v = lane; v < nvec; v += 32) {
      load8_bf16(xv, xr + 8 * v);
      load8_f32(dv, dr + 8 * v);
      load8_bf16(wv, w + 8 * v);
      float out[8], rv[8];
      const size_t off = static_cast<size_t>(row) * dim + 8 * v;
      if (has_res) load8_res(rv, res, off, RES_F32 ? res_f32 : 0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xh = (xv[i] - mu) * rstd;
        out[i] = rstd * (dv[i] * wv[i] - m1 - xh * m2);
        acc[8 * v + i] += dv[i] * xh;
        acc[dim + 8 * v + i] += dv[i];
        if constexpr (RES_F32) acc[2 * dim + 8 * v + i] += rv[i];
      }
      store_dx<RES_F32>(dx, off, out, rv, has_res, dx_f32);
    }
  }
  block_partials<kSlices>(ln_bwd_smem, partial, dim);
}

// sums[c] = factor * sum over b of partial[b][c], in a fixed order: slice s
// of a block adds rows s, s + 8, ...; the block then adds its 8 slices in
// order.  The LayerNorm backward's second pass (factor 1) and the qk-norm
// dgammas' (factor sqrt(64): gamma enters the norm as gamma * sqrt(dh))
__global__ void __launch_bounds__(kLnSumCols * kLnSumSlices)
layernorm_bwd_sum_kernel(const float* __restrict__ partial, float* __restrict__ sums, int blocks, int width,
                         float factor) {
  __shared__ float part[kLnSumSlices][kLnSumCols];
  const int col = blockIdx.x * kLnSumCols + (threadIdx.x % kLnSumCols), slice = threadIdx.x / kLnSumCols;
  float s = 0.f;
  if (col < width)
    for (int b = slice; b < blocks; b += kLnSumSlices) s += partial[static_cast<size_t>(b) * width + col];
  part[slice][threadIdx.x % kLnSumCols] = s;
  __syncthreads();
  if (slice == 0 && col < width) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kLnSumSlices; ++i) total += part[i][threadIdx.x];
    sums[col] = total * factor;
  }
}

}  // namespace

cudaError_t launch_column_sum(const float* partial, float* sums, int rows, int width, float factor,
                              cudaStream_t stream) {
  layernorm_bwd_sum_kernel<<<(width + kLnSumCols - 1) / kLnSumCols, kLnSumCols * kLnSumSlices, 0, stream>>>(
      partial, sums, rows, width, factor);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The launches and the C interface (ctypes).  Pointers are device pointers of
// contiguous tensors, 16-byte aligned; the wrappers in ops/fused_block.py
// check shapes and dtypes and allocate the outputs and the scratch buffers.
// ---------------------------------------------------------------------------

namespace {

typedef void (*LnBwdKernel)(const bf16*, const float*, const bf16*, const void*, int, void*, int, float*, int, int,
                            float);

// the kernel for rows of dim: the register path at VEC = ceil(dim / 256)
// chunks a lane up to kLnBwdRegDim, else the loop
template <bool RES_F32>
LnBwdKernel layernorm_bwd_kernel(int dim) {
  switch ((dim / 8 + 31) / 32) {
    case 1: return layernorm_bwd_rows_kernel<RES_F32, 1>;
    case 2: return layernorm_bwd_rows_kernel<RES_F32, 2>;
    case 3: return layernorm_bwd_rows_kernel<RES_F32, 3>;
    case 4: return layernorm_bwd_rows_kernel<RES_F32, 4>;
    default: return layernorm_bwd_loop_kernel<RES_F32>;
  }
}
static_assert(kLnBwdRegDim == 4 * 32 * 8, "the register path's widest instantiation");
static_assert(kLnBwdMaxBlocks == 132 * kLnBwdBlocksPerSm, "one wave of the register path on an H100");

template <bool RES_F32>
cudaError_t launch_layernorm_bwd(const void* x, const void* dh, const void* w, const void* res, int res_f32, void* dx,
                                 int dx_f32, void* partial, void* sums, int rows, int dim, float eps,
                                 cudaStream_t s) {
  constexpr int kSlices = RES_F32 ? 3 : 2;
  const LnBwdKernel kernel = layernorm_bwd_kernel<RES_F32>(dim);
  const int smem = kLnBwdWarps * kSlices * dim * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = layernorm_bwd_blocks(rows);
  kernel<<<blocks, kLnBwdThreads, smem, s>>>(static_cast<const bf16*>(x), static_cast<const float*>(dh),
                                             static_cast<const bf16*>(w), res, res_f32, dx, dx_f32,
                                             static_cast<float*>(partial), rows, dim, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_column_sum(static_cast<const float*>(partial), static_cast<float*>(sums), blocks, kSlices * dim, 1.f,
                           s);
}

}  // namespace

extern "C" {

// rows of the (blocks, slices, dim) f32 scratch buffer vit_layernorm_bwd_rows takes
int vit_layernorm_bwd_blocks(int rows) { return rows > 0 ? layernorm_bwd_blocks(rows) : 0; }

// x (rows, dim) bf16, dh (rows, dim) f32, w (dim) bf16, res (rows, dim) bf16
// or null -> dx (rows, dim) bf16, sums (2, dim) f32 = dgamma, dbeta
int vit_layernorm_bwd_rows(const void* x, const void* dh, const void* w, const void* res, void* dx, void* partial,
                           void* sums, int rows, int dim, float eps, void* stream) {
  if (rows <= 0 || dim <= 0 || dim % 8 || dim > kLnBwdMaxDim) return cudaErrorInvalidValue;
  return launch_layernorm_bwd<false>(x, dh, w, res, 0, dx, 0, partial, sums, rows, dim, eps,
                                     static_cast<cudaStream_t>(stream));
}

// The [res_f32] variant: res (rows, dim) bf16 (res_f32 = 0) or f32 (1), dx
// (rows, dim) bf16 (dx_f32 = 0) or f32 (1), partial (blocks, 3, dim) f32
// scratch -> sums (3, dim) f32 = dgamma, dbeta, the residual's column sum
int vit_layernorm_bwd_rows_res(const void* x, const void* dh, const void* w, const void* res, int res_f32, void* dx,
                               int dx_f32, void* partial, void* sums, int rows, int dim, float eps, void* stream) {
  if (rows <= 0 || dim <= 0 || dim % 8 || dim > kLnBwdResMaxDim || !res) return cudaErrorInvalidValue;
  return launch_layernorm_bwd<true>(x, dh, w, res, res_f32, dx, dx_f32, partial, sums, rows, dim, eps,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
