// The tile bodies of one pre-norm ViT layer's forward chain, shared by the
// chain's kernels (fused_layer.cu: one launch a step) and the multi-layer
// kernel stack_layers (stack_layers.cu: every step of g layers in one
// launch).  Each body takes its tile's coordinates as arguments instead of
// reading blockIdx, so a kernel may walk many tiles; the arithmetic of a tile
// is the same wherever it runs, so the two routes give the same bits.
//
//   layernorm_row        one row of LN (one warp)
//   gemm_tile<EPI>       one 128x128 output tile of A . W^T with an epilogue
//                        (256 threads, two warpgroups)
//   attention_tile       one (image, head, 64-query tile) of softmax attention
//                        (128 threads: a block of 4 warps, or one warpgroup)
//
// Internal linkage, as common.cuh.
#pragma once

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 load_pair_f32(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// round a pair of f32 to bf16 and back: the cast the TPU kernel makes
__device__ __forceinline__ float2 round_bf16(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// jax.nn.gelu(approximate=True) == torch gelu(approximate="tanh"), in f32
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// d/dh of the tanh GELU in f32, ops/fused_block.py::_gelu_tanh_grad
// (:1147-1153), the term order kept
__device__ __forceinline__ float gelu_tanh_grad(float h) {
  const float c = 0.7978845608028654f, a = 0.044715f;
  const float t = tanhf(c * (h + a * h * h * h));
  return 0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * c * (1.0f + 3.0f * a * h * h);
}

// the barrier of the threads that run one tile body: the whole block, or
// one warpgroup of 128 threads on its own named barrier (ids >= 1; 0 is
// __syncthreads')
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

struct GroupSync {
  int id;
  __device__ __forceinline__ void operator()() const { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }
};

// ---------------------------------------------------------------------------
// layernorm_row
//
// Replaces: the ln() of ops/fused_block.py::_layer_kernel (_layer_rows, LN1
// and LN2).
// Bound on this card: memory.  One read and one write of a (rows, dim) bf16
// matrix, a few flops per byte, far below the ~295 flop/byte ridge.
// Design: one warp per row, 16-byte vector loads; the row (1.5 KB at ViT-B)
// is read three times (mean, centred variance, output) and the second and
// third reads hit L1, so device memory sees one read and one write.
// Statistics in f32, var = mean((x - mu)^2), output cast to bf16.
// ---------------------------------------------------------------------------

constexpr int kLnThreads = 256;

__device__ __forceinline__ void layernorm_row(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                              const bf16* __restrict__ b, bf16* __restrict__ out, int row, int dim,
                                              float eps, int lane) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * dim);
  uint4* orow = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * dim);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  const uint4* bv = reinterpret_cast<const uint4*>(b);
  const int nvec = dim / 8;

  float sum = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    uint4 u = xr[v];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(p[i]);
      sum += f.x + f.y;
    }
  }
  const float mu = warp_sum(sum) / dim;

  float sq = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    uint4 u = xr[v];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(p[i]);
      sq += (f.x - mu) * (f.x - mu) + (f.y - mu) * (f.y - mu);
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / dim + eps);

  for (int v = lane; v < nvec; v += 32) {
    uint4 u = xr[v], uw = wv[v], ub = bv[v], o;
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    const __nv_bfloat162* pw = reinterpret_cast<const __nv_bfloat162*>(&uw);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&ub);
    __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(p[i]);
      float2 fw = __bfloat1622float2(pw[i]);
      float2 fb = __bfloat1622float2(pb[i]);
      po[i] = __floats2bfloat162_rn((f.x - mu) * rstd * fw.x + fb.x, (f.y - mu) * rstd * fw.y + fb.y);
    }
    orow[v] = o;
  }
}

// ---------------------------------------------------------------------------
// gemm_tile
//
// Replaces: the four jnp.dot sites of ops/fused_block.py::_layer_kernel
// (qkv :1015, out-proj :1040, fc1 :1046, fc2 :1048) with their epilogues.
// Bound on this card: tensor-core throughput.  At ViT-B bs=128 (M = 25,216)
// each output element takes 2*K flops against a few bytes, hundreds of flops
// per byte, above the ridge; the fc1 (GELU) and out-proj (+x) epilogues
// add a pass over a large output and bring those two sites close to it.
// Design: C[M, N] = A[M, K] . W[N, K]^T with W as nn.Linear keeps it, (out,
// in), so both operands are K-contiguous, which is the layout wgmma takes
// for both, and no transpose is ever made.  128x128x64 block tiles; two
// warpgroups each own 64 rows and issue one wgmma m64n128k16 per k16 step
// from shared memory.  A 3-stage cp.async ring, one tile ahead, keeps one
// group of wgmma in flight while the next tile lands.  That is 97 KB of
// shared memory, so two blocks share an SM and one block's epilogue runs
// under the other's main loop (measured: 128x256 tiles at one block an SM
// were slower at every site, most at fc1).  Tiles are stored in
// the 128-byte swizzle the wgmma descriptors name (16-byte chunk c of row r
// at chunk c ^ (r % 8)), so the tensor cores read them without bank
// conflicts.  N-tiles vary fastest over the grid: the blocks in flight share
// one A row tile and sweep W, which stays in L2, so A streams from device
// memory once.  M (= b*n) and N are ragged: loads clamp to the last row and
// the epilogue masks the stores.  TMA, warp specialisation and a persistent
// tile loop are later work.
// ---------------------------------------------------------------------------

enum Epilogue {
  kEpiQkv = 0, kEpiOut = 1, kEpiFc1 = 2, kEpiFc2 = 3, kEpiF32 = 4, kEpiBlockOut = 5, kEpiFc1Save = 6, kEpiGeluBwd = 7,
  kEpiFc1F32 = 8
};

// kEpiFc1F32 is the fc1 of the JAX package's whole-layer, stack and block
// prototypes in tools/ (bench_layer_fused.py:141-143, bench_stack_fusion.py:
// 98-99, fused_block_proto.py:108-109): the f32 bias is added to the f32 dot
// before the one cast, then the tanh GELU of that bf16 value, o =
// bf16(gelu_tanh(bf16(dot + b1))).  (kEpiFc1 rounds the dot first, as
// _layer_rows does.)  Those prototypes' out projection and fc2 are
// kEpiBlockOut without dropout: f32 dot + optional f32 bias + f32 residual,
// one cast.
// Bound on this card: tensor-core throughput, as kEpiFc1.
// Design: the main loop unchanged; only the epilogue's rounding point moves.

// kEpiBlockOut is the out projection of the attention-block kernel.
// Replaces: the out-proj site of ops/fused_block.py::_kernel (:357-374), which
// rounds once: f32 dot + f32 bias, times keep * 1/(1 - rate) of the output
// stream (image = row / n, stream head = heads) when dropout is on, + the
// f32 residual, one cast.  (The whole layer's kEpiOut rounds after each
// add, as _layer_rows does; the two are different results.)
// Bound on this card: tensor-core throughput, as kEpiOut; the keep bits are
// one Philox call per accumulator pair, ~32 a thread, in the epilogue.
// Design: the main loop unchanged; the bits come from keep_nibble
// (common.cuh), the same function the replay and dropout_apply kernels use.
struct BlockOutArgs {
  DropoutArgs d;
  int n;      // rows of one image
  int heads;  // the output stream's head index
  int drop;   // 0: no mask
};

// kEpiFc1Save and kEpiGeluBwd are the FF backward's two products with a
// weight that carry an elementwise epilogue.
// Replaces: the fc1 recompute and the dact/GELU' lines of the row-tiled FF
// backward ops/fused_block.py::_ff_bwd_kernel (:1553-1567) and of the
// whole-layer backward _layer_bwd_kernel (:1229-1243).
//  - kEpiFc1Save: h1 = bf16(bf16(y2 . W1^T) + b1), act = bf16(gelu_tanh(h1));
//    both are stored (act to out, h1 to ff.aux), so the backward's GELU'
//    reads the exact bf16 h1 the forward's GELU took.
//  - kEpiGeluBwd: dh1 = (g . W2) * gelu_tanh_grad(h1) in f32, with h1 read
//    from res; bf16(dh1) to out, and db1 = sum over rows of the f32 dh1
//    (:1566, before the cast): each block adds its 128 rows per column
//    (within a thread, over the 8 lanes of a column by shuffles, then the 8
//    warps in order through shared memory) into its row of the (row tiles,
//    N) f32 buffer ff.colpart, which launch_column_sum adds in a fixed order.
// Bound on this card: tensor-core throughput (K = dim 768, N = mlp 3072 at
// ViT-B), as fc1; the epilogues add one (M, N) bf16 store (fc1_save) or one
// (M, N) bf16 read (gelu_bwd) to the product's bytes.
// Design: the main loop unchanged; the dh1 column partials are one shuffle
// tree and 4 KB of the pipeline's shared memory after the last product, so
// db1 is bitwise deterministic and needs no atomics.
struct FfArgs {
  bf16* aux;      // kEpiFc1Save: h1 out
  float* colpart; // kEpiGeluBwd: (ceil(M / 128), N) f32 column partials of dh1
};

// kEpiF32 (gemm_f32out) stores the f32 dot as it is.
// Replaces: dh = dqkv . Wqkv^T of ops/fused_block.py::_bwd_kernel
// (fused_block.py:695-700, the product in f32 that feeds the LayerNorm
// backward; a bf16 store of dh would be a different result).
// Bound on this card: tensor-core throughput, as the other sites: M = b*n,
// N = dim, K = 3*inner, so 2*K = 4,608 flops (ViT-B) for each output
// element against its 4-byte store, far above the ~295 flop/byte ridge.
// Design: the main loop unchanged; each thread writes its accumulator pair
// as one float2, so the epilogue adds no pass over the output.

template <int EPI>
__device__ __forceinline__ void gemm_store(float v0, float v1, int row, int col, int N, const bf16* __restrict__ bias,
                                           const bf16* __restrict__ res, void* __restrict__ out,
                                           const BlockOutArgs& bo, const FfArgs& ff) {
  const size_t off = static_cast<size_t>(row) * N + col;
  if constexpr (EPI == kEpiF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(v0, v1);
    return;
  }
  uint32_t o;
  if (EPI == kEpiBlockOut) {
    if (bias) {
      float2 bb = load_pair_f32(bias + col);
      v0 += bb.x;
      v1 += bb.y;
    }
    if (bo.drop) {  // col is even: col, col + 1 are bits (col & 3), +1 of one nibble
      const int img = row / bo.n;
      const uint32_t keep = keep_nibble(bo.d, dropout_stream(img, bo.heads), row - img * bo.n, col >> 2) >> (col & 3);
      v0 *= (keep & 1u) ? bo.d.inv : 0.f;
      v1 *= (keep & 2u) ? bo.d.inv : 0.f;
    }
    if (res) {
      float2 r = load_pair_f32(res + off);
      v0 += r.x;
      v1 += r.y;
    }
    o = pack_floats(v0, v1);
  } else if (EPI == kEpiFc1F32) {
    if (bias) {
      float2 bb = load_pair_f32(bias + col);
      v0 += bb.x;
      v1 += bb.y;
    }
    const float2 t = round_bf16(v0, v1);  // (dot + b1).astype(x.dtype)
    o = pack_floats(gelu_tanh(t.x), gelu_tanh(t.y));
  } else if (EPI == kEpiQkv) {
    // _layer_rows :1015-1018 -- bias added to the f32 dot, then one cast
    if (bias) {
      float2 bb = load_pair_f32(bias + col);
      v0 += bb.x;
      v1 += bb.y;
    }
    o = pack_floats(v0, v1);
  } else {
    float2 t = round_bf16(v0, v1);  // .astype(x.dtype) of the f32 dot
    if (bias) {
      float2 bb = load_pair_f32(bias + col);
      t = round_bf16(t.x + bb.x, t.y + bb.y);
    }
    if (EPI == kEpiFc1 || EPI == kEpiFc1Save) {
      if constexpr (EPI == kEpiFc1Save) *reinterpret_cast<uint32_t*>(ff.aux + off) = pack_floats(t.x, t.y);
      o = pack_floats(gelu_tanh(t.x), gelu_tanh(t.y));
    } else {  // out-proj (+x) and fc2 (+y): residual add in bf16
      float2 r = load_pair_f32(res + off);
      o = pack_floats(t.x + r.x, t.y + r.y);
    }
  }
  *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + off) = o;
}

// K-major operand descriptor, 128-byte swizzle: rows of 64 bf16 (128 B),
// 8-row groups 1024 B apart
__device__ __forceinline__ uint64_t wgmma_desc(const bf16* p) { return wgmma_desc_sw128(p, 16, 1024); }

constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 64;
// the stage a load fills must not be read by the wgmma group in flight
constexpr int kGemmStages = 3, kGemmPrefetch = kGemmStages - 2;
constexpr int kGemmThreads = 256;  // 2 warpgroups of 64 rows
constexpr int kGemmATile = kGemmBM * kGemmBK, kGemmBTile = kGemmBN * kGemmBK;
constexpr int kGemmSmem = kGemmStages * (kGemmATile + kGemmBTile) * static_cast<int>(sizeof(bf16)) + 1024;

// One output tile, rows m0.. and columns n0.., by all kGemmThreads threads
// of the block; smem holds kGemmSmem bytes.  A block that runs a second
// tile must __syncthreads() first: the other warpgroup may still read the
// ring.
template <int EPI>
__device__ __forceinline__ void gemm_tile(unsigned char* smem, const bf16* __restrict__ A, const bf16* __restrict__ W,
                                          const bf16* __restrict__ bias, const bf16* __restrict__ res,
                                          void* __restrict__ out, int M, int N, int K, int m0, int n0,
                                          const BlockOutArgs& bo, const FfArgs& ff) {
  bf16* As = reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  bf16* Bs = As + kGemmStages * kGemmATile;

  const int tid = threadIdx.x, wg = tid >> 7, wwarp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // 16-byte chunk c of row r goes to chunk c ^ (r % 8): the 128-byte swizzle
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * kGemmBK;
    bf16* as = As + stage * kGemmATile;
    bf16* bs = Bs + stage * kGemmBTile;
#pragma unroll
    for (int i = 0; i < kGemmATile / 8 / kGemmThreads; ++i) {
      const int q = tid + i * kGemmThreads, r = q >> 3, c = q & 7;
      cp_async_16(as + r * kGemmBK + ((c ^ (r & 7)) << 3), A + static_cast<size_t>(min(m0 + r, M - 1)) * K + k0 + c * 8);
    }
#pragma unroll
    for (int i = 0; i < kGemmBTile / 8 / kGemmThreads; ++i) {
      const int q = tid + i * kGemmThreads, r = q >> 3, c = q & 7;
      cp_async_16(bs + r * kGemmBK + ((c ^ (r & 7)) << 3), W + static_cast<size_t>(min(n0 + r, N - 1)) * K + k0 + c * 8);
    }
  };

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  fence_operands(d, 64);

  const int ktiles = K / kGemmBK;
#pragma unroll
  for (int s = 0; s < kGemmPrefetch; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kGemmPrefetch - 1>();
    fence_proxy_async();
    __syncthreads();  // tile kt landed; every warpgroup is done with tile kt-2's stage
    const int nk = kt + kGemmPrefetch;
    if (nk < ktiles) load_tile(nk % kGemmStages, nk);
    cp_async_commit();

    const bf16* as = As + (kt % kGemmStages) * kGemmATile + wg * 64 * kGemmBK;
    const bf16* bs = Bs + (kt % kGemmStages) * kGemmBTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk)
      wgmma_m64n128k16<0, 0>(d, wgmma_desc(as + kk * 16), wgmma_desc(bs + kk * 16));
    wgmma_commit();
    wgmma_wait<1>();  // tile kt-1's products are done; tile kt's stay in flight
  }
  wgmma_wait<0>();
  fence_operands(d, 64);

  // accumulator layout: warp w of the warpgroup holds rows 16w + (g, g+8),
  // and d[4j..4j+3] their columns 8j + 2t, 8j + 2t + 1
  if constexpr (EPI == kEpiGeluBwd) {
    __syncthreads();  // both warpgroups' products are done: the ring's shared memory is free
    float* colbuf = reinterpret_cast<float*>(As);  // [8 warps][128 columns]
    const int warp8 = tid >> 5;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + j * 8 + 2 * t;  // N % 8 == 0: col < N is the same for the whole warp
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wg * 64 + wwarp * 16 + g + half * 8;
        if (row < M && col < N) {
          const size_t off = static_cast<size_t>(row) * N + col;
          const float2 h = load_pair_f32(res + off);
          const float2 v = make_float2(d[4 * j + 2 * half] * gelu_tanh_grad(h.x),
                                       d[4 * j + 2 * half + 1] * gelu_tanh_grad(h.y));  // dh1 in f32
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + off) = pack_floats(v.x, v.y);
          p0 += v.x;
          p1 += v.y;
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // over g: the lanes of one column pair
        p0 += __shfl_xor_sync(0xffffffffu, p0, o);
        p1 += __shfl_xor_sync(0xffffffffu, p1, o);
      }
      if (g == 0) colbuf[warp8 * kGemmBN + j * 8 + 2 * t] = p0, colbuf[warp8 * kGemmBN + j * 8 + 2 * t + 1] = p1;
    }
    __syncthreads();
    if (tid < kGemmBN && n0 + tid < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kGemmThreads / 32; ++w) s += colbuf[w * kGemmBN + tid];
      ff.colpart[static_cast<size_t>(m0 / kGemmBM) * N + n0 + tid] = s;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wg * 64 + wwarp * 16 + g + half * 8;
        if (row < M)
          gemm_store<EPI>(d[4 * j + 2 * half], d[4 * j + 2 * half + 1], row, col, N, bias, res, out, bo, ff);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// attention_tile
//
// Replaces: the per-head loop of ops/fused_block.py::_layer_kernel
// (_layer_rows :1021-1037: q.k^T, _softmax_from_dots, p.v, heads merged),
// and the same loop of the layer prototypes in tools/ (exp and a division,
// the padded ones with a -inf key bias).
// Bound on this card: at n = 197 the two products are 4*n*n*dh flops per
// (image, head) against 3*n*dh*2 bytes of q/k/v, ~130 flops per byte, under
// the ridge, and the (n, n) f32 logits would be 16x the bytes of q/k/v if
// they went to device memory.  So the logits never leave the SM.
// Design: 4 warps per (image, head, 64-row q-tile).  They read q, k and v
// for the head straight from the (b, n, 3*inner) qkv buffer into shared
// memory (rows >= n zero-filled).  Each warp owns 16 query rows
// and keeps their full f32 logit rows in registers: 2*KT mma tiles of 16x8,
// 8*KT = 104 floats a thread.  Exact two-pass softmax as
// _softmax_from_dots: scale*log2(e) folded into one multiply, max, exp2,
// one reciprocal of the row sum; padded columns (j >= n_keys) masked to -inf.
// The accumulator layout of q.k^T is the A-operand layout of p.v, so P is cast
// to bf16 in registers and multiplied by v without a trip through memory.
// The output goes to the merged-heads (b, n, inner) layout.  Every q-tile
// re-reads its head's k and v (from L2 after the first); sharing them
// across q-tiles is later work.
// Limits: dh = 64; n <= 16*KT = 208, the one instantiation, sized for the
// 197 tokens of ViT-B/16 @224 and bounded by registers (167 a thread with
// the runtime key count, 156 before it; no spill; 3 blocks an SM either way).  Shared memory is (64 + 2*16*KT) rows of 72 bf16 = 69,120 bytes,
// under the 232,448-byte block limit up to 16*KT = 775 keys, so registers,
// not shared memory, bind n.
// ---------------------------------------------------------------------------

// kAttnQT, kAttnThreads, kAttnDh, kAttnLd, kAttnKT: common.cuh
constexpr int kAttnSmem = (kAttnQT + 2 * 16 * kAttnKT) * kAttnLd * static_cast<int>(sizeof(bf16));
// with dropout, + the block's bit-packed keep tile: 64 rows x 7 words
constexpr int kAttnDropSmem = kAttnSmem + kAttnQT * kKeepWords * static_cast<int>(sizeof(uint32_t));

// DROP: the dropout of ops/fused_block.py::_kernel (:345-348) -- P, in f32,
// is where(keep, p, 0) * 1/(1 - rate) before its bf16 cast, keep from the
// (seed, img, head) stream.  The block draws its 64 x n keep bits once into
// shared memory (fill_keep_tile) before the logits take the registers.
// QKNORM: the qk-norm of _kernel (:323-338).  Bound on this card: the norm
// reads and writes the q and k tiles once more in shared memory, ~10 flops
// an element against the logits' 2*n, so the bound is the attention's.
// Design: after the tile loads, the block rewrites its 64 q rows and every
// k row in shared memory as bf16(x * rsqrt(sum x^2 + 1e-12) * gamma * 8)
// (rms_norm_rows, common.cuh); the logits then read them as before.  Every
// q-tile block normalises its head's k rows again, as it reloads them.
//
// n_keys: keys j >= n_keys (1 <= n_keys <= n) are masked to -inf in the
// softmax, the additive -inf key bias of the padded prototypes in tools/
// (bench_layer_fused.py:267-268, make_whole_padded); every one of the n rows
// is still computed and stored.  The layer chain and the stack pass n.
//
// The tile of (q0, h, img), by 128 threads: tid is the thread's index among
// them and sync their barrier.  DROP and QKNORM draw and normalise with the
// block's threadIdx.x, so they run only in a block of 128 threads
// (BlockSync); stack_layers runs <false, false> on each warpgroup.
template <bool DROP, bool QKNORM, typename Sync>
__device__ __forceinline__ void attention_tile(unsigned char* smem, const bf16* __restrict__ qkv,
                                               bf16* __restrict__ out, int n, int n_keys, int heads,
                                               float scale_log2e,
                                               const DropoutArgs& drop, const bf16* __restrict__ gq,
                                               const bf16* __restrict__ gk, int q0, int h, int img, int tid,
                                               Sync sync) {
  constexpr int KT = kAttnKT;
  constexpr int NP = 16 * KT;  // keys, padded
  constexpr int NT = 2 * KT;   // 8-key logit tiles
  constexpr int DT = kAttnDh / 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [QT][ld]
  bf16* Ks = Qs + kAttnQT * kAttnLd;          // [NP][ld]
  bf16* Vs = Ks + NP * kAttnLd;               // [NP][ld]
  uint32_t* Keep = reinterpret_cast<uint32_t*>(Vs + NP * kAttnLd);  // [QT][kKeepWords], DROP only

  const int inner = heads * kAttnDh;
  const size_t rstride = 3 * static_cast<size_t>(inner);
  const bf16* base = qkv + static_cast<size_t>(img) * n * rstride + h * kAttnDh;
  load_head_rows<kAttnQT>(Qs, base, rstride, q0, n, tid);
  load_head_rows<NP>(Ks, base + inner, rstride, 0, n, tid);
  load_head_rows<NP>(Vs, base + 2 * inner, rstride, 0, n, tid);
  if constexpr (DROP) fill_keep_tile<kAttnQT, kKeepWords>(Keep, drop, dropout_stream(img, h), q0, 0, n, n);
  sync();
  if constexpr (QKNORM) {
    rms_norm_rows<kAttnQT>(Qs, gq + h * kAttnDh, nullptr, nullptr);
    rms_norm_rows<NP>(Ks, gk + h * kAttnDh, nullptr, nullptr);
    sync();
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float s[NT][4];  // logits, then p in f32
  qk_logits(s, Qs + warp * 16 * kAttnLd, Ks, g, t);
  float mx0, mx1, inv0, inv1;
  softmax_rows(s, n_keys, t, scale_log2e, mx0, mx1, inv0, inv1);
  if constexpr (DROP) {
    const uint32_t* krow0 = Keep + (warp * 16 + g) * kKeepWords;
#pragma unroll
    for (int j = 0; j < NT; ++j) apply_keep(s[j], krow0, krow0 + 8 * kKeepWords, j, t, drop.inv);
  }

  // P in bf16, laid out as the A operand of p.v: key chunk kc = tiles 2kc, 2kc+1
  uint32_t pf[KT][4];
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) acc_to_a_frag(pf[kc], s[2 * kc], s[2 * kc + 1]);

  const int row0 = q0 + warp * 16 + g;
#pragma unroll
  for (int dj = 0; dj < DT; ++dj) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < KT; ++kc) {
      uint32_t b[2];
      load_b_frag_cols(b, Vs + kc * 16 * kAttnLd + dj * 8, kAttnLd, g, t);
      mma_16816(o, pf[kc], b);
    }
    const int col = h * kAttnDh + dj * 8 + 2 * t;
    if (row0 < n)
      *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(img) * n + row0) * inner + col) = pack_floats(o[0], o[1]);
    if (row0 + 8 < n)
      *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(img) * n + row0 + 8) * inner + col) =
          pack_floats(o[2], o[3]);
  }
}

}  // namespace
