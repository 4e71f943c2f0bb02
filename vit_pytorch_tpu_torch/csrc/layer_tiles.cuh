// The tile bodies of one pre-norm ViT layer's forward chain, shared by the
// chain's kernels (fused_layer.cu, gemm_bf16.cu, attention_rows.cu: one
// launch a step) and the multi-layer kernel stack_layers (stack_layers.cu:
// every step of g layers in one launch).  Each body takes its tile's
// coordinates as arguments instead of reading blockIdx, so a kernel may walk
// many tiles; the arithmetic of a tile is the same wherever it runs, so the
// two routes give the same bits.
//
//   layernorm_row        one row of LN (one warp)
//   epilogue_pair<EPI>   the arithmetic of a GEMM epilogue on one accumulator
//                        pair: gemm_bf16.cu's kernel and gemm_tile share it
//   gemm_tile<EPI>       one 128x128 output tile of A . W^T with an epilogue
//                        (256 threads, two warpgroups): stack_layers' alone
//   attention_wg_tile    one 64-query tile of one head's softmax attention on
//                        wgmma (one warpgroup), from q, k and v in shared
//                        memory: attention_rows.cu's kernel and
//                        stack_layers' attention step
//
// Internal linkage, as common.cuh.
#pragma once

#include "attn_wgmma.cuh"
#include "wgmma_wide.cuh"

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
// gemm_tile and the GEMM epilogues
//
// gemm_tile is the first port's GEMM tile, kept as stack_layers' GEMM step
// (stack_layers.cu): the chain's gemm_bf16 (gemm_bf16.cu) is a TMA-fed,
// warp-specialised, persistent kernel with the same main loop (the same
// wgmma k16 steps in ascending k into f32 accumulators) and the same
// epilogue_pair, so the two give the same bits, and the stack stays bitwise
// the chain.
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

// The arithmetic of every epilogue but kEpiF32 and kEpiGeluBwd on one
// accumulator pair, columns col, col + 1 (col even) of row: bb is the bias
// pair (added when has_bias), r the residual pair (kEpiOut and kEpiFc2 add it
// always, kEpiBlockOut when has_res).  Returns the bf16 output pair, packed;
// kEpiFc1Save's h1 pair goes to *h1.
template <int EPI>
__device__ __forceinline__ uint32_t epilogue_pair(float v0, float v1, int row, int col, bool has_bias, float2 bb,
                                                  bool has_res, float2 r, const BlockOutArgs& bo, uint32_t* h1) {
  if (EPI == kEpiBlockOut) {
    if (has_bias) {
      v0 += bb.x;
      v1 += bb.y;
    }
    if (bo.drop) {  // col is even: col, col + 1 are bits (col & 3), +1 of one nibble
      const int img = row / bo.n;
      const uint32_t keep = keep_nibble(bo.d, dropout_stream(img, bo.heads), row - img * bo.n, col >> 2) >> (col & 3);
      v0 *= (keep & 1u) ? bo.d.inv : 0.f;
      v1 *= (keep & 2u) ? bo.d.inv : 0.f;
    }
    if (has_res) {
      v0 += r.x;
      v1 += r.y;
    }
    return pack_floats(v0, v1);
  } else if (EPI == kEpiFc1F32) {
    if (has_bias) {
      v0 += bb.x;
      v1 += bb.y;
    }
    const float2 t = round_bf16(v0, v1);  // (dot + b1).astype(x.dtype)
    return pack_floats(gelu_tanh(t.x), gelu_tanh(t.y));
  } else if (EPI == kEpiQkv) {
    // _layer_rows :1015-1018 -- bias added to the f32 dot, then one cast
    if (has_bias) {
      v0 += bb.x;
      v1 += bb.y;
    }
    return pack_floats(v0, v1);
  } else {
    float2 t = round_bf16(v0, v1);  // .astype(x.dtype) of the f32 dot
    if (has_bias) t = round_bf16(t.x + bb.x, t.y + bb.y);
    if (EPI == kEpiFc1 || EPI == kEpiFc1Save) {
      if (EPI == kEpiFc1Save) *h1 = pack_floats(t.x, t.y);
      return pack_floats(gelu_tanh(t.x), gelu_tanh(t.y));
    }
    return pack_floats(t.x + r.x, t.y + r.y);  // out-proj (+x) and fc2 (+y): residual add in bf16
  }
}

// gemm_tile's store of one accumulator pair: the operands read from device
// memory, epilogue_pair, the output (and kEpiFc1Save's h1) written there
template <int EPI>
__device__ __forceinline__ void gemm_store(float v0, float v1, int row, int col, int N, const bf16* __restrict__ bias,
                                           const bf16* __restrict__ res, void* __restrict__ out,
                                           const BlockOutArgs& bo, const FfArgs& ff) {
  const size_t off = static_cast<size_t>(row) * N + col;
  if constexpr (EPI == kEpiF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(v0, v1);
    return;
  }
  const float2 zero = make_float2(0.f, 0.f);
  const bool has_res = (EPI == kEpiOut || EPI == kEpiFc2 || EPI == kEpiBlockOut) && res != nullptr;
  const float2 bb = bias ? load_pair_f32(bias + col) : zero;
  const float2 r = has_res ? load_pair_f32(res + off) : zero;
  uint32_t h1 = 0u;
  const uint32_t o = epilogue_pair<EPI>(v0, v1, row, col, bias != nullptr, bb, has_res, r, bo, &h1);
  if constexpr (EPI == kEpiFc1Save) *reinterpret_cast<uint32_t*>(ff.aux + off) = h1;
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
// attention_wg_tile
//
// Replaces: the per-head loop of ops/fused_block.py::_layer_kernel
// (_layer_rows :1021-1037: q.k^T, _softmax_from_dots, p.v, heads merged),
// the same loop of the attention-block kernel _kernel (:323-348, with its
// qk-norm and dropout), and of the layer prototypes in tools/ (exp and a
// division, the padded ones with a -inf key bias).
// Bound on this card: at n = 197 the two products are 4*n*n*dh flops per
// (image, head) against 4*n*dh*2 bytes of q, k, v and the output, ~100
// flops per byte, under the ~295 flop/byte ridge: the bytes bound it, and
// the (n, n) f32 logits, 16x the bytes of q/k/v, never leave the SM.
// Design: one warpgroup takes 64 queries of one head against all its keys,
// padded to 16 * KT (KT a template parameter: the host runs KT = ceil(n /
// 16), so n = 64 computes 4 key chunks, not 13).  q (64 rows), k and v (16 *
// KT rows each) sit in shared memory as 64-column bf16 tiles in the 128-byte
// swizzle (attn_wgmma.cuh's sw_off), rows past n zero.  Both products run on
// Hopper's warpgroup MMA:
//  - S = q.k^T: four wgmma.m64n(16 KT)k16 (wgmma_wide.cuh), q and k both
//    K-major from shared memory, f32 logits in registers, 8 KT floats a
//    thread: the accumulator layout of mma.m16n8 (rows g, g + 8; columns
//    8j + 2t, +1), so softmax_rows, apply_keep and acc_to_a_frag read it as
//    before;
//  - the exact two-pass softmax of _softmax_from_dots (softmax_rows: the row
//    max, exp2, one reciprocal of the row sum; keys j >= n_keys masked), P
//    times the keep bits and 1/(1 - rate) with DROP (_kernel :345-348),
//    then P cast to bf16 in registers as the A fragments of
//  - O = bf16(P).v: KT wgmma.m64n64k16 with A from registers and v MN-major
//    from shared memory (its rows are the k axis), f32 accumulators.
// No fragment is built from 16-bit shared loads, and each product is one
// committed group.  The caller brings q, k, v in and takes o out:
// attention_rows.cu's kernel loads a head's k and v once by the TMA for all
// its query tiles; stack_layers' attention step loads them with generic
// 16-byte loads (load_head_rows_sw).  Both run this body on the same tiles,
// so the stack's attention is bitwise the chain's.
// Limits: dh = 64; n <= 16 * 13 = 208, bounded by registers (8 KT logits and
// 4 KT bf16 P fragments a thread).
// ---------------------------------------------------------------------------

// the key-chunk counts built: one instantiation each of attention_rows and
// of stack_layers' attention step (ops/fused_block.py::ATTN_KEY_CHUNKS
// mirrors the list)
#define VIT_ATTN_KEY_CHUNKS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)

// the instantiation run at n keys (1 <= n <= 208)
__host__ __device__ constexpr int attn_key_chunks(int n) { return (n + 15) / 16; }

// 32-key words of one keep row at KT key chunks
__host__ __device__ constexpr int attn_keep_words(int kt) { return (16 * kt + 31) / 32; }

// ROWS rows from r0 of one head's 64 columns (row stride `stride`) into a
// swizzled tile, zero from row n on; 128 threads (tid their index among
// them), 16-byte generic stores: a fence_proxy_async and a barrier of the
// 128 must follow before wgmma reads the tile
template <int ROWS>
__device__ __forceinline__ void load_head_rows_sw(bf16* dst, const bf16* src, size_t stride, int r0, int n, int tid) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int c = tid; c < ROWS * (kAttnDh / 8); c += kAttnThreads) {
    const int r = c / (kAttnDh / 8), d = (c % (kAttnDh / 8)) * 8;
    uint4 v = zero;
    if (r0 + r < n) v = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + d);
    *reinterpret_cast<uint4*>(dst + sw_off(r, d)) = v;
  }
}

// o = softmax(q.k^T * scale) v of one 64-query tile (qs: 64 swizzled rows;
// ks, vs: 16 * KT), f32 in the accumulator layout (o[dj]: rows g, g + 8 of
// warp wtid / 32, columns 8dj + 2t, +1); keep: the 64 x attn_keep_words(KT)
// keep tile with DROP (inv = 1/(1 - rate)).  One warpgroup, wtid its thread
// index in it; waits for both products.
template <int KT, bool DROP>
__device__ __forceinline__ void attention_wg_tile(float (&o)[8][4], const bf16* qs, const bf16* ks, const bf16* vs,
                                                  const uint32_t* keep, int n_keys, float scale_log2e, float inv,
                                                  int wtid) {
  constexpr int NT = 2 * KT;  // 8-key logit tiles
  const int warp = wtid >> 5, lane = wtid & 31, g = lane >> 2, t = lane & 3;
  float s[NT][4];  // logits, then p in f32
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kAttnDh / 16; ++kk)
    WgmmaSS<NT>::mma(s, desc_k_major(qs + kk * 16), desc_k_major(ks + kk * 16), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(&s[0][0], 4 * NT);

  float mx0, mx1, inv0, inv1;
  softmax_rows(s, n_keys, t, scale_log2e, mx0, mx1, inv0, inv1);
  if constexpr (DROP) {
    constexpr int kWords = attn_keep_words(KT);
    const uint32_t* krow0 = keep + (warp * 16 + g) * kWords;
#pragma unroll
    for (int j = 0; j < NT; ++j) apply_keep(s[j], krow0, krow0 + 8 * kWords, j, t, inv);
  }

  // P in bf16, laid out as the A operand of p.v: key chunk kc = tiles 2kc, 2kc+1
  uint32_t pf[KT][4];
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) acc_to_a_frag(pf[kc], s[2 * kc], s[2 * kc + 1]);
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) o[dj][0] = o[dj][1] = o[dj][2] = o[dj][3] = 0.f;
  fence_acc(o);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) wgmma_m64n64k16_rs<1>(o, pf[kc], desc_mn_major(vs + kc * 16 * kAttnDh), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int kc = 0; kc < KT; ++kc)  // the registers p.v read stay put until it is done
    asm volatile("" : "+r"(pf[kc][0]), "+r"(pf[kc][1]), "+r"(pf[kc][2]), "+r"(pf[kc][3])::"memory");
  fence_acc(o);
}

}  // namespace
