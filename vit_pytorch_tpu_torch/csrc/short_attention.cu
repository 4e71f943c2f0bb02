// Hopper (sm_90a) one-shot softmax attention for short sequences, with an
// optional per-head additive bias.
//
// It replaces the TPU kernel vit_pytorch_tpu/ops/short_attention.py::
// _short_kernel (:31, called at :135): s = q.k^T in f32 times the scale, plus
// a per-head (h, n, m) bias upcast to f32, keys past m masked to -1e30; p =
// exp(s - rowmax) in f32 with the row's exact max; l = sum of the unrounded p
// in f32; o = (bf16(p).v in f32) / l, one cast.  The division comes after the
// p.v product, unlike the flash kernel's online softmax, which rescales as it
// goes, and unlike the composite, which normalises p before its cast: this
// kernel rounds where _short_kernel does.
//
// Bound on this card: at SimpleViT-B/16 @512 (b = 32, h = 12, n = m = 1024,
// dh = 64) the work is 4 * n * m * dh = 268 M operations a (b, h) slice
// against 512 KB of q, k, v and o: far above the ~295 operations a byte where
// the H100 turns from memory- to compute-bound.  The (n, m) logits, 32 M a
// slice, never leave the chip.
//
// Design.  The TPU kernel holds a whole key row, and G slices of it, in
// VMEM.  At m = 1024 and dh = 64, K and V in bf16 are 128 KB each, more than a
// Hopper block's 227 KB of shared memory together, and a query row's f32
// logits are another 4 KB.  So here a block of two warpgroups takes 128
// queries of one (b, h) slice (q in registers, the A operand of wgmma, read
// once) and streams the keys in 64-row tiles through attn_wgmma.cuh's TMA
// ring (four stages filled two steps ahead; with a bias two, one ahead)
// twice, as one stream of 2 * tiles steps:
//  - pass 1 (K tiles, and bias tiles) computes each tile's logits with the
//    one wgmma sequence qk_issue and keeps only the running row max (two
//    tiles a step where the ring allows: the second q.k^T beside the first
//    max); after it, the max is exact;
//  - pass 2 (K, V and bias tiles) recomputes the logits with the same
//    sequence (so the same values, bitwise), forms p = exp(s - max) in f32,
//    sums l from the unrounded p, packs bf16(p) into wgmma A fragments in
//    registers and accumulates p.v with wgmma in f32.
// Then o = acc / l, cast once.  The ring runs across the two passes, so
// pass 2's first tiles land while pass 1 ends.  The recomputation costs one
// more q.k^T product (6 instead of 4 dh operations a logit) and keeps every
// logit out of memory, shared and device alike, at any m: 64 queries'
// logits over 1024 keys in f32 would be 256 KB, more than a block has.  An
// online softmax would round bf16(p) against a running max, which is not
// the function _short_kernel computes.
//
// The bias is a (heads, n, m) table shared by the batch (batch stride 0).
// Each ring stage carries its 128 x 64 tile (attn_wgmma.cuh), and the grid
// is ordered by head, then query tile, then image (grid_pos), so the 32
// images of one (head, query tile) read the same tile rows side by side:
// the table comes from device memory about once and from L2 for the other
// images.  Rows past n and keys past m read no bias.
//
// Shapes: dh = dv = 64 (the port's gate, ops/short_attention.py::
// short_supported, sends everything else to the composite), q, k, v and o
// (b, h, rows, 64) with any (b, h, row) strides and a contiguous head dim.

#include "attn_wgmma.cuh"

namespace {

// warpgroups a block (64 queries each, sharing the ring), by instantiation
__host__ __device__ constexpr int short_wgs(bool bias) { return 2; }

// ring stages and how many steps ahead a stage is filled, by instantiation
// (a bias stage is large: with two, three blocks fit an SM); with two
// stages more than that, pass 1 takes its steps two at a time
__host__ __device__ constexpr int short_ring(bool bias) { return bias ? 2 : 4; }
__host__ __device__ constexpr int short_ahead(bool bias) { return bias ? 1 : 2; }

// the ring's K and V tiles (stage s's K at 2s, V at 2s + 1), the bias
// stages of 64 * wgs query rows, the stages' K and V mbarriers
constexpr int short_smem(bool bias) {
  return kWgAlign + 2 * short_ring(bias) * kSwTileBytes + (bias ? short_ring(bias) * short_wgs(bias) * kBiasTileBytes : 0) +
         2 * short_ring(bias) * 8;
}

struct ShortArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const void* bias;  // (heads, n, m) f32 or bf16, rows contiguous; read by the kBias instantiation only
  int bias_bf16;
  long long bias_h, bias_row;  // its head and row strides (elements)
  Strides sq, sk, sv, so;
  int batch, heads, n, m;
  float scale;
};

// padded keys, past m, leave the softmax (_short_kernel :48-50): their logit
// is -1e30, so p = exp(s - max) = 0
__device__ __forceinline__ bool key_in(int c, int m) { return c < m; }

// The logits of key tile j in place: s = (q.k^T) * scale (+ bias, f32, two
// roundings), keys past m at -1e30 (a tile whose keys are all below m,
// kFull, tests none).  bias: the tile's ring stage of ROWS rows (kBias).
template <bool kBias, bool kFull, int ROWS>
__device__ __forceinline__ void tile_logits(float (&s)[8][4], const ShortArgs& a, const unsigned char* bias, int j,
                                            int lr, int t) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int c = j * kFlashTile + jj * 8 + 2 * t;
    float s0[2] = {__fmul_rn(s[jj][0], a.scale), __fmul_rn(s[jj][1], a.scale)};
    float s1[2] = {__fmul_rn(s[jj][2], a.scale), __fmul_rn(s[jj][3], a.scale)};
    if constexpr (kBias) {
      const float2 b0 = bias_pair<ROWS>(bias, a.bias_bf16, lr, jj * 8 + 2 * t);
      const float2 b1 = bias_pair<ROWS>(bias, a.bias_bf16, lr + 8, jj * 8 + 2 * t);
      s0[0] = __fadd_rn(s0[0], b0.x), s0[1] = __fadd_rn(s0[1], b0.y);
      s1[0] = __fadd_rn(s1[0], b1.x), s1[1] = __fadd_rn(s1[1], b1.y);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool in = kFull || key_in(c + e, a.m);
      s[jj][e] = in ? s0[e] : kNegInf;
      s[jj][2 + e] = in ? s1[e] : kNegInf;
    }
  }
}

// one block per (64 * kWgs-query tile, image, head), in grid_pos's order;
// the loop of attn_wgmma.cuh, peeled so that every wgmma issue and wait is
// unconditional: pass 1, pass 2's first step (no p.v yet), the rest of pass
// 2 (q.k^T of this step beside p.v of the previous one), the last p.v
template <bool kBias>
__global__ void __launch_bounds__(kFlashThreads * short_wgs(kBias), wg_blocks(short_wgs(kBias)))
    short_attention_kernel(ShortArgs a, const __grid_constant__ TmaMaps maps) {
  constexpr int kWgs = short_wgs(kBias), kThreads = kFlashThreads * kWgs, kRows = kFlashTile * kWgs;
  constexpr int kBiasStage = kWgs * kBiasTileBytes, kStages = short_ring(kBias), kAhead = short_ahead(kBias);
  extern __shared__ unsigned char short_smem_raw[];
  unsigned char* smem = aligned_smem(short_smem_raw);
  bf16* ring = reinterpret_cast<bf16*>(smem);
  unsigned char* bias_ring = smem + 2 * kStages * kSwTileBytes;  // stage s at s * kBiasStage

  const int nk = (a.m + kFlashTile - 1) / kFlashTile, steps = 2 * nk;
  const GridPos pos = grid_pos(a.batch, (a.n + kRows - 1) / kRows, false);
  const int b = pos.b, h = pos.h, q0 = pos.qt * kRows;
  const int wg = threadIdx.x / kFlashThreads, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the per-head table of this block's head, batch stride 0 (_short_kernel's
  // bias index map, :129-132), from its query tile's first row
  const BiasTable bt{kBias ? static_cast<const char*>(a.bias) + (h * a.bias_h + q0 * a.bias_row) * (a.bias_bf16 ? 2 : 4)
                           : nullptr,
                     a.bias_row, a.bias_bf16, h, 0};
  // stage s's mbarriers: its K (and bias) copies at kfull[s], its V at
  // vfull[s]; bit s of kphase / vphase is the parity each waits for next
  uint64_t* kfull = reinterpret_cast<uint64_t*>(bias_ring + (kBias ? kStages * kBiasStage : 0));
  uint64_t* vfull = kfull + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(kfull + i);
    mbar_fence_init();
  }
  __syncthreads();
  uint32_t kphase = 0u, vphase = 0u;

  // step s: key tile s % nk; pass 1 (s < nk) reads K and bias, pass 2 K, V
  // and bias; iteration i fills K and bias of step i + kAhead and V of step
  // i + kAhead - 1
  auto load_kb = [&](int step) {
    const int st = step % kStages, j = step % nk;
    [[maybe_unused]] const bool bias_tma = kBias && maps.bias_tma;
    if (threadIdx.x == 0) {
      uint32_t bytes = kSwTileBytes;
      if constexpr (kBias) bytes += bias_tma ? bias_tile_bytes<kRows>(a.bias_bf16) : 0u;
      mbar_expect(kfull + st, bytes);
      tma_load(ring + 2 * st * kSwTile, maps.k, 0, j * kFlashTile, h, b, kfull + st);
      if constexpr (kBias)
        if (bias_tma)
          tma_bias_tile<kRows>(bias_ring + st * kBiasStage, maps, bt, q0, j * kFlashTile, kfull + st);
    }
    if constexpr (kBias)
      if (!bias_tma) load_bias_elems<kRows, kThreads>(bias_ring + st * kBiasStage, bt, j * kFlashTile, a.n - q0, a.m);
  };
  auto load_v = [&](int step) {
    if (step >= nk && threadIdx.x == 0) {
      const int st = step % kStages;
      mbar_expect(vfull + st, kSwTileBytes);
      tma_load(ring + (2 * st + 1) * kSwTile, maps.v, 0, (step - nk) * kFlashTile, h, b, vfull + st);
    }
  };
  auto wait_v = [&](int step) {
    const int st = step % kStages;
    mbar_wait(vfull + st, (vphase >> st) & 1u);
    vphase ^= 1u << st;
  };
  // the top of every step: every reader of the stages refilled here is
  // done (its generic reads ordered before the copies' async writes); then
  // the step's K and bias have landed
  auto top = [&](int step) {
    fence_proxy_async();
    __syncthreads();
    if (step + kAhead < steps) load_kb(step + kAhead);
    if (step + kAhead - 1 < steps) load_v(step + kAhead - 1);
    const int st = step % kStages;
    mbar_wait(kfull + st, (kphase >> st) & 1u);
    kphase ^= 1u << st;
  };
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < steps) load_kb(i);
    if (i > 0 && i - 1 < steps) load_v(i - 1);
  }

  const int lr = wg * kFlashTile + warp * 16 + g;  // this thread's rows lr, lr + 8 of the block's tile
  uint32_t qf[kFlashDh / 16][4];
  load_a_rows(qf, head_ptr(a.q, a.sq, b, h), a.sq.row, q0 + lr, a.n, t);
  auto bias_stage = [&](int step) { return bias_ring + (step % kStages) * kBiasStage; };
  // the logits of a step's key tile j: only the last tile can hold keys past m
  auto logits = [&](float (&s)[8][4], int step, int j) {
    if ((j + 1) * kFlashTile <= a.m)
      tile_logits<kBias, true, kRows>(s, a, bias_stage(step), j, lr, t);
    else
      tile_logits<kBias, false, kRows>(s, a, bias_stage(step), j, lr, t);
  };

  // pass 1: the exact row max; two steps at a time where the ring has the
  // stages (the second step's q.k^T runs beside the first one's max)
  // Without a bias and with a positive scale the max is taken over the raw
  // logits and scaled once: round(max(s) * scale) = max(round(s * scale)).
  float mx0 = kNegInf, mx1 = kNegInf;
  const bool raw_max = !kBias && a.scale > 0.f;
  auto row_max = [&](float (&s)[8][4], int step) {
    if (raw_max) {
      const bool full = (step + 1) * kFlashTile <= a.m;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = full || key_in(step * kFlashTile + jj * 8 + 2 * t + e, a.m);
          mx0 = fmaxf(mx0, in ? s[jj][e] : kNegInf);
          mx1 = fmaxf(mx1, in ? s[jj][2 + e] : kNegInf);
        }
      }
      return;
    }
    logits(s, step, step);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      mx0 = fmaxf(mx0, fmaxf(s[jj][0], s[jj][1]));
      mx1 = fmaxf(mx1, fmaxf(s[jj][2], s[jj][3]));
    }
  };
  int step1 = 0;
  if constexpr (kStages >= kAhead + 2) {
    for (; step1 + 1 < nk; step1 += 2) {
      top(step1);
      top(step1 + 1);
      float s[8][4], s2[8][4];
      wgmma_fence();
      qk_issue(s, qf, ring + 2 * (step1 % kStages) * kSwTile);
      qk_issue(s2, qf, ring + 2 * ((step1 + 1) % kStages) * kSwTile);
      wgmma_wait<1>();
      fence_acc(s);
      row_max(s, step1);
      wgmma_wait<0>();
      fence_acc(s2);
      row_max(s2, step1 + 1);
    }
  }
  for (; step1 < nk; ++step1) {
    top(step1);
    float s[8][4];
    wgmma_fence();
    qk_issue(s, qf, ring + 2 * (step1 % kStages) * kSwTile);
    wgmma_wait<0>();
    fence_acc(s);
    row_max(s, step1);
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  if (raw_max) {
    mx0 = __fmul_rn(mx0, a.scale);
    mx1 = __fmul_rn(mx1, a.scale);
  }

  // pass 2: p = exp(s - max), l from the unrounded p, bf16(p) for the step's
  // p.v (issued beside the next step's q.k^T)
  float sum0 = 0.f, sum1 = 0.f;
  auto probabilities = [&](float (&s)[8][4], int step) {
    logits(s, step, step - nk);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2_ftz((s[jj][e] - mx0) * kLog2e), p1 = exp2_ftz((s[jj][2 + e] - mx1) * kLog2e);
        sum0 += p0;
        sum1 += p1;
        s[jj][e] = p0;
        s[jj][2 + e] = p1;
      }
    }
  };
  float o[8][4];
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) o[dj][0] = o[dj][1] = o[dj][2] = o[dj][3] = 0.f;
  uint32_t pf[4][4];  // bf16(p) of the previous step, the A operand of its p.v
  {
    top(nk);
    float s[8][4];
    wgmma_fence();
    qk_issue(s, qf, ring + 2 * (nk % kStages) * kSwTile);
    wgmma_wait<0>();
    fence_acc(s);
    probabilities(s, nk);
    to_a_frags(pf, s);
  }
  for (int step = nk + 1; step < steps; ++step) {
    top(step);
    float s[8][4];
    wait_v(step - 1);
    wgmma_fence();
    qk_issue(s, qf, ring + 2 * (step % kStages) * kSwTile);
    pv_issue(o, pf, ring + (2 * ((step - 1) % kStages) + 1) * kSwTile);
    wgmma_wait<1>();
    fence_acc(s);
    probabilities(s, step);
    wgmma_wait<0>();
    fence_acc(o);
    fence_frags(pf);
    to_a_frags(pf, s);
  }
  wait_v(steps - 1);  // the last step's V landed
  wgmma_fence();
  pv_issue(o, pf, ring + (2 * ((steps - 1) % kStages) + 1) * kSwTile);
  wgmma_wait<0>();
  fence_acc(o);

  // o = acc / l (_short_kernel :53-61): one division, one cast
  const float div0 = quad_sum(sum0), div1 = quad_sum(sum1);
  const int row_lo = q0 + lr;
  bf16* ob = head_ptr(a.o, a.so, b, h);
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) {
    const int col = dj * 8 + 2 * t;
    if (row_lo < a.n)
      *reinterpret_cast<uint32_t*>(ob + row_lo * a.so.row + col) = pack_floats(o[dj][0] / div0, o[dj][1] / div0);
    if (row_lo + 8 < a.n)
      *reinterpret_cast<uint32_t*>(ob + (row_lo + 8) * a.so.row + col) =
          pack_floats(o[dj][2] / div1, o[dj][3] / div1);
  }
}

typedef void (*ShortKernel)(ShortArgs, TmaMaps);

}  // namespace

// ---------------------------------------------------------------------------
// C interface (ctypes).  q, k, v, o: device pointers, bf16 (b, h, rows, 64)
// with the (b, h, row) strides given in `strides` (12 values, q, k, v, o; in
// elements, a contiguous head dim, 16-byte aligned rows); bias: null, or a
// (heads, n, m) f32 (bias_bf16 = 0) or bf16 table with head stride bias_h and
// row stride bias_row, its rows contiguous.  The wrapper in
// ops/short_attention.py checks all of it.
// ---------------------------------------------------------------------------

extern "C" {

int vit_short_attention(const void* q, const void* k, const void* v, void* o, const void* bias, int bias_bf16,
                        long long bias_h, long long bias_row, int batch, int heads, int n, int m, int dim_head,
                        int dim_value, float scale, const long long* strides, void* stream) {
  if (dim_head != kFlashDh || dim_value != kFlashDh || batch <= 0 || heads <= 0 || n <= 0 || m <= 0 ||
      static_cast<long long>(batch) * heads > 65535)
    return cudaErrorInvalidValue;
  ShortArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.bias = bias;
  a.bias_bf16 = bias_bf16;
  a.bias_h = bias_h;
  a.bias_row = bias_row;
  Strides* s[4] = {&a.sq, &a.sk, &a.sv, &a.so};
  for (int i = 0; i < 4; ++i) *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  a.heads = heads;
  a.n = n;
  a.m = m;
  a.scale = scale;
  a.batch = batch;
  TmaMaps maps{};
  if (!encode_operand_map(maps.k, k, a.sk, m, heads, batch) || !encode_operand_map(maps.v, v, a.sv, m, heads, batch))
    return cudaErrorInvalidValue;
  const int rows = kFlashTile * short_wgs(bias != nullptr);
  maps.bias_tma = bias && bias_tma_ok(bias, bias_bf16, 0, bias_h, bias_row) &&
                  encode_bias_map(maps.bias, bias, bias_bf16, n, m, heads, 1, bias_row, bias_h, 0, rows);
  const ShortKernel kernel = bias ? short_attention_kernel<true> : short_attention_kernel<false>;
  const long long blocks = static_cast<long long>((n + rows - 1) / rows) * batch * heads;
  return launch_attention(kernel, a, maps, blocks, kFlashThreads * short_wgs(bias != nullptr), short_smem(bias != nullptr),
                          stream);
}

}  // extern "C"
