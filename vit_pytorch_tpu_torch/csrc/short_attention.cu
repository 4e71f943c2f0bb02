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
// logits are another 4 KB.  So here a block of 4 warps takes 64 queries of one
// (b, h) slice (each warp 16 rows, q in registers as mma A fragments, read
// once) and streams the keys in 64-row tiles through the two-stage cp.async
// ring of flash_tiles.cuh, twice:
//  - pass 1 computes each tile's logits with mma.sync m16n8k16 and keeps only
//    the running row max: after it, the max is exact;
//  - pass 2 recomputes the logits (the same products in the same order, so
//    the same values), forms p = exp(s - max) in f32, sums l from the
//    unrounded p, casts p to bf16 in registers and accumulates p.v in f32.
// Then o = acc / l, cast once.  The recomputation costs one more q.k^T
// product (6 instead of 4 dh operations a logit) and keeps every logit out of
// memory, shared and device alike, at any m.
//
// The bias is read straight from device memory by each thread for its own
// accumulator elements, in both passes, with batch stride 0: block (x, bh)
// reads head bh % heads of the table, never a broadcast copy.  Rows past n
// and keys past m read no bias.
//
// Shapes: dh = dv = 64 (the port's gate, ops/short_attention.py::
// short_supported, sends everything else to the composite), q, k, v and o
// (b, h, rows, 64) with any (b, h, row) strides and a contiguous head dim.

#include "flash_tiles.cuh"

namespace {

// two ring stages of a K and a V tile
constexpr int kShortSmem = 4 * kTileElems * static_cast<int>(sizeof(bf16));

struct ShortArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const void* bias;  // (heads, n, m) f32 or bf16, rows contiguous; read by the kBias instantiation only
  int bias_bf16;
  long long bias_h, bias_row;  // its head and row strides (elements)
  Strides sq, sk, sv, so;
  int heads, n, m;
  float scale;
};

// padded keys, past m, leave the softmax (_short_kernel :48-50): their logit
// is -1e30, so p = exp(s - max) = 0
__device__ __forceinline__ bool key_in(int c, int m) { return c < m; }

// This warp's logits of key tile j: s = (q.k^T) * scale (+ bias, f32, two
// roundings), keys past m at -1e30.  bias0 / bias1: the offsets of the bias
// rows of this thread's rows g and g + 8 (read only for rows < n, keys < m).
template <bool kBias>
__device__ __forceinline__ void tile_logits(float (&s)[8][4], const uint32_t (&qf)[kFlashDh / 16][4], const bf16* ks,
                                            const ShortArgs& a, int j, long long bias0, long long bias1, bool row0,
                                            bool row1, int g, int t) {
  mma_rows_t(s, qf, ks, g, t);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * kFlashTile + jj * 8 + 2 * t + e;
      float s0 = s[jj][e] * a.scale, s1 = s[jj][2 + e] * a.scale;
      if constexpr (kBias) {
        if (row0 && c < a.m) s0 = __fadd_rn(s0, bias_at(a.bias, a.bias_bf16, bias0 + c));
        if (row1 && c < a.m) s1 = __fadd_rn(s1, bias_at(a.bias, a.bias_bf16, bias1 + c));
      }
      const bool in = key_in(c, a.m);
      s[jj][e] = in ? s0 : kNegInf;
      s[jj][2 + e] = in ? s1 : kNegInf;
    }
  }
}

// Pass 2: p = exp(s - mx) over every key tile, l += p (f32, unrounded), acc +=
// bf16(p * norm).v (norm is 1: the division by l comes after the product).
// All threads; the ring is drained on return.
template <bool kBias>
__device__ __forceinline__ void pv_pass(float (&o)[8][4], float& l0, float& l1, float mx0, float mx1, float norm0,
                                        float norm1, bf16* ring, const uint32_t (&qf)[kFlashDh / 16][4],
                                        const bf16* kb, const bf16* vb, const ShortArgs& a, long long bias0,
                                        long long bias1, bool row0, bool row1, int g, int t) {
  const int nk = (a.m + kFlashTile - 1) / kFlashTile;
  load_tile_async(ring, kb, a.sk.row, 0, a.m);
  load_tile_async(ring + kTileElems, vb, a.sv.row, 0, a.m);
  cp_async_commit();
  float sum0 = 0.f, sum1 = 0.f;
  for (int j = 0, stage = 0; j < nk; ++j, stage ^= 1) {
    if (j + 1 < nk) {
      load_tile_async(ring + 2 * (stage ^ 1) * kTileElems, kb, a.sk.row, (j + 1) * kFlashTile, a.m);
      load_tile_async(ring + (2 * (stage ^ 1) + 1) * kTileElems, vb, a.sv.row, (j + 1) * kFlashTile, a.m);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile j landed
    const bf16* ks = ring + 2 * stage * kTileElems;
    float s[8][4];
    tile_logits<kBias>(s, qf, ks, a, j, bias0, bias1, row0, row1, g, t);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 = exp2f((s[jj][e] - mx0) * kLog2e), p1 = exp2f((s[jj][2 + e] - mx1) * kLog2e);
        sum0 += p0;
        sum1 += p1;
        s[jj][e] = p0 * norm0;
        s[jj][2 + e] = p1 * norm1;
      }
    }
    uint32_t pf[4][4];
    to_a_frags(pf, s);
    mma_acc(o, pf, ks + kTileElems, g, t);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  l0 += quad_sum(sum0);
  l1 += quad_sum(sum1);
}

// one block per (64-query tile, b*h)
template <bool kBias>
__global__ void __launch_bounds__(kFlashThreads) short_attention_kernel(ShortArgs a) {
  extern __shared__ __align__(16) unsigned char short_smem[];
  bf16* ring = reinterpret_cast<bf16*>(short_smem);  // stage s: K at 2s, V at 2s + 1

  const int q0 = blockIdx.x * kFlashTile, bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* kb = head_ptr(a.k, a.sk, b, h);
  const bf16* vb = head_ptr(a.v, a.sv, b, h);
  const int nk = (a.m + kFlashTile - 1) / kFlashTile;

  const int row_lo = q0 + warp * 16 + g;
  const bool row0 = row_lo < a.n, row1 = row_lo + 8 < a.n;
  // the per-head table's rows of this thread, batch stride 0 (_short_kernel's
  // bias index map, :129-132)
  const long long bias0 = (bh % a.heads) * a.bias_h + row_lo * a.bias_row, bias1 = bias0 + 8 * a.bias_row;

  load_tile_async(ring, kb, a.sk.row, 0, a.m);
  cp_async_commit();
  uint32_t qf[kFlashDh / 16][4];
  load_a_rows(qf, head_ptr(a.q, a.sq, b, h), a.sq.row, row_lo, a.n, t);

  // pass 1: the exact row max over the key stream (K tiles only)
  float mx0 = kNegInf, mx1 = kNegInf;
  for (int j = 0, stage = 0; j < nk; ++j, stage ^= 1) {
    if (j + 1 < nk) load_tile_async(ring + 2 * (stage ^ 1) * kTileElems, kb, a.sk.row, (j + 1) * kFlashTile, a.m);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    tile_logits<kBias>(s, qf, ring + 2 * stage * kTileElems, a, j, bias0, bias1, row0, row1, g, t);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      mx0 = fmaxf(mx0, fmaxf(s[jj][0], s[jj][1]));
      mx1 = fmaxf(mx1, fmaxf(s[jj][2], s[jj][3]));
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is refilled by pass 2
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);

  // pass 2, then o = acc / l (_short_kernel :53-61): one division, one cast
  float o[8][4];
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) o[dj][0] = o[dj][1] = o[dj][2] = o[dj][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  pv_pass<kBias>(o, l0, l1, mx0, mx1, 1.f, 1.f, ring, qf, kb, vb, a, bias0, bias1, row0, row1, g, t);
  const float div0 = l0, div1 = l1;
  bf16* ob = head_ptr(a.o, a.so, b, h);
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) {
    const int col = dj * 8 + 2 * t;
    if (row0) *reinterpret_cast<uint32_t*>(ob + row_lo * a.so.row + col) = pack_floats(o[dj][0] / div0, o[dj][1] / div0);
    if (row1)
      *reinterpret_cast<uint32_t*>(ob + (row_lo + 8) * a.so.row + col) =
          pack_floats(o[dj][2] / div1, o[dj][3] / div1);
  }
}

typedef void (*ShortKernel)(ShortArgs);

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
  const ShortKernel kernel = bias ? short_attention_kernel<true> : short_attention_kernel<false>;
  const dim3 grid((n + kFlashTile - 1) / kFlashTile, batch * heads);
  kernel<<<grid, kFlashThreads, kShortSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
