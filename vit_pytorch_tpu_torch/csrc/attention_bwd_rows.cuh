// Hopper (sm_90a) kernel attention_bwd_rows: the attention backward of every
// head of a layer, from the packed (b, n, 3 * inner) qkv rows and the merged
// heads' gradient dm (b, n, inner) to the recomputed merged heads m and the
// packed dqkv, n <= 208, dh = 64; with the instantiations [dropout] (the
// forward's keep bits replayed), [qknorm] (q and k through the per-head
// RMSNorm, closed on dq and dk, dgamma_q and dgamma_k summed) and both.
//
// Replaces: the per-head loop of vit_pytorch_tpu/ops/fused_block.py::
// _bwd_kernel (:608-692; the TPU kernel :524, called at :786 by
// _pallas_backward), with its rounding points:
//   p  = _softmax_from_dots(q k^T, scale)   (f32; padded keys masked)
//   pd = p, or with dropout where(keep, p, 0) * 1/(1 - rate)   (:634-656)
//   m  = bf16(bf16(pd) . v)
//   dv = bf16(pd)^T . dm_h
//   dp = dm_h . v^T (f32), with dropout where(keep, dp, 0) * 1/(1 - rate)
//   ds = bf16(p * (dp - rowsum(dp * p)))     (the f32, unmasked p both times)
//   dq = ds . k * scale,  dk = ds^T . q * scale   (scale on the f32 product)
// and with qk-norm the norm's recompute (:614-627) and backward (:665-688):
// dgamma terms d * xhat, d <- r (d g8 - xhat <d g8, xhat>).  The rest of
// _bwd_kernel is other launches: ops/fused_block.py::_attention_block_bwd.
//
// Bound on this card: the bytes of q, k, v, dm in and m, dqkv out, 16 bytes
// a (row, head column): at bs=128 n=197 the kernel moves 310 MB, 0.0925 ms
// at 3.35 TB/s, against 9 n^2 dh flops a head on the tensor cores (~0.05
// ms at 989 TFLOP/s).  The (n, n) p, dp and ds never leave the SM.
//
// Design: one block of one warpgroup for each (image, head), in the grid's
// order image by image, that runs a row pass and then a key pass on
// operands it loads once:
//  - Copies: one thread loads the head's q, k, v and dm, 16 KT rows each
//    (KT = ceil(n / 16), a template parameter; the host runs one
//    instantiation per count in VIT_ATTN_KEY_CHUNKS, so n = 64 computes 4
//    key chunks, not 13), by the TMA through 3-D (image, row, column)
//    tensor maps in the 128-byte swizzle: rows past n are zero-filled and
//    never read from the next image.  104 KB at KT = 13, so two blocks
//    share an SM and one's copies run under the other's products.  With
//    qk-norm q and k are normalised once, in place, in the sum order of the
//    forward's attention_rows[qknorm] (rms_norm_tile_sw), so the backward's
//    q^ and k^ are the forward's bits.
//  - Row pass, a 64-query tile at a time: the logits against every key on
//    wgmma.m64n(16 KT)k16 (wgmma_wide.cuh) and the forward's exact softmax
//    (softmax_rows), so p is the forward's p, held in registers (8 KT
//    floats a thread).  Then two sweeps over 64-key chunks (the last one
//    16 keys a k16 step left over): the first forms
//    dp = dm.v^T (both K-major from shared memory), D = rowsum(dp * p) and
//    m += bf16(pd).v (pd's A fragments from registers, v MN-major); the
//    second forms dp again, ds and dq += ds.k (k MN-major).  Each row's
//    max, 1/sum and D stay in shared memory for the key pass (0, 0, 0 for
//    a row past n, whose p is then 0).
//  - Key pass, a 64-key tile at a time, over the same query chunks: p^T = k.q^T
//    and dp^T = v.dm^T (K-major both), p^T rebuilt from the row statistics
//    (exp2 of the scaled logit less the row max, times 1/sum), ds^T and
//    pd^T formed in registers, dv += bf16(pd^T).dm and dk += ds^T.q with
//    dm and q MN-major.  Every accumulator is at most 32 floats a thread.
//  - Dropout: the row pass draws each query tile's keep bits (the
//    forward's Philox stream (seed, img * 1024 + head), fill_keep_tile)
//    once, and also writes them to a scratch buffer (b, heads, 16 KT, words)
//    from which the key pass reads its tile's columns back: the mask is
//    drawn once a head, not once a pass.
//  - qk-norm: dq and dk are closed on the f32 products with the raw rows
//    (read from device memory into registers while the tile's products
//    run) and the rsqrt kept by the norm (rms_norm_bwd_rows);
//    a block owns the 64 columns of its head, so it adds its rows' dgamma
//    terms in a fixed order (tiles in order, the 4 warps in order) into
//    its row of a (b, 2, inner) f32 buffer, and launch_column_sum adds the
//    images in a fixed order with the sqrt(64) factor: no atomics, the
//    result does not change from run to run.
//  - Every product is one committed group with its wait in straight-line
//    code (the chunk loops are unrolled; a wgmma issue or wait in a branch
//    serialises every wgmma of the kernel), and register-A fragments are
//    fenced live up to their wait.
// A 64-row tile that reaches past 16 KT rows reads the next operand's rows
// (or the tail's slack after dm): those rows are computed and thrown away,
// since a row of a product depends on its own row of A alone.
//
// The kernel and its launcher live here; attention_bwd_rows.cu (the C entry
// point and the plain instantiations) and attention_bwd_rows_dropout.cu,
// _qknorm.cu and _dropout_qknorm.cu each build one variant's 13, so nvcc
// compiles the four sets in parallel.

#pragma once

#include "layer_tiles.cuh"

struct AttnBwdArgs {
  int n, heads;
  float scale_log2e, scale;
  DropoutArgs drop;
  const bf16* qkv;  // the raw q and k rows the qk-norm's closing reads
  const bf16* gq;   // qk-norm gammas, (heads * 64) bf16 each
  const bf16* gk;
  bf16* m;
  bf16* dqkv;
  uint32_t* keep;     // [dropout]: (b, heads, 16 KT, attn_keep_words(KT)) scratch
  float* dg_partial;  // [qknorm]: (b, 2, inner)
};

// qkv as (3 inner, n, b) and dm as (inner, n, b), boxes of 64 columns x 16
// KT rows
struct alignas(64) AttnBwdMaps {
  CUtensorMap qkv, dm;
};

// the launch of one variant at kt key chunks: one block an (image, head)
cudaError_t attention_bwd_launch_plain(int kt, const AttnBwdArgs& args, const AttnBwdMaps& maps, unsigned blocks,
                                       cudaStream_t stream);
cudaError_t attention_bwd_launch_dropout(int kt, const AttnBwdArgs& args, const AttnBwdMaps& maps, unsigned blocks,
                                         cudaStream_t stream);
cudaError_t attention_bwd_launch_qknorm(int kt, const AttnBwdArgs& args, const AttnBwdMaps& maps, unsigned blocks,
                                        cudaStream_t stream);
cudaError_t attention_bwd_launch_dropout_qknorm(int kt, const AttnBwdArgs& args, const AttnBwdMaps& maps,
                                                unsigned blocks, cudaStream_t stream);

namespace {


// The block's shared memory past the four operands: an mbarrier, the row
// statistics, the keep words ([dropout]: a query tile's 64 rows, then all
// queries x a key tile's two words), the norm's rsqrt and the 4 warps'
// column sums ([qknorm]); at least as many bytes as a 64-row tile reaches
// past the last operand.
__host__ __device__ constexpr int bwd_keep_words(int kt) {
  return 64 * attn_keep_words(kt) > 2 * 16 * kt ? 64 * attn_keep_words(kt) : 2 * 16 * kt;
}
__host__ __device__ constexpr int bwd_tail_bytes(int kt, bool drop, bool qk) {
  const int np = 16 * kt, slack = ((np + 63) / 64 * 64 - np) * 64 * 2;
  const int extras = 16 + 3 * np * 4 + (drop ? bwd_keep_words(kt) * 4 : 0) + (qk ? 2 * np * 4 + 4 * 64 * 4 : 0);
  return ((extras > slack ? extras : slack) + 15) / 16 * 16;
}
__host__ __device__ constexpr int attn_bwd_smem(int kt, bool drop, bool qk) {
  return kWgAlign + 4 * 16 * kt * kAttnDh * 2 + bwd_tail_bytes(kt, drop, qk);
}

// d[0 .. 2W-1] = A(64 rows) . B(16 W rows)^T over dh = 64, both K-major
// swizzled tiles in shared memory (four k16 steps, the first overwriting);
// d[2W ..] untouched.  After a wgmma_fence; not committed.
template <int W, int NT>
__device__ __forceinline__ void ss_chunk(float (&d)[NT][4], const bf16* a_rows, const bf16* b_rows) {
  float(&dw)[2 * W][4] = *reinterpret_cast<float(*)[2 * W][4]>(&d[0][0]);
#pragma unroll
  for (int kk = 0; kk < kAttnDh / 16; ++kk)
    WgmmaSS<2 * W>::mma(dw, desc_k_major(a_rows + kk * 16), desc_k_major(b_rows + kk * 16), kk);
}

// the accumulators' four k16 A fragments stay put until the wgmma that
// reads them is done
__device__ __forceinline__ void fence_frag(uint32_t (&f)[4]) {
  asm volatile("" : "+r"(f[0]), "+r"(f[1]), "+r"(f[2]), "+r"(f[3])::"memory");
}

// rows past n (zero rows, or a 64-row tile's rows past 16 KT, read from the
// next operand) out of the norm's column sums: their gradient rows are 0
__device__ __forceinline__ void zero_rows_past(float (&d)[8][4], bool past0, bool past1) {
#pragma unroll
  for (int dj = 0; dj < 8; ++dj) {
    if (past0) d[dj][0] = d[dj][1] = 0.f;
    if (past1) d[dj][2] = d[dj][3] = 0.f;
  }
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_floats(a, b);
}

template <int KT, bool DROP, bool QKNORM>
__global__ void __launch_bounds__(kAttnThreads, 2)
    attention_bwd_kernel(AttnBwdArgs a, const __grid_constant__ AttnBwdMaps maps) {
  constexpr int NP = 16 * KT;               // rows of each operand, padded
  constexpr int NT = 2 * KT;                // 8-column logit tiles of a full row
  // k16 steps a chunk of keys (queries): 64-wide chunks.  With dropout
  // 32-wide ones spill 4 bytes, not 52, but run 4% slower on an H100.
  constexpr int CW = 4;
  constexpr int NC = (KT + CW - 1) / CW;           // chunks
  constexpr int LW = KT % CW == 0 ? CW : KT % CW;  // k16 steps of the last chunk
  constexpr int KW = attn_keep_words(KT);   // 32-key words of a keep row
  extern __shared__ unsigned char attn_bwd_raw[];
  unsigned char* smem = aligned_smem(attn_bwd_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);  // NP rows each, swizzled
  bf16* ks = qs + NP * kAttnDh;
  bf16* vs = ks + NP * kAttnDh;
  bf16* dms = vs + NP * kAttnDh;
  unsigned char* tail = reinterpret_cast<unsigned char*>(dms + NP * kAttnDh);
  uint64_t* full = reinterpret_cast<uint64_t*>(tail);
  float* st_mx = reinterpret_cast<float*>(tail + 16);  // [NP]: the scaled logits' row max
  float* st_inv = st_mx + NP;                          // [NP]: 1 / the row sum
  float* st_d = st_inv + NP;                           // [NP]: D = rowsum(dp * p)
  uint32_t* keep = reinterpret_cast<uint32_t*>(st_d + NP);  // [bwd_keep_words(KT)], DROP only
  float* rq = reinterpret_cast<float*>(keep + (DROP ? bwd_keep_words(KT) : 0));  // [NP], QKNORM only
  float* rk = rq + NP;                                                           // [NP]
  float* colsum = rk + NP;                                                       // [4][64]

  const int img = blockIdx.x / a.heads, h = blockIdx.x % a.heads, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int n = a.n, inner = a.heads * kAttnDh;
  const size_t rstride = 3 * static_cast<size_t>(inner);
  const size_t img_row = static_cast<size_t>(img) * n;
  uint32_t* keep_g = a.keep + (static_cast<size_t>(img) * a.heads + h) * NP * KW;  // DROP only
  if (tid == 0) {
    mbar_init(full);
    mbar_fence_init();
    mbar_expect(full, 4 * NP * kAttnDh * static_cast<int>(sizeof(bf16)));
    tma_load_3d(qs, &maps.qkv, h * kAttnDh, 0, img, full);
    tma_load_3d(ks, &maps.qkv, inner + h * kAttnDh, 0, img, full);
    tma_load_3d(vs, &maps.qkv, 2 * inner + h * kAttnDh, 0, img, full);
    tma_load_3d(dms, &maps.dm, h * kAttnDh, 0, img, full);
  }
  __syncthreads();  // the barrier is initialised before any thread waits on it
  mbar_wait(full, 0);
  if constexpr (QKNORM) {  // q and k once a head, the forward's sum order
    rms_norm_tile_sw<kAttnThreads, NP>(qs, a.gq + h * kAttnDh, rq);
    rms_norm_tile_sw<kAttnThreads, NP>(ks, a.gk + h * kAttnDh, rk);
    fence_proxy_async();
    __syncthreads();
  }
  float dgamma = 0.f;  // QKNORM: threads 0..63, the head's column tid

  // this warp's rows of a 64-row tile: 16 warp + g and + 8
  const int wr0 = warp * 16 + g, wr1 = wr0 + 8;

  // ---- the row pass: a 64-query tile at a time ----
#pragma unroll 1
  for (int q0 = 0; q0 < n; q0 += kAttnQT) {
    const bf16* qt = qs + q0 * kAttnDh;
    const bf16* dmt = dms + q0 * kAttnDh;
    if constexpr (DROP) {
      __syncthreads();  // every warp is done with the last tile's keep words
      fill_keep_tile<kAttnQT, KW>(keep, a.drop, dropout_stream(img, h), q0, 0, n, n);
      for (int i = tid; i < kAttnQT * KW; i += kAttnThreads)  // this thread's own words, for the key pass
        if (q0 + i / KW < NP) keep_g[q0 * KW + i] = keep[i];
      __syncthreads();
    }
    const uint32_t* krow0 = keep + wr0 * KW;  // DROP: keep rows g, g + 8 of the warp
    const uint32_t* krow1 = keep + wr1 * KW;

    float s[NT][4];  // logits, then p in f32
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAttnDh / 16; ++kk)
      WgmmaSS<NT>::mma(s, desc_k_major(qt + kk * 16), desc_k_major(ks + kk * 16), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(&s[0][0], 4 * NT);
    float mx0, mx1, inv0, inv1;
    softmax_rows(s, n, t, a.scale_log2e, mx0, mx1, inv0, inv1);

    // sweep 1: dp, D = rowsum(dp * p), m = bf16(pd) . v
    float mo[8][4];
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) mo[dj][0] = mo[dj][1] = mo[dj][2] = mo[dj][3] = 0.f;
    fence_acc(mo);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float dp[2 * CW][4];
      wgmma_fence();
      if (c + 1 < NC) ss_chunk<CW>(dp, dmt, vs + c * 16 * CW * kAttnDh);
      else ss_chunk<LW>(dp, dmt, vs + c * 16 * CW * kAttnDh);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(&dp[0][0], 8 * CW);
      uint32_t pf[CW][4];
#pragma unroll
      for (int kc = 0; kc < CW; ++kc) {
        const int k16 = CW * c + kc;
        if (k16 < KT) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * k16 + jj;  // the logit tile
            float* dpj = dp[2 * kc + jj];
            if constexpr (DROP) apply_keep(dpj, krow0, krow1, j, t, a.drop.inv);
            d0 += s[j][0] * dpj[0] + s[j][1] * dpj[1];
            d1 += s[j][2] * dpj[2] + s[j][3] * dpj[3];
          }
          if constexpr (DROP) {
            float lo[4] = {s[2 * k16][0], s[2 * k16][1], s[2 * k16][2], s[2 * k16][3]};
            float hi[4] = {s[2 * k16 + 1][0], s[2 * k16 + 1][1], s[2 * k16 + 1][2], s[2 * k16 + 1][3]};
            apply_keep(lo, krow0, krow1, 2 * k16, t, a.drop.inv);
            apply_keep(hi, krow0, krow1, 2 * k16 + 1, t, a.drop.inv);
            acc_to_a_frag(pf[kc], lo, hi);
          } else {
            acc_to_a_frag(pf[kc], s[2 * k16], s[2 * k16 + 1]);
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < CW; ++kc)
        if (CW * c + kc < KT) wgmma_m64n64k16_rs<1>(mo, pf[kc], desc_mn_major(vs + (CW * c + kc) * 16 * kAttnDh), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kc = 0; kc < CW; ++kc)
        if (CW * c + kc < KT) fence_frag(pf[kc]);
      fence_acc(mo);
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    const int r0 = q0 + wr0, r1 = q0 + wr1;
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) {
      const int col = h * kAttnDh + dj * 8 + 2 * t;
      if (r0 < n) store_pair(a.m + (img_row + r0) * inner + col, mo[dj][0], mo[dj][1]);
      if (r1 < n) store_pair(a.m + (img_row + r1) * inner + col, mo[dj][2], mo[dj][3]);
    }
    if (t == 0) {  // the key pass's statistics; a row past n gets p = 0 there
      if (r0 < NP) st_mx[r0] = r0 < n ? mx0 : 0.f, st_inv[r0] = r0 < n ? inv0 : 0.f, st_d[r0] = r0 < n ? d0 : 0.f;
      if (r1 < NP) st_mx[r1] = r1 < n ? mx1 : 0.f, st_inv[r1] = r1 < n ? inv1 : 0.f, st_d[r1] = r1 < n ? d1 : 0.f;
    }

    // sweep 2: dp again, ds = bf16(p * (dp - D)), dq = ds . k
    uint32_t raw0[8], raw1[8];  // QKNORM: the raw q rows the closing reads, in flight under the sweep
    if constexpr (QKNORM) {
      const bf16* raw = a.qkv + img_row * rstride + h * kAttnDh;
      load_raw_pairs(raw0, raw + (r0 < n ? r0 : n - 1) * rstride, t);
      load_raw_pairs(raw1, raw + (r1 < n ? r1 : n - 1) * rstride, t);
    }
    float dq[8][4];
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) dq[dj][0] = dq[dj][1] = dq[dj][2] = dq[dj][3] = 0.f;
    fence_acc(dq);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float dp[2 * CW][4];
      wgmma_fence();
      if (c + 1 < NC) ss_chunk<CW>(dp, dmt, vs + c * 16 * CW * kAttnDh);
      else ss_chunk<LW>(dp, dmt, vs + c * 16 * CW * kAttnDh);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(&dp[0][0], 8 * CW);
      uint32_t sf[CW][4];
#pragma unroll
      for (int kc = 0; kc < CW; ++kc) {
        const int k16 = CW * c + kc;
        if (k16 < KT) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * k16 + jj;
            float* dpj = dp[2 * kc + jj];
            if constexpr (DROP) apply_keep(dpj, krow0, krow1, j, t, a.drop.inv);
            dpj[0] = s[j][0] * (dpj[0] - d0);
            dpj[1] = s[j][1] * (dpj[1] - d0);
            dpj[2] = s[j][2] * (dpj[2] - d1);
            dpj[3] = s[j][3] * (dpj[3] - d1);
          }
          acc_to_a_frag(sf[kc], dp[2 * kc], dp[2 * kc + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < CW; ++kc)
        if (CW * c + kc < KT) wgmma_m64n64k16_rs<1>(dq, sf[kc], desc_mn_major(ks + (CW * c + kc) * 16 * kAttnDh), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kc = 0; kc < CW; ++kc)
        if (CW * c + kc < KT) fence_frag(sf[kc]);
      fence_acc(dq);
    }
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[dj][e] *= a.scale;
    }
    if constexpr (QKNORM) {
      zero_rows_past(dq, r0 >= n, r1 >= n);
      rms_norm_bwd_rows(dq, raw0, raw1, r0 < n ? rq[r0] : 0.f, r1 < n ? rq[r1] : 0.f, a.gq + h * kAttnDh,
                        colsum + warp * kAttnDh, g, t);
      __syncthreads();
      if (tid < kAttnDh)
        dgamma += ((colsum[tid] + colsum[kAttnDh + tid]) + colsum[2 * kAttnDh + tid]) + colsum[3 * kAttnDh + tid];
      __syncthreads();
    }
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) {
      const int col = h * kAttnDh + dj * 8 + 2 * t;
      if (r0 < n) store_pair(a.dqkv + (img_row + r0) * rstride + col, dq[dj][0], dq[dj][1]);
      if (r1 < n) store_pair(a.dqkv + (img_row + r1) * rstride + col, dq[dj][2], dq[dj][3]);
    }
  }
  if constexpr (QKNORM) {
    if (tid < kAttnDh) a.dg_partial[static_cast<size_t>(img) * 2 * inner + h * kAttnDh + tid] = dgamma;
    dgamma = 0.f;
  }
  __syncthreads();  // the statistics (and the keep words) are in place

  // ---- the key pass: a 64-key tile at a time ----
  // this thread's keys wr0 and wr1 share one 32-key word of the tile
  const int kword = wr0 >> 5, kbit0 = wr0 & 31, kbit1 = kbit0 + 8;
#pragma unroll 1
  for (int k0 = 0; k0 < n; k0 += kAttnQT) {
    const bf16* kt_s = ks + k0 * kAttnDh;
    const bf16* vt_s = vs + k0 * kAttnDh;
    const int r0 = k0 + wr0, r1 = k0 + wr1;
    uint32_t raw0[8], raw1[8];  // QKNORM: the raw k rows the closing reads, in flight under the products
    if constexpr (QKNORM) {
      const bf16* raw = a.qkv + img_row * rstride + inner + h * kAttnDh;
      load_raw_pairs(raw0, raw + (r0 < n ? r0 : n - 1) * rstride, t);
      load_raw_pairs(raw1, raw + (r1 < n ? r1 : n - 1) * rstride, t);
    }
    if constexpr (DROP) {
      __syncthreads();  // every warp is done with the last tile's words
      for (int i = tid; i < 2 * NP; i += kAttnThreads) {  // query i / 2, the tile's word i % 2
        const int w = k0 / 32 + (i & 1);
        keep[i] = w < KW ? __ldcg(keep_g + (i >> 1) * KW + w) : 0u;
      }
      __syncthreads();
    }
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) {
      dk[dj][0] = dk[dj][1] = dk[dj][2] = dk[dj][3] = 0.f;
      dv[dj][0] = dv[dj][1] = dv[dj][2] = dv[dj][3] = 0.f;
    }
    fence_acc(dk);
    fence_acc(dv);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float pt[2 * CW][4], dpt[2 * CW][4];  // keys (rows) x the chunk's queries
      wgmma_fence();
      if (c + 1 < NC) {
        ss_chunk<CW>(pt, kt_s, qs + c * 16 * CW * kAttnDh);
        ss_chunk<CW>(dpt, vt_s, dms + c * 16 * CW * kAttnDh);
      } else {
        ss_chunk<LW>(pt, kt_s, qs + c * 16 * CW * kAttnDh);
        ss_chunk<LW>(dpt, vt_s, dms + c * 16 * CW * kAttnDh);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(&pt[0][0], 8 * CW);
      fence_operands(&dpt[0][0], 8 * CW);
      uint32_t pf[CW][4], sf[CW][4];
#pragma unroll
      for (int kc = 0; kc < CW; ++kc) {
        if (CW * c + kc < KT) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * kc + jj;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = c * 16 * CW + j * 8 + 2 * t + e;
              const float mx = st_mx[q], iv = st_inv[q], dd = st_d[q];
              const float p0 = exp2f(pt[j][e] * a.scale_log2e - mx) * iv;
              const float p1 = exp2f(pt[j][2 + e] * a.scale_log2e - mx) * iv;
              if constexpr (DROP) {  // ds takes the unmasked p; pd = where(keep, p, 0) * inv feeds dv
                const uint32_t kw = keep[2 * q + kword];
                const bool keep0 = (kw >> kbit0) & 1u, keep1 = (kw >> kbit1) & 1u;
                dpt[j][e] = p0 * ((keep0 ? dpt[j][e] * a.drop.inv : 0.f) - dd);
                dpt[j][2 + e] = p1 * ((keep1 ? dpt[j][2 + e] * a.drop.inv : 0.f) - dd);
                pt[j][e] = keep0 ? p0 * a.drop.inv : 0.f;
                pt[j][2 + e] = keep1 ? p1 * a.drop.inv : 0.f;
              } else {
                dpt[j][e] = p0 * (dpt[j][e] - dd);
                dpt[j][2 + e] = p1 * (dpt[j][2 + e] - dd);
                pt[j][e] = p0;
                pt[j][2 + e] = p1;
              }
            }
          }
          acc_to_a_frag(pf[kc], pt[2 * kc], pt[2 * kc + 1]);
          acc_to_a_frag(sf[kc], dpt[2 * kc], dpt[2 * kc + 1]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < CW; ++kc) {
        if (CW * c + kc < KT) {
          wgmma_m64n64k16_rs<1>(dv, pf[kc], desc_mn_major(dms + (CW * c + kc) * 16 * kAttnDh), 1);
          wgmma_m64n64k16_rs<1>(dk, sf[kc], desc_mn_major(qs + (CW * c + kc) * 16 * kAttnDh), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kc = 0; kc < CW; ++kc) {
        if (CW * c + kc < KT) {
          fence_frag(pf[kc]);
          fence_frag(sf[kc]);
        }
      }
      fence_acc(dk);
      fence_acc(dv);
    }
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[dj][e] *= a.scale;
    }
    if constexpr (QKNORM) {
      zero_rows_past(dk, r0 >= n, r1 >= n);
      rms_norm_bwd_rows(dk, raw0, raw1, r0 < n ? rk[r0] : 0.f, r1 < n ? rk[r1] : 0.f, a.gk + h * kAttnDh,
                        colsum + warp * kAttnDh, g, t);
      __syncthreads();
      if (tid < kAttnDh)
        dgamma += ((colsum[tid] + colsum[kAttnDh + tid]) + colsum[2 * kAttnDh + tid]) + colsum[3 * kAttnDh + tid];
      __syncthreads();
    }
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) {
      const int col = h * kAttnDh + dj * 8 + 2 * t;
      if (r0 < n) {
        store_pair(a.dqkv + (img_row + r0) * rstride + inner + col, dk[dj][0], dk[dj][1]);
        store_pair(a.dqkv + (img_row + r0) * rstride + 2 * inner + col, dv[dj][0], dv[dj][1]);
      }
      if (r1 < n) {
        store_pair(a.dqkv + (img_row + r1) * rstride + inner + col, dk[dj][2], dk[dj][3]);
        store_pair(a.dqkv + (img_row + r1) * rstride + 2 * inner + col, dv[dj][2], dv[dj][3]);
      }
    }
  }
  if constexpr (QKNORM) {
    if (tid < kAttnDh) a.dg_partial[static_cast<size_t>(img) * 2 * inner + inner + h * kAttnDh + tid] = dgamma;
  }
}

template <bool DROP, bool QKNORM>
cudaError_t launch_attention_bwd(int kt, const AttnBwdArgs& args, const AttnBwdMaps& maps, unsigned blocks,
                                 cudaStream_t stream) {
  void (*kernel)(AttnBwdArgs, AttnBwdMaps) = nullptr;
  int smem = 0;
  switch (kt) {
#define VIT_ATTN_BWD_CASE(KT)                              \
  case KT:                                                 \
    kernel = attention_bwd_kernel<KT, DROP, QKNORM>;       \
    smem = attn_bwd_smem(KT, DROP, QKNORM);                \
    break;
    VIT_ATTN_KEY_CHUNKS(VIT_ATTN_BWD_CASE)
#undef VIT_ATTN_BWD_CASE
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // two blocks an SM at KT = 13
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kAttnThreads, smem, stream>>>(args, maps);
  return cudaGetLastError();
}

}  // namespace
