// Hopper (sm_90a) kernels for the attention-block backward of one pre-norm
// ViT layer.
//
// They replace the TPU kernel vit_pytorch_tpu/ops/fused_block.py::_bwd_kernel
// (:524, called at :786 by _pallas_backward); its dropout replay is the DROP
// variant of attention_bwd_rows and, for gm, dropout.cu; its qk-norm (the
// norm's recompute and backward, the dgamma_q/dgamma_k accumulators) the
// QKNORM variant.
// That kernel runs one image per sequential grid step with both weight
// matrices resident in VMEM: it recomputes LN1 and qkv, forms dm = dy.Wout^T,
// runs the per-head attention backward with the logits in VMEM, forms
// dh = dqkv.Wqkv^T and the LayerNorm backward, and carries dgamma/dbeta
// across the grid.  Here the same function is a chain of launches (see
// ops/fused_block.py::_attention_block_bwd): the recompute and the two
// products with a weight run the forward's kernels (layernorm_rows,
// gemm_bf16, and gemm_bf16's f32 epilogue for dh: fused_layer.cu,
// gemm_bf16.cu, attention_rows.cu), and this
// file holds the two kernels that have no forward counterpart:
//
//   attention_bwd_rows   qkv, dm -> m, dqkv     (logits on chip)
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
// attention_bwd_rows
//
// Replaces: the per-head loop of _bwd_kernel (fused_block.py:608-692):
//   p  = _softmax_from_dots(q k^T, scale)   (f32; padded keys masked)
//   m  = bf16(bf16(p) . v)
//   dv = bf16(p)^T . dm_h
//   dp = dm_h . v^T                          (f32)
//   ds = bf16(p * (dp - rowsum(dp * p)))     (the f32 p, not bf16(p))
//   dq = ds . k * scale,  dk = ds^T . q * scale   (scale on the f32 product)
// Bound on this card: as the forward attention_rows, the (n, n) logits: per
// (image, head) at n = 197 the products are ~10*n*n*dh flops against
// ~7*n*dh*2 bytes of q, k, v, dm, m, dqkv, ~140 flops per byte, under the
// ridge, and the f32 p, dp and ds would be 48x the bytes of q if they went
// to device memory.  So they never leave the SM.  The second limit is
// registers: a warp that owns 16 query rows holds their full f32 p rows
// (104 floats a thread), and dk, dv need a sum over every query row, which
// rows owned by different warps and blocks cannot give without a
// cross-block reduction.
// Design: two passes, as the JAX flash backward splits dq from dk/dv
// (flash_attention.py:298, 376), each a grid of (64-row tile, head, image)
// blocks of 4 warps x 16 rows:
//  - row pass (one block per 64 queries): the forward's exact softmax with
//    the p rows in registers; m = bf16(p).v; D = rowsum(dp * p) with dp
//    recomputed per 8-key tile from the dm rows (dp is never held whole,
//    so p and dp do not double the registers); then dp once more, tile by
//    tile, into ds and dq = ds.k, with the accumulator layout of ds reused
//    as the A operand of the next product.  It stores each row's max,
//    1/sum and D (16 bytes a row) in a scratch buffer.
//  - key pass (one block per 64 keys): the same p, transposed: each warp
//    computes p^T = exp2(k q^T * scale*log2e - max_q) / sum_q for its 16
//    keys, 16 queries at a time, from the row pass's statistics, and
//    dp^T = v dm^T; dv += bf16(p^T).dm and dk += ds^T.q accumulate in
//    registers over all queries, so each key row's sums stay in one warp
//    and the result does not depend on block order.
// q/k and dm are products of mma.sync m16n8k16 (bf16, f32 accumulators),
// which take the transposes this needs from row- or column-strided
// shared-memory reads (load_b_frag_rows/cols); wgmma's 64-row tiles would
// not fit the per-warp row ownership.  Limits: dh = 64; n <= 208 (keys
// padded to 13 chunks of 16), the forward's instantiation.
// ---------------------------------------------------------------------------

constexpr int kBwdRowSmem = (2 * kAttnQT + 2 * 16 * kAttnKT) * kAttnLd * static_cast<int>(sizeof(bf16));
constexpr int kBwdKeySmem = kBwdRowSmem + 16 * kAttnKT * static_cast<int>(sizeof(float4));
// with dropout, + the block's keep tile: the row pass's 64 query rows x 7
// key words; the key pass's 208 query rows x 2 words of its 64 keys
constexpr int kBwdRowDropSmem = kBwdRowSmem + kAttnQT * kKeepWords * static_cast<int>(sizeof(uint32_t));
constexpr int kBwdKeyKeepWords = kAttnQT / 32;
constexpr int kBwdKeyDropSmem = kBwdKeySmem + 16 * kAttnKT * kBwdKeyKeepWords * static_cast<int>(sizeof(uint32_t));
// with qk-norm, after those: the block's 64 rows of raw q (row pass) or raw
// k (key pass), their rsqrt, and the 4 warps' dgamma column sums
constexpr int kBwdQkNormSmem = kAttnQT * kAttnLd * static_cast<int>(sizeof(bf16)) +
                               (kAttnQT + 4 * kAttnDh) * static_cast<int>(sizeof(float));

// QKNORM: the qk-norm of _bwd_kernel (:614-627, 665-688).  Each pass
// normalises the q and k rows it loaded, in shared memory, as the forward
// does (rms_norm_rows), keeping a raw copy and the rsqrt of the rows it owns
// (the row pass its 64 queries, the key pass its 64 keys).  The logits, dq
// and dk then take the normed rows, as in the JAX kernel; the f32 dq (dk) of
// a full row, times scale, is the cotangent of the normed row, and
// rms_norm_bwd_rows closes the norm on it: the row's dgamma terms d * xhat
// and d <- r (d g8 - xhat <d g8, xhat>).  On the TPU dgamma_q/dgamma_k
// accumulate across the sequential grid; here each block adds its rows'
// terms per column, in a fixed order, into its row of a (blocks, 2, inner)
// f32 scratch buffer (q in the first half, k in the second), and
// layernorm_bwd_sum_kernel adds the blocks in a fixed order and applies the
// sqrt(64) factor: the result does not depend on block scheduling.  Bound:
// the norm adds a few passes over 64-element rows of shared memory and a
// 2 * inner * 4-byte partial per block, next to the attention's 12 n dh
// flops a row.
__device__ __forceinline__ void qknorm_smem(unsigned char* base, bf16*& raw, float*& r, float*& colsum) {
  raw = reinterpret_cast<bf16*>(base);
  r = reinterpret_cast<float*>(raw + kAttnQT * kAttnLd);
  colsum = r + kAttnQT;
}

// DROP: the dropout replay of _bwd_kernel (:634-656).  The keep mask of the
// forward's (seed, img, head) stream is drawn again, into shared memory as
// the forward draws it; pd = where(keep, p, 0) * inv feeds m and dv as
// bf16(pd), dp is masked and scaled the same way, and
// ds = p * (dp - rowsum(dp * p)) takes the unmasked f32 p.  The row pass's D
// is that rowsum.
template <bool DROP, bool QKNORM>
__global__ void __launch_bounds__(kAttnThreads)
attention_bwd_row_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dm, bf16* __restrict__ m_out,
                         bf16* __restrict__ dqkv, float4* __restrict__ stats, int n, int heads, float scale_log2e,
                         float scale, DropoutArgs drop, const bf16* __restrict__ gq, const bf16* __restrict__ gk,
                         float* __restrict__ dg_partial) {
  constexpr int KT = kAttnKT;
  constexpr int NP = 16 * KT;  // keys, padded
  constexpr int NT = 2 * KT;   // 8-key logit tiles
  constexpr int DK = kAttnDh / 16;
  constexpr int DT = kAttnDh / 8;
  extern __shared__ __align__(16) unsigned char bwd_row_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(bwd_row_smem);  // [QT][ld]
  bf16* Ds = Qs + kAttnQT * kAttnLd;                  // [QT][ld] dm rows
  bf16* Ks = Ds + kAttnQT * kAttnLd;                  // [NP][ld]
  bf16* Vs = Ks + NP * kAttnLd;                       // [NP][ld]
  uint32_t* Keep = reinterpret_cast<uint32_t*>(Vs + NP * kAttnLd);  // [QT][kKeepWords], DROP only

  const int q0 = blockIdx.x * kAttnQT, h = blockIdx.y, img = blockIdx.z;
  const int inner = heads * kAttnDh;
  const size_t rstride = 3 * static_cast<size_t>(inner);
  const bf16* base = qkv + static_cast<size_t>(img) * n * rstride + h * kAttnDh;
  load_head_rows<kAttnQT>(Qs, base, rstride, q0, n);
  load_head_rows<kAttnQT>(Ds, dm + static_cast<size_t>(img) * n * inner + h * kAttnDh, inner, q0, n);
  load_head_rows<NP>(Ks, base + inner, rstride, 0, n);
  load_head_rows<NP>(Vs, base + 2 * inner, rstride, 0, n);
  if constexpr (DROP) fill_keep_tile<kAttnQT, kKeepWords>(Keep, drop, dropout_stream(img, h), q0, 0, n, n);
  __syncthreads();
  bf16* Raw = nullptr;  // QKNORM: the block's raw q rows, their rsqrt, dgamma_q column sums
  float *Rr = nullptr, *Col = nullptr;
  if constexpr (QKNORM) {
    qknorm_smem(bwd_row_smem + (DROP ? kBwdRowDropSmem : kBwdRowSmem), Raw, Rr, Col);
    rms_norm_rows<kAttnQT>(Qs, gq + h * kAttnDh, Raw, Rr);
    rms_norm_rows<NP>(Ks, gk + h * kAttnDh, nullptr, nullptr);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;
  const uint32_t* krow0 = Keep + (wrow + g) * kKeepWords;  // keep rows g, g + 8 (DROP)
  const uint32_t* krow1 = krow0 + 8 * kKeepWords;

  float s[NT][4];  // logits, then p in f32
  qk_logits(s, Qs + wrow * kAttnLd, Ks, g, t);
  float mx0, mx1, inv0, inv1;
  softmax_rows(s, n, t, scale_log2e, mx0, mx1, inv0, inv1);

  const int row0 = q0 + wrow + g, row1 = row0 + 8;
  const size_t orow0 = static_cast<size_t>(img) * n + row0, orow1 = orow0 + 8;

  // m = bf16(pd) . v, pd = p or, with dropout, where(keep, p, 0) * inv
  {
    float o[DT][4];
#pragma unroll
    for (int dj = 0; dj < DT; ++dj) o[dj][0] = o[dj][1] = o[dj][2] = o[dj][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KT; ++kc) {
      uint32_t a[4];
      if constexpr (DROP) {
        float lo[4] = {s[2 * kc][0], s[2 * kc][1], s[2 * kc][2], s[2 * kc][3]};
        float hi[4] = {s[2 * kc + 1][0], s[2 * kc + 1][1], s[2 * kc + 1][2], s[2 * kc + 1][3]};
        apply_keep(lo, krow0, krow1, 2 * kc, t, drop.inv);
        apply_keep(hi, krow0, krow1, 2 * kc + 1, t, drop.inv);
        acc_to_a_frag(a, lo, hi);
      } else {
        acc_to_a_frag(a, s[2 * kc], s[2 * kc + 1]);
      }
#pragma unroll
      for (int dj = 0; dj < DT; ++dj) {
        uint32_t b[2];
        load_b_frag_cols(b, Vs + kc * 16 * kAttnLd + dj * 8, kAttnLd, g, t);
        mma_16816(o[dj], a, b);
      }
    }
#pragma unroll
    for (int dj = 0; dj < DT; ++dj) {
      const int col = h * kAttnDh + dj * 8 + 2 * t;
      if (row0 < n) *reinterpret_cast<uint32_t*>(m_out + orow0 * inner + col) = pack_floats(o[dj][0], o[dj][1]);
      if (row1 < n) *reinterpret_cast<uint32_t*>(m_out + orow1 * inner + col) = pack_floats(o[dj][2], o[dj][3]);
    }
  }

  uint32_t df[DK][4];  // dm rows as A fragments
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) load_a_frag(df[kk], Ds + wrow * kAttnLd + kk * 16, kAttnLd, g, t);

  // dp tile j (rows g, g+8 x keys 8j + 2t, +1) = dm . v^T, with dropout
  // where(keep, dp, 0) * inv
  auto dp_tile = [&](float dp[4], int j) {
    dp[0] = dp[1] = dp[2] = dp[3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t b[2];
      load_b_frag_rows(b, Vs + j * 8 * kAttnLd + kk * 16, kAttnLd, g, t);
      mma_16816(dp, df[kk], b);
    }
    if constexpr (DROP) apply_keep(dp, krow0, krow1, j, t, drop.inv);
  };

  // D = rowsum(dp * p)
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float dp[4];
    dp_tile(dp, j);
    d0 += s[j][0] * dp[0] + s[j][1] * dp[1];
    d1 += s[j][2] * dp[2] + s[j][3] * dp[3];
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);

  // ds = bf16(p * (dp - D)), dq = ds . k
  float dq[DT][4];
#pragma unroll
  for (int dj = 0; dj < DT; ++dj) dq[dj][0] = dq[dj][1] = dq[dj][2] = dq[dj][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    float ds[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * kc + jj;
      dp_tile(ds[jj], j);
      ds[jj][0] = s[j][0] * (ds[jj][0] - d0);
      ds[jj][1] = s[j][1] * (ds[jj][1] - d0);
      ds[jj][2] = s[j][2] * (ds[jj][2] - d1);
      ds[jj][3] = s[j][3] * (ds[jj][3] - d1);
    }
    uint32_t a[4];
    acc_to_a_frag(a, ds[0], ds[1]);
#pragma unroll
    for (int dj = 0; dj < DT; ++dj) {
      uint32_t b[2];
      load_b_frag_cols(b, Ks + kc * 16 * kAttnLd + dj * 8, kAttnLd, g, t);
      mma_16816(dq[dj], a, b);
    }
  }
#pragma unroll
  for (int dj = 0; dj < DT; ++dj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dj][e] *= scale;
  }
  if constexpr (QKNORM) rms_norm_bwd_rows(dq, Raw + wrow * kAttnLd, Rr + wrow, gq + h * kAttnDh, Col + warp * kAttnDh, g, t);
#pragma unroll
  for (int dj = 0; dj < DT; ++dj) {
    const int col = h * kAttnDh + dj * 8 + 2 * t;
    if (row0 < n) *reinterpret_cast<uint32_t*>(dqkv + orow0 * rstride + col) = pack_floats(dq[dj][0], dq[dj][1]);
    if (row1 < n) *reinterpret_cast<uint32_t*>(dqkv + orow1 * rstride + col) = pack_floats(dq[dj][2], dq[dj][3]);
  }
  if (t == 0) {
    float4* st = stats + (static_cast<size_t>(img) * heads + h) * n;
    if (row0 < n) st[row0] = make_float4(mx0, inv0, d0, 0.f);
    if (row1 < n) st[row1] = make_float4(mx1, inv1, d1, 0.f);
  }
  if constexpr (QKNORM) {
    __syncthreads();
    store_colsum(dg_partial + (static_cast<size_t>(img) * gridDim.x + blockIdx.x) * 2 * inner + h * kAttnDh, Col);
  }
}

template <bool DROP, bool QKNORM>
__global__ void __launch_bounds__(kAttnThreads)
attention_bwd_key_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dm, bf16* __restrict__ dqkv,
                         const float4* __restrict__ stats, int n, int heads, float scale_log2e, float scale,
                         DropoutArgs drop, const bf16* __restrict__ gq, const bf16* __restrict__ gk,
                         float* __restrict__ dg_partial) {
  constexpr int KT = kAttnKT;
  constexpr int NP = 16 * KT;  // queries, padded
  constexpr int DK = kAttnDh / 16;
  constexpr int DT = kAttnDh / 8;
  extern __shared__ __align__(16) unsigned char bwd_key_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_key_smem);  // [QT][ld] this block's keys
  bf16* Vs = Ks + kAttnQT * kAttnLd;                  // [QT][ld]
  bf16* Qs = Vs + kAttnQT * kAttnLd;                  // [NP][ld] every query
  bf16* Ds = Qs + NP * kAttnLd;                       // [NP][ld] every dm row
  float4* St = reinterpret_cast<float4*>(Ds + NP * kAttnLd);  // [NP] max, 1/sum, D
  uint32_t* Keep = reinterpret_cast<uint32_t*>(St + NP);      // [NP][2]: query rows x this block's keys, DROP only

  const int k0 = blockIdx.x * kAttnQT, h = blockIdx.y, img = blockIdx.z;
  const int inner = heads * kAttnDh;
  const size_t rstride = 3 * static_cast<size_t>(inner);
  const bf16* base = qkv + static_cast<size_t>(img) * n * rstride + h * kAttnDh;
  load_head_rows<kAttnQT>(Ks, base + inner, rstride, k0, n);
  load_head_rows<kAttnQT>(Vs, base + 2 * inner, rstride, k0, n);
  load_head_rows<NP>(Qs, base, rstride, 0, n);
  load_head_rows<NP>(Ds, dm + static_cast<size_t>(img) * n * inner + h * kAttnDh, inner, 0, n);
  const float4* st = stats + (static_cast<size_t>(img) * heads + h) * n;
  for (int r = threadIdx.x; r < NP; r += kAttnThreads) St[r] = r < n ? st[r] : make_float4(0.f, 0.f, 0.f, 0.f);
  // the same (query row, key column) bits as the forward and the row pass,
  // walked by key: rows are every query, columns this block's 64 keys
  if constexpr (DROP) fill_keep_tile<NP, kBwdKeyKeepWords>(Keep, drop, dropout_stream(img, h), 0, k0, n, n);
  __syncthreads();
  bf16* Raw = nullptr;  // QKNORM: the block's raw k rows, their rsqrt, dgamma_k column sums
  float *Rr = nullptr, *Col = nullptr;
  if constexpr (QKNORM) {
    qknorm_smem(bwd_key_smem + (DROP ? kBwdKeyDropSmem : kBwdKeySmem), Raw, Rr, Col);
    rms_norm_rows<kAttnQT>(Ks, gk + h * kAttnDh, Raw, Rr);
    rms_norm_rows<NP>(Qs, gq + h * kAttnDh, nullptr, nullptr);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;
  // this thread's keys wrow + g and wrow + g + 8 share one 32-key word
  const int kword = wrow >> 5, kbit0 = (wrow + g) & 31, kbit1 = kbit0 + 8;
  uint32_t kf[DK][4], vf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
    load_a_frag(kf[kk], Ks + wrow * kAttnLd + kk * 16, kAttnLd, g, t);
    load_a_frag(vf[kk], Vs + wrow * kAttnLd + kk * 16, kAttnLd, g, t);
  }

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dj = 0; dj < DT; ++dj) {
    dk[dj][0] = dk[dj][1] = dk[dj][2] = dk[dj][3] = 0.f;
    dv[dj][0] = dv[dj][1] = dv[dj][2] = dv[dj][3] = 0.f;
  }

#pragma unroll 1
  for (int qc = 0; qc < KT; ++qc) {
    // p^T and dp^T for keys (g, g+8) x queries 16qc + 8jj + 2t + e
    float pt[2][4], dpt[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const bf16* qrows = Qs + (16 * qc + 8 * jj) * kAttnLd;
      const bf16* drows = Ds + (16 * qc + 8 * jj) * kAttnLd;
      pt[jj][0] = pt[jj][1] = pt[jj][2] = pt[jj][3] = 0.f;
      dpt[jj][0] = dpt[jj][1] = dpt[jj][2] = dpt[jj][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t b[2];
        load_b_frag_rows(b, qrows + kk * 16, kAttnLd, g, t);
        mma_16816(pt[jj], kf[kk], b);
        load_b_frag_rows(b, drows + kk * 16, kAttnLd, g, t);
        mma_16816(dpt[jj], vf[kk], b);
      }
    }
    float dst[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 16 * qc + 8 * jj + 2 * t + e;
        const float4 sq = St[q];  // padded queries: inv = 0, so p = 0
        pt[jj][e] = exp2f(pt[jj][e] * scale_log2e - sq.x) * sq.y;
        pt[jj][2 + e] = exp2f(pt[jj][2 + e] * scale_log2e - sq.x) * sq.y;
        if constexpr (DROP) {
          // ds takes the unmasked p; pd = where(keep, p, 0) * inv feeds dv
          const uint32_t kw = Keep[q * kBwdKeyKeepWords + kword];
          const bool keep0 = (kw >> kbit0) & 1u, keep1 = (kw >> kbit1) & 1u;
          dst[jj][e] = pt[jj][e] * ((keep0 ? dpt[jj][e] * drop.inv : 0.f) - sq.z);
          dst[jj][2 + e] = pt[jj][2 + e] * ((keep1 ? dpt[jj][2 + e] * drop.inv : 0.f) - sq.z);
          pt[jj][e] = keep0 ? pt[jj][e] * drop.inv : 0.f;
          pt[jj][2 + e] = keep1 ? pt[jj][2 + e] * drop.inv : 0.f;
        } else {
          dst[jj][e] = pt[jj][e] * (dpt[jj][e] - sq.z);
          dst[jj][2 + e] = pt[jj][2 + e] * (dpt[jj][2 + e] - sq.z);
        }
      }
    }
    uint32_t ap[4], as[4];
    acc_to_a_frag(ap, pt[0], pt[1]);
    acc_to_a_frag(as, dst[0], dst[1]);
#pragma unroll
    for (int dj = 0; dj < DT; ++dj) {
      uint32_t b[2];
      load_b_frag_cols(b, Ds + 16 * qc * kAttnLd + dj * 8, kAttnLd, g, t);
      mma_16816(dv[dj], ap, b);
      load_b_frag_cols(b, Qs + 16 * qc * kAttnLd + dj * 8, kAttnLd, g, t);
      mma_16816(dk[dj], as, b);
    }
  }

#pragma unroll
  for (int dj = 0; dj < DT; ++dj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dj][e] *= scale;
  }
  if constexpr (QKNORM) rms_norm_bwd_rows(dk, Raw + wrow * kAttnLd, Rr + wrow, gk + h * kAttnDh, Col + warp * kAttnDh, g, t);
  const int key0 = k0 + wrow + g, key1 = key0 + 8;
  bf16* out0 = dqkv + (static_cast<size_t>(img) * n + key0) * rstride + h * kAttnDh + 2 * t;
  bf16* out1 = out0 + 8 * rstride;
#pragma unroll
  for (int dj = 0; dj < DT; ++dj) {
    if (key0 < n) {
      *reinterpret_cast<uint32_t*>(out0 + inner + dj * 8) = pack_floats(dk[dj][0], dk[dj][1]);
      *reinterpret_cast<uint32_t*>(out0 + 2 * inner + dj * 8) = pack_floats(dv[dj][0], dv[dj][1]);
    }
    if (key1 < n) {
      *reinterpret_cast<uint32_t*>(out1 + inner + dj * 8) = pack_floats(dk[dj][2], dk[dj][3]);
      *reinterpret_cast<uint32_t*>(out1 + 2 * inner + dj * 8) = pack_floats(dv[dj][2], dv[dj][3]);
    }
  }
  if constexpr (QKNORM) {
    __syncthreads();
    store_colsum(dg_partial + (static_cast<size_t>(img) * gridDim.x + blockIdx.x) * 2 * inner + inner + h * kAttnDh,
                 Col);
  }
}

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
// and writes dx, 14 bytes an element against a few tens of flops.
// Design: one warp per row, 16-byte loads; the rows are read once for the
// statistics and again from L1.  On the TPU the sequential grid carries
// dgamma/dbeta from step to step; here blocks run in no order, so the sums
// are two-pass and deterministic, without atomics: each lane owns fixed
// columns and adds its rows' terms into its warp's slice of shared memory
// (8 warps x 2 x dim f32), a block sums its warps in order into one row of
// a (blocks, 2, dim) scratch buffer, and a second grid sums those rows in a
// fixed order.  The grid has min(ceil(rows / 64), 528) blocks (4 per SM),
// a function of the shape alone, so the result does not change from run to
// run.  Limits: dim % 8 == 0 and dim <= 3584 (the slices' shared memory).
// ---------------------------------------------------------------------------

constexpr int kLnBwdWarps = 8;
constexpr int kLnBwdThreads = 32 * kLnBwdWarps;
constexpr int kLnBwdMaxBlocks = 528;
constexpr int kLnBwdMaxDim = 3584;  // 64 * dim bytes of slices <= 232,448
constexpr int kLnBwdResMaxDim = 2416;  // [res_f32]: 96 * dim bytes of slices <= 232,448
constexpr int kLnSumCols = 32, kLnSumSlices = 8;  // the partials' sum: 32 columns x 8 row slices a block

int layernorm_bwd_blocks(int rows) {
  const int want = (rows + 8 * kLnBwdWarps - 1) / (8 * kLnBwdWarps);
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

// RES_F32: the [res_f32] variant.
// Replaces: the LayerNorm backward with its residual of _ff_bwd_kernel,
// dy = (dy_ln + g).astype(io) (fused_block.py:1588-1596), and of
// _layer_bwd_kernel, dy = ln_bwd(dyln) + g kept in f32 (:1261) and dx =
// ln_bwd(dh) + dy (:1342): the residual (bf16 g, or the f32 dy) is added to
// the f32 dx_ln before one cast, or none (res_f32 and dx_f32 say which).
// It also sums the f32 residual per column into a third slice: db2 = sum of
// g (:1559) and db_out = sum of dy (:1274).
// Bound on this card: memory, as the plain variant: x, dh and the residual
// in, dx out.
// Design: the plain variant's, with three slices (dgamma, dbeta, the
// residual's sum) a warp, so dim <= 2416.
template <bool RES_F32>
__global__ void __launch_bounds__(kLnBwdThreads)
layernorm_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ dh, const bf16* __restrict__ w,
                          const void* __restrict__ res, int res_f32, void* __restrict__ dx, int dx_f32,
                          float* __restrict__ partial, int rows, int dim, float eps) {
  constexpr int kSlices = RES_F32 ? 3 : 2;
  extern __shared__ float ln_bwd_smem[];  // [warps][kSlices][dim]: dgamma, dbeta (, the residual's sum)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc = ln_bwd_smem + warp * kSlices * dim;
  const int nvec = dim / 8;
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
      float out[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xh = (xv[i] - mu) * rstd;
        out[i] = rstd * (dv[i] * wv[i] - m1 - xh * m2);
        acc[8 * v + i] += dv[i] * xh;
        acc[dim + 8 * v + i] += dv[i];
      }
      const size_t off = static_cast<size_t>(row) * dim + 8 * v;
      if constexpr (RES_F32) {
        float rv[8];
        if (res_f32) {
          load8_f32(rv, static_cast<const float*>(res) + off);
        } else {
          load8_bf16(rv, static_cast<const bf16*>(res) + off);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          out[i] += rv[i];  // in f32, before the one cast
          acc[2 * dim + 8 * v + i] += rv[i];
        }
        if (dx_f32) {
          float4* o4 = reinterpret_cast<float4*>(static_cast<float*>(dx) + off);
          o4[0] = make_float4(out[0], out[1], out[2], out[3]);
          o4[1] = make_float4(out[4], out[5], out[6], out[7]);
          continue;
        }
      }
      uint4 o;
      uint32_t* po = reinterpret_cast<uint32_t*>(&o);
      if (!RES_F32 && res) {
        float rv[8];
        load8_bf16(rv, static_cast<const bf16*>(res) + off);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 r = __floats2bfloat162_rn(out[2 * i], out[2 * i + 1]);  // dx_ln in bf16
          const float2 f = __bfloat1622float2(r);
          po[i] = pack_floats(f.x + rv[2 * i], f.y + rv[2 * i + 1]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) po[i] = pack_floats(out[2 * i], out[2 * i + 1]);
      }
      *reinterpret_cast<uint4*>(static_cast<bf16*>(dx) + off) = o;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kSlices * dim; c += kLnBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kLnBwdWarps; ++wi) s += ln_bwd_smem[wi * kSlices * dim + c];
    partial[static_cast<size_t>(blockIdx.x) * kSlices * dim + c] = s;
  }
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
// C interface (ctypes).  Pointers are device pointers of contiguous tensors,
// 16-byte aligned; the wrappers in ops/fused_block.py check shapes and dtypes
// and allocate the outputs and the scratch buffers.
// ---------------------------------------------------------------------------

extern "C" {

// qkv (b, n, 3*inner) and dm (b, n, inner) bf16 -> m (b, n, inner) and
// dqkv (b, n, 3*inner) bf16; stats (b, heads, n) float4 scratch; drop = 0:
// no dropout (seed, threshold, inv unread).  qk-norm: gq, gk the gammas,
// (inner) bf16 each, dg_partial a (b * ceil(n / 64), 2, inner) f32 scratch
// buffer and dg (2, inner) f32 = dgamma_q, dgamma_k; all four null without
int vit_attention_bwd_rows(const void* qkv, const void* dm, void* m, void* dqkv, void* stats, int batch, int n,
                           int heads, int dim_head, float scale_log2e, float scale, int drop, unsigned seed,
                           unsigned threshold, float inv, const void* gq, const void* gk, void* dg_partial, void* dg,
                           void* stream) {
  const bool qk = gq != nullptr;
  if (dim_head != kAttnDh || n <= 0 || n > 16 * kAttnKT || batch <= 0 || batch > 65535 || heads <= 0 ||
      qk != (gk != nullptr) || qk != (dg_partial != nullptr) || qk != (dg != nullptr))
    return cudaErrorInvalidValue;
  const auto row_kernel = drop ? (qk ? attention_bwd_row_kernel<true, true> : attention_bwd_row_kernel<true, false>)
                               : (qk ? attention_bwd_row_kernel<false, true> : attention_bwd_row_kernel<false, false>);
  const auto key_kernel = drop ? (qk ? attention_bwd_key_kernel<true, true> : attention_bwd_key_kernel<true, false>)
                               : (qk ? attention_bwd_key_kernel<false, true> : attention_bwd_key_kernel<false, false>);
  const int extra = qk ? kBwdQkNormSmem : 0;
  const int row_smem = (drop ? kBwdRowDropSmem : kBwdRowSmem) + extra;
  const int key_smem = (drop ? kBwdKeyDropSmem : kBwdKeySmem) + extra;
  cudaError_t err = cudaFuncSetAttribute(row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, row_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(key_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, key_smem);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kAttnQT - 1) / kAttnQT, heads, batch);
  const bf16 *pq = static_cast<const bf16*>(qkv), *pd = static_cast<const bf16*>(dm);
  const DropoutArgs d{seed, threshold, inv};
  const bf16 *g_q = static_cast<const bf16*>(gq), *g_k = static_cast<const bf16*>(gk);
  float* part = static_cast<float*>(dg_partial);
  row_kernel<<<grid, kAttnThreads, row_smem, s>>>(pq, pd, static_cast<bf16*>(m), static_cast<bf16*>(dqkv),
                                                  static_cast<float4*>(stats), n, heads, scale_log2e, scale, d, g_q,
                                                  g_k, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  key_kernel<<<grid, kAttnThreads, key_smem, s>>>(pq, pd, static_cast<bf16*>(dqkv),
                                                  static_cast<const float4*>(stats), n, heads, scale_log2e, scale, d,
                                                  g_q, g_k, part);
  if (!qk) return cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = 2 * heads * kAttnDh;
  layernorm_bwd_sum_kernel<<<(width + kLnSumCols - 1) / kLnSumCols, kLnSumCols * kLnSumSlices, 0, s>>>(
      part, static_cast<float*>(dg), batch * static_cast<int>(grid.x), width, kRmsRoot);
  return cudaGetLastError();
}

// rows of the (blocks, 2, dim) f32 scratch buffer vit_layernorm_bwd_rows takes
int vit_layernorm_bwd_blocks(int rows) { return rows > 0 ? layernorm_bwd_blocks(rows) : 0; }

// x (rows, dim) bf16, dh (rows, dim) f32, w (dim) bf16, res (rows, dim) bf16
// or null -> dx (rows, dim) bf16, sums (2, dim) f32 = dgamma, dbeta
int vit_layernorm_bwd_rows(const void* x, const void* dh, const void* w, const void* res, void* dx, void* partial,
                           void* sums, int rows, int dim, float eps, void* stream) {
  if (rows <= 0 || dim <= 0 || dim % 8 || dim > kLnBwdMaxDim) return cudaErrorInvalidValue;
  const int smem = kLnBwdWarps * 2 * dim * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(layernorm_bwd_rows_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = layernorm_bwd_blocks(rows);
  layernorm_bwd_rows_kernel<false><<<blocks, kLnBwdThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dh), static_cast<const bf16*>(w), res, 0, dx, 0,
      static_cast<float*>(partial), rows, dim, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_column_sum(static_cast<const float*>(partial), static_cast<float*>(sums), blocks, 2 * dim, 1.f, s);
}

// The [res_f32] variant: res (rows, dim) bf16 (res_f32 = 0) or f32 (1), dx
// (rows, dim) bf16 (dx_f32 = 0) or f32 (1), partial (blocks, 3, dim) f32
// scratch -> sums (3, dim) f32 = dgamma, dbeta, the residual's column sum
int vit_layernorm_bwd_rows_res(const void* x, const void* dh, const void* w, const void* res, int res_f32, void* dx,
                               int dx_f32, void* partial, void* sums, int rows, int dim, float eps, void* stream) {
  if (rows <= 0 || dim <= 0 || dim % 8 || dim > kLnBwdResMaxDim || !res) return cudaErrorInvalidValue;
  const int smem = kLnBwdWarps * 3 * dim * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(layernorm_bwd_rows_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = layernorm_bwd_blocks(rows);
  layernorm_bwd_rows_kernel<true><<<blocks, kLnBwdThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dh), static_cast<const bf16*>(w), res, res_f32, dx,
      dx_f32, static_cast<float*>(partial), rows, dim, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_column_sum(static_cast<const float*>(partial), static_cast<float*>(sums), blocks, 3 * dim, 1.f, s);
}

}  // extern "C"
