// attention_bwd_rows (attention_bwd_rows.cuh has the kernel, what it
// replaces, its bound and its design): the C entry point, and the plain
// instantiations, one per key-chunk count.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a), bound
// with ctypes: vit_attention_bwd_rows returns the launches' cudaError_t.

#include "attention_bwd_rows.cuh"
#include "attention_wide.cuh"

cudaError_t attention_bwd_launch_plain(int kt, const AttnBwdArgs& args, const AttnBwdMaps& maps, unsigned blocks,
                                       cudaStream_t stream) {
  return launch_attention_bwd<false, false>(kt, args, maps, blocks, stream);
}

// ---------------------------------------------------------------------------
// C interface (ctypes).  Pointers are device pointers of contiguous tensors,
// 16-byte aligned; the wrapper in ops/fused_block.py checks shapes and dtypes
// and allocates the outputs and the scratch buffers.
// ---------------------------------------------------------------------------

extern "C" {

// qkv (b, n, 3*inner) and dm (b, n, inner) bf16 -> m (b, n, inner) and
// dqkv (b, n, 3*inner) bf16.  drop = 0: no dropout (seed, threshold, inv and
// keep unread); else keep a (b, heads, 16 ceil(n / 16), ceil(n / 32)) uint32
// scratch buffer.  qk-norm: gq, gk the gammas, (inner) bf16 each, dg_partial
// a (b, 2, inner) f32 scratch buffer and dg (2, inner) f32 = dgamma_q,
// dgamma_k; all four null without.  Past dh 64 or 208 keys the wide kernels
// run (attention_wide.cuh): keep is unread, stats a (b, heads, 3, 64 ceil(n /
// 64)) f32 scratch buffer, dg_partial (b ceil(n / 64), 2, inner); stats is
// unread on the narrow path.
int vit_attention_bwd_rows(const void* qkv, const void* dm, void* m, void* dqkv, void* keep, void* stats, int batch,
                           int n, int heads, int dim_head, float scale_log2e, float scale, int drop, unsigned seed,
                           unsigned threshold, float inv, const void* gq, const void* gk, void* dg_partial, void* dg,
                           void* stream) {
  const bool qk = gq != nullptr;
  if (dim_head != kAttnDh || n > 16 * kAttnKT)  // past ViT-B's head shape: the wide kernels (attention_wide.cu)
    return attention_wide_backward(qkv, dm, m, dqkv, stats, batch, n, heads, dim_head, scale_log2e, scale, drop, seed,
                                   threshold, inv, gq, gk, dg_partial, dg, static_cast<cudaStream_t>(stream));
  if (n <= 0 || batch <= 0 || heads <= 0 ||
      static_cast<long long>(batch) * heads > 0x7fffffffLL || qk != (gk != nullptr) ||
      qk != (dg_partial != nullptr) || qk != (dg != nullptr) || (drop && keep == nullptr))
    return cudaErrorInvalidValue;
  const int kt = attn_key_chunks(n);
  const long long inner = static_cast<long long>(heads) * kAttnDh;
  AttnBwdMaps maps{};
  if (!rows_map(maps.qkv, qkv, 3 * inner, n, batch, 16 * kt) || !rows_map(maps.dm, dm, inner, n, batch, 16 * kt))
    return cudaErrorInvalidValue;
  const AttnBwdArgs args{n, heads, scale_log2e, scale, DropoutArgs{seed, threshold, inv},
                         static_cast<const bf16*>(qkv), static_cast<const bf16*>(gq), static_cast<const bf16*>(gk),
                         static_cast<bf16*>(m), static_cast<bf16*>(dqkv), static_cast<uint32_t*>(keep),
                         static_cast<float*>(dg_partial)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(batch) * static_cast<unsigned>(heads);
  cudaError_t err = drop ? (qk ? attention_bwd_launch_dropout_qknorm(kt, args, maps, blocks, s)
                               : attention_bwd_launch_dropout(kt, args, maps, blocks, s))
                         : (qk ? attention_bwd_launch_qknorm(kt, args, maps, blocks, s)
                               : attention_bwd_launch_plain(kt, args, maps, blocks, s));
  if (err != cudaSuccess || !qk) return err;
  return launch_column_sum(static_cast<const float*>(dg_partial), static_cast<float*>(dg), batch,
                           2 * heads * kAttnDh, kRmsRoot, s);
}

}  // extern "C"
