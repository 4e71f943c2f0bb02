// The wide attention path (attention_wide.cuh has the kernels, what they
// replace, their bound and their design): the host side of
// vit_attention_rows and vit_attention_bwd_rows past ViT-B's head shape, a
// dispatch over the built head widths.  attention_wide_d<dh>.cu instantiate
// the kernels, one dh a source.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a).

#include <math.h>

#include "attention_wide.cuh"

namespace {

bool wide_shape_ok(int batch, int n, int heads, int dim_head) {
  bool built = false;
#define VIT_ATTN_WIDE_BUILT(DH) built = built || dim_head == DH;
  VIT_ATTN_WIDE_DIM_HEADS(VIT_ATTN_WIDE_BUILT)
#undef VIT_ATTN_WIDE_BUILT
  const long long blocks = static_cast<long long>(batch) * heads * ((n + kAttnWideTile - 1) / kAttnWideTile);
  return built && n >= 1 && n <= kAttnWideMaxKeys && batch >= 1 && heads >= 1 && blocks <= 0x7fffffffLL;
}

// the qkv map (3 inner, n, b) and, with dm, its map (inner, n, b): boxes of 64 columns x 64 rows
bool wide_maps(WideMaps& maps, const void* qkv, const void* dm, int batch, int n, long long inner) {
  return rows_map(maps.qkv, qkv, 3 * inner, n, batch, kAttnWideTile) &&
         (dm == nullptr || rows_map(maps.dm, dm, inner, n, batch, kAttnWideTile));
}

// sqrt(dh) rounded to f32, as the JAX kernels' float(dim_head) ** 0.5 in f32 arithmetic
float wide_root(int dim_head) { return static_cast<float>(sqrt(static_cast<double>(dim_head))); }

}  // namespace

cudaError_t attention_wide_forward(const void* qkv, void* out, int batch, int n, int n_keys, int heads, int dim_head,
                                   float scale_log2e, int drop, unsigned seed, unsigned threshold, float inv,
                                   const void* gq, const void* gk, cudaStream_t stream) {
  if (!wide_shape_ok(batch, n, heads, dim_head) || n_keys < 1 || n_keys > n || (gq == nullptr) != (gk == nullptr))
    return cudaErrorInvalidValue;
  const long long inner = static_cast<long long>(heads) * dim_head;
  WideMaps maps{};
  if (!wide_maps(maps, qkv, nullptr, batch, n, inner)) return cudaErrorInvalidValue;
  WideArgs a{};
  a.batch = batch, a.n = n, a.n_keys = n_keys, a.heads = heads;
  a.scale_log2e = scale_log2e, a.root = wide_root(dim_head);
  a.drop = DropoutArgs{seed, threshold, inv};
  a.qkv = static_cast<const bf16*>(qkv);
  a.gq = static_cast<const bf16*>(gq), a.gk = static_cast<const bf16*>(gk);
  a.out = static_cast<bf16*>(out);
  const bool qk = gq != nullptr;
  switch (dim_head) {
#define VIT_ATTN_WIDE_FWD_CASE(DH) \
  case DH:                         \
    return attention_wide_fwd_d##DH(a, maps, drop != 0, qk, stream);
    VIT_ATTN_WIDE_DIM_HEADS(VIT_ATTN_WIDE_FWD_CASE)
#undef VIT_ATTN_WIDE_FWD_CASE
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t attention_wide_backward(const void* qkv, const void* dm, void* m, void* dqkv, void* stats, int batch, int n,
                                    int heads, int dim_head, float scale_log2e, float scale, int drop, unsigned seed,
                                    unsigned threshold, float inv, const void* gq, const void* gk, void* dg_partial,
                                    void* dg, cudaStream_t stream) {
  const bool qk = gq != nullptr;
  if (!wide_shape_ok(batch, n, heads, dim_head) || stats == nullptr || qk != (gk != nullptr) ||
      qk != (dg_partial != nullptr) || qk != (dg != nullptr))
    return cudaErrorInvalidValue;
  const long long inner = static_cast<long long>(heads) * dim_head;
  WideMaps maps{};
  if (!wide_maps(maps, qkv, dm, batch, n, inner)) return cudaErrorInvalidValue;
  WideArgs a{};
  a.batch = batch, a.n = n, a.n_keys = n, a.heads = heads;
  a.scale_log2e = scale_log2e, a.scale = scale, a.root = wide_root(dim_head);
  a.drop = DropoutArgs{seed, threshold, inv};
  a.qkv = static_cast<const bf16*>(qkv), a.dm = static_cast<const bf16*>(dm);
  a.gq = static_cast<const bf16*>(gq), a.gk = static_cast<const bf16*>(gk);
  a.out = static_cast<bf16*>(m), a.dqkv = static_cast<bf16*>(dqkv);
  a.stats = static_cast<float*>(stats), a.dg_partial = static_cast<float*>(dg_partial);
  cudaError_t err = cudaErrorInvalidValue;
  switch (dim_head) {
#define VIT_ATTN_WIDE_BWD_CASE(DH)                                   \
  case DH:                                                           \
    err = attention_wide_bwd_d##DH(a, maps, drop != 0, qk, stream); \
    break;
    VIT_ATTN_WIDE_DIM_HEADS(VIT_ATTN_WIDE_BWD_CASE)
#undef VIT_ATTN_WIDE_BWD_CASE
    default: break;
  }
  if (err != cudaSuccess || !qk) return err;
  // dgamma: the row and key passes' per-tile column sums, (b ceil(n / 64), 2, inner), in a fixed order
  return launch_column_sum(static_cast<const float*>(dg_partial), static_cast<float*>(dg),
                           batch * ((n + kAttnWideTile - 1) / kAttnWideTile), 2 * static_cast<int>(inner), a.root,
                           stream);
}
