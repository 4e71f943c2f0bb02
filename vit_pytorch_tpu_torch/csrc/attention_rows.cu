// Hopper (sm_90a) kernel attention_rows: softmax attention of every head of
// a layer, from the packed (b, n, 3 * inner) qkv rows to the merged heads
// (b, n, inner), n <= 208, dh = 64; with the instantiations [dropout] (P
// masked from the (seed, image, head) Philox stream), [qknorm] (q and k
// through the per-head RMSNorm first) and both.  [n_keys] (keys j >=
// n_keys masked, the tools' padded prototypes) is a runtime argument.
//
// Replaces: the per-head loop of vit_pytorch_tpu/ops/fused_block.py::
// _layer_kernel (_layer_rows :1021-1037), of the attention-block kernel
// _kernel (:323-348) and of the layer prototypes in tools/; layer_tiles.cuh's
// attention_wg_tile has the note on the function, its bound (the bytes of
// q, k, v and the output: ~100 flops a byte at n = 197, under the ridge) and
// the products' design.
//
// Design of the kernel around the tile body: one block of one warpgroup
// for each (image, head), in the grid's order image by image.  It loads the
// head's k and v once, by the TMA, for all of the head's query tiles (four
// at n = 197), through a 3-D (image, row, column) tensor map of the qkv
// buffer, so rows past n are zero-filled and never read from the next
// image; its query tiles come through two stages, the next one's copy in
// flight while this one's products run.  With qk-norm the k rows are
// normalised once a head, in shared memory, and each query tile as it
// lands (rms_norm_tile_sw: eight lanes a row).  With dropout the block draws
// each query tile's keep bits (fill_keep_tile, the bits of dropout_masks).
// A tile's output is cast to bf16 into its query stage and leaves by one
// TMA store (rows past n clipped).  Shared memory is 16 KB of query stages
// and 2 x 16 KT x 128 B of k and v (68 KB at KT = 13), so three blocks share
// an SM and one block's copies run under another's products.  KT, the key
// chunks of 16, is a template parameter: the host runs KT = ceil(n / 16)
// (attn_key_chunks), one instantiation per count in VIT_ATTN_KEY_CHUNKS.
//
// Built by ops/_build.py (nvcc -gencode arch=compute_90a,code=sm_90a), bound
// with ctypes: vit_attention_rows returns the launch's cudaError_t.

#include "layer_tiles.cuh"

namespace {

struct AttnRowsArgs {
  int n, n_keys, heads;
  float scale_log2e;
  DropoutArgs drop;
  const bf16* gq;  // qk-norm gammas, (heads * 64) bf16 each
  const bf16* gk;
};

// The tensor maps of a launch: qkv as (3 inner, n, b) in boxes of 64
// columns x 64 rows (q) and x 16 KT rows (k, v); the output (inner, n, b) in
// boxes of 64 x 64
struct alignas(64) AttnRowsMaps {
  CUtensorMap q, kv, out;
};

__host__ __device__ constexpr int attn_rows_smem(int kt, bool drop) {
  return kWgAlign + 2 * kSwTileBytes + 2 * 16 * kt * kAttnDh * 2 + (drop ? kAttnQT * attn_keep_words(kt) * 4 : 0) +
         3 * 8;
}

template <int KT, bool DROP, bool QKNORM>
__global__ void __launch_bounds__(kAttnThreads, 3)
    attention_rows_kernel(AttnRowsArgs a, const __grid_constant__ AttnRowsMaps maps) {
  constexpr int NP = 16 * KT;  // keys, padded
  extern __shared__ unsigned char attn_rows_raw[];
  unsigned char* smem = aligned_smem(attn_rows_raw);
  bf16* qring = reinterpret_cast<bf16*>(smem);  // two 64-row query stages
  bf16* ks = qring + 2 * kSwTile;               // NP rows
  bf16* vs = ks + NP * kAttnDh;                 // NP rows
  uint32_t* keep = reinterpret_cast<uint32_t*>(vs + NP * kAttnDh);  // 64 x attn_keep_words(KT), DROP only
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(keep + (DROP ? kAttnQT * attn_keep_words(KT) : 0));
  uint64_t* q_full = kv_full + 1;  // [2]

  const int img = blockIdx.x / a.heads, h = blockIdx.x % a.heads, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int inner = a.heads * kAttnDh, qtiles = (a.n + kAttnQT - 1) / kAttnQT;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(kv_full + i);
    mbar_fence_init();
    mbar_expect(kv_full, 2 * NP * kAttnDh * static_cast<int>(sizeof(bf16)));
    tma_load_3d(ks, &maps.kv, inner + h * kAttnDh, 0, img, kv_full);
    tma_load_3d(vs, &maps.kv, 2 * inner + h * kAttnDh, 0, img, kv_full);
    for (int i = 0; i < 2 && i < qtiles; ++i) {
      mbar_expect(q_full + i, kSwTileBytes);
      tma_load_3d(qring + i * kSwTile, &maps.q, h * kAttnDh, i * kAttnQT, img, q_full + i);
    }
  }
  __syncthreads();  // the barriers are initialised before any thread waits on them
  mbar_wait(kv_full, 0);
  if constexpr (QKNORM) {  // k once a head
    rms_norm_tile_sw<kAttnThreads, NP>(ks, a.gk + h * kAttnDh);
    fence_proxy_async();
    __syncthreads();
  }

  for (int qt = 0; qt < qtiles; ++qt) {
    const int buf = qt & 1, q0 = qt * kAttnQT;
    bf16* qs = qring + buf * kSwTile;
    if constexpr (DROP)
      fill_keep_tile<kAttnQT, attn_keep_words(KT)>(keep, a.drop, dropout_stream(img, h), q0, 0, a.n, a.n);
    mbar_wait(q_full + buf, (qt >> 1) & 1);
    if constexpr (QKNORM) rms_norm_tile_sw<kAttnThreads>(qs, a.gq + h * kAttnDh);
    if constexpr (DROP || QKNORM) {
      fence_proxy_async();
      __syncthreads();  // the keep tile and the normed q rows are in place
    }
    float o[8][4];
    attention_wg_tile<KT, DROP>(o, qs, ks, vs, keep, a.n_keys, a.scale_log2e, a.drop.inv, tid);
    __syncthreads();  // every warp's products have read the query stage (and the keep tile)

    // the output tile, bf16, into the query stage, then one TMA store
    const int r = warp * 16 + g;
#pragma unroll
    for (int dj = 0; dj < 8; ++dj) {
      *reinterpret_cast<uint32_t*>(qs + sw_off(r, dj * 8 + 2 * t)) = pack_floats(o[dj][0], o[dj][1]);
      *reinterpret_cast<uint32_t*>(qs + sw_off(r + 8, dj * 8 + 2 * t)) = pack_floats(o[dj][2], o[dj][3]);
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {
      tma_store_3d(&maps.out, qs, h * kAttnDh, q0, img);
      bulk_commit();
      if (qt + 2 < qtiles) {  // the stage's next query tile, once the store has read it
        bulk_wait_read();
        mbar_expect(q_full + buf, kSwTileBytes);
        tma_load_3d(qs, &maps.q, h * kAttnDh, q0 + 2 * kAttnQT, img, q_full + buf);
      }
    }
  }
  if (tid == 0) bulk_wait();  // the last store is done before the block's shared memory goes
}

typedef void (*AttnRowsKernel)(AttnRowsArgs, AttnRowsMaps);

template <int KT>
AttnRowsKernel attn_rows_kernel(bool drop, bool qk) {
  return drop ? (qk ? attention_rows_kernel<KT, true, true> : attention_rows_kernel<KT, true, false>)
              : (qk ? attention_rows_kernel<KT, false, true> : attention_rows_kernel<KT, false, false>);
}

}  // namespace

extern "C" {

// n_keys: keys j >= n_keys are masked (1 <= n_keys <= n; n: none); drop = 0:
// no dropout (seed, threshold, inv unread); gq, gk: the qk-norm gammas,
// (heads * dim_head) bf16 each, or both null (no qk-norm).  Pointers are
// device pointers of contiguous bf16 tensors, 16-byte aligned.
int vit_attention_rows(const void* qkv, void* out, int batch, int n, int n_keys, int heads, int dim_head,
                       float scale_log2e, int drop, unsigned seed, unsigned threshold, float inv, const void* gq,
                       const void* gk, void* stream) {
  if (dim_head != kAttnDh || n <= 0 || n > 16 * kAttnKT || n_keys < 1 || n_keys > n || batch <= 0 ||
      batch > 65535 || heads <= 0 || (gq == nullptr) != (gk == nullptr))
    return cudaErrorInvalidValue;
  const int kt = attn_key_chunks(n);
  const bool qk = gq != nullptr;
  AttnRowsKernel kernel = nullptr;
  switch (kt) {
#define VIT_ATTN_ROWS_CASE(KT) \
  case KT:                     \
    kernel = attn_rows_kernel<KT>(drop != 0, qk); \
    break;
    VIT_ATTN_KEY_CHUNKS(VIT_ATTN_ROWS_CASE)
#undef VIT_ATTN_ROWS_CASE
    default: return cudaErrorInvalidValue;
  }
  const long long inner = static_cast<long long>(heads) * kAttnDh;
  AttnRowsMaps maps{};
  if (!rows_map(maps.q, qkv, 3 * inner, n, batch, kAttnQT) || !rows_map(maps.kv, qkv, 3 * inner, n, batch, 16 * kt) ||
      !rows_map(maps.out, out, inner, n, batch, kAttnQT))
    return cudaErrorInvalidValue;
  const int smem = attn_rows_smem(kt, drop != 0);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const AttnRowsArgs args{n, n_keys, heads, scale_log2e, DropoutArgs{seed, threshold, inv},
                          static_cast<const bf16*>(gq), static_cast<const bf16*>(gk)};
  kernel<<<static_cast<unsigned>(batch) * static_cast<unsigned>(heads), kAttnThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(args, maps);
  return cudaGetLastError();
}

}  // extern "C"
