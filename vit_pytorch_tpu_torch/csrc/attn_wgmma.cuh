// The wgmma tile machinery of the port's forward attention kernels
// (short_attention.cu, flash_fwd in flash_attention.cu); the backward
// kernels keep flash_tiles.cuh's mma.sync tiles.
//
// A warpgroup (128 threads, 4 warps) takes 64 queries; warp w owns query
// rows 16w .. 16w + 15 of them, as in flash_tiles.cuh.  A block holds one
// or two warpgroups (by instantiation: `wgs`), which share every tile of
// the ring, so two halve the bytes a query costs in copies.  Both products
// run on Hopper's warpgroup MMA:
//  - S = Q.K^T: four wgmma.m64n64k16 over dh = 64, A (q) from registers,
//    read once from device memory into the mma A fragments each warp keeps
//    for the whole loop (no shared-memory read of q a tile), and B the k
//    tile from shared memory.  A 64-wide bf16 row is exactly one 128-byte
//    swizzle row, so k is a K-major tile stored row by row with the
//    128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), the
//    layout of gemm_bf16's tiles (layer_tiles.cuh).
//  - O += bf16(P).V: four wgmma.m64n64k16 with A from registers (P packed
//    from the S accumulators by acc_to_a_frag, no trip through memory) and B
//    the v tile, MN-major: v's rows (keys) are the k axis, its 64 columns
//    the n axis, stored the same way as k's tile, and wgmma reads it with
//    its transpose flag (gemm_wgrad.cu's operands), so no fragment is built
//    from 16-bit shared loads.
// The wgmma accumulator of m64nN gives warp w's thread (g = lane / 4, t =
// lane % 4) rows 16w + g and 16w + g + 8 at columns 8j + 2t, 8j + 2t + 1:
// the m16n8 layout of flash_tiles.cuh, so masks, keep bits and bias offsets
// index it as before (float s[8][4]: s[j][0..1] row g, s[j][2..3] row g+8).
//
// The tiles the loop walks come through a ring of shared-memory stages,
// filled by the Tensor Memory Accelerator: one thread issues a tile's
// copy (cp.async.bulk.tensor with the 128-byte swizzle, from a tensor map
// the host encodes for each call: every operand is a strided (b, h, row)
// view) and the copy reports its bytes to the stage's mbarrier, on which
// the consumers wait.  A stage is refilled only after the block barrier
// that follows its last reader's wgmma_wait.  The k tile of a stage and
// its v tile have a barrier each: v is read one iteration after k (the
// pipelined loop below).  Rows past the sequence are zero-filled by the
// copy (a masked p stays exactly 0, and 0 times a zero row stays 0).
// Copies write shared memory through the async proxy, which wgmma reads
// through; the in-place qk-norm writes it through the generic proxy, so it
// is followed by fence.proxy.async before the barrier that publishes it.
//
// Bias tiles (the [bias] instantiations) are staged in the same ring: the
// block's query rows x 64 keys of the f32 or bf16 table in the 128-byte
// swizzle (f32 as two 32-key halves), so a thread's float2 or bf16 pair
// reads are conflict-free, copied by the TMA when the table's strides are
// whole 16-byte units and element by element otherwise; elements past n
// or m are never read from device memory (zero in the stage).
//
// The loops are software-pipelined: iteration i issues tile i's q.k^T and
// then tile i-1's p.v, waits for the first only and computes tile i's
// softmax while the tensor cores run p.v; so a v tile is read one
// iteration after its k tile, and iteration i fills the stage of k (and
// ids, keep and bias) of the tile `ahead` iterations on, but v of the tile
// one nearer.  The softmax's 2^x is one MUFU instruction (exp2_ftz).
//
// Internal linkage, as common.cuh.
#pragma once

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kSwTile = kFlashTile * kFlashDh;              // one swizzled 64 x 64 bf16 tile (8 KB)
constexpr int kSwTileBytes = kSwTile * static_cast<int>(sizeof(bf16));
constexpr int kBiasTileBytes = kFlashTile * kFlashTile * 4;  // 64 query rows of a bias stage, sized for f32 (16 KB)
constexpr int kWgAlign = 1024;                              // the 128-byte swizzle's atom

// element (r, c) of a swizzled 64 x 64 tile
__device__ __forceinline__ int sw_off(int r, int c) { return r * kFlashDh + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7); }

// the dynamic shared memory, aligned up to the swizzle atom (the launch asks
// kWgAlign bytes more)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + kWgAlign - 1) & ~uintptr_t(kWgAlign - 1));
}

// ---- the TMA (hopper.cuh: mbarriers, 2-D and 3-D copies, the encoder) -------

// A 4-D tensor map over (columns, rows, heads, images) and the order of its
// dims 1..3: order[d] is 0, 1 or 2 for rows, heads or images (the host sorts
// the dims by stride)
struct TileMap {
  CUtensorMap map;
  int order[3];
};

// the box at (c0, row, head, image) of `m` into shared memory, its bytes
// reported to `bar`; one thread
__device__ __forceinline__ void tma_load(void* dst, const TileMap& m, int c0, int row, int head, int image,
                                         uint64_t* bar) {
  auto pick = [&](int o) { return o == 0 ? row : o == 1 ? head : image; };
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(&m.map)), "r"(c0), "r"(pick(m.order[0])), "r"(pick(m.order[1])),
      "r"(pick(m.order[2])), "r"(smem_addr(bar))
      : "memory");
}

// The tensor maps of a launch: k, v, the bias (read when bias_tma)
struct alignas(64) TmaMaps {
  TileMap k, v, bias;
  int bias_tma;
};

// K-major (k, the B of q.k^T) and MN-major (v) descriptors of
// a swizzled tile: 8-row groups 1024 bytes apart; the MN-major one's 64-wide
// column groups would be 8 KB apart (there is one)
__device__ __forceinline__ uint64_t desc_k_major(const bf16* p) { return wgmma_desc_sw128(p, 16, 1024); }
__device__ __forceinline__ uint64_t desc_mn_major(const bf16* p) { return wgmma_desc_sw128(p, 8192, 1024); }

// d(64 x 64, f32) (+)= A(64 x 16, bf16 fragments in registers, the mma
// m16n8k16 A layout a warp) . B(16 x 64) from shared memory, K-major
// (TRANS_B = 0) or MN-major (1); scale_d = 0 overwrites d
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
        "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
        "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// 2^x for the probabilities p of the forward kernels: ex2.approx with
// subnormal results flushed to zero, one MUFU instruction (exp2f keeps a
// subnormal result and pays three more instructions for it).  A p below
// 2^-126 is then 0 instead of a subnormal: the row max's own p is 1, so l
// and o do not see the difference.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void fence_acc(float (&d)[8][4]) { fence_operands(&d[0][0], 32); }

// keep a register-A operand live and unmoved until here: a wgmma in flight
// still reads it
__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("" : "+r"(f[i][0]), "+r"(f[i][1]), "+r"(f[i][2]), "+r"(f[i][3])::"memory");
}

// s = q.k^T of the block's 64 queries (q: each warp's 16 rows as the four
// k16 A fragments of load_a_rows, held in registers for the whole loop)
// against one 64-key tile, f32: four k16 steps in a fixed order, committed
// as one group (not waited for).  Every logit a kernel computes comes from
// this one sequence, so a logit recomputed is bitwise the same.  After a
// wgmma_fence.
__device__ __forceinline__ void qk_issue(float (&s)[8][4], const uint32_t (&q)[kFlashDh / 16][4], const bf16* ks) {
#pragma unroll
  for (int kk = 0; kk < kFlashDh / 16; ++kk) wgmma_m64n64k16_rs<0>(s, q[kk], desc_k_major(ks + kk * 16), kk);
  wgmma_commit();
}

// o += bf16(p).v, p the four A fragments of a 64 x 64 probability tile, vs
// the swizzled v tile (k16 step kc: its keys 16kc .. 16kc + 15, two atoms),
// committed as one group (not waited for).  After a wgmma_fence.
__device__ __forceinline__ void pv_issue(float (&o)[8][4], const uint32_t (&p)[4][4], const bf16* vs) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) wgmma_m64n64k16_rs<1>(o, p[kc], desc_mn_major(vs + kc * 16 * kFlashDh), 1);
  wgmma_commit();
}

// The qk-norm of a swizzled tile of ROWS rows in place (rms_norm_rows
// through the swizzle: lane c of a row's 8 takes the row's logical 16-byte
// chunk c, so the f32 sum order is rms_norm_rows' own).  All THREADS threads
// of the block; zero rows stay zero.  gamma: the head's 64 gammas (f32, or
// bf16: the attention block's).
template <int THREADS, int ROWS = kFlashTile, typename G = float>
__device__ __forceinline__ void rms_norm_tile_sw(bf16* rows, const G* gamma) {
  static_assert((ROWS * 8) % THREADS == 0, "8 lanes a row, every lane busy");
  const int c = (threadIdx.x & 7) * 8;
  float g8[8];
  load_gamma8(g8, gamma + c);
#pragma unroll
  for (int i = 0; i < 8; ++i) g8[i] *= kRmsRoot;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * 8; i += THREADS) {
    const int row = i >> 3;
    bf16* p = rows + sw_off(row, c);
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    float f[8];
    unpack8(f, u);
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 4);
    const float rr = rsqrtf(ss + kRmsEps);
    uint4 o;
    uint32_t* po = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) po[j] = pack_floats(f[2 * j] * rr * g8[2 * j], f[2 * j + 1] * rr * g8[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = o;
  }
}

// An additive (.., n, m) bias table: base of this block's (image, head)
// table from its first query row, the row stride, the element type, and
// the coordinates of the (image, head) in its tensor map (0 on a
// broadcast dim).
struct BiasTable {
  const void* p;
  long long row;
  int bf16;
  int map_head, map_image;
};

// Byte offset of element (r, c) of a bias stage of ROWS rows x 64 keys in
// the 128-byte swizzle: f32 as two halves of 32 keys (ROWS x 128 bytes
// each), bf16 as one.
template <int ROWS>
__device__ __forceinline__ int bias_off(int is_bf16, int r, int c) {
  return is_bf16 ? r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + (c & 7) * 2
                 : (c >> 5) * ROWS * 128 + r * 128 + (((((c & 31) >> 2) ^ (r & 7))) << 4) + (c & 3) * 4;
}

// the bytes of a bias stage's copies
template <int ROWS>
__device__ __forceinline__ uint32_t bias_tile_bytes(int is_bf16) {
  return ROWS * kFlashTile * (is_bf16 ? 2 : 4);
}

// The TMA copies of the bias tile of queries q0.. x keys c0.. (the boxes of
// maps.bias), reported to `bar`; one thread.
template <int ROWS>
__device__ __forceinline__ void tma_bias_tile(unsigned char* dst, const TmaMaps& maps, const BiasTable& bt, int q0,
                                              int c0, uint64_t* bar) {
  tma_load(dst, maps.bias, c0, q0, bt.map_head, bt.map_image, bar);
  if (!bt.bf16) tma_load(dst + ROWS * 128, maps.bias, c0 + 32, q0, bt.map_head, bt.map_image, bar);
}

// The same tile element by element, for a table whose strides are no whole
// 16-byte units (no tensor map): all THREADS threads, generic stores into
// the same swizzled layout; elements past n or m are 0 and not read.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_bias_elems(unsigned char* dst, const BiasTable& bt, int c0, int n, int m) {
  for (int i = threadIdx.x; i < ROWS * kFlashTile; i += THREADS) {
    const int r = i / kFlashTile, c = i % kFlashTile;
    const bool ok = r < n && c0 + c < m;
    const long long off = r * bt.row + c0 + c;
    if (bt.bf16) {
      *reinterpret_cast<unsigned short*>(dst + bias_off<ROWS>(1, r, c)) =
          ok ? static_cast<const unsigned short*>(bt.p)[off] : 0;
    } else {
      *reinterpret_cast<float*>(dst + bias_off<ROWS>(0, r, c)) = ok ? static_cast<const float*>(bt.p)[off] : 0.f;
    }
  }
}

// the bias pair of stage row lr, keys c, c + 1 (c even), as f32
template <int ROWS>
__device__ __forceinline__ float2 bias_pair(const unsigned char* stage, int is_bf16, int lr, int c) {
  if (is_bf16) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(stage + bias_off<ROWS>(1, lr, c)));
  return *reinterpret_cast<const float2*>(stage + bias_off<ROWS>(0, lr, c));
}

// ---- the host side: tensor maps ----------------------------------------------

// A tensor map over a (cols, rows, heads, images) view of `base` with
// element strides (1, s_row, s_head, s_image) (a dim of size 1 may have any
// stride), box (box_cols, box_rows, 1, 1); its dims 1..3 sorted by stride.
// False if the driver refuses it.
inline bool encode_tile_map(TileMap& tm, const void* base, int is_bf16, long long cols, long long rows, long long heads,
                            long long images, long long s_row, long long s_head, long long s_image, int box_cols,
                            int box_rows, bool swizzle) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const long long es = is_bf16 ? 2 : 4;
  long long size[3] = {rows, heads, images}, stride[3] = {s_row, s_head, s_image};
  long long widest = cols;
  for (int i = 0; i < 3; ++i) widest = stride[i] > widest ? stride[i] : widest;
  for (int i = 0; i < 3; ++i)
    if (size[i] == 1) stride[i] = widest;  // a broadcast dim: any legal stride
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (stride[order[j]] < stride[order[i]]) {
        const int o = order[i];
        order[i] = order[j];
        order[j] = o;
      }
  cuuint64_t dim[4] = {static_cast<cuuint64_t>(cols)}, gstride[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols)}, estride[4] = {1, 1, 1, 1};
  for (int d = 0; d < 3; ++d) {
    const int o = order[d];
    dim[d + 1] = static_cast<cuuint64_t>(size[o]);
    gstride[d] = static_cast<cuuint64_t>(stride[o] * es);
    box[d + 1] = o == 0 ? static_cast<cuuint32_t>(box_rows) : 1u;
    tm.order[d] = o;
  }
  return encode(&tm.map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(base), dim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the k or v map of a bf16 (b, h, rows, 64) operand: 64 x 64 boxes
inline bool encode_operand_map(TileMap& tm, const void* base, const Strides& s, int rows, int heads, int batch) {
  return encode_tile_map(tm, base, 1, kFlashDh, rows, heads, batch, s.row, s.h, s.b, kFlashDh, kFlashTile, true);
}

// Whether a bias table can be copied by the TMA: a 16-byte aligned base and
// strides of whole 16-byte units (0 on a broadcast dim).
inline bool bias_tma_ok(const void* p, int is_bf16, long long sb, long long sh, long long srow) {
  const long long es = is_bf16 ? 2 : 4;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (sb * es) % 16 == 0 && (sh * es) % 16 == 0 &&
         (srow * es) % 16 == 0;
}

// the bias map of a (images, heads, n, m) table (a dim of size 1 is
// broadcast): boxes of 32 f32 or 64 bf16 keys x `rows` queries
inline bool encode_bias_map(TileMap& tm, const void* base, int is_bf16, int n, int m, int heads, int images,
                            long long s_row, long long s_head, long long s_image, int rows) {
  return encode_tile_map(tm, base, is_bf16, m, n, heads, images, s_row, s_head, s_image, is_bf16 ? 64 : 32, rows, true);
}

// One launch of a forward kernel on a 1-D grid of `blocks` blocks.
template <typename Args>
inline cudaError_t launch_attention(void (*kernel)(Args, TmaMaps), const Args& a, const TmaMaps& maps, long long blocks,
                                    int threads, int smem, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(a, maps);
  return cudaGetLastError();
}

// blocks an SM a kernel of `wgs` warpgroups is built for (its register
// budget: 170, 128, 128 registers a thread)
__host__ __device__ constexpr int wg_blocks(int wgs) { return wgs == 1 ? 3 : wgs == 2 ? 2 : 1; }

// The grid: one block per (query tile, image, head), ordered by head, then
// query tile, then image, so that the blocks of one (head, query tile) and
// consecutive images run side by side and a bias table shared by the batch
// (batch stride 0) is read from device memory once and from L2 by the other
// images.  With heavy_first (causal) the query tiles run from the last,
// whose loops are the longest.
struct GridPos {
  int b, h, qt;
};

__device__ __forceinline__ GridPos grid_pos(int batch, int qtiles, bool heavy_first) {
  const int bid = blockIdx.x;
  GridPos p;
  p.b = bid % batch;
  const int rest = bid / batch;
  p.qt = rest % qtiles;
  p.h = rest / qtiles;
  if (heavy_first) p.qt = qtiles - 1 - p.qt;
  return p;
}

}  // namespace
