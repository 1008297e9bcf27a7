// Decode paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dynamo_tpu/ops/paged_attention.py
// `decode_paged_attention` (body `_decode_kernel_body`), its bf16 bodies
// `_decode_kernel` and `_decode_kernel_win` and its int8 bodies
// `_decode_kernel_int8` and `_decode_kernel_int8_win`, with the static
// softcap and scale, at head dims 64, 96, 128 and 256 and G 1 to 8: one
// query token per sequence, all G query heads of each kv-head, attends over the sequence's pages of a
// token-major pool [NP, PS, Hk, D] up to kv_len (with a window w > 0,
// from kv_len - w: the reference's rule at paged_attention.py:78-84), with
// an online softmax in f32. Rows with kv_len 0 come out 0.
//
// What bounds it on an H100: bytes. Each context token's K and V rows
// (2 x D bf16 per kv-head) are read once and used for G dot products and
// G axpys, about 1.5 flops per byte at G 3 against the card's ~295 flops
// per byte balance point. At the main path's decode batch (B 8, Hk 8, D
// 128, contexts of up to 4096 tokens, 11k in all) that is 45 MB, 13.5 us
// at 3.35 TB/s. To come near it the kernel has to keep enough bytes in
// flight on every SM and must not leave a long row to one block.
//
// Design:
//   - The context is split over blocks (flash-decoding): grid (Hk, B, NS),
//     NS = ceil(MP * PS / split) from the page table's width, a shape, so
//     the launch needs no host sync. Block (h, b, z) walks positions
//     [z * split, min((z + 1) * split, kv_len)) and returns at once when
//     that range is empty (split 0 always runs: it writes rows with no
//     context). The wrapper's split is 384 tokens: at the main path's
//     batch that is 34 live splits x 8 heads = 272 blocks, about two for
//     each of the 132 SMs (PERF.md gives the measurements behind it).
//   - The block's 3 warps each own their own 64-token tiles of the split
//     (warp w: tiles w, w + 3, ...), so no warp idles while another holds
//     the G <= 8 live rows: the slots form a ring of 3 tiles, one per
//     warp, refilled by its warp when it has used it. A tile arrives by
//     bulk copies (cp.async.bulk, the TMA unit): one per token row per
//     K/V, counted on the slot's mbarrier, the page-table entry read by
//     the issuing lane. Tokens past kv_len are not copied and their table
//     entries are never read; their V rows are zeroed instead, so their
//     P = 0 never meets a NaN. A block holds 109 KB of shared memory at
//     D 128, so two blocks share an SM and one's loads run under the
//     other's products.
//   - Each warp runs paged_flash.cuh's tile body (tile_update): S = Q K^T
//     and O += P V on mma.sync.m16n8k16 (bf16 in, f32 accumulate) with
//     ldmatrix fragments, the G live rows in a 16-row fragment (the rest
//     zero), the online softmax in registers, P rounded to bf16 before
//     the value product (the TPU kernel keeps p in f32). Tensor cores are
//     not what this byte-bound kernel needs; sharing the tile body with
//     the prefill and ragged kernels is.
//   - Sliding window: block (h, b, z) starts at max(z * split, kv_len - w)
//     (the index map's low clamp at paged_attention.py:241-254, as a
//     start position), so no tile below the window is copied and no table
//     entry below it is read; every position a block walks is visible, so
//     the window needs no mask here. A split wholly below the window of a
//     row longer than one split stages nothing and writes the empty
//     partial (m = -1e30, l = 0, O = 0), which the merge weighs 0.
//   - The soft cap is the tile body's template flag (paged_flash.cuh):
//     the plain body carries none of it.
//   - D 256 (Gemma-2): Q's fragments are reloaded from shared memory each
//     tile (QFrags), so that O's 128 registers fit; 211 KB of shared
//     memory, one block an SM.
//   - D 96 (Phi-3) is the D 128 body with 6 slices of 16 dims: rows of
//     104 bf16 (208 bytes, 16-byte aligned, conflict-free for ldmatrix),
//     bulk copies of 192 bytes (int8: 96), 83 KB of shared memory.
//   - G is 1 to 8 (the rows of one 16-row fragment a KV head's queries
//     take). At G 1 (MHA: Phi-3, OLMo-2, Gemma-7B) a warp carries one live
//     row in its fragment: the products cost what G 8's do, the bytes
//     are the same, and the kernel stays bound by bytes.
//   - int8 pools (models/quant.py; the TPU kernel's `_decode_kernel_int8`
//     and `_int8_win`) run a kernel of their own, decode_codes_kernel. It
//     moves half the bf16 body's bytes plus 8 bytes a token and head of
//     scales ((D + 4) / 2 D of them: 0.52 at D 128), so what bounds it is
//     latency: the bf16 walk's copies, its conversion pass and its serial
//     chain a warp left it 1.16-1.23x slower than the bf16 body. Measured
//     on an H100 (PERF.md §6, int8 GQA decode), its design:
//       - Codes stay codes: a warp's tile slot holds 64 K and 64 V rows of
//         D + 16 bytes (about half a bf16 slot) and a scale slab [2][64]
//         f32; no bf16 copy of a tile is made and there is no conversion
//         barrier or proxy fence.
//       - One tile a warp, all in flight at once: 4 warps a block at D 64 /
//         96 / 128 (6 at D 256) and an int8 split of 64 x warps tokens (the
//         wrapper's DECODE_INT8_SPLIT_TOKENS), each warp issuing its tile's
//         copies before it waits; 3 to 5 blocks an SM hold the 3B shape's
//         384 live blocks in one wave.
//       - Page boxes: at D <= 128 and page sizes 8 to 64 (or multiples of
//         64) a page's rows of one head arrive by one TMA box from a tensor
//         map, 8 boxes a tile at PS 16 in place of 128 row copies; D 256
//         and other page sizes copy a row at a time (decode_codes_kernel's
//         comment). Scales come by 4-byte cp.async a token.
//       - Transposed products (tile_update_codes_t): the tile's tokens are
//         the 16-row side of each mma.sync and the G <= 8 query rows its
//         8-column side, so no product row idles (the bf16 body fills 16
//         rows with G), O^T takes D / 4 registers and Q's fragments come
//         from global memory into registers; bf16 fragments are built from
//         the codes in registers as paged_flash.cuh's tile_update_codes
//         builds them, P^T by movmatrix.
//       - Its merge, decode_merge_codes_kernel, reads a row's splits 8 at a
//         time in one pass and is launched as a programmatic dependent of
//         the split kernel, so it is scheduled while that grid runs.
//     Tokens past the split's end or below a window's low edge within a
//     64-token tile are masked; a slot's scales start at 0 and its codes
//     are int8 whatever they hold, so masked tokens give finite scores and
//     P = 0.
//   - The warps' (m, l, O) are combined through shared memory in warp
//     order. A row whose context fits one split writes its bf16 output
//     directly; a longer row's blocks write f32 partials (O, m, l) to the
//     wrapper's scratch [NS, B, Hk, G, D + 4], and decode_merge_kernel,
//     launched by the same call on the same stream, merges them by
//     log-sum-exp in split order (paged_flash.cuh merge_splits, shared
//     with the ragged kernel). No atomics: results are the same bit for
//     bit from run to run.

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "paged_flash.cuh"

namespace {

using namespace paged_flash;

constexpr int kWarps = 3;
constexpr int kThreads = 32 * kWarps;

// the bf16 body's shared memory
template <int D>
struct DecShape {
  static constexpr int kStride = D + 8;  // bf16 row stride in shared memory
  static constexpr int kTileElems = kTile * kStride;
  static constexpr int kQElems = 16 * kStride;
  // Q, then per warp a K tile and a V tile, then one mbarrier a warp
  static constexpr int kBarOff = (kQElems + 2 * kWarps * kTileElems) * 2;
  static constexpr int kSmemBytes = kBarOff + 8 * kWarps;
  // the combine area (per warp 8 rows of O, m, l) reuses the tile slots
  static_assert(kWarps * 8 * (D + 2) * 4 <= 2 * kWarps * kTileElems * 2,
                "combine area larger than the slots");
};

// The block's range of one split: [c_begin, c_end) and whether the row's
// context fits one split (bf16 out) or takes partials. Returns false when
// the block has nothing to do: an empty split of a long row (uniform over
// the block), or a split wholly below the window, whose empty partial (m =
// -1e30, l = 0, O = 0) it writes first.
template <int D, int kThr>
__device__ __forceinline__ bool split_range(const int* __restrict__ kv_lens,
                                            float* __restrict__ part, int B, int Hk,
                                            int G, int PS, int MP, int split, int window,
                                            int& c_begin, int& c_end, bool& direct) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int kvl = min(kv_lens[b], MP * PS);
  if (z > 0 && z * split >= kvl) return false;
  // the query sits at kvl - 1: with a window it sees [kvl - window, kvl)
  const int lo = window > 0 ? max(kvl - window, 0) : 0;
  c_begin = max(z * split, lo);
  c_end = min(z * split + split, kvl);
  direct = kvl <= split;  // one split: bf16 out, else partials
  if (c_begin >= c_end && !direct) {
    for (int i = threadIdx.x; i < G * (D + 4); i += kThr) {
      const int d = i % (D + 4);
      part[((size_t)z * B * Hk * G + ((size_t)(b * Hk + h)) * G + i / (D + 4)) * (D + 4) +
           d] = d == D ? kNegInf : 0.f;
    }
    return false;
  }
  return true;
}

// The block's epilogue: the W warps' (m, l, O) rows in shared memory at
// smem ([W][8][D] O in natural column order, then [W] x 8 m, then l) are
// combined in warp order; one split: bf16 out, else partials
template <int D, int W>
__device__ __forceinline__ void combine_warps(const unsigned char* smem,
                                              __nv_bfloat16* __restrict__ out,
                                              float* __restrict__ part, int B, int Hk,
                                              int G, bool direct) {
  const float* sO = reinterpret_cast<const float*>(smem);
  const float* sM = sO + W * 8 * D;
  const float* sL = sM + W * 8;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  for (int i = threadIdx.x; i < G * (D / 2); i += 32 * W) {
    const int r = i / (D / 2);
    const int d = (i % (D / 2)) * 2;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, sM[w * 8 + r]);
    float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float f = exp2_approx(sM[w * 8 + r] - M);
      const float2 o = *reinterpret_cast<const float2*>(sO + (w * 8 + r) * D + d);
      L += f * sL[w * 8 + r];
      a0 += f * o.x;
      a1 += f * o.y;
    }
    const size_t row = ((size_t)(b * Hk + h)) * G + r;
    if (direct) {
      const float inv = 1.f / fmaxf(L, 1e-30f);
      *reinterpret_cast<uint32_t*>(out + row * D + d) = pack_bf16(a0 * inv, a1 * inv);
    } else {
      float* p = part + ((size_t)z * B * Hk * G + row) * (D + 4);
      *reinterpret_cast<float2*>(p + d) = make_float2(a0, a1);
      if (d == 0) *reinterpret_cast<float2*>(p + D) = make_float2(M, L);
    }
  }
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pool,
                    const __nv_bfloat16* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ kv_lens,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part,
                    int B, int Hk, int G, int PS, int MP, int split,
                    int window, ScoreMap sm) {
  using Sh = DecShape<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  int c_begin, c_end;
  bool direct;
  if (!split_range<D, kThreads>(kv_lens, part, B, Hk, G, PS, MP, split, window, c_begin,
                                c_end, direct)) {
    return;
  }
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kTile - 1) / kTile : 0;

  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sKV = sQ + Sh::kQElems;  // warp w: K at 2w, V at 2w + 1
  const uint32_t bar0 = smem_u32(smem + Sh::kBarOff);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int* pt = page_table + (size_t)b * MP;
  const size_t row_stride = (size_t)Hk * D;
  const __nv_bfloat16* qb = q + (size_t)(b * Hk + h) * G * D;

  // Q: rows r < G, zeros below
  for (int i = tid; i < 16 * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int c8 = (i % (D / 8)) * 8;
    cp_async16(smem_u32(sQ + r * Sh::kStride + c8), r < G ? qb + r * D + c8 : qb, r < G);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid == 0) {
    for (int w = 0; w < kWarps; ++w) mbar_init(bar0 + 8 * w, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are visible

  const uint32_t bar = bar0 + 8 * warp;
  __nv_bfloat16* sK = sKV + 2 * warp * Sh::kTileElems;
  // tile t into this warp's slot: lane j copies token rows j / 2, (j + 32) / 2,
  // ... (K for even j, V for odd). The V rows of a partial tile's missing
  // tokens are zeroed (other addresses than the copies'), so their P = 0
  // never meets stale bits. The warp syncs before it reads the slot.
  auto issue = [&](int t) {
    const int c0 = c_begin + t * kTile;
    const int n = min(kTile, c_end - c0);
    if (lane == 0) mbar_expect_tx(bar, n * D * 2 * 2);
    for (int j = lane; j < 2 * n; j += 32) {
      const int c = c0 + (j >> 1);
      const int is_v = j & 1;
      const size_t cell = (size_t)__ldg(pt + c / PS) * PS + c % PS;
      bulk_copy(smem_u32(sK + is_v * Sh::kTileElems + (j >> 1) * Sh::kStride),
                (is_v ? v_pool : k_pool) + cell * row_stride + (size_t)h * D, D * 2, bar);
    }
    for (int i = n * (D / 8) + lane; i < kTile * (D / 8); i += 32) {
      *reinterpret_cast<uint4*>(sK + Sh::kTileElems + (i / (D / 8)) * Sh::kStride +
                                (i % (D / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (warp < n_tiles) issue(warp);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // Q
  __syncthreads();  // Q is visible

  RowState<D> st;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
  }
  const int r0 = lane >> 2;  // rows r0 and r0 + 8; G <= 8, so only r0 lives
  st.vis[0] = r0 < G ? c_end - 1 : -1;
  st.vis[1] = -1;

  if (warp < n_tiles) {
    QFrags<D> qf;
    qf.init(sQ);
    int use = 0;
    for (int t = warp; t < n_tiles; t += kWarps, ++use) {
      mbar_wait(bar, use & 1);
      __syncwarp();  // the zeroed rows are visible
      const int c0 = c_begin + t * kTile;
      // no window mask: every position the block walks is visible
      tile_update<D, kCap, false>(qf, sK, c0, c0 + kTile <= c_end, sm, st);
      __syncwarp();  // every lane is done with the slot
      if (t + kWarps < n_tiles) issue(t + kWarps);
    }
  }
  st.l[0] = quad_sum(st.l[0]);
  __syncthreads();  // every slot is consumed: its memory takes the combine area

  float* sO = reinterpret_cast<float*>(sKV);  // [kWarps][8][D]
  float* sM = sO + kWarps * 8 * D;             // [kWarps][8]
  float* sL = sM + kWarps * 8;
  if (r0 < G) {
    const int t4 = lane & 3;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(sO + (warp * 8 + r0) * D + n * 8 + 2 * t4) =
          make_float2(st.o[n][0], st.o[n][1]);
    }
    if (t4 == 0) {
      sM[warp * 8 + r0] = st.m[0];
      sL[warp * 8 + r0] = st.l[0];
    }
  }
  __syncthreads();
  combine_warps<D, kWarps>(reinterpret_cast<const unsigned char*>(sKV), out, part, B, Hk,
                           G, direct);
}

// int8 pools, by head dim (measured: PERF.md §6, int8 GQA decode):
// code_warps<D>() warps a block, warp w owning tiles w, w + code_warps, ...
// of the split in one tile slot; the wrapper's int8 split (ops/paged_attention.py
// DECODE_INT8_SPLIT_TOKENS) gives each warp one tile, all in flight at
// once (a longer split refills a warp's slot when it has used it).
// code_min_blocks<D>() is the launch bounds' least resident blocks, a
// register cap: ptxas's own choice spilled at D 64 (80 registers), and
// larger caps spilled at D 128
template <int D>
constexpr int code_warps() { return D == 256 ? 6 : 4; }
template <int D>
constexpr int code_min_blocks() { return D == 64 ? 5 : D == 256 ? 2 : 4; }
// threads of the int8 launches' merge blocks: one (row, 4 dims) item each
constexpr int kCodeMergeThreads = 256;

// decode_codes_kernel's shared memory: per warp a slot of 64 K then 64 V
// code rows of D + 16 bytes, then per warp a scale slab [2][64] f32, then
// one mbarrier a warp
template <int D>
struct DecCodeShape {
  static constexpr int kWarps = code_warps<D>();
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlot = D + 16;
  static constexpr int kTileBytes = 2 * kTile * kSlot;
  static constexpr int kScaleOff = kWarps * kTileBytes;
  static constexpr int kBarOff = kScaleOff + kWarps * 2 * kTile * 4;
  static constexpr int kSmemBytes = kBarOff + 8 * kWarps;
  static_assert(kSlot % 32 == 16, "eight consecutive slots in eight bank quads");
  static_assert(kSmemBytes <= 232448, "the slots fit one block");
  // the combine area (per warp 8 rows of O, m, l) reuses the slots
  static_assert(kWarps * 8 * (D + 2) * 4 <= kScaleOff, "combine area larger than the slots");
};

// One warp's rows in the transposed walk (g = lane / 4, t4 = lane % 4):
// O^T in D / 16 blocks of 16 dims x 8 rows, register e of block j holding
// dim 16 j + 2 g + (e >> 1) of row 2 t4 + (e & 1); m and l of rows 2 t4
// and 2 t4 + 1 (l this lane's share until the walk ends); the last
// position each row sees (-1: no row)
template <int D>
struct RowsT {
  float o[D / 16][4];
  float m[2];
  float l[2];
  int vis[2];
};

// Q's B fragments of the transposed products: slice s of 16 dims in
// code_slice's order, b[s][0] the k pairs 2 t4, 2 t4 + 1 and b[s][1] 2 t4 +
// 8, 2 t4 + 9 of query row g (zero for g >= G), read straight from global
// memory: slice s of 64-dim group gr (or D 96's last 32 dims) starts at
// dim d0 = 64 gr + (width / 4) t4 + 4 (s - 4 gr) for quad lane t4, and its
// k pairs are (d0, d0 + 2), (d0 + 1, d0 + 3)
template <int D>
__device__ __forceinline__ void q_frags_t(uint32_t (&qb)[D / 16][2],
                                          const __nv_bfloat16* __restrict__ q_row0, int G) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2;
  const int t4 = lane & 3;
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    const int gr = s / 4;
    const int width = gr < D / 64 ? 64 : 32;
    const int d0 = 64 * gr + (width / 4) * t4 + 4 * (s - 4 * gr);
    const uint2 x = r < G ? __ldg(reinterpret_cast<const uint2*>(q_row0 + r * D + d0))
                          : make_uint2(0u, 0u);
    qb[s][0] = __byte_perm(x.x, x.y, 0x5410);
    qb[s][1] = __byte_perm(x.x, x.y, 0x7632);
  }
}

// One 64-token tile of the online softmax on int8 codes, transposed: the
// tile's tokens are the 16-row side of each product and the warp's G <= 8
// query rows the 8-column side, so no product row is idle (the untransposed
// tile_update_codes spends half of every product on rows 8 .. 15 of a
// decode row group) and O^T takes D / 4 registers a thread. S^T = K Q^T in
// four 16-token blocks (block tb's product row m is token 16 tb + 8 (m / 8)
// + bitrev3(m % 8): the bank-conflict-free order of tile_update_codes' K
// loads), the A fragments built from each thread's 16-byte loads of its two
// tokens' codes (i8_lo_bf16x2 / i8_hi_bf16x2 of a word give the k pairs 2
// t4, 2 t4 + 1 and 2 t4 + 8, 2 t4 + 9 of its slice); the K scale on the raw
// score, the score map, the mask (a token c counts for row r when full or c
// <= vis[r], and c >= lo: the split's first visible position, which a tile
// aligned to 64 tokens may start below), row max over the 8 lanes of t4; P =
// exp2(S - m), the row sum,
// then P times the V scale rounded to bf16 and transposed by movmatrix into
// P^T's B fragments; O^T += V^T P^T from ldmatrix.trans on code pairs (as in
// tile_update_codes, whose register x gives tokens 2 t4, 2 t4 + 1 at dims 2
// g, 2 g + 1 of its 16-byte column: lo the A pair of product row g, dim 2 g;
// hi product row g + 8, dim 2 g + 1). sK: the tile's K code rows (D + 16
// bytes apart), the V rows 64 rows later; sSc its scales (K at [0, 64), V
// at [64, 128)).
template <int D, bool kCap>
__device__ __forceinline__ void tile_update_codes_t(const uint32_t (&qb)[D / 16][2],
                                                    const unsigned char* sK, int c0, int lo,
                                                    bool full, const ScoreMap& sm,
                                                    RowsT<D>& st, const float* sSc) {
  constexpr int kSlot = D + 16;
  constexpr int kG64 = D / 64;        // 64-dim groups: 16-byte loads
  constexpr bool kG32 = D % 64 != 0;  // D 96's last 32 dims: 8-byte loads
  const unsigned char* sV = sK + kTile * kSlot;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int tg = bitrev3(lane >> 2);  // token of product row g in its 8-token half
  float s[4][4];
#pragma unroll
  for (int tb = 0; tb < 4; ++tb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[tb][e] = 0.f;
  // S^T += K Q^T over one load group of kJ slices from dim byte `at`
  // (kJ 4: 16-byte loads; 2: 8-byte loads at 8 t4), slices from kc
  auto qk = [&](auto kj, int at, int kc) {
    constexpr int kJ = decltype(kj)::value;
#pragma unroll
    for (int tb = 0; tb < 4; ++tb) {
      const unsigned char* ra = sK + (16 * tb + tg) * kSlot + at + t4 * 4 * kJ;
      const unsigned char* rb = ra + 8 * kSlot;
      uint32_t wa[kJ], wb[kJ];
      if constexpr (kJ == 4) {
        const uint4 x = *reinterpret_cast<const uint4*>(ra);
        const uint4 y = *reinterpret_cast<const uint4*>(rb);
        wa[0] = x.x, wa[1] = x.y, wa[2] = x.z, wa[3] = x.w;
        wb[0] = y.x, wb[1] = y.y, wb[2] = y.z, wb[3] = y.w;
      } else {
        const uint2 x = *reinterpret_cast<const uint2*>(ra);
        const uint2 y = *reinterpret_cast<const uint2*>(rb);
        wa[0] = x.x, wa[1] = x.y;
        wb[0] = y.x, wb[1] = y.y;
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const uint32_t a[4] = {i8_lo_bf16x2(wa[j]), i8_lo_bf16x2(wb[j]),
                               i8_hi_bf16x2(wa[j]), i8_hi_bf16x2(wb[j])};
        mma_bf16(s[tb], a, qb[kc + j][0], qb[kc + j][1]);
      }
    }
  };
#pragma unroll
  for (int gr = 0; gr < kG64; ++gr) qk(std::integral_constant<int, 4>{}, gr * 64, 4 * gr);
  if constexpr (kG32) qk(std::integral_constant<int, 2>{}, kG64 * 64, 4 * kG64);

  // score map (the K scale on the raw score first), mask, row max
  float mx[2] = {minus_inf(), minus_inf()};
#pragma unroll
  for (int tb = 0; tb < 4; ++tb) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tok = 16 * tb + 8 * hf + tg;
      const float ks = sSc[tok];
      const int c = c0 + tok;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float x = base2_logit<kCap>(s[tb][2 * hf + i] * ks, sm);
        s[tb][2 * hf + i] = (full || (c >= lo && c <= st.vis[i])) ? x : minus_inf();
        mx[i] = fmaxf(mx[i], s[tb][2 * hf + i]);
      }
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int x = 4; x < 32; x <<= 1) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], x));
    const float m_new = fmaxf(st.m[i], mx[i]);
    alpha[i] = exp2_approx(st.m[i] - m_new);
    st.m[i] = m_new;
  }
  // P = exp2(S - m), the row sum before the V scale; P^T's B fragments of
  // block tb: pb[tb][hf] holds product rows (tokens) 8 hf + 2 t4, + 1 of
  // query row g
  uint32_t pb[4][2];
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int tb = 0; tb < 4; ++tb) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float vs = sSc[kTile + 16 * tb + 8 * hf + tg];
      const float p0 = exp2_approx(s[tb][2 * hf] - st.m[0]);
      const float p1 = exp2_approx(s[tb][2 * hf + 1] - st.m[1]);
      sum[0] += p0;
      sum[1] += p1;
      pb[tb][hf] = movmatrix_trans(pack_bf16(p0 * vs, p1 * vs));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * alpha[i] + sum[i];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    st.o[j][0] *= alpha[0];
    st.o[j][1] *= alpha[1];
    st.o[j][2] *= alpha[0];
    st.o[j][3] *= alpha[1];
  }

  // O^T += V^T P^T, one ldmatrix.trans a 16-token block and 32 dims:
  // matrix x (lanes 8 x .. 8 x + 7 give its rows) holds tokens 16 tb + 8 (x
  // & 1) + bitrev3(row) at bytes 32 c + 16 (x >> 1)
  const unsigned char* vr = sV + (8 * ((lane >> 3) & 1) + bitrev3(lane & 7)) * kSlot +
                            16 * (lane >> 4);
#pragma unroll
  for (int tb = 0; tb < 4; ++tb) {
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      uint32_t b[4];
      ldsm_x4_trans(b, smem_u32(vr + tb * 16 * kSlot + c * 32));
      const uint32_t a0[4] = {i8_lo_bf16x2(b[0]), i8_hi_bf16x2(b[0]), i8_lo_bf16x2(b[1]),
                              i8_hi_bf16x2(b[1])};
      const uint32_t a1[4] = {i8_lo_bf16x2(b[2]), i8_hi_bf16x2(b[2]), i8_lo_bf16x2(b[3]),
                              i8_hi_bf16x2(b[3])};
      mma_bf16(st.o[2 * c], a0, pb[tb][0], pb[tb][1]);
      mma_bf16(st.o[2 * c + 1], a1, pb[tb][0], pb[tb][1]);
    }
  }
}

// The int8 split kernel. Its tiles are 64-token aligned, from a_begin =
// c_begin rounded down to 64 (a window's low edge is masked in the tile
// body), and each arrives in one of two ways (box_rows):
//   - box_rows > 0 (D <= 128 and a page size that 64 divides or divides
//     64, at least 8): one TMA box a page of box_rows = min(PS, 64) rows
//     of one head a K/V, from a 3-D tensor map over the pool {D, Hk, NP PS}
//     whose box is D + 16 bytes wide: the 16 bytes past a row's codes are
//     out of bounds and arrive as zeros, so each row lands in its slot as
//     the bulk copies put it. 64 / box_rows boxes a K/V a tile (8 at PS 16)
//     in place of 128 row copies of 64-128 bytes, each of which costs the
//     TMA unit a copy (PERF.md §6, int8 GQA decode). Pages with no
//     visible token are not read.
//   - else one bulk copy a token row a K/V (D 256, whose D + 16 passes a
//     box's 256-byte limit, and other page sizes).
// Scales come by 4-byte cp.async a token either way.
template <int D, bool kCap>
__global__ void __launch_bounds__(DecCodeShape<D>::kThreads, code_min_blocks<D>())
decode_codes_kernel(const __nv_bfloat16* __restrict__ q,
                    const int8_t* __restrict__ k_pool,
                    const float* __restrict__ ks,  // [NP, PS, Hk] scales
                    const int8_t* __restrict__ v_pool,
                    const float* __restrict__ vs,
                    const __grid_constant__ CUtensorMap k_map,  // box_rows > 0 only
                    const __grid_constant__ CUtensorMap v_map,
                    const int* __restrict__ page_table,
                    const int* __restrict__ kv_lens,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part,
                    int B, int Hk, int G, int PS, int MP, int split,
                    int window, int box_rows, ScoreMap sm) {
  using Sh = DecCodeShape<D>;
  constexpr int kW = Sh::kWarps;
  // the merge (a programmatic dependent launch) may be scheduled now; it
  // waits for this grid to complete before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(128) unsigned char smem[];
  int c_begin, c_end;
  bool direct;
  if (!split_range<D, Sh::kThreads>(kv_lens, part, B, Hk, G, PS, MP, split, window,
                                     c_begin, c_end, direct)) {
    return;
  }
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int a_begin = c_begin & ~(kTile - 1);
  const int n_tiles = c_end > c_begin ? (c_end - a_begin + kTile - 1) / kTile : 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int* pt = page_table + (size_t)b * MP;
  const size_t row_stride = (size_t)Hk * D;

  unsigned char* slot = smem + warp * Sh::kTileBytes;  // K codes, then V codes
  float* sSc = reinterpret_cast<float*>(smem + Sh::kScaleOff) + warp * 2 * kTile;
  const uint32_t bar = smem_u32(smem + Sh::kBarOff) + 8 * warp;
  if (lane == 0) mbar_init(bar, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // scales of tokens never copied stay finite (0 x p = 0); their codes,
  // whatever bytes the slot holds, are finite numbers
  for (int i = lane; i < 2 * kTile; i += 32) sSc[i] = 0.f;
  __syncwarp();  // the warp's barrier and zeroed scales are visible to it

  // the warp's u-th tile is t = warp + u * kW. Lane j handles the tile's
  // tokens j / 2 + 16 i (K for even j, V for odd): the scale (and, without
  // boxes, the row) of a visible token, and the box of a page (or 64-row
  // run) that starts there and holds a visible token. The page-table
  // entries are read first (pages), all four loads in flight together,
  // then the copies go out (copies)
  auto pages = [&](int t, int (&pg)[4]) {
    const int c0 = a_begin + t * kTile;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tok = (lane >> 1) + 16 * i;
      const int c = c0 + tok;
      const bool seen = c >= c_begin && c < c_end;
      const bool box = box_rows > 0 && tok % box_rows == 0 && c + box_rows > c_begin &&
                       c < c_end;
      pg[i] = seen || box ? __ldg(pt + max(c, c_begin) / PS) : -1;
    }
  };
  auto copies = [&](int t, const int (&pg)[4]) {
    const int c0 = a_begin + t * kTile;
    const int is_v = lane & 1;
    if (lane == 0) {
      const int v_lo = max(c_begin, c0) - c0;  // the tile's visible tokens
      const int v_hi = min(c_end, c0 + kTile) - c0;
      mbar_expect_tx(bar, box_rows > 0 ? 2 * ((v_hi - 1) / box_rows - v_lo / box_rows + 1) *
                                            box_rows * Sh::kSlot
                                      : 2 * (v_hi - v_lo) * D);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (pg[i] < 0) continue;
      const int tok = (lane >> 1) + 16 * i;
      const int c = c0 + tok;
      const size_t cell = (size_t)pg[i] * PS + c % PS;
      if (c >= c_begin && c < c_end) {
        if (box_rows == 0) {
          bulk_copy(smem_u32(slot + (is_v * kTile + tok) * Sh::kSlot),
                    (is_v ? v_pool : k_pool) + cell * row_stride + (size_t)h * D, D, bar);
        }
        cp_async4(smem_u32(sSc + is_v * kTile + tok), (is_v ? vs : ks) + cell * Hk + h);
      }
      if (box_rows > 0 && tok % box_rows == 0) {
        tma_load_3d(smem_u32(slot + (is_v * kTile + tok) * Sh::kSlot), is_v ? &v_map : &k_map,
                    bar, 0, h, static_cast<int>(cell));
      }
    }
  };
  // the warp's first tile; one cp.async group a tile
  if (warp < n_tiles) {
    int pg[4];
    pages(warp, pg);
    copies(warp, pg);
    cp_async_commit();
  }

  const int t4 = lane & 3;
  RowsT<D> st;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
    st.vis[i] = 2 * t4 + i < G ? c_end - 1 : -1;
  }
  if (warp < n_tiles) {
    uint32_t qb[D / 16][2];
    q_frags_t<D>(qb, q + (size_t)(b * Hk + h) * G * D, G);
    for (int u = 0, t = warp; t < n_tiles; ++u, t += kW) {
      const int t_next = t + kW;  // the tile that refills the slot
      int pg[4];
      if (t_next < n_tiles) pages(t_next, pg);  // in flight under the products
      // the tile's scales have landed; the __syncwarp shows them to every
      // lane
      cp_async_wait<0>();
      mbar_wait(bar, u & 1);
      __syncwarp();
      const int c0 = a_begin + t * kTile;
      tile_update_codes_t<D, kCap>(qb, slot, c0, c_begin, c0 >= c_begin && c0 + kTile <= c_end,
                                   sm, st, sSc);
      __syncwarp();  // every lane is done with the slot
      if (t_next < n_tiles) {
        copies(t_next, pg);
        cp_async_commit();
      }
    }
  }
  cp_async_wait<0>();
  // the row sums over the 8 lanes of each t4
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int x = 4; x < 32; x <<= 1) st.l[i] += __shfl_xor_sync(0xffffffffu, st.l[i], x);
  __syncthreads();  // every slot is consumed: its memory takes the combine area

  // O^T's registers back to rows in natural column order
  float* sO = reinterpret_cast<float*>(smem);  // [kW][8][D]
  float* sM = sO + kW * 8 * D;                  // [kW][8]
  float* sL = sM + kW * 8;
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * t4 + i;
    if (r < G) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        *reinterpret_cast<float2*>(sO + (warp * 8 + r) * D + 16 * j + 2 * g) =
            make_float2(st.o[j][i], st.o[j][2 + i]);
      if (g == 0) {
        sM[warp * 8 + r] = st.m[i];
        sL[warp * 8 + r] = st.l[i];
      }
    }
  }
  __syncthreads();
  combine_warps<D, kW>(smem, out, part, B, Hk, G, direct);
}

// Grid (Hk, B), 96 threads: each row longer than one split merges its
// splits' partials in split order (merge_splits) and writes bf16.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part, const int* __restrict__ kv_lens,
                    __nv_bfloat16* __restrict__ out, int B, int Hk, int G, int PS,
                    int MP, int split) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvl = min(kv_lens[b], MP * PS);
  if (kvl <= split) return;  // written by its one block
  const size_t row0 = ((size_t)(b * Hk + h)) * G;
  merge_splits<D, kThreads>(part + row0 * (D + 4), (size_t)B * Hk * G * (D + 4),
                            (kvl + split - 1) / split, G,
                            [=](int r) { return out + (row0 + r) * D; });
}

// The int8 launches' merge, grid (Hk, B), kCodeMergeThreads threads (one
// (row, 4 dims) item each): a programmatic dependent of the split kernel,
// so it is scheduled while that grid runs and waits for its memory here;
// merge_splits' result in one pass (paged_flash.cuh merge_splits_chunked).
template <int D>
__global__ void __launch_bounds__(kCodeMergeThreads)
decode_merge_codes_kernel(const float* __restrict__ part, const int* __restrict__ kv_lens,
                          __nv_bfloat16* __restrict__ out, int B, int Hk, int G, int PS,
                          int MP, int split) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvl = min(kv_lens[b], MP * PS);
  if (kvl <= split) return;  // written by its one block
  const size_t row0 = ((size_t)(b * Hk + h)) * G;
  merge_splits_chunked<D, kCodeMergeThreads>(
      part + row0 * (D + 4), (size_t)B * Hk * G * (D + 4), (kvl + split - 1) / split, G,
      [=](int r) { return out + (row0 + r) * D; });
}

template <int D, bool kCap>
int launch(int B, int Hk, int NS, cudaStream_t st, const __nv_bfloat16* q,
           const __nv_bfloat16* k, const __nv_bfloat16* v, const int* pt, const int* kl,
           __nv_bfloat16* out, float* part, int G, int PS, int MP, int split, int window,
           const ScoreMap& sm) {
  constexpr int smem = DecShape<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<D, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<D, kCap><<<dim3(Hk, B, NS), kThreads, smem, st>>>(
      q, k, v, pt, kl, out, part, B, Hk, G, PS, MP, split, window, sm);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS < 2) return static_cast<int>(err);
  decode_merge_kernel<D><<<dim3(Hk, B), kThreads, 0, st>>>(part, kl, out, B, Hk, G,
                                                             PS, MP, split);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCap>
int launch_codes(int B, int Hk, int NS, cudaStream_t st, const __nv_bfloat16* q,
                 const KvPools& kv, const CUtensorMap& k_map, const CUtensorMap& v_map,
                 int box_rows, const int* pt, const int* kl, __nv_bfloat16* out,
                 float* part, int G, int PS, int MP, int split, int window,
                 const ScoreMap& sm) {
  using Sh = DecCodeShape<D>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_codes_kernel<D, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_codes_kernel<D, kCap><<<dim3(Hk, B, NS), Sh::kThreads, Sh::kSmemBytes, st>>>(
      q, static_cast<const int8_t*>(kv.k), kv.ks, static_cast<const int8_t*>(kv.v), kv.vs,
      k_map, v_map, pt, kl, out, part, B, Hk, G, PS, MP, split, window, box_rows, sm);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS < 2) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hk, B);
  cfg.blockDim = dim3(kCodeMergeThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, decode_merge_codes_kernel<D>, part, kl,
                                             out, B, Hk, G, PS, MP, split));
}

// -- int8 page boxes: tensor maps on the host -------------------------------

// rows a page box of the int8 kernel at (D, PS): min(PS, 64) when that is a
// whole number of 8-row (128-byte aligned) slot runs a tile holds whole, at
// D + 16 <= 256 (a box's widest row); else 0: one copy a token row
int box_rows(int D, int PS) {
  const int r = PS < kTile ? PS : kTile;
  return D + 16 <= 256 && r % 8 == 0 && (PS % kTile == 0 || kTile % PS == 0) ? r : 0;
}

// an int8 pool's codes [NP, PS, Hk, D] as a 3-D map {D, Hk, NP PS} with
// boxes {D + 16, 1, rows}: the 16 bytes past a row are out of bounds and
// land as zeros. Pools live as long as their runner, so maps are kept,
// keyed by pointer and shape.
bool page_map(CUtensorMap* map, const void* ptr, int NP, int PS, int Hk, int D, int rows) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(ptr, NP, PS, Hk, D);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiled fn = encoder();
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hk),
                              static_cast<cuuint64_t>(NP) * PS};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D),
                                 static_cast<cuuint64_t>(Hk) * D};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D + 16), 1,
                             static_cast<cuuint32_t>(rows)};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (!fn || fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// the body for (D, soft cap or not, int8 or bf16): the plain path carries
// no cap code, and the bf16 kernel no int8 code
template <int D>
int launch_d(bool cap, int B, int Hk, int NS, int NP, cudaStream_t st,
             const __nv_bfloat16* q, const KvPools& kv, const int* pt, const int* kl,
             __nv_bfloat16* out, float* part, int G, int PS, int MP, int split,
             int window, const ScoreMap& sm) {
  if (kv.ks == nullptr) {
    const auto* k = static_cast<const __nv_bfloat16*>(kv.k);
    const auto* v = static_cast<const __nv_bfloat16*>(kv.v);
    return cap ? launch<D, true>(B, Hk, NS, st, q, k, v, pt, kl, out, part, G, PS, MP, split,
                                 window, sm)
               : launch<D, false>(B, Hk, NS, st, q, k, v, pt, kl, out, part, G, PS, MP,
                                  split, window, sm);
  }
  CUtensorMap k_map = {}, v_map = {};
  const int rows = box_rows(D, PS);
  if (rows > 0 && (!page_map(&k_map, kv.k, NP, PS, Hk, D, rows) ||
                   !page_map(&v_map, kv.v, NP, PS, Hk, D, rows))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return cap ? launch_codes<D, true>(B, Hk, NS, st, q, kv, k_map, v_map, rows, pt, kl, out,
                                     part, G, PS, MP, split, window, sm)
             : launch_codes<D, false>(B, Hk, NS, st, q, kv, k_map, v_map, rows, pt, kl, out,
                                      part, G, PS, MP, split, window, sm);
}

}  // namespace

// part: f32 scratch [NS, B, Hk, G, D + 4], NS = ceil(MP * PS / split); only
// the splits of rows longer than one split are written. k_scales and
// v_scales: nullptr for bf16 pools; for int8 pools (codes [NP, PS, Hk, D])
// their f32 scales [NP, PS, Hk].
extern "C" int decode_paged_attention(const void* q, const void* k_pool,
                                      const void* k_scales, const void* v_pool,
                                      const void* v_scales, const void* page_table,
                                      const void* kv_lens, void* out, void* part,
                                      int B, int Hk, int G, int D, int PS, int MP, int NP,
                                      int split, int window, float scale,
                                      float softcap, void* stream) {
  if (B == 0) return 0;
  if (G < 1 || G > 8 || split < paged_flash::kTile || split % paged_flash::kTile ||
      (k_scales == nullptr) != (v_scales == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int NS = (MP * PS + split - 1) / split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const KvPools kv{k_pool, static_cast<const float*>(k_scales), v_pool,
                 static_cast<const float*>(v_scales)};
  const auto* pt = static_cast<const int*>(page_table);
  const auto* kl = static_cast<const int*>(kv_lens);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  auto* pp = static_cast<float*>(part);
  const paged_flash::ScoreMap sm = paged_flash::score_map(scale, softcap);
  const bool cap = softcap > 0.f;
  if (D == 128) {
    return launch_d<128>(cap, B, Hk, NS, NP, st, qq, kv, pt, kl, oo, pp, G, PS, MP,
                         split, window, sm);
  }
  if (D == 64) {
    return launch_d<64>(cap, B, Hk, NS, NP, st, qq, kv, pt, kl, oo, pp, G, PS, MP,
                        split, window, sm);
  }
  if (D == 256) {
    return launch_d<256>(cap, B, Hk, NS, NP, st, qq, kv, pt, kl, oo, pp, G, PS, MP,
                         split, window, sm);
  }
  if (D == 96) {
    return launch_d<96>(cap, B, Hk, NS, NP, st, qq, kv, pt, kl, oo, pp, G, PS, MP,
                        split, window, sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
