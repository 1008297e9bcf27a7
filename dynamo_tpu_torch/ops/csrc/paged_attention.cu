// Decode paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dynamo_tpu/ops/paged_attention.py
// `decode_paged_attention` (body `_decode_kernel_body`), its bf16 bodies
// `_decode_kernel` and `_decode_kernel_win` with the static softcap and
// scale, at head dims 64, 128 and 256: one query token per sequence, all
// G query heads of each kv-head, attends over the sequence's pages of a
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
//   - The warps' (m, l, O) are combined through shared memory in warp
//     order. A row whose context fits one split writes its bf16 output
//     directly; a longer row's blocks write f32 partials (O, m, l) to the
//     wrapper's scratch [NS, B, Hk, G, D + 4], and decode_merge_kernel,
//     launched by the same call on the same stream, merges them by
//     log-sum-exp in split order (paged_flash.cuh merge_splits, shared
//     with the ragged kernel). No atomics: results are the same bit for
//     bit from run to run.

#include "paged_flash.cuh"

namespace {

using namespace paged_flash;

constexpr int kWarps = 3;
constexpr int kThreads = 32 * kWarps;

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
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int kvl = min(kv_lens[b], MP * PS);
  if (z > 0 && z * split >= kvl) return;  // uniform over the block
  // the query sits at kvl - 1: with a window it sees [kvl - window, kvl)
  const int lo = window > 0 ? max(kvl - window, 0) : 0;
  const int c_begin = max(z * split, lo);
  const int c_end = min(z * split + split, kvl);
  const bool direct = kvl <= split;  // one split: bf16 out, else partials
  if (c_begin >= c_end && !direct) {
    // a split wholly below the window: the empty partial, nothing staged
    for (int i = threadIdx.x; i < G * (D + 4); i += kThreads) {
      const int d = i % (D + 4);
      part[((size_t)z * B * Hk * G + ((size_t)(b * Hk + h)) * G + i / (D + 4)) * (D + 4) +
           d] = d == D ? kNegInf : 0.f;
    }
    return;
  }
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
  // never meets stale bits; the warp syncs before it reads the slot.
  auto issue = [&](int t) {
    const int c0 = c_begin + t * kTile;
    const int n = min(kTile, c_end - c0);
    if (lane == 0) mbar_expect_tx(bar, n * D * 4);
    for (int j = lane; j < 2 * n; j += 32) {
      const int c = c0 + (j >> 1);
      const int is_v = j & 1;
      const size_t off = ((size_t)__ldg(pt + c / PS) * PS + c % PS) * row_stride +
                         (size_t)h * D;
      bulk_copy(smem_u32(sK + is_v * Sh::kTileElems + (j >> 1) * Sh::kStride),
                (is_v ? v_pool : k_pool) + off, D * 2, bar);
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

  // combine the warps in warp order; one split: bf16 out, else partials
  for (int i = tid; i < G * (D / 2); i += kThreads) {
    const int r = i / (D / 2);
    const int d = (i % (D / 2)) * 2;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sM[w * 8 + r]);
    float L = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
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

// Grid (Hk, B), 128 threads: each row longer than one split merges its
// splits' partials in split order and writes bf16.
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

template <int D, bool kCap>
int launch(int B, int Hk, int NS, cudaStream_t st, const __nv_bfloat16* q,
           const __nv_bfloat16* k, const __nv_bfloat16* v, const int* pt,
           const int* kl, __nv_bfloat16* out, float* part, int G, int PS,
           int MP, int split, int window, const ScoreMap& sm) {
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

// the body for (D, soft cap or not): the plain path carries no cap code
template <int D>
int launch_d(bool cap, int B, int Hk, int NS, cudaStream_t st,
             const __nv_bfloat16* q, const __nv_bfloat16* k,
             const __nv_bfloat16* v, const int* pt, const int* kl,
             __nv_bfloat16* out, float* part, int G, int PS, int MP, int split,
             int window, const ScoreMap& sm) {
  return cap ? launch<D, true>(B, Hk, NS, st, q, k, v, pt, kl, out, part, G, PS,
                               MP, split, window, sm)
             : launch<D, false>(B, Hk, NS, st, q, k, v, pt, kl, out, part, G, PS,
                                MP, split, window, sm);
}

}  // namespace

// part: f32 scratch [NS, B, Hk, G, D + 4], NS = ceil(MP * PS / split); only
// the splits of rows longer than one split are written.
extern "C" int decode_paged_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_table,
                                      const void* kv_lens, void* out, void* part,
                                      int B, int Hk, int G, int D, int PS, int MP,
                                      int split, int window, float scale,
                                      float softcap, void* stream) {
  if (B == 0) return 0;
  if (G < 1 || G > 8 || split < paged_flash::kTile || split % paged_flash::kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int NS = (MP * PS + split - 1) / split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vv = static_cast<const __nv_bfloat16*>(v_pool);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* kl = static_cast<const int*>(kv_lens);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  auto* pp = static_cast<float*>(part);
  const paged_flash::ScoreMap sm = paged_flash::score_map(scale, softcap);
  const bool cap = softcap > 0.f;
  if (D == 128) {
    return launch_d<128>(cap, B, Hk, NS, st, qq, kk, vv, pt, kl, oo, pp, G, PS, MP,
                         split, window, sm);
  }
  if (D == 64) {
    return launch_d<64>(cap, B, Hk, NS, st, qq, kk, vv, pt, kl, oo, pp, G, PS, MP,
                        split, window, sm);
  }
  if (D == 256) {
    return launch_d<256>(cap, B, Hk, NS, st, qq, kk, vv, pt, kl, oo, pp, G, PS, MP,
                         split, window, sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
