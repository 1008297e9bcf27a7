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
//     and `_int8_win`, template flag kI8): a tile's codes arrive by bulk
//     copies of D bytes into the last D bytes of each row slot and its
//     scales by 4-byte cp.async into the warp's scale slab; the warp
//     converts its slot to bf16 in place (paged_flash.cuh convert_rows)
//     and tile_update folds the K scale into the raw scores and the V
//     scale into p after the row sum. Half the bytes of the bf16 body
//     plus 8 bytes a token and head of scales: (D + 4) / 2 D of them at
//     D 128, 0.52.
//   - The warps' (m, l, O) are combined through shared memory in warp
//     order. A row whose context fits one split writes its bf16 output
//     directly; a longer row's blocks write f32 partials (O, m, l) to the
//     wrapper's scratch [NS, B, Hk, G, D + 4], and decode_merge_kernel,
//     launched by the same call on the same stream, merges them by
//     log-sum-exp in split order (paged_flash.cuh merge_splits, shared
//     with the ragged kernel). No atomics: results are the same bit for
//     bit from run to run.

#include <type_traits>

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
  // Q, then per warp a K tile and a V tile, then one mbarrier a warp; int8
  // adds a scale slab a warp [kWarps][2][kTile] f32
  static constexpr int kBarOff = (kQElems + 2 * kWarps * kTileElems) * 2;
  static constexpr int kSmemBytes = kBarOff + 8 * kWarps;
  static constexpr int kScaleOff = kSmemBytes;
  static constexpr int kSmemBytesI8 = kScaleOff + kWarps * 2 * kTile * 4;
  // the combine area (per warp 8 rows of O, m, l) reuses the tile slots
  static_assert(kWarps * 8 * (D + 2) * 4 <= 2 * kWarps * kTileElems * 2,
                "combine area larger than the slots");
};

template <int D, bool kCap, bool kI8>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const void* __restrict__ k_pool,
                    const float* __restrict__ ks,  // kI8: [NP, PS, Hk] scales
                    const void* __restrict__ v_pool,
                    const float* __restrict__ vs,
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

  constexpr int kElem = kI8 ? 1 : 2;  // bytes a pool element
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
  float* sSc = reinterpret_cast<float*>(smem + Sh::kScaleOff) + warp * 2 * kTile;  // kI8
  if constexpr (kI8) {  // scales of tokens never copied stay finite
    for (int i = lane; i < 2 * kTile; i += 32) sSc[i] = 0.f;
    __syncwarp();
  }
  // tile t into this warp's slot: lane j copies token rows j / 2, (j + 32) / 2,
  // ... (K for even j, V for odd; with kI8 the codes into the slot's last D
  // bytes and the scale into the warp's slab). The bf16 V rows of a partial
  // tile's missing tokens are zeroed (other addresses than the copies'), so
  // their P = 0 never meets stale bits; int8 rows convert to finite values
  // whatever their bytes. The warp syncs before it reads the slot.
  auto issue = [&](int t) {
    const int c0 = c_begin + t * kTile;
    const int n = min(kTile, c_end - c0);
    if (lane == 0) mbar_expect_tx(bar, n * D * 2 * kElem);
    for (int j = lane; j < 2 * n; j += 32) {
      const int c = c0 + (j >> 1);
      const int is_v = j & 1;
      const size_t cell = (size_t)__ldg(pt + c / PS) * PS + c % PS;
      const size_t off = (cell * row_stride + (size_t)h * D) * kElem;
      unsigned char* dst =
          reinterpret_cast<unsigned char*>(sK + is_v * Sh::kTileElems + (j >> 1) * Sh::kStride);
      bulk_copy(smem_u32(dst + (kI8 ? D + 16 : 0)),
                static_cast<const unsigned char*>(is_v ? v_pool : k_pool) + off, D * kElem, bar);
      if constexpr (kI8) {
        cp_async4(smem_u32(sSc + is_v * kTile + (j >> 1)), (is_v ? vs : ks) + cell * Hk + h);
      }
    }
    if constexpr (kI8) {
      cp_async_commit();
    } else {
      for (int i = n * (D / 8) + lane; i < kTile * (D / 8); i += 32) {
        *reinterpret_cast<uint4*>(sK + Sh::kTileElems + (i / (D / 8)) * Sh::kStride +
                                  (i % (D / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
      }
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
      if constexpr (kI8) {
        // the warp's slot to bf16; the one outstanding scale group is this
        // tile's
        convert_rows<D, 2 * Sh::kStride, 2 * kTile>(reinterpret_cast<unsigned char*>(sK));
        cp_async_wait<0>();
        fence_proxy_async();  // the converted rows before the slot's refill
      }
      __syncwarp();  // the zeroed (or converted) rows and the scales are visible
      const int c0 = c_begin + t * kTile;
      // no window mask: every position the block walks is visible
      tile_update<D, kCap, false, kI8>(qf, sK, c0, c0 + kTile <= c_end, sm, st, sSc);
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

template <int D, bool kCap, bool kI8>
int launch(int B, int Hk, int NS, cudaStream_t st, const __nv_bfloat16* q,
           const KvPools& kv, const int* pt, const int* kl, __nv_bfloat16* out,
           float* part, int G, int PS, int MP, int split, int window,
           const ScoreMap& sm) {
  constexpr int smem = kI8 ? DecShape<D>::kSmemBytesI8 : DecShape<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<D, kCap, kI8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<D, kCap, kI8><<<dim3(Hk, B, NS), kThreads, smem, st>>>(
      q, kv.k, kv.ks, kv.v, kv.vs, pt, kl, out, part, B, Hk, G, PS, MP, split, window, sm);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS < 2) return static_cast<int>(err);
  decode_merge_kernel<D><<<dim3(Hk, B), kThreads, 0, st>>>(part, kl, out, B, Hk, G,
                                                             PS, MP, split);
  return static_cast<int>(cudaGetLastError());
}

// the body for (D, soft cap or not, int8 or bf16): the plain path carries
// no cap or int8 code
template <int D>
int launch_d(bool cap, int B, int Hk, int NS, cudaStream_t st,
             const __nv_bfloat16* q, const KvPools& kv, const int* pt, const int* kl,
             __nv_bfloat16* out, float* part, int G, int PS, int MP, int split,
             int window, const ScoreMap& sm) {
  auto go = [&](auto cap_t, auto i8_t) {
    return launch<D, decltype(cap_t)::value, decltype(i8_t)::value>(
        B, Hk, NS, st, q, kv, pt, kl, out, part, G, PS, MP, split, window, sm);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (kv.ks != nullptr) return cap ? go(T{}, T{}) : go(F{}, T{});
  return cap ? go(T{}, F{}) : go(F{}, F{});
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
                                      int B, int Hk, int G, int D, int PS, int MP,
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
    return launch_d<128>(cap, B, Hk, NS, st, qq, kv, pt, kl, oo, pp, G, PS, MP,
                         split, window, sm);
  }
  if (D == 64) {
    return launch_d<64>(cap, B, Hk, NS, st, qq, kv, pt, kl, oo, pp, G, PS, MP,
                        split, window, sm);
  }
  if (D == 256) {
    return launch_d<256>(cap, B, Hk, NS, st, qq, kv, pt, kl, oo, pp, G, PS, MP,
                         split, window, sm);
  }
  if (D == 96) {
    return launch_d<96>(cap, B, Hk, NS, st, qq, kv, pt, kl, oo, pp, G, PS, MP,
                        split, window, sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
