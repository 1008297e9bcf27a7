// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dynamo_tpu/ops/ragged_paged_attention.py
// `ragged_paged_attention` (body `_ragged_kernel_body`), its bf16 bodies
// `_ragged_kernel` and `_ragged_kernel_win` and its int8 bodies
// `_ragged_kernel_int8` and `_ragged_kernel_int8_win` (codes and scales as
// paged_flash.cuh's kI8 describes; the split partials fold the scales
// before they are written, so the merge is the bf16 one), with the static
// softcap and scale, at head dims 64, 96, 128 and 256: one flat [T, Hk, G, D]
// query axis
// holds decode rows (one token
// each), prefill chunks and speculative-verify rows (K+1 tokens), each
// segment attending causally over its own paged context in the token-major
// pool [NP, PS, Hk, D]. The host cuts the axis into work units
// (meta [5, NW]: seg, q block, first row, row count, position of the first
// row; ops/ragged_paged_attention.py); rows of the dummy tail segment
// (kv_len 0) come out 0. With a window w > 0 each flat token at position
// p sees only positions c > p - w.
//
// What bounds it on an H100: at the main path's shapes (T 264, Hk 8, G 3,
// D 128, PS 16: eight decode rows over up to 4096 tokens and four chunks
// of 16-125 tokens over up to 3000 prior tokens) the bytes are each
// segment's visible K/V read once, ~68 MB, about 20 us at 3.35 TB/s;
// the two products are ~2.8 GFLOP, under 3 us of bf16 tensor-core time.
// So it is bound by bytes. What holds it back is the traffic from L2 into
// shared memory: each 8-token unit of a chunk copies its segment's whole
// visible context again, ~158 MB in all for the 68 MB of K/V.
//
// Design: the tile body of paged_flash.cuh (bf16 tiles of 64 tokens
// through a ring of bulk copies, both products on tensor cores, softmax
// in registers), 128 threads and 64 rows a block (a unit holds at most
// q_block * G rows), with the context split over blocks
// (flash-decoding): grid (NW, Hk, NS), NS = ceil(MP * PS / split) from
// the page table's width, a shape, so the launch needs no host sync.
// Block (w, h, z) walks positions [z * split, min((z + 1) * split,
// last_pos + 1)) of unit w, last_pos = min(qpos0 + rows - 1, kv_len - 1),
// and returns at once when that range is empty. CUDA blocks run in no
// order, so one block per (unit, head) walking a whole 4096-token row
// alone set the time of the whole launch; split, that row is 8 blocks of
// 8 tiles each.
//   - A unit whose last position falls in split 0 is one block: it
//     writes its own rows (rs .. rs + rows) of `out` in bf16, and only
//     those. Every row of [0, T) belongs to exactly one unit, so `out`
//     needs no initialisation.
//   - A longer unit's blocks write f32 partials per row (the unnormalised
//     O, the running max m in base-2 units, the sum l) to the scratch the
//     wrapper allocates, [NS, NW, Hk, q_block * G, D + 4]; then
//     `ragged_merge_kernel`, launched by the same call on the same stream,
//     merges each such unit's splits by log-sum-exp in split order and
//     writes bf16. A split in which a row sees no key has m = -1e30, l = 0
//     and weighs exactly 0.
// Sliding window: block (w, h, z) starts at max(z * split, the unit's
// first token's position - w + 1), the index map's low clamp. A split
// wholly below the window stages nothing and writes the empty partial
// (m = -1e30, l = 0, O = 0), which the merge weighs 0.
// Idle rows: a decode unit fills G of a block's 64 rows (one warp's mma
// with 3 live rows). In the bf16 bodies the idle warps get no share of
// each tile's tokens: clock stamps on an H100 put a tile's products and
// softmax in one warp at about a third of the time a tile takes to
// arrive, so the loads, not the products, set a block's pace.
// int8 pools (paged_flash.cuh attend_codes): the stages hold the codes
// (three deep; two at D 256, where that lets two blocks share an SM:
// kCodeStages) and each warp builds its bf16 fragments from them in
// registers, integer work that a single warp would do alone for a decode
// unit. So there the idle warps do share: a unit whose rows fill one (two)
// of the 4 warps splits each tile's tokens 4 (2) ways, and the parts'
// softmax states are merged at the end; only the merged rows are written.
// That made the 3B shape's int8 step faster than its bf16 one on an H100
// (PERF.md section 6).

#include <type_traits>

#include "paged_flash.cuh"

namespace {

using namespace paged_flash;

constexpr int kWarps = 4;  // 64 query rows: a unit's q_block * G at most
constexpr int kThreads = 32 * kWarps;
// int8 ring depth (attend_codes) by head dim: at D 256 two stages let two
// blocks share an SM
template <int D>
constexpr int kCodeStages = D == 256 ? 2 : 3;

struct Unit {
  int n_tok, seg, t0, qpos0, last_pos;
};

__device__ __forceinline__ Unit read_unit(const int* __restrict__ meta,
                                          const int* __restrict__ seg_kv_lens,
                                          int NW, int w, int PS, int MP, int QB) {
  Unit u;
  u.n_tok = meta[3 * NW + w];
  u.seg = meta[w];
  u.t0 = meta[NW + w] * QB + meta[2 * NW + w];  // first flat token
  u.qpos0 = meta[4 * NW + w];
  const int kvl = u.n_tok > 0 ? min(seg_kv_lens[u.seg], MP * PS) : 0;
  u.last_pos = min(u.qpos0 + u.n_tok - 1, kvl - 1);
  return u;
}

template <int D, bool kCap, bool kWin, bool kI8>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const __nv_bfloat16* __restrict__ q,
              const void* __restrict__ k_pool,
              const float* __restrict__ ks,  // kI8: [NP, PS, Hk] scales
              const void* __restrict__ v_pool,
              const float* __restrict__ vs,
              const int* __restrict__ seg_page_table,
              const int* __restrict__ seg_kv_lens,
              const int* __restrict__ meta,
              __nv_bfloat16* __restrict__ out,
              float* __restrict__ part,
              int NW, int Hk, int G, int PS, int MP, int QB, int split,
              int window, ScoreMap sm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const Unit u = read_unit(meta, seg_kv_lens, NW, w, PS, MP, QB);
  if (u.n_tok <= 0) return;  // padding unit (uniform over the block)
  // split 0 always runs: it writes the rows of a unit with no context
  if (z > 0 && z * split > u.last_pos) return;
  // the first position a query at p sees (0 without a window)
  auto first_seen = [&](int p) { return kWin ? max(p - window + 1, 0) : 0; };
  const int c_begin = max(z * split, first_seen(u.qpos0));
  const int c_end = min(z * split + split, u.last_pos + 1);
  const int rows = u.n_tok * G;
  float* base = part + (((size_t)z * NW + w) * Hk + h) * (size_t)(QB * G) * (D + 4);
  if (kWin && c_begin >= c_end && u.last_pos >= split) {
    // a split wholly below the window: the empty partial, nothing staged
    for (int i = threadIdx.x; i < rows * (D + 4); i += kThreads) {
      const int d = i % (D + 4);
      base[(size_t)(i / (D + 4)) * (D + 4) + d] = d == D ? kNegInf : 0.f;
    }
    return;
  }

  auto q_offset = [&](int r) {  // row r = token (r / G) x group (r % G)
    return (((size_t)(u.t0 + r / G) * Hk + h) * G + r % G) * D;
  };
  RowState<D> st;
  auto q_row = [&](int r) -> const __nv_bfloat16* {
    return r < rows ? q + q_offset(r) : nullptr;
  };
  auto row_span = [&](int r) {
    if (r >= rows) return make_int2(0, -1);
    const int p = u.qpos0 + r / G;
    return make_int2(first_seen(p), min(p, u.last_pos));
  };
  if constexpr (kI8) {
    // warps whose token share was merged into another's write nothing
    if (!attend_codes<D, kWarps, kCodeStages<D>, 1, kCap, kWin>(
            smem, q_row, row_span, static_cast<const int8_t*>(k_pool), ks,
            static_cast<const int8_t*>(v_pool), vs, seg_page_table + (size_t)u.seg * MP,
            PS, Hk, h, c_begin, c_end, sm, &st)) {
      return;
    }
  } else {
    attend<D, kWarps, kCap, kWin>(smem, q_row, row_span, k_pool, v_pool,
                                  seg_page_table + (size_t)u.seg * MP, PS, Hk, h, c_begin,
                                  c_end, sm, st);
  }

  if (u.last_pos < split) {  // one split: the rows go straight to out
    store_rows<D, kI8>([&](int r) -> __nv_bfloat16* {
      return r < rows ? out + q_offset(r) : nullptr;
    }, st);
    return;
  }
  // partials of split z: per row D values of O, then m, l
  const int lane = threadIdx.x & 31;
  const int r0 = kI8 ? st.r0 : (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= rows) continue;
    float* p = base + (size_t)r * (D + 4);
    if constexpr (kI8) {  // O's columns in code_cols' order
#pragma unroll
      for (int c = 0; c < D / 32; ++c)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float4*>(p + c * 32 + hh * 16 + 4 * (lane & 3)) =
              code_cols(st, c, hh, i);
    } else {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<float2*>(p + n * 8 + 2 * (lane & 3)) =
            make_float2(st.o[n][2 * i], st.o[n][2 * i + 1]);
      }
    }
    if ((lane & 3) == 0) *reinterpret_cast<float2*>(p + D) = make_float2(st.m[i], st.l[i]);
  }
}

// Grid (NW, Hk), 128 threads: each unit that spans more than one split
// merges its splits' partials per row, in split order, and writes bf16.
template <int D>
__global__ void __launch_bounds__(kThreads)
ragged_merge_kernel(const float* __restrict__ part,
                    const int* __restrict__ seg_kv_lens,
                    const int* __restrict__ meta,
                    __nv_bfloat16* __restrict__ out,
                    int NW, int Hk, int G, int PS, int MP, int QB, int split) {
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const Unit u = read_unit(meta, seg_kv_lens, NW, w, PS, MP, QB);
  if (u.n_tok <= 0 || u.last_pos < split) return;  // written by its one block
  const int n_split = u.last_pos / split + 1;
  const size_t split_stride = (size_t)NW * Hk * (QB * G) * (D + 4);
  const float* base = part + ((size_t)w * Hk + h) * (size_t)(QB * G) * (D + 4);
  merge_splits<D, kThreads>(base, split_stride, n_split, u.n_tok * G, [&](int r) {
    return out + (((size_t)(u.t0 + r / G) * Hk + h) * G + r % G) * D;
  });
}

template <int D, bool kCap, bool kWin, bool kI8>
int launch(int NW, int Hk, int NS, cudaStream_t st, const __nv_bfloat16* q,
           const KvPools& kv, const int* pt, const int* kl, const int* mt,
           __nv_bfloat16* out, float* part, int G, int PS, int MP, int QB,
           int split, int window, const ScoreMap& sm) {
  constexpr int smem = kI8 ? CodeShape<D, kWarps, kCodeStages<D>>::kSmemBytes
                           : Shape<D, kWarps>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ragged_kernel<D, kCap, kWin, kI8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_kernel<D, kCap, kWin, kI8><<<dim3(NW, Hk, NS), kThreads, smem, st>>>(
      q, kv.k, kv.ks, kv.v, kv.vs, pt, kl, mt, out, part, NW, Hk, G, PS, MP, QB, split,
      window, sm);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS < 2) return static_cast<int>(err);
  ragged_merge_kernel<D><<<dim3(NW, Hk), kThreads, 0, st>>>(
      part, kl, mt, out, NW, Hk, G, PS, MP, QB, split);
  return static_cast<int>(cudaGetLastError());
}

// the body for (D, soft cap or not, window or not, int8 or bf16): the
// plain path carries no cap, window or int8 code
template <int D>
int launch_d(bool cap, int NW, int Hk, int NS, cudaStream_t st,
             const __nv_bfloat16* q, const KvPools& kv, const int* pt, const int* kl,
             const int* mt, __nv_bfloat16* out, float* part, int G, int PS, int MP,
             int QB, int split, int window, const ScoreMap& sm) {
  auto go = [&](auto cap_t, auto win_t, auto i8_t) {
    return launch<D, decltype(cap_t)::value, decltype(win_t)::value,
                  decltype(i8_t)::value>(NW, Hk, NS, st, q, kv, pt, kl, mt, out, part,
                                         G, PS, MP, QB, split, window, sm);
  };
  using T = std::true_type;
  using F = std::false_type;
  if (kv.ks != nullptr) {
    if (window > 0) return cap ? go(T{}, T{}, T{}) : go(F{}, T{}, T{});
    return cap ? go(T{}, F{}, T{}) : go(F{}, F{}, T{});
  }
  if (window > 0) return cap ? go(T{}, T{}, F{}) : go(F{}, T{}, F{});
  return cap ? go(T{}, F{}, F{}) : go(F{}, F{}, F{});
}

}  // namespace

// part: f32 scratch [NS, NW, Hk, q_block * G, D + 4], NS = ceil(MP * PS /
// split); only the splits of units longer than one split are written.
// k_scales, v_scales: nullptr for bf16 pools; for int8 pools (codes [NP,
// PS, Hk, D]) their f32 scales [NP, PS, Hk].
extern "C" int ragged_paged_attention(
    const void* q, const void* k_pool, const void* k_scales, const void* v_pool,
    const void* v_scales, const void* seg_page_table, const void* seg_kv_lens,
    const void* meta, void* out, void* part, int NW, int Hk, int G, int D, int PS,
    int MP, int q_block, int split, int window, float scale, float softcap,
    void* stream) {
  if (NW == 0) return 0;
  if (q_block < 1 || q_block * G > 16 * kWarps || split < paged_flash::kTile ||
      split % paged_flash::kTile || (k_scales == nullptr) != (v_scales == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int NS = (MP * PS + split - 1) / split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const KvPools kv{k_pool, static_cast<const float*>(k_scales), v_pool,
                 static_cast<const float*>(v_scales)};
  const auto* pt = static_cast<const int*>(seg_page_table);
  const auto* kl = static_cast<const int*>(seg_kv_lens);
  const auto* mt = static_cast<const int*>(meta);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  auto* pp = static_cast<float*>(part);
  const paged_flash::ScoreMap sm = paged_flash::score_map(scale, softcap);
  const bool cap = softcap > 0.f;
  if (D == 128) {
    return launch_d<128>(cap, NW, Hk, NS, st, qq, kv, pt, kl, mt, oo, pp, G,
                         PS, MP, q_block, split, window, sm);
  }
  if (D == 64) {
    return launch_d<64>(cap, NW, Hk, NS, st, qq, kv, pt, kl, mt, oo, pp, G,
                        PS, MP, q_block, split, window, sm);
  }
  if (D == 256) {
    return launch_d<256>(cap, NW, Hk, NS, st, qq, kv, pt, kl, mt, oo, pp, G,
                         PS, MP, q_block, split, window, sm);
  }
  if (D == 96) {
    return launch_d<96>(cap, NW, Hk, NS, st, qq, kv, pt, kl, mt, oo, pp, G,
                        PS, MP, q_block, split, window, sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
