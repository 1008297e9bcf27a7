// Chunked-prefill paged flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dynamo_tpu/ops/flash_prefill.py
// `prefill_paged_attention` (body `_prefill_kernel_body`), its bf16
// bodies `_prefill_kernel` and `_prefill_kernel_win` and its int8 bodies
// `_prefill_kernel_int8` and `_prefill_kernel_int8_win` (codes and scales
// as paged_flash.cuh's kI8 describes), with the static softcap and scale:
// a chunk of S query tokens per sequence, at absolute
// positions q_start .. q_start + q_len - 1 (padding rows after q_len),
// attends causally over the sequence's whole paged context (prior prefix
// plus the chunk, already written to the token-major pool [NP, PS, Hk,
// D]); with a window w > 0 the row at position p sees only positions
// c > p - w. Padding rows come out 0. Head dims 64, 96, 128 and 256.
//
// What bounds it on an H100: for a 512-token chunk with a few hundred
// prior tokens the QK^T and PV products (4 * D flops per visible
// query-key pair per query head) outweigh the bytes, so the bound is the
// tensor cores' rate. What held it back was how fast tiles reach shared
// memory: every block reads its whole visible context, most of it from
// L2 after a neighbouring block (a 1150-token context of one layer is
// 4.7 MB), so the L2-to-SM traffic is the K/V bytes times the number of
// query blocks.
//
// Design: grid (ceil(S / QB), Hk, B), 256 threads, the tile body of
// paged_flash.cuh: both products on tensor cores (mma.sync, bf16 -> f32)
// from bf16 tiles of 64 context tokens that bulk copies (TMA) fill while
// the previous tile is computed. A block owns QB query tokens of one kv
// head, QB * G <= 128 rows over 8 warps; the wrapper picks QB =
// floor(128 / G), so at G 3 a block fills 126 of its 128 rows. 128 rows
// a block rather than 64 halve the tiles each token's K/V is copied into
// (at S 512, G 3: 13 query blocks a head instead of 25), and the 8 warps
// compute while the copies land. A block walks the context only up to
// the last position its rows can see, min(causal top, kv_len - 1): the
// TPU index-map clamp (flash_prefill.py:248-264) as a trip count, so a
// causal chunk costs about half the rectangle, and tiles wholly below a
// warp's causal limits skip the mask. With a window the walk starts at the
// block's first token's position - w + 1 (the index map's low clamp), so
// a chunk past the window reads w + QB tokens a block, not its whole
// context. Nothing crosses blocks.
//
// D 256 (Gemma-2): 128 Q rows (67.6 KB) and two stages of K and V tiles
// (135 KB) take 203 KB of shared memory, one block an SM; Q's fragments
// are reloaded from shared memory each tile (paged_flash.cuh QFrags) so
// that O (128 registers) fits without spilling.
//
// int8 pools (paged_flash.cuh attend_codes): the stages hold the codes,
// two deep (kCodeStages: on an H100 2 was 4-7% faster than 4, and 3 no
// faster; PERF.md section 6), and each warp builds its bf16 fragments
// from them in registers. That conversion is integer work in every warp
// that computes a tile, and it binds these bodies, not the bytes. Up to D
// 128 a warp therefore holds 32 rows (two 16-row tiles, each fragment
// feeding both) over half of each tile's tokens, the halves merged at the
// end: a block converts each tile 4 times, not 8, which made the D 96 and
// D 128 bodies faster than the earlier ones that converted each tile in
// place (the 3B case 0.0673 ms against 0.0697). At D 256, O takes 128
// registers for 16 rows, so each of the 8 warps converts every tile, and
// that body is 1.5x slower than the converting one; at D 64 it is 1.2x
// slower (that body ran two blocks an SM at 128 registers; this one, held
// to 128, spills and runs slower still). Padding rows past the last group
// of rows with a query are written as zeros here, since no warp of
// attend_codes holds them.

#include <type_traits>

#include "paged_flash.cuh"

namespace {

using namespace paged_flash;

constexpr int kWarps = 8;  // 128 query rows: 16 a warp
constexpr int kCodeStages = 2;  // int8 ring depth (attend_codes)

// One block of the chunked prefill: bf16 pools (attend) or int8 codes
// and their scales (kI8, attend_codes)
template <int D, bool kCap, bool kWin, bool kI8>
__device__ __forceinline__ void prefill_block(const __nv_bfloat16* __restrict__ q,
                                              const void* __restrict__ k_pool,
                                              const float* __restrict__ ks,
                                              const void* __restrict__ v_pool,
                                              const float* __restrict__ vs,
                                              const int* __restrict__ page_table,
                                              const int* __restrict__ q_start,
                                              const int* __restrict__ q_len,
                                              const int* __restrict__ kv_lens,
                                              __nv_bfloat16* __restrict__ out,
                                              int S, int Hk, int G, int PS, int MP,
                                              int QB, int window, ScoreMap sm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int s0 = qb * QB;                        // first query token here
  const int pos0 = q_start[b] + s0;              // its absolute position
  const int kvl = min(kv_lens[b], MP * PS);
  const int n_tok = min(min(q_len[b], S) - s0, QB);  // valid tokens here
  const int rows = QB * G;

  auto q_offset = [&](int r) {
    return ((((size_t)b * S + s0 + r / G) * Hk + h) * G + r % G) * D;
  };
  auto q_row = [&](int r) -> const __nv_bfloat16* {
    return (r < rows && r / G < n_tok) ? q + q_offset(r) : nullptr;
  };
  // the first position a query at p sees (0 without a window)
  auto first_seen = [&](int p) { return kWin ? max(p - window + 1, 0) : 0; };
  auto row_span = [&](int r) {
    if (r >= rows || r / G >= n_tok) return make_int2(0, -1);
    const int p = pos0 + r / G;
    return make_int2(first_seen(p), min(p, kvl - 1));
  };
  const int last_pos = n_tok > 0 ? min(pos0 + n_tok - 1, kvl - 1) : -1;

  auto out_row = [&](int r) -> __nv_bfloat16* {
    return (r < rows && s0 + r / G < S) ? out + q_offset(r) : nullptr;
  };
  if constexpr (kI8) {
    // two 16-row tiles a warp up to D 128 (paged_flash.cuh attend_codes)
    constexpr int kM = D <= 128 ? 2 : 1;
    // padding rows past the last 16 kM-row group with a query are no
    // warp's in attend_codes: zeros
    const int held = max((max(n_tok, 0) * G + 16 * kM - 1) / (16 * kM), 1) * 16 * kM;
    for (int i = held * (D / 8) + threadIdx.x; i < rows * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8);
      if (s0 + r / G < S) {
        *reinterpret_cast<uint4*>(out + q_offset(r) + (i % (D / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    RowState<D> st[kM];
    // warps whose token share was merged into another's write nothing
    if (!attend_codes<D, kWarps, kCodeStages, kM, kCap, kWin>(
            smem, q_row, row_span, static_cast<const int8_t*>(k_pool), ks,
            static_cast<const int8_t*>(v_pool), vs, page_table + (size_t)b * MP, PS, Hk,
            h, first_seen(pos0), last_pos + 1, sm, st)) {
      return;
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) store_rows<D, true>(out_row, st[m]);
  } else {
    RowState<D> st;
    attend<D, kWarps, kCap, kWin>(smem, q_row, row_span, k_pool, v_pool,
                                  page_table + (size_t)b * MP, PS, Hk, h,
                                  first_seen(pos0), last_pos + 1, sm, st);
    store_rows<D, false>(out_row, st);
  }
}

// the bf16 bodies
template <int D, bool kCap, bool kWin>
__global__ void __launch_bounds__(32 * kWarps)
prefill_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
               const float* __restrict__ ks, const void* __restrict__ v_pool,
               const float* __restrict__ vs, const int* __restrict__ page_table,
               const int* __restrict__ q_start, const int* __restrict__ q_len,
               const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out,
               int S, int Hk, int G, int PS, int MP, int QB, int window, ScoreMap sm) {
  prefill_block<D, kCap, kWin, false>(q, k_pool, ks, v_pool, vs, page_table, q_start, q_len,
                                      kv_lens, out, S, Hk, G, PS, MP, QB, window, sm);
}

// the int8 bodies (ks, vs: [NP, PS, Hk] scales), one block an SM: ptxas
// may use 255 registers a thread, where on its own it picks 128-218 (and
// spills at D 64); on an H100 that ran them 10-12% faster, and a chunk's
// grid is under a wave at the main path's shapes (PERF.md section 6)
template <int D, bool kCap, bool kWin>
__global__ void __launch_bounds__(32 * kWarps, 1)
prefill_codes_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
                     const float* __restrict__ ks, const void* __restrict__ v_pool,
                     const float* __restrict__ vs, const int* __restrict__ page_table,
                     const int* __restrict__ q_start, const int* __restrict__ q_len,
                     const int* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out,
                     int S, int Hk, int G, int PS, int MP, int QB, int window,
                     ScoreMap sm) {
  prefill_block<D, kCap, kWin, true>(q, k_pool, ks, v_pool, vs, page_table, q_start, q_len,
                                     kv_lens, out, S, Hk, G, PS, MP, QB, window, sm);
}

template <int D, bool kCap, bool kWin, bool kI8>
int launch(const dim3& grid, cudaStream_t st, const __nv_bfloat16* q,
           const KvPools& kv, const int* pt, const int* qs, const int* ql,
           const int* kl, __nv_bfloat16* out, int S, int Hk, int G, int PS,
           int MP, int QB, int window, const ScoreMap& sm) {
  constexpr int smem = kI8 ? CodeShape<D, kWarps, kCodeStages>::kSmemBytes
                           : Shape<D, kWarps>::kSmemBytes;
  const auto kernel =
      kI8 ? prefill_codes_kernel<D, kCap, kWin> : prefill_kernel<D, kCap, kWin>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 32 * kWarps, smem, st>>>(q, kv.k, kv.ks, kv.v, kv.vs, pt, qs, ql, kl, out, S,
                                          Hk, G, PS, MP, QB, window, sm);
  return static_cast<int>(cudaGetLastError());
}

// the body for (D, soft cap or not, window or not, int8 or bf16): the
// plain path carries no cap, window or int8 code
template <int D>
int launch_d(bool cap, const dim3& grid, cudaStream_t st, const __nv_bfloat16* q,
             const KvPools& kv, const int* pt, const int* qs, const int* ql,
             const int* kl, __nv_bfloat16* out, int S, int Hk, int G, int PS,
             int MP, int QB, int window, const ScoreMap& sm) {
  auto go = [&](auto cap_t, auto win_t, auto i8_t) {
    return launch<D, decltype(cap_t)::value, decltype(win_t)::value,
                  decltype(i8_t)::value>(grid, st, q, kv, pt, qs, ql, kl, out, S, Hk,
                                         G, PS, MP, QB, window, sm);
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

// k_scales, v_scales: nullptr for bf16 pools; for int8 pools (codes [NP,
// PS, Hk, D]) their f32 scales [NP, PS, Hk].
extern "C" int prefill_paged_attention(
    const void* q, const void* k_pool, const void* k_scales, const void* v_pool,
    const void* v_scales, const void* page_table, const void* q_start,
    const void* q_len, const void* kv_lens, void* out, int B, int S, int Hk,
    int G, int D, int PS, int MP, int q_block, int window, float scale,
    float softcap, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (q_block < 1 || q_block * G > 16 * kWarps ||
      (k_scales == nullptr) != (v_scales == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + q_block - 1) / q_block, Hk, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const KvPools kv{k_pool, static_cast<const float*>(k_scales), v_pool,
                 static_cast<const float*>(v_scales)};
  const auto* pt = static_cast<const int*>(page_table);
  const auto* qs = static_cast<const int*>(q_start);
  const auto* ql = static_cast<const int*>(q_len);
  const auto* kl = static_cast<const int*>(kv_lens);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const paged_flash::ScoreMap sm = paged_flash::score_map(scale, softcap);
  const bool cap = softcap > 0.f;
  if (D == 128) {
    return launch_d<128>(cap, grid, st, qq, kv, pt, qs, ql, kl, oo, S, Hk, G,
                         PS, MP, q_block, window, sm);
  }
  if (D == 64) {
    return launch_d<64>(cap, grid, st, qq, kv, pt, qs, ql, kl, oo, S, Hk, G,
                        PS, MP, q_block, window, sm);
  }
  if (D == 256) {
    return launch_d<256>(cap, grid, st, qq, kv, pt, qs, ql, kl, oo, S, Hk, G,
                         PS, MP, q_block, window, sm);
  }
  if (D == 96) {
    return launch_d<96>(cap, grid, st, qq, kv, pt, qs, ql, kl, oo, S, Hk, G,
                        PS, MP, q_block, window, sm);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
