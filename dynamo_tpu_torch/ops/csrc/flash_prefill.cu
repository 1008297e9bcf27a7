// Chunked-prefill paged flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dynamo_tpu/ops/flash_prefill.py
// `prefill_paged_attention` (body `_prefill_kernel_body`), plain bf16
// variant: a chunk of S query tokens per sequence, at absolute positions
// q_start .. q_start + q_len - 1 (padding rows after q_len), attends
// causally over the sequence's whole paged context (prior prefix plus the
// chunk, already written to the token-major pool [NP, PS, Hk, D]).
// Padding rows come out 0.
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
// warp's causal limits skip the mask. Nothing crosses blocks.

#include "paged_flash.cuh"

namespace {

using namespace paged_flash;

constexpr int kWarps = 8;  // 128 query rows: 16 a warp

template <int D>
__global__ void __launch_bounds__(32 * kWarps)
prefill_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k_pool,
               const __nv_bfloat16* __restrict__ v_pool,
               const int* __restrict__ page_table,
               const int* __restrict__ q_start,
               const int* __restrict__ q_len,
               const int* __restrict__ kv_lens,
               __nv_bfloat16* __restrict__ out,
               int S, int Hk, int G, int PS, int MP, int QB, float scale_log2) {
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
  auto row_vis = [&](int r) {
    return (r < rows && r / G < n_tok) ? min(pos0 + r / G, kvl - 1) : -1;
  };
  const int last_pos = n_tok > 0 ? min(pos0 + n_tok - 1, kvl - 1) : -1;

  RowState<D> st;
  attend<D, kWarps>(smem, q_row, row_vis, k_pool, v_pool,
                    page_table + (size_t)b * MP, PS, Hk, h, 0, last_pos + 1,
                    scale_log2, st);
  store_rows<D>([&](int r) -> __nv_bfloat16* {
    return (r < rows && s0 + r / G < S) ? out + q_offset(r) : nullptr;
  }, st);
}

template <int D>
int launch(const dim3& grid, cudaStream_t st, const __nv_bfloat16* q,
           const __nv_bfloat16* k, const __nv_bfloat16* v, const int* pt,
           const int* qs, const int* ql, const int* kl, __nv_bfloat16* out,
           int S, int Hk, int G, int PS, int MP, int QB, float scale_log2) {
  constexpr int smem = Shape<D, kWarps>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prefill_kernel<D><<<grid, 32 * kWarps, smem, st>>>(
      q, k, v, pt, qs, ql, kl, out, S, Hk, G, PS, MP, QB, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int prefill_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* q_start, const void* q_len,
    const void* kv_lens, void* out, int B, int S, int Hk, int G, int D,
    int PS, int MP, int q_block, float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (q_block < 1 || q_block * G > 16 * kWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + q_block - 1) / q_block, Hk, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vv = static_cast<const __nv_bfloat16*>(v_pool);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* qs = static_cast<const int*>(q_start);
  const auto* ql = static_cast<const int*>(q_len);
  const auto* kl = static_cast<const int*>(kv_lens);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  const float scale_log2 = scale * paged_flash::kLog2e;
  if (D == 128) {
    return launch<128>(grid, st, qq, kk, vv, pt, qs, ql, kl, oo, S, Hk, G, PS,
                       MP, q_block, scale_log2);
  }
  if (D == 64) {
    return launch<64>(grid, st, qq, kk, vv, pt, qs, ql, kl, oo, S, Hk, G, PS,
                      MP, q_block, scale_log2);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
