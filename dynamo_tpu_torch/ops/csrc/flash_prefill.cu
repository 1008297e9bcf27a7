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
// query-key pair per query head) outweigh the bytes, so it is bound by
// operations; with no prior context the two are within a factor of two.
// This first version computes both products with f32 FMAs from shared
// memory rather than tensor cores (mma.sync / wgmma are a later change),
// so it runs far from that bound; what it does do is touch only the
// context each query block can see.
//
// Design: grid (ceil(S / QB), Hk, B), 128 threads. A block owns QB query
// tokens of one kv-head, i.e. QB * G <= 64 query rows (row = token * G +
// group, as in the TPU kernel's [Sq * G] flattening), staged once in
// shared memory. It walks the context in tiles of 16 tokens, only up to
// the last position its rows can see: min(causal top, kv_len - 1). That
// loop bound is the TPU index-map clamp (flash_prefill.py:248-264) done
// as a trip count, so a causal chunk costs about half the rectangle. Each
// tile's K and V rows are gathered through the page table (entries past
// kv_len are never read) into shared memory as f32; each thread scores 8
// rows against one tile token, one thread per row updates the online
// softmax (m, l in f32), and each thread accumulates an 8-row by D/16-dim
// block of the output in registers. Nothing crosses blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsMax = 64;  // query rows (token x group) per block
constexpr int kTile = 16;     // context tokens per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float masked_score() { return __int_as_float(static_cast<int>(0xff800000u)); }  // -inf

template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k_pool,
               const __nv_bfloat16* __restrict__ v_pool,
               const int* __restrict__ page_table,
               const int* __restrict__ q_start,
               const int* __restrict__ q_len,
               const int* __restrict__ kv_lens,
               __nv_bfloat16* __restrict__ out,
               int S, int Hk, int G, int PS, int MP, int QB, float scale) {
  constexpr int kChunks = D / 8;     // 16-byte chunks per row
  constexpr int kQPad = D + 8;       // bf16 row stride of the query tile
  constexpr int kKPad = D + 4;       // f32 row stride of the key tile
  constexpr int kDims = D / 16;      // output dims per thread
  __shared__ __align__(16) __nv_bfloat16 sq[kRowsMax][kQPad];
  __shared__ __align__(16) float sk[kTile][kKPad];
  __shared__ __align__(16) float sv[kTile][D];
  __shared__ float sp[kRowsMax][kTile + 1];
  __shared__ float s_m[kRowsMax], s_l[kRowsMax], s_alpha[kRowsMax];

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid / 16;   // rows rg*8 .. rg*8+7
  const int col = tid % 16;  // tile token (scores) / dim block (PV)
  const int rows = QB * G;
  const int qs = q_start[b];
  const int kvl = kv_lens[b];
  const int blk_rows = min(q_len[b] - qb * QB, QB);  // valid tokens here
  const size_t row_stride = (size_t)Hk * D;

  auto q_offset = [&](int s, int g) {
    return ((((size_t)b * S + s) * Hk + h) * G + g) * D;
  };

  for (int i = tid; i < kRowsMax * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c8 = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && r / G < blk_rows) {
      val = __ldg(reinterpret_cast<const uint4*>(
          q + q_offset(qb * QB + r / G, r % G) + c8));
    }
    *reinterpret_cast<uint4*>(&sq[r][c8]) = val;
  }
  if (tid < kRowsMax) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  float acc[8][kDims];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < kDims; ++e) acc[i][e] = 0.f;

  // last context position any valid row of this block can see
  const int last_pos = blk_rows > 0 ? min(qs + qb * QB + blk_rows - 1, kvl - 1) : -1;
  const int n_tiles = last_pos >= 0 ? last_pos / kTile + 1 : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int j = i / kChunks;
      const int c8 = (i % kChunks) * 8;
      const int c = c0 + j;
      float kf[8], vf[8];
      if (c < kvl) {
        const int page = page_table[(size_t)b * MP + c / PS];
        const size_t off =
            ((size_t)page * PS + c % PS) * row_stride + (size_t)h * D + c8;
        const uint4 kr = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
        const uint4 vr = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
        const __nv_bfloat162* kh = reinterpret_cast<const __nv_bfloat162*>(&kr);
        const __nv_bfloat162* vh = reinterpret_cast<const __nv_bfloat162*>(&vr);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(kh[e]);
          const float2 z = __bfloat1622float2(vh[e]);
          kf[2 * e] = a.x;
          kf[2 * e + 1] = a.y;
          vf[2 * e] = z.x;
          vf[2 * e + 1] = z.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = vf[e] = 0.f;
      }
      *reinterpret_cast<float4*>(&sk[j][c8]) = make_float4(kf[0], kf[1], kf[2], kf[3]);
      *reinterpret_cast<float4*>(&sk[j][c8 + 4]) = make_float4(kf[4], kf[5], kf[6], kf[7]);
      *reinterpret_cast<float4*>(&sv[j][c8]) = make_float4(vf[0], vf[1], vf[2], vf[3]);
      *reinterpret_cast<float4*>(&sv[j][c8 + 4]) = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
    __syncthreads();

    // scores: rows rg*8 .. rg*8+7 against tile token `col`
    float sc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&sk[col][d]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint2 raw = *reinterpret_cast<const uint2*>(&sq[rg * 8 + i][d]);
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        sc[i] = fmaf(a.x, k4.x, fmaf(a.y, k4.y, fmaf(z.x, k4.z, fmaf(z.y, k4.w, sc[i]))));
      }
    }
    const int kv_pos = c0 + col;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rg * 8 + i;
      const int s_loc = r / G;
      const bool ok = r < rows && s_loc < blk_rows &&
                      kv_pos <= qs + qb * QB + s_loc && kv_pos < kvl;
      sp[r][col] = ok ? sc[i] * scale : masked_score();
    }
    __syncthreads();

    // online softmax: one thread per row. Masked scores are -inf, so they
    // contribute p = 0 even while the running max is still the -1e30 start
    if (tid < kRowsMax) {
      const int r = tid;
      const float m_old = s_m[r];
      float mx = masked_score();
#pragma unroll
      for (int j = 0; j < kTile; ++j) mx = fmaxf(mx, sp[r][j]);
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float p = __expf(sp[r][j] - m_new);
        sp[r][j] = p;
        sum += p;
      }
      const float alpha = __expf(m_old - m_new);
      s_l[r] = s_l[r] * alpha + sum;
      s_m[r] = m_new;
      s_alpha[r] = alpha;
    }
    __syncthreads();

    // PV: rows rg*8 .. rg*8+7, dims col*kDims .. col*kDims + kDims - 1
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = s_alpha[rg * 8 + i];
#pragma unroll
      for (int e = 0; e < kDims; ++e) acc[i][e] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float v[kDims];
#pragma unroll
      for (int e = 0; e < kDims; e += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&sv[j][col * kDims + e]);
        v[e] = v4.x;
        v[e + 1] = v4.y;
        v[e + 2] = v4.z;
        v[e + 3] = v4.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = sp[rg * 8 + i][j];
#pragma unroll
        for (int e = 0; e < kDims; ++e) acc[i][e] = fmaf(p, v[e], acc[i][e]);
      }
    }
  }
  __syncthreads();  // s_l is final (and initialised when no tile ran)

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    const int s = qb * QB + r / G;
    if (r >= rows || s >= S) continue;
    const float denom = fmaxf(s_l[r], 1e-30f);
    __nv_bfloat16* o = out + q_offset(s, r % G) + col * kDims;
#pragma unroll
    for (int e = 0; e < kDims; e += 2) {
      *reinterpret_cast<__nv_bfloat162*>(o + e) =
          __floats2bfloat162_rn(acc[i][e] / denom, acc[i][e + 1] / denom);
    }
  }
}

}  // namespace

extern "C" int prefill_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* q_start, const void* q_len,
    const void* kv_lens, void* out, int B, int S, int Hk, int G, int D,
    int PS, int MP, int q_block, float scale, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (q_block < 1 || q_block * G > kRowsMax) {
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
  if (D == 128) {
    prefill_kernel<128><<<grid, kThreads, 0, st>>>(
        qq, kk, vv, pt, qs, ql, kl, oo, S, Hk, G, PS, MP, q_block, scale);
  } else if (D == 64) {
    prefill_kernel<64><<<grid, kThreads, 0, st>>>(
        qq, kk, vv, pt, qs, ql, kl, oo, S, Hk, G, PS, MP, q_block, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
