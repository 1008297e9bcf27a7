// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dynamo_tpu/ops/ragged_paged_attention.py
// `ragged_paged_attention` (body `_ragged_kernel_body`), plain bf16
// variant: one flat [T, Hk, G, D] query axis holds decode rows (one token
// each), prefill chunks and speculative-verify rows (K+1 tokens), each
// segment attending causally over its own paged context in the token-major
// pool [NP, PS, Hk, D]. The host cuts the axis into work units
// (meta [5, NW]: seg, q block, first row, row count, position of the first
// row; ops/ragged_paged_attention.py); rows of the dummy tail segment
// (kv_len 0) come out 0.
//
// What bounds it on an H100: at the main path's shapes (T 264, Hk 8, G 3,
// D 128, PS 16: eight decode rows over up to 4096 tokens and four chunks
// of 16-125 tokens over up to 3000 prior tokens) the bytes are each
// segment's visible K/V read once, ~68 MB, about 20 us at 3.35 TB/s;
// the two products are ~2.8 GFLOP, under 3 us of bf16 tensor-core time.
// So it is bound by bytes. This first version reads each unit's K/V
// through shared memory and computes both products with f32 FMAs, one
// tile of 16 context tokens at a time, with no overlap of loads and math:
// it runs far from that bound.
//
// Design: grid (NW, Hk), 128 threads. The TPU runs the (NW, MP) grid in
// order and lets consecutive units of one q block read-modify-write a
// resident out block under a row mask; CUDA blocks run in no order, so
// here one block owns one (work unit, kv head), walks that unit's pages in
// a loop, and stores ONLY its own rows (rs .. rs + rows). Units of one q
// block never touch each other's rows, and every row of [0, T) belongs to
// exactly one unit, so the output needs no initialisation and no
// read-modify-write. Padding units (rows 0) return at once. The loop
// bound replaces the TPU index-map clamp: a unit walks context tokens up
// to min(qpos0 + rows - 1, kv_len - 1), so table entries past it are never
// read. Masked scores are -inf against a -1e30 running max (p = 0
// exactly) and the finalize divides by max(l, 1e-30): an empty context
// gives 0, not NaN.
//
// Known imbalance: a decode row over a 4096-token context is one unit of
// G query rows that walks 256 tiles alone while a chunk's units finish
// early, and it keeps 3 of its 64 row slots busy. Splitting long units
// over the context (split-K), mma.sync / wgmma for the products and TMA
// for the page loads are later changes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsMax = 64;  // query rows (token x group) per unit
constexpr int kTile = 16;     // context tokens per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float masked_score() { return __int_as_float(static_cast<int>(0xff800000u)); }  // -inf

template <int D>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k_pool,
              const __nv_bfloat16* __restrict__ v_pool,
              const int* __restrict__ seg_page_table,
              const int* __restrict__ seg_kv_lens,
              const int* __restrict__ meta,
              __nv_bfloat16* __restrict__ out,
              int NW, int Hk, int G, int PS, int MP, int QB, float scale) {
  constexpr int kChunks = D / 8;     // 16-byte chunks per row
  constexpr int kQPad = D + 8;       // bf16 row stride of the query tile
  constexpr int kKPad = D + 4;       // f32 row stride of the key tile
  constexpr int kDims = D / 16;      // output dims per thread
  __shared__ __align__(16) __nv_bfloat16 sq[kRowsMax][kQPad];
  __shared__ __align__(16) float sk[kTile][kKPad];
  __shared__ __align__(16) float sv[kTile][D];
  __shared__ float sp[kRowsMax][kTile + 1];
  __shared__ float s_m[kRowsMax], s_l[kRowsMax], s_alpha[kRowsMax];

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int n_tok = meta[3 * NW + w];
  if (n_tok <= 0) return;  // padding unit (uniform over the block)
  const int seg = meta[w];
  const int t0 = meta[NW + w] * QB + meta[2 * NW + w];  // first flat token
  const int qpos0 = meta[4 * NW + w];
  const int kvl = min(seg_kv_lens[seg], MP * PS);
  const int* __restrict__ pt = seg_page_table + (size_t)seg * MP;
  const int tid = threadIdx.x;
  const int rg = tid / 16;   // rows rg*8 .. rg*8+7
  const int col = tid % 16;  // tile token (scores) / dim block (PV)
  const int rows = n_tok * G;
  const size_t row_stride = (size_t)Hk * D;

  auto q_offset = [&](int r) {  // row r = token (r / G) x group (r % G)
    return (((size_t)(t0 + r / G) * Hk + h) * G + r % G) * D;
  };

  for (int i = tid; i < kRowsMax * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c8 = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      val = __ldg(reinterpret_cast<const uint4*>(q + q_offset(r) + c8));
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

  // last context position any row of this unit can see
  const int last_pos = min(qpos0 + n_tok - 1, kvl - 1);
  const int n_tiles = last_pos >= 0 ? last_pos / kTile + 1 : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * kChunks; i += kThreads) {
      const int j = i / kChunks;
      const int c8 = (i % kChunks) * 8;
      const int c = c0 + j;
      float kf[8], vf[8];
      if (c <= last_pos) {
        const int page = pt[c / PS];
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

    // scores: rows rg*8 .. rg*8+7 against tile token `col`; row groups
    // past the unit's rows skip the products
    const int kv_pos = c0 + col;
    if (rg * 8 < rows) {
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
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = rg * 8 + i;
        const bool ok = r < rows && kv_pos <= qpos0 + r / G && kv_pos < kvl;
        sp[r][col] = ok ? sc[i] * scale : masked_score();
      }
    }
    __syncthreads();

    // online softmax: one thread per row. Masked scores are -inf, so they
    // contribute p = 0 even while the running max is still the -1e30 start
    if (tid < rows) {
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
    if (rg * 8 < rows) {
      const int n_live = min(8, rows - rg * 8);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < n_live) {
          const float a = s_alpha[rg * 8 + i];
#pragma unroll
          for (int e = 0; e < kDims; ++e) acc[i][e] *= a;
        }
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
          if (i < n_live) {
            const float p = sp[rg * 8 + i][j];
#pragma unroll
            for (int e = 0; e < kDims; ++e) acc[i][e] = fmaf(p, v[e], acc[i][e]);
          }
        }
      }
    }
  }
  __syncthreads();  // s_l is final (and initialised when no tile ran)

  // store only this unit's rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    if (r >= rows) continue;
    const float denom = fmaxf(s_l[r], 1e-30f);
    __nv_bfloat16* o = out + q_offset(r) + col * kDims;
#pragma unroll
    for (int e = 0; e < kDims; e += 2) {
      *reinterpret_cast<__nv_bfloat162*>(o + e) =
          __floats2bfloat162_rn(acc[i][e] / denom, acc[i][e + 1] / denom);
    }
  }
}

}  // namespace

extern "C" int ragged_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* seg_page_table, const void* seg_kv_lens, const void* meta,
    void* out, int NW, int Hk, int G, int D, int PS, int MP, int q_block,
    float scale, void* stream) {
  if (NW == 0) return 0;
  if (q_block < 1 || q_block * G > kRowsMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(NW, Hk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vv = static_cast<const __nv_bfloat16*>(v_pool);
  const auto* pt = static_cast<const int*>(seg_page_table);
  const auto* kl = static_cast<const int*>(seg_kv_lens);
  const auto* mt = static_cast<const int*>(meta);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  if (D == 128) {
    ragged_kernel<128><<<grid, kThreads, 0, st>>>(
        qq, kk, vv, pt, kl, mt, oo, NW, Hk, G, PS, MP, q_block, scale);
  } else if (D == 64) {
    ragged_kernel<64><<<grid, kThreads, 0, st>>>(
        qq, kk, vv, pt, kl, mt, oo, NW, Hk, G, PS, MP, q_block, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
