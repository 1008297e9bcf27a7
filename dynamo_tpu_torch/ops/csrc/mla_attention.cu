// Multi-head latent attention (MLA, DeepSeek V2/V3/R1) over a paged latent
// cache, for Hopper (sm_90a): decode and chunked prefill.
//
// Replaces the Pallas TPU kernels of dynamo_tpu/ops/mla_attention.py:
// `decode_mla_attention` (body `_mla_kernel`, plain bf16 variant) and
// `prefill_mla_attention` (`_mla_prefill_kernel`). Attention runs in the
// absorbed form: every query row (a token x head) carries a 576-wide vector
// q = [q_nope @ W_UK ; q_rope], every context token one 576-wide latent
// (the RMS-normed c_kv, 512 wide, then the shared RoPE key, 64 wide) in the
// pool [NP, PS, 1, 576]. Scores are q . latent * scale; values are the
// latent's first 512 columns. Output [rows, 512] (the caller lifts it
// through W_UV). Rows with no context, and prefill padding rows, come out 0;
// page-table entries past kv_len are never read.
//
// What bounds them on an H100: all 128 heads share one latent row per
// token, so each latent byte feeds 128 x 2 multiply-adds: unlike GQA
// decode, MLA decode is compute-heavy (at 8 sequences over 11k context
// tokens, 3.07 GFLOP against 15 MB; the byte time still leads by a little
// at the tensor cores' rate), and prefill is bound by operations. These
// first versions compute both products with f32 FMAs on the CUDA cores from
// shared memory (mma.sync / wgmma are a later change), so they sit near the
// CUDA cores' ~67 TFLOP/s at best, far from the tensor-core bound.
//
// Design, shared by both: a block owns R query rows and walks the context
// in tiles of 16 tokens, each gathered through the page table once into
// shared memory as f32 [16][576]. That one tile feeds the scores (all 576
// columns) and the values (the first 512): the point of the TPU kernel's
// single page DMA. Scores are an [R x 576] x [576 x 16] product split over
// K, each thread holding a register tile; one pass reduces the K splits,
// masks, and updates the online softmax (m, l in f32) per row; then each
// thread accumulates its register block of the [R x 512] f32 output. CUDA
// blocks run in no order, so a block walks all of its row's tiles itself;
// nothing crosses blocks.
//
// Decode: grid (B, H / 8), 256 threads, R = 8 heads of one sequence (128
// blocks at B 8, H 128 on 132 SMs). The next tile's loads are issued into
// registers before the current tile is computed.
// Prefill: grid (ceil(S / 4), H / 16, B), 256 threads, R = 64 rows = 4
// query tokens x 16 heads, so the block's causal top is tight; it walks
// tiles only up to min(causal top, kv_len - 1), the trip-count form of the
// TPU kernel's `lat_index` clamp and `needed` test. The f32 accumulator is
// 64 x 512 (128 registers a thread); the TPU kernel's 4 MiB VMEM cap on it
// does not apply here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDL = 576;         // latent row: d_c + d_rh
constexpr int kDC = 512;         // value width: d_c
constexpr int kTile = 16;        // context tokens per tile
constexpr int kPad = kDL + 4;    // f32 row stride in shared memory: rows 4 banks apart
constexpr int kRowVecs = kDL / 8;            // 16-byte vectors per latent row (72)
constexpr int kTileVecs = kTile * kRowVecs;  // 1152
constexpr int kThreads = 256;
constexpr int kTileLoads = (kTileVecs + kThreads - 1) / kThreads;  // 5
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

__device__ __forceinline__ void store8(float* dst, uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]);
  const float2 d = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// This thread's share of the 16-token tile starting at c0: vector i of the
// tile is token i / 72, columns (i % 72) * 8 .. + 7. Tokens at or past
// kv_len load zeros and their table entries are not read.
__device__ __forceinline__ void load_tile(uint4 (&r)[kTileLoads],
                                          const __nv_bfloat16* __restrict__ lat,
                                          const int* __restrict__ pt_row,
                                          int PS, int kvl, int c0) {
#pragma unroll
  for (int u = 0; u < kTileLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int c = c0 + i / kRowVecs;
    r[u] = make_uint4(0u, 0u, 0u, 0u);
    if (i < kTileVecs && c < kvl) {
      const int page = pt_row[c / PS];
      r[u] = __ldg(reinterpret_cast<const uint4*>(
          lat + ((size_t)page * PS + c % PS) * kDL + (i % kRowVecs) * 8));
    }
  }
}

__device__ __forceinline__ void store_tile(float* slat,
                                           const uint4 (&r)[kTileLoads]) {
#pragma unroll
  for (int u = 0; u < kTileLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < kTileVecs) store8(slat + (i / kRowVecs) * kPad + (i % kRowVecs) * 8, r[u]);
  }
}

// ---------------------------------------------------------------- decode
namespace dec {
constexpr int kHB = 8;                    // heads (rows) per block
constexpr int kSplits = 8;                // score K splits, one warp each
constexpr int kSplitDims = kDL / kSplits; // 72
constexpr size_t kSmemFloats =
    kHB * kPad + kTile * kPad + kSplits * kHB * kTile + kTile * kHB + 3 * kHB;
}  // namespace dec

__global__ void __launch_bounds__(kThreads)
mla_decode_kernel(const __nv_bfloat16* __restrict__ q,    // [B, H, 576]
                  const __nv_bfloat16* __restrict__ lat,  // [NP, PS, 576]
                  const int* __restrict__ page_table,     // [B, MP]
                  const int* __restrict__ kv_lens,        // [B]
                  __nv_bfloat16* __restrict__ out,        // [B, H, 512]
                  int H, int PS, int MP, float scale) {
  using namespace dec;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                             // [kHB][kPad] queries, f32
  float* slat = sq + kHB * kPad;                // [kTile][kPad] latent tile
  float* sred = slat + kTile * kPad;            // [kSplits][kHB][kTile]
  float* sp = sred + kSplits * kHB * kTile;     // [kTile][kHB] probabilities
  float* s_m = sp + kTile * kHB;                // [kHB] running max
  float* s_l = s_m + kHB;                       // [kHB] running denominator
  float* s_alpha = s_l + kHB;                   // [kHB] this tile's rescale

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kHB;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kvl = kv_lens[b];
  const int* pt_row = page_table + (size_t)b * MP;

  for (int i = tid; i < kHB * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs;
    const int c8 = (i % kRowVecs) * 8;
    store8(sq + r * kPad + c8, __ldg(reinterpret_cast<const uint4*>(
                                   q + ((size_t)b * H + h0 + r) * kDL + c8)));
  }
  if (tid < kHB) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }

  // scores: warp = K split (72 dims); rows {rp, rp + 4}, tokens {tp, tp + 8}
  const int rp = lane / 8;
  const int tp = lane % 8;
  // PV: all 8 rows, output columns 2 * tid, 2 * tid + 1
  float acc[kHB][2];
#pragma unroll
  for (int i = 0; i < kHB; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int n_tiles = (kvl + kTile - 1) / kTile;
  uint4 pre[kTileLoads];
  if (n_tiles > 0) load_tile(pre, lat, pt_row, PS, kvl, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    store_tile(slat, pre);
    __syncthreads();
    if (t + 1 < n_tiles) load_tile(pre, lat, pt_row, PS, kvl, c0 + kTile);

    float sc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    {
      const int d0 = warp * kSplitDims;
      const float* qa = sq + rp * kPad + d0;
      const float* qb = sq + (rp + 4) * kPad + d0;
      const float* ka = slat + tp * kPad + d0;
      const float* kb = slat + (tp + 8) * kPad + d0;
#pragma unroll 6
      for (int d = 0; d < kSplitDims; d += 4) {
        const float4 q0 = *reinterpret_cast<const float4*>(qa + d);
        const float4 q1 = *reinterpret_cast<const float4*>(qb + d);
        const float4 k0 = *reinterpret_cast<const float4*>(ka + d);
        const float4 k1 = *reinterpret_cast<const float4*>(kb + d);
        sc[0][0] = dot4(q0, k0, sc[0][0]);
        sc[0][1] = dot4(q0, k1, sc[0][1]);
        sc[1][0] = dot4(q1, k0, sc[1][0]);
        sc[1][1] = dot4(q1, k1, sc[1][1]);
      }
    }
    float* red = sred + warp * kHB * kTile;
    red[rp * kTile + tp] = sc[0][0];
    red[rp * kTile + tp + 8] = sc[0][1];
    red[(rp + 4) * kTile + tp] = sc[1][0];
    red[(rp + 4) * kTile + tp + 8] = sc[1][1];
    __syncthreads();

    // reduce the K splits and update the online softmax: 16 lanes per row
    if (tid < kHB * kTile) {
      const int r = tid / kTile;
      const int j = tid % kTile;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kSplits; ++k) s += sred[(k * kHB + r) * kTile + j];
      s = c0 + j < kvl ? s * scale : minus_inf();
      float mx = s;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = __expf(s - m_new);  // masked: exp(-inf) = 0
      float sum = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sp[j * kHB + r] = p;
      if (j == 0) {
        const float alpha = __expf(m_old - m_new);
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
        s_alpha[r] = alpha;
      }
    }
    __syncthreads();

    {
      const float4 a0 = *reinterpret_cast<const float4*>(s_alpha);
      const float4 a1 = *reinterpret_cast<const float4*>(s_alpha + 4);
      const float al[kHB] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < kHB; ++i) {
        acc[i][0] *= al[i];
        acc[i][1] *= al[i];
      }
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(sp + j * kHB);
      const float4 p1 = *reinterpret_cast<const float4*>(sp + j * kHB + 4);
      const float2 v = *reinterpret_cast<const float2*>(slat + j * kPad + 2 * tid);
      const float pr[kHB] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int i = 0; i < kHB; ++i) {
        acc[i][0] = fmaf(pr[i], v.x, acc[i][0]);
        acc[i][1] = fmaf(pr[i], v.y, acc[i][1]);
      }
    }
  }
  __syncthreads();  // s_l is final (and initialised when no tile ran)

#pragma unroll
  for (int i = 0; i < kHB; ++i) {
    const float inv = 1.f / fmaxf(s_l[i], 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * H + h0 + i) * kDC + 2 * tid) =
        __floats2bfloat162_rn(acc[i][0] * inv, acc[i][1] * inv);
  }
}

// --------------------------------------------------------------- prefill
namespace pre {
constexpr int kSq = 4;                    // query tokens per block
constexpr int kHB = 16;                   // heads per block
constexpr int kRows = kSq * kHB;          // 64 rows: row = token * 16 + head
constexpr int kSplits = 4;                // score K splits, two warps each
constexpr int kSplitDims = kDL / kSplits; // 144
constexpr int kRowsPerWarp = kRows / 8;   // PV: 8 rows per warp
constexpr int kColsPerLane = kDC / 32;    // PV: 16 columns per lane
constexpr size_t kSmemFloats = kRows * kPad + kTile * kPad +
                               kSplits * kRows * kTile + kTile * kRows + 3 * kRows;
}  // namespace pre

__global__ void __launch_bounds__(kThreads, 1)
mla_prefill_kernel(const __nv_bfloat16* __restrict__ q,    // [B, S, H, 576]
                   const __nv_bfloat16* __restrict__ lat,  // [NP, PS, 576]
                   const int* __restrict__ page_table,     // [B, MP]
                   const int* __restrict__ q_start,        // [B]
                   const int* __restrict__ q_len,          // [B]
                   const int* __restrict__ kv_lens,        // [B]
                   __nv_bfloat16* __restrict__ out,        // [B, S, H, 512]
                   int S, int H, int PS, int MP, float scale) {
  using namespace pre;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                             // [kRows][kPad]
  float* slat = sq + kRows * kPad;              // [kTile][kPad]
  float* sred = slat + kTile * kPad;            // [kSplits][kRows][kTile]
  float* sp = sred + kSplits * kRows * kTile;   // [kTile][kRows]
  float* s_m = sp + kTile * kRows;
  float* s_l = s_m + kRows;
  float* s_alpha = s_l + kRows;

  const int sb = blockIdx.x;
  const int h0 = blockIdx.y * kHB;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qs = q_start[b];
  const int kvl = kv_lens[b];
  const int blk_rows = min(q_len[b] - sb * kSq, kSq);  // valid tokens here
  const int* pt_row = page_table + (size_t)b * MP;

  for (int i = tid; i < kRows * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs;
    const int c8 = (i % kRowVecs) * 8;
    const int s_loc = r / kHB;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s_loc < blk_rows) {
      v = __ldg(reinterpret_cast<const uint4*>(
          q + (((size_t)b * S + sb * kSq + s_loc) * H + h0 + r % kHB) * kDL + c8));
    }
    store8(sq + r * kPad + c8, v);
  }
  if (tid < kRows) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }

  // scores: K split ks = warp / 2 (144 dims); rows rg + 16 a, tokens tg + 4 a
  const int ks = warp / 2;
  const int rg = (warp % 2) * 8 + lane / 4;
  const int tg = lane % 4;
  // softmax: row tid / 4, tokens (tid % 4) * 4 .. + 3
  const int sm_row = tid / 4;
  const int sm_q = tid % 4;
  // PV: rows warp * 8 .. + 7; columns 128 k + 4 lane + e
  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int e = 0; e < kColsPerLane; ++e) acc[i][e] = 0.f;

  // last context position any valid row of this block can see
  const int last_pos = blk_rows > 0 ? min(qs + sb * kSq + blk_rows - 1, kvl - 1) : -1;
  const int n_tiles = last_pos >= 0 ? last_pos / kTile + 1 : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kTile;
    uint4 ld[kTileLoads];
    load_tile(ld, lat, pt_row, PS, kvl, c0);
    __syncthreads();  // the previous tile's readers are done
    store_tile(slat, ld);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
    {
      const int d0 = ks * kSplitDims;
#pragma unroll 2
      for (int d = d0; d < d0 + kSplitDims; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          qv[a] = *reinterpret_cast<const float4*>(sq + (rg + 16 * a) * kPad + d);
          kv[a] = *reinterpret_cast<const float4*>(slat + (tg + 4 * a) * kPad + d);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[a][c] = dot4(qv[a], kv[c], sc[a][c]);
      }
    }
    {
      float* red = sred + ks * kRows * kTile;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) red[(rg + 16 * a) * kTile + tg + 4 * c] = sc[a][c];
    }
    __syncthreads();

    // reduce the K splits, mask, online softmax: 4 lanes per row
    {
      const int r = sm_row;
      const int s_loc = r / kHB;
      const int q_pos = qs + sb * kSq + s_loc;
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = 0.f;
#pragma unroll
      for (int k = 0; k < kSplits; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(
            sred + (k * kRows + r) * kTile + sm_q * 4);
        s[0] += v.x;
        s[1] += v.y;
        s[2] += v.z;
        s[3] += v.w;
      }
      float mx = minus_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kv_pos = c0 + sm_q * 4 + j;
        const bool ok = s_loc < blk_rows && kv_pos <= q_pos && kv_pos < kvl;
        s[j] = ok ? s[j] * scale : minus_inf();
        mx = fmaxf(mx, s[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[j] - m_new);  // masked: exp(-inf) = 0
        sp[(sm_q * 4 + j) * kRows + r] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (sm_q == 0) {
        const float alpha = __expf(m_old - m_new);
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
        s_alpha[r] = alpha;
      }
    }
    __syncthreads();

    {
      const float* al = s_alpha + warp * kRowsPerWarp;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float a = al[i];
#pragma unroll
        for (int e = 0; e < kColsPerLane; ++e) acc[i][e] *= a;
      }
    }
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(sp + j * kRows + warp * kRowsPerWarp);
      const float4 p1 = *reinterpret_cast<const float4*>(sp + j * kRows + warp * kRowsPerWarp + 4);
      const float pr[kRowsPerWarp] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float v[kColsPerLane];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v4 = *reinterpret_cast<const float4*>(slat + j * kPad + 128 * k + 4 * lane);
        v[4 * k] = v4.x;
        v[4 * k + 1] = v4.y;
        v[4 * k + 2] = v4.z;
        v[4 * k + 3] = v4.w;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
        for (int e = 0; e < kColsPerLane; ++e) acc[i][e] = fmaf(pr[i], v[e], acc[i][e]);
    }
  }
  __syncthreads();  // s_l is final (and initialised when no tile ran)

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int s = sb * kSq + r / kHB;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(s_l[r], 1e-30f);
    __nv_bfloat16* o = out + (((size_t)b * S + s) * H + h0 + r % kHB) * kDC + 4 * lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][4 * k] * inv, acc[i][4 * k + 1] * inv);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][4 * k + 2] * inv, acc[i][4 * k + 3] * inv);
      uint2 pk;
      pk.x = *reinterpret_cast<uint32_t*>(&lo);
      pk.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o + 128 * k) = pk;
    }
  }
}

}  // namespace

// q [B, H, 576], lat [NP, PS, 1, 576], page_table [B, MP], kv_lens [B]
// -> out [B, H, 512]; bf16, int32
extern "C" int decode_mla_attention(const void* q, const void* lat,
                                    const void* page_table, const void* kv_lens,
                                    void* out, int B, int H, int dc, int dr,
                                    int PS, int MP, float scale, void* stream) {
  if (dc != kDC || dc + dr != kDL || H % dec::kHB != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const int smem = static_cast<int>(dec::kSmemFloats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_decode_kernel<<<dim3(B, H / dec::kHB), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(lat),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), H, PS, MP, scale);
  return static_cast<int>(cudaGetLastError());
}

// q [B, S, H, 576], lat [NP, PS, 1, 576], page_table [B, MP], q_start,
// q_len, kv_lens [B] -> out [B, S, H, 512]; bf16, int32
extern "C" int prefill_mla_attention(const void* q, const void* lat,
                                     const void* page_table, const void* q_start,
                                     const void* q_len, const void* kv_lens,
                                     void* out, int B, int S, int H, int dc,
                                     int dr, int PS, int MP, float scale,
                                     void* stream) {
  if (dc != kDC || dc + dr != kDL || H % pre::kHB != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0) return 0;
  const int smem = static_cast<int>(pre::kSmemFloats * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mla_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_prefill_kernel<<<dim3((S + pre::kSq - 1) / pre::kSq, H / pre::kHB, B),
                       kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(lat),
      static_cast<const int*>(page_table), static_cast<const int*>(q_start),
      static_cast<const int*>(q_len), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), S, H, PS, MP, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
