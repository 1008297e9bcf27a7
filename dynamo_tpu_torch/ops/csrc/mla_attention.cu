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
// token, so each latent byte feeds 128 x 2 multiply-adds (256 FLOP a byte
// against the card's ~295 balance point): at the main path's decode batch
// (8 sequences over 11k context tokens) 3.07 GFLOP against 12.7 MB, a byte
// floor of 4.5 us and a tensor-core floor of 3.1 us; prefill is bound by
// operations.
//
// Decode (redesigned for Hopper): grid (B, ceil(H / 64), NS), 256 threads.
//   - A block owns 64 heads of one sequence (FlashMLA's and wgmma's
//     64-row tile) over one context split: positions [z * split, min((z +
//     1) * split, kv_len)), NS = ceil(MP * PS / split) from the page
//     table's width, so the launch needs no host sync; blocks past a row's
//     kv_len return at once. Each latent tile is read once per 64-head
//     group (twice at H 128), not once per 8 heads as before. The
//     wrapper's split is 192 tokens: at the main path's batch, 63 live
//     splits x 2 head groups = 126 blocks, one wave on 132 SMs (PERF.md
//     gives the measurements behind it).
//   - Latent tiles of 32 tokens stay bf16 (no f32 staging) and arrive in a
//     3-stage ring by bulk copies (cp.async.bulk): one 1152-byte copy per
//     token row, counted on the stage's mbarrier, the page-table entry read
//     by the issuing thread; tokens past kv_len are not copied and their
//     entries never read; their rows are zeroed instead, so their P = 0
//     meets no NaN. Q stays bf16 in shared memory (64 x 576, rows padded 16
//     bytes for conflict-free ldmatrix).
//   - Both products on tensor cores, mma.sync.m16n8k16 (bf16 in, f32
//     accumulate) with ldmatrix fragments (.trans on the value side): S =
//     Q Lat^T and O += P Lat[:, :512]. The 64 x 512 f32 accumulator is 128
//     registers a thread over 256 threads, so, as in FlashMLA, the 8 warps
//     are 4 row groups x 2 halves: for S a warp takes its 16 rows x its
//     half's 16 tokens of the tile, for O its 16 rows x its half's 256
//     columns. The two warps of a row group exchange the row max and the
//     bf16 P tile through shared memory (a 64-thread named barrier); the
//     online softmax runs in f32 registers with quad shuffles, scores in
//     base-2 units. P is rounded to bf16 before the value product (the TPU
//     kernel keeps p in f32).
//   - mma.sync rather than wgmma: it reuses the fragment code of
//     paged_flash.cuh and needs no warp specialisation. What holds the
//     kernel back now is its one block an SM (234 registers x 256
//     threads, 193 KB of shared memory): 8 warps, three barriers a tile,
//     and every warp reading its Q fragments from shared memory again for
//     each tile. wgmma, which takes A and B from shared memory without
//     the ldmatrix round trip, with a producer warp, is the next step.
//   - A row whose context fits one split writes bf16 directly; longer
//     rows write f32 partials (O, m, l) to the wrapper's scratch [NS, B, H,
//     516], merged by log-sum-exp in split order by mla_decode_merge_kernel
//     (paged_flash.cuh merge_splits), launched by the same call. No
//     atomics: the same bits from run to run.
//
// Prefill: f32 FMAs on the CUDA cores from shared memory (tensor cores are
// a later change), so it sits near the CUDA cores' ~67 TFLOP/s at best.
// A block owns R query rows and walks the context in tiles of 16 tokens,
// each gathered through the page table once into shared memory as f32
// [16][576]. That one tile feeds the scores (all 576 columns) and the
// values (the first 512): the point of the TPU kernel's single page DMA.
// Scores are an [R x 576] x [576 x 16] product split over K, each thread
// holding a register tile; one pass reduces the K splits, masks, and
// updates the online softmax (m, l in f32) per row; then each thread
// accumulates its register block of the [R x 512] f32 output. CUDA blocks
// run in no order, so a block walks all of its row's tiles itself.
// Grid (ceil(S / 4), H / 16, B), 256 threads, R = 64 rows = 4 query tokens
// x 16 heads, so the block's causal top is tight; it walks tiles only up
// to min(causal top, kv_len - 1), the trip-count form of the TPU kernel's
// `lat_index` clamp and `needed` test. The f32 accumulator is 64 x 512
// (128 registers a thread); the TPU kernel's 4 MiB VMEM cap on it does not
// apply here.

#include "paged_flash.cuh"

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
constexpr int kHB = 64;            // heads (rows) a block: wgmma's and FlashMLA's tile
constexpr int kT = 32;             // context tokens a tile
constexpr int kStages = 3;         // depth of the latent tile ring
constexpr int kStr = kDL + 8;      // bf16 row stride of Q and latent tiles (584)
constexpr int kPStr = kT + 8;      // bf16 row stride of the P tile (40)
constexpr int kTileBytes = kT * kStr * 2;                  // 37,376
constexpr int kRingOff = kHB * kStr * 2;                   // after Q (74,752)
constexpr int kPOff = kRingOff + kStages * kTileBytes;
constexpr int kMaxOff = kPOff + kHB * kPStr * 2;           // [2][kHB] f32
constexpr int kLOff = kMaxOff + 2 * kHB * 4;               // [2][kHB] f32
constexpr int kBarOff = kLOff + 2 * kHB * 4;
constexpr int kSmemBytes = kBarOff + 8 * kStages;
constexpr int kMergeThreads = kDC / 4;  // a merge block: one head, a float4 a thread
static_assert(kThreads == 256, "4 row groups x 2 halves of 8 warps");
}  // namespace dec

// the 64 threads of row group rg's two warps
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(1 + rg) : "memory");
}

// Grid (B, ceil(H / 64), NS), 256 threads: heads h0 .. h0 + 63 of sequence
// b over context positions [z * split, min((z + 1) * split, kv_len)).
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_split_kernel(const __nv_bfloat16* __restrict__ q,    // [B, H, 576]
                        const __nv_bfloat16* __restrict__ lat,  // [NP, PS, 576]
                        const int* __restrict__ page_table,     // [B, MP]
                        const int* __restrict__ kv_lens,        // [B]
                        __nv_bfloat16* __restrict__ out,        // [B, H, 512]
                        float* __restrict__ part,               // [NS, B, H, 516]
                        int B, int H, int PS, int MP, int split, float scale_log2) {
  using namespace dec;
  using paged_flash::exp2_approx;
  using paged_flash::ldsm_x4;
  using paged_flash::ldsm_x4_trans;
  using paged_flash::mma_bf16;
  using paged_flash::pack_bf16;
  using paged_flash::quad_max;
  using paged_flash::quad_sum;
  using paged_flash::smem_u32;
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kHB;
  const int z = blockIdx.z;
  const int nh = min(kHB, H - h0);  // a multiple of 16
  const int kvl = min(kv_lens[b], MP * PS);
  const int c_begin = z * split;
  if (z > 0 && c_begin >= kvl) return;  // uniform over the block
  const int c_end = min(c_begin + split, kvl);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kT - 1) / kT : 0;

  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(dsmem);
  __nv_bfloat16* sLat = reinterpret_cast<__nv_bfloat16*>(dsmem + kRingOff);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(dsmem + kPOff);
  float* sMax = reinterpret_cast<float*>(dsmem + kMaxOff);
  float* sL = reinterpret_cast<float*>(dsmem + kLOff);
  const uint32_t bar0 = smem_u32(dsmem + kBarOff);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int rg = warp & 3;   // rows rg * 16 .. + 15
  const int ch = warp >> 2;  // S: tile tokens ch * 16 .. + 15; O: columns ch * 256 .. + 255
  const bool live = rg * 16 < nh;  // uniform over the warp and its pair
  const int* pt = page_table + (size_t)b * MP;

  // Q stays bf16 (rows past nh zero)
  for (int i = tid; i < kHB * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs;
    const int c8 = (i % kRowVecs) * 8;
    const bool ok = r < nh;
    paged_flash::cp_async16(smem_u32(sQ + r * kStr + c8),
                            ok ? q + ((size_t)b * H + h0 + r) * kDL + c8 : q, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) paged_flash::mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are visible

  // tile u: thread j < 32 copies token j's 1152-byte latent row. The rows of
  // a partial tile's missing tokens (tokens past kv_len: never copied, their
  // table entries never read) are zeroed by the other threads, at other
  // addresses than the copies', so their P = 0 meets no stale bits; a
  // __syncthreads comes between this and the tile's first reader.
  auto issue = [&](int u) {
    const int c0 = c_begin + u * kT;
    const int n = min(kT, c_end - c0);
    const uint32_t bar = bar0 + 8 * (u % kStages);
    __nv_bfloat16* rows = sLat + (u % kStages) * kT * kStr;
    if (tid == 0) paged_flash::mbar_expect_tx(bar, n * kDL * 2);
    if (tid < n) {
      const int c = c0 + tid;
      paged_flash::bulk_copy(smem_u32(rows + tid * kStr),
                             lat + ((size_t)__ldg(pt + c / PS) * PS + c % PS) * kDL,
                             kDL * 2, bar);
    }
    for (int i = n * kRowVecs + tid - kT; i >= n * kRowVecs && i < kT * kRowVecs;
         i += kThreads - kT) {
      *reinterpret_cast<uint4*>(rows + (i / kRowVecs) * kStr + (i % kRowVecs) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  };
  for (int u = 0; u < kStages - 1 && u < n_tiles; ++u) issue(u);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // Q
  __syncthreads();  // Q and the zeroed rows are visible

  float o[kDC / 2 / 8][4];  // rows r0, r0 + 8; columns ch * 256 + n * 8 + 2 * t4, + 1
#pragma unroll
  for (int n = 0; n < kDC / 2 / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // over this warp's half of each tile
  const int r0 = rg * 16 + (lane >> 2);

  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) __syncthreads();  // tile t - 1's stage, P and maxima are free
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    paged_flash::mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
    if (!live) continue;
    const int c0 = c_begin + t * kT;
    const __nv_bfloat16* sT = sLat + (t % kStages) * kT * kStr;

    // S = Q Lat^T: 16 rows x this half's 16 tokens, k over all 576 columns
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < kDL / 16; ++kc) {
      uint32_t a[4], bb[4];
      ldsm_x4(a, smem_u32(sQ + (rg * 16 + (lane & 15)) * kStr + kc * 16 + (lane >> 4) * 8));
      ldsm_x4(bb, smem_u32(sT + (ch * 16 + (lane >> 4) * 8 + (lane & 7)) * kStr + kc * 16 +
                           ((lane >> 3) & 1) * 8));
      mma_bf16(s[0], a, bb[0], bb[1]);
      mma_bf16(s[1], a, bb[2], bb[3]);
    }
    // scale, mask the tokens past the split's end, row max over both halves
    float mx[2] = {minus_inf(), minus_inf()};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + ch * 16 + n * 8 + 2 * t4 + (e & 1);
        s[n][e] = c < c_end ? s[n][e] * scale_log2 : minus_inf();
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = quad_max(mx[i]);
    if (t4 == 0) {
      sMax[ch * kHB + r0] = mx[0];
      sMax[ch * kHB + r0 + 8] = mx[1];
    }
    pair_sync(rg);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const float m_new = fmaxf(m[i], fmaxf(sMax[r], sMax[kHB + r]));
      alpha[i] = exp2_approx(m[i] - m_new);
      m[i] = m_new;
    }
    // P = exp2(S - m), rounded to bf16 into the shared P tile
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float p0 = exp2_approx(s[n][0] - m[0]);
      const float p1 = exp2_approx(s[n][1] - m[0]);
      const float p2 = exp2_approx(s[n][2] - m[1]);
      const float p3 = exp2_approx(s[n][3] - m[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      const int col = ch * 16 + n * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(sP + r0 * kPStr + col) = pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(sP + (r0 + 8) * kPStr + col) = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < kDC / 2 / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    pair_sync(rg);
    // O += P Lat[:, :512]: 16 rows x this half's 256 columns, k = 32 tokens
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t pa[4];
      ldsm_x4(pa, smem_u32(sP + (rg * 16 + (lane & 15)) * kPStr + kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int n2 = 0; n2 < kDC / 2 / 16; ++n2) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, smem_u32(sT + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kStr +
                                   ch * (kDC / 2) + n2 * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * n2], pa, bb[0], bb[1]);
        mma_bf16(o[2 * n2 + 1], pa, bb[2], bb[3]);
      }
    }
  }

  // the row sums of both halves, added in half order
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
  if (live && t4 == 0) {
    sL[ch * kHB + r0] = l[0];
    sL[ch * kHB + r0 + 8] = l[1];
  }
  __syncthreads();
  if (!live) return;
  const bool direct = kvl <= split;  // one split: bf16 out, else partials
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const float L = sL[r] + sL[kHB + r];
    const size_t row = (size_t)b * H + h0 + r;
    if (direct) {
      const float inv = 1.f / fmaxf(L, 1e-30f);
      __nv_bfloat16* orow = out + row * kDC + ch * (kDC / 2) + 2 * t4;
#pragma unroll
      for (int n = 0; n < kDC / 2 / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    } else {
      float* p = part + ((size_t)z * B * H + row) * (kDC + 4);
#pragma unroll
      for (int n = 0; n < kDC / 2 / 8; ++n)
        *reinterpret_cast<float2*>(p + ch * (kDC / 2) + n * 8 + 2 * t4) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (ch == 0 && t4 == 0) *reinterpret_cast<float2*>(p + kDC) = make_float2(m[i], L);
    }
  }
}

// Grid (B, H), 128 threads: each head of a row longer than one split
// merges its splits' partials in split order and writes bf16, one float4
// of the 512 columns a thread, so that every thread has all its splits'
// loads in flight at once.
__global__ void __launch_bounds__(dec::kMergeThreads, 8)  // 64 registers: no spill
mla_decode_merge_kernel(const float* __restrict__ part, const int* __restrict__ kv_lens,
                        __nv_bfloat16* __restrict__ out, int B, int H, int PS, int MP,
                        int split) {
  const int b = blockIdx.x;
  const int kvl = min(kv_lens[b], MP * PS);
  if (kvl <= split) return;  // written by its one block
  const size_t row = (size_t)b * H + blockIdx.y;
  paged_flash::merge_splits<kDC, dec::kMergeThreads>(
      part + row * (kDC + 4), (size_t)B * H * (kDC + 4), (kvl + split - 1) / split, 1,
      [=](int) { return out + row * kDC; });
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
// -> out [B, H, 512]; bf16, int32. part: f32 scratch [NS, B, H, 516], NS =
// ceil(MP * PS / split); only the splits of rows longer than one split are
// written.
extern "C" int decode_mla_attention(const void* q, const void* lat,
                                    const void* page_table, const void* kv_lens,
                                    void* out, void* part, int B, int H, int dc,
                                    int dr, int PS, int MP, int split, float scale,
                                    void* stream) {
  if (dc != kDC || dc + dr != kDL || H % 16 != 0 || split < dec::kT ||
      split % dec::kT != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const int NS = (MP * PS + split - 1) / split;
  const int n_hb = (H + dec::kHB - 1) / dec::kHB;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dec::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_decode_split_kernel<<<dim3(B, n_hb, NS), kThreads, dec::kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(lat),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), B, H, PS, MP, split,
      scale * paged_flash::kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || NS < 2) return static_cast<int>(err);
  mla_decode_merge_kernel<<<dim3(B, H), dec::kMergeThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), B, H, PS, MP, split);
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
