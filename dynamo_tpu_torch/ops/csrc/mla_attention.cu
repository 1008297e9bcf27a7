// Multi-head latent attention (MLA, DeepSeek V2/V3/R1) over a paged latent
// cache, for Hopper (sm_90a): decode and chunked prefill.
//
// Replaces the Pallas TPU kernels of dynamo_tpu/ops/mla_attention.py:
// `decode_mla_attention` (bodies `_mla_kernel`, bf16, and
// `_mla_kernel_int8`, the int8 latent) and `prefill_mla_attention`
// (`_mla_prefill_kernel`, bf16 only, as there). Attention runs in the
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
// floor of 4.5 us and a tensor-core floor of 3.1 us; prefill, whose query
// tokens share each latent tile too, is bound by operations.
//
// Both kernels are one block shape walked by one function, `attend`: a
// block of 256 threads owns 64 query rows and walks a range of the context
// in tiles of 32 tokens.
//   - Latent tiles stay bf16 and arrive in a 4-stage ring by bulk copies
//     (cp.async.bulk), one 1152-byte copy per token row, two tiles ahead of
//     the one computed. Each warp copies 4 rows of a tile, each lane having
//     read its row's page-table entry a tile earlier: when one warp issued
//     all 32 copies, it stalled while the copy unit took them, and its pair
//     and then the block waited on it. Every stage has a `full` mbarrier
//     (the 8 warps' arrivals and the tile's bytes) and an `empty` one (the 8
//     warps' arrivals once done with the tile); a warp refills a stage after
//     waiting on its `empty`. No barrier spans the block inside the walk,
//     so the pairs drift apart by up to a tile and one pair's softmax
//     overlaps another's products. Tokens past the range's end are not
//     copied and their entries never read; their rows are zeroed instead,
//     so their P = 0 meets no NaN. Q stays bf16 in shared memory (64 x 576,
//     rows padded 16 bytes for conflict-free ldmatrix), staged by cp.async.
//   - Both products on tensor cores, mma.sync.m16n8k16 (bf16 in, f32
//     accumulate) with ldmatrix fragments (.trans on the value side): S =
//     Q Lat^T and O += P Lat[:, :512]. The 64 x 512 f32 accumulator is 128
//     registers a thread over 256 threads, so, as in FlashMLA, the 8 warps
//     are 4 row groups x 2 halves: for S a warp takes its 16 rows x its
//     half's 16 tokens of the tile, for O its 16 rows x its half's 256
//     columns. The two warps of a row group exchange the row max and the
//     bf16 P tile through shared memory (a 64-thread named barrier); the
//     online softmax runs in f32 registers with quad shuffles, scores in
//     base-2 units, the running max from -1e30 and masked scores -inf. P
//     is rounded to bf16 before the value product (the TPU kernels keep p
//     in f32).
//   - A row group's rows share one last visible position `vis`: scores of
//     tokens past it are masked in registers, a tile wholly at or below it
//     skips the mask, and a tile wholly past it skips both products for
//     the pair (both warps alike; they still arrive on the stage's
//     barriers).
//   - mma.sync rather than wgmma: it reuses the fragment code of
//     paged_flash.cuh and needs no warp specialisation. The blocks sit at
//     one an SM (~236 registers x 256 threads, 230 KB of shared memory),
//     and the products are bound by shared memory: every warp reads its Q
//     fragments again for each tile, and each latent tile is read by all 4
//     row groups. wgmma, which takes A and B from shared memory without
//     the ldmatrix round trip, with a producer warp, is the next step.
//
// Decode: grid (B, ceil(H / 64), NS). A block owns 64 heads of one
// sequence (FlashMLA's and wgmma's 64-row tile) over one context split:
// positions [z * split, min((z + 1) * split, kv_len)), NS = ceil(MP * PS /
// split) from the page table's width, so the launch needs no host sync;
// blocks past a row's kv_len return at once. Every live row group sees the
// whole split (vis = its end - 1). Sharing `attend` with prefill keeps its
// arithmetic, so its results, and costs it no occupancy: ptxas gives it
// 236 registers against 234 for a decode-only body on a 3-stage ring, no
// spill, one block an SM either way. The wrapper's split is 192 tokens: at
// the main path's batch, 63 live splits x 2 head groups = 126 blocks, one
// wave on 132 SMs (PERF.md gives the measurements behind it). A row whose
// context fits one split writes bf16 directly; longer rows write f32
// partials (O, m, l) to the wrapper's scratch [NS, B, H, 516], merged by
// log-sum-exp in split order by mla_decode_merge_kernel (paged_flash.cuh
// merge_splits), launched by the same call. No atomics: the same bits from
// run to run.
//
// int8 latent (decode only; template flag kI8): the pool is models/quant.py's
// {"q": int8 [NP, PS, 1, 576], "s": f32 [NP, PS, 1]}. A token's 576 codes are
// one bulk copy into the last 576 bytes of its 1168-byte row slot and its
// scale a 4-byte cp.async into the stage's slab [32] f32. Once a tile's
// `full` barrier has completed, each warp converts its own 4 rows to bf16
// in place (paged_flash.cuh convert_rows) and arrives on the stage's third
// barrier, `conv`; a warp computes on the tile after `conv` has completed.
// The one per-token scale multiplies the raw scores and, after the row
// sum, p (the TPU kernel's fold): it dequantizes both the scores' and the
// values' side of the same latent. 292 bytes a token against 1152 in bf16.
//
// Prefill: grid (ceil(S / 4), H / 16, B). A block owns 4 query tokens x 16
// heads, so a row group is one token's 16 heads and its causal limit,
// min(q_start + s, kv_len - 1), is the same for every row of the pair; a
// padding token's row group (s >= q_len) has none, stages zeros for Q and
// skips every tile. The block walks tiles [0, ceil((last + 1) / 32)),
// `last` the largest limit of its tokens: the trip-count form of the TPU
// kernel's `lat_index` clamp and `needed` test, so table entries past
// `last` are never read. A block with no live token writes its zeros and
// returns without staging anything: many blocks of the engine's padded
// [4, 256] dispatches. Block indices are mapped so that the token groups
// with the longest context start first, every head group of one before the
// next, and the light ones form the tail. No context split: at the timed
// shape (S 512, q_len 450 over 700 prior tokens, H 128) 904 live blocks
// fill about 7 waves.

#include "paged_flash.cuh"

namespace {

using paged_flash::kNegInf;
using paged_flash::minus_inf;
using paged_flash::smem_u32;

constexpr int kDL = 576;               // latent row: d_c + d_rh
constexpr int kDC = 512;               // value width: d_c
constexpr int kRowVecs = kDL / 8;      // 16-byte vectors per latent row (72)
constexpr int kThreads = 256;          // 4 row groups x 2 halves of 8 warps
constexpr int kRows = 64;              // query rows a block: wgmma's and FlashMLA's tile
constexpr int kT = 32;                 // context tokens a tile
constexpr int kStages = 4;             // depth of the latent tile ring
constexpr int kStr = kDL + 8;          // bf16 row stride of Q and latent tiles (584)
constexpr int kPStr = kT + 8;          // bf16 row stride of the P tile (40)
constexpr int kTileBytes = kT * kStr * 2;                  // 37,376
constexpr int kRingOff = kRows * kStr * 2;                 // after Q (74,752)
constexpr int kPOff = kRingOff + kStages * kTileBytes;
constexpr int kMaxOff = kPOff + kRows * kPStr * 2;         // [2][kRows] f32
constexpr int kLOff = kMaxOff + 2 * kRows * 4;             // [2][kRows] f32
constexpr int kBarOff = kLOff + 2 * kRows * 4;
constexpr int kSmemBytes = kBarOff + 2 * 8 * kStages;       // a full and an empty barrier a stage
// int8: a `conv` barrier a stage, then the stages' scale slabs [kStages][kT]
constexpr int kConvOff = kSmemBytes;
constexpr int kScaleOff = kConvOff + 8 * kStages;
constexpr int kSmemBytesI8 = kScaleOff + kStages * kT * 4;
constexpr int kWarps = kThreads / 32;
constexpr int kCopiesPerWarp = kT / kWarps;  // latent rows a warp copies a tile (4)
// tiles issued ahead of the one computed: the ring also holds the tile
// computed and the one before it, which the slowest warps may still read
constexpr int kLead = kStages - 2;
constexpr int kOCols = kDC / 2 / 8;    // 8-column blocks of a half's accumulator (32)
constexpr int kMergeThreads = kDC / 4; // a merge block: one head, a float4 a thread
constexpr int kPreHeads = 16;                   // heads a prefill block: a row group
constexpr int kPreTokens = kRows / kPreHeads;   // query tokens a prefill block (4)
static_assert(kSmemBytesI8 <= 232448, "the ring fits shared memory");

// the 64 threads of row group rg's two warps
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(1 + rg) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// The block's attention over context positions [c_begin, c_end), c_begin a
// multiple of kT, in the layout above: q_row(r) is row r's 576 query values
// in global memory (nullptr: staged as zeros), vis the last position this
// warp's row group sees (-1: none; at most c_end - 1), pt the row's page
// table over the pool [NP, PS, 576] (bf16; with kI8 int8 codes, lat_s their
// scales [NP, PS]). On return o holds rows r0 = rg * 16 +
// lane / 4 and r0 + 8 (index i) unnormalised, columns ch * 256 + n * 8 +
// 2 * (lane % 4) and the next; m the running max in base-2 units; l the sum
// over the whole row (both halves, added in half order). Every thread of
// the block must call it (it holds __syncthreads).
template <bool kI8, class QRow>
__device__ __forceinline__ void attend(unsigned char* dsmem, QRow q_row, int vis,
                                       const void* __restrict__ lat,
                                       const float* __restrict__ lat_s,
                                       const int* __restrict__ pt, int PS, int c_begin,
                                       int c_end, float scale_log2, float (&o)[kOCols][4],
                                       float (&m)[2], float (&l)[2]) {
  using paged_flash::exp2_approx;
  using paged_flash::ldsm_x4;
  using paged_flash::ldsm_x4_trans;
  using paged_flash::mma_bf16;
  using paged_flash::pack_bf16;
  using paged_flash::quad_max;
  using paged_flash::quad_sum;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(dsmem);
  __nv_bfloat16* sLat = reinterpret_cast<__nv_bfloat16*>(dsmem + kRingOff);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(dsmem + kPOff);
  float* sMax = reinterpret_cast<float*>(dsmem + kMaxOff);
  float* sL = reinterpret_cast<float*>(dsmem + kLOff);
  float* sSc = reinterpret_cast<float*>(dsmem + kScaleOff);  // kI8 only
  const uint32_t bar0 = smem_u32(dsmem + kBarOff);
  const uint32_t conv0 = smem_u32(dsmem + kConvOff);  // kI8 only
  constexpr int kElem = kI8 ? 1 : 2;  // bytes a pool element
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int rg = warp & 3;   // rows rg * 16 .. + 15
  const int ch = warp >> 2;  // S: tile tokens ch * 16 .. + 15; O: columns ch * 256 .. + 255
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kT - 1) / kT : 0;

  for (int i = tid; i < kRows * kRowVecs; i += kThreads) {
    const int r = i / kRowVecs;
    const int c8 = (i % kRowVecs) * 8;
    const __nv_bfloat16* src = q_row(r);
    paged_flash::cp_async16(smem_u32(sQ + r * kStr + c8),
                            src ? src + c8 : static_cast<const __nv_bfloat16*>(lat),
                            src != nullptr);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // stage s: `full` at bar0 + 8 s, `empty` at bar0 + 8 (kStages + s), with
  // kI8 `conv` at conv0 + 8 s, each arrived on once a tile by every warp
  if (tid == 0) {
    for (int s = 0; s < 2 * kStages; ++s) paged_flash::mbar_init(bar0 + 8 * s, kWarps);
    if constexpr (kI8) {
      for (int s = 0; s < kStages; ++s) paged_flash::mbar_init(conv0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kI8) {  // scales of tokens never copied stay finite
    for (int i = tid; i < kStages * kT; i += kThreads) sSc[i] = 0.f;
  }
  __syncthreads();  // the barriers (and the zeroed scales) are visible

  // Tile u goes into stage u % kStages, issued by every warp at the start of
  // tile u - kLead once all are done with tile u - kStages (`empty`): lanes
  // j < 4 of warp w copy token 4 w + j's 1152-byte row, its table entry read
  // a tile earlier (`page`). The rows of a partial tile's missing tokens
  // (past c_end: never copied, their table entries never read) are zeroed
  // by their warp instead, before its arrival on the stage's `full`
  // barrier, which orders the zeros before every reader. Only the last tile
  // is partial, so no copy lands later on a zeroed row.
  const int tok = warp * kCopiesPerWarp + lane;  // this lane's token of a tile
  auto fetch_page = [&](int u) {
    const int c = c_begin + u * kT + tok;
    return lane < kCopiesPerWarp && u < n_tiles && c < c_end ? __ldg(pt + c / PS) : 0;
  };
  int page = fetch_page(0);  // of token `tok` in the next tile to issue
  // With kI8 a lane's codes land in its row slot's last 576 bytes (the
  // zeroed rows convert to 0) and its scale in the stage's slab; every lane
  // commits one cp.async group an issue.
  auto issue = [&](int u) {
    const int c0 = c_begin + u * kT;
    const int n = min(kT, c_end - c0) - warp * kCopiesPerWarp;  // this warp's rows to copy
    const uint32_t full = bar0 + 8 * (u % kStages);
    __nv_bfloat16* rows = sLat + ((u % kStages) * kT + warp * kCopiesPerWarp) * kStr;
    for (int i = max(n, 0) * kRowVecs + lane; i < kCopiesPerWarp * kRowVecs; i += 32) {
      *reinterpret_cast<uint4*>(rows + (i / kRowVecs) * kStr + (i % kRowVecs) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
    if (lane == 0) {
      paged_flash::mbar_expect_tx(full, min(max(n, 0), kCopiesPerWarp) * kDL * kElem);
    }
    if (lane < min(n, kCopiesPerWarp)) {
      const size_t cell = (size_t)page * PS + (c0 + tok) % PS;
      unsigned char* dst = reinterpret_cast<unsigned char*>(rows + lane * kStr);
      paged_flash::bulk_copy(smem_u32(dst + (kI8 ? kStr * 2 - kDL : 0)),
                             static_cast<const unsigned char*>(lat) + cell * kDL * kElem,
                             kDL * kElem, full);
      if constexpr (kI8) {
        paged_flash::cp_async4(smem_u32(sSc + (u % kStages) * kT + tok), lat_s + cell);
      }
    }
    if constexpr (kI8) paged_flash::cp_async_commit();
    page = fetch_page(u + 1);
  };
  for (int u = 0; u < kLead && u < n_tiles; ++u) issue(u);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // Q
  __syncthreads();  // Q is visible

#pragma unroll
  for (int n = 0; n < kOCols; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;  // over this warp's half of each tile
  const int r0 = rg * 16 + (lane >> 2);

  for (int t = 0; t < n_tiles; ++t) {
    const int u = t + kLead;
    if (u < n_tiles) {
      if (u >= kStages)  // every warp is done with tile u - kStages
        paged_flash::mbar_wait(bar0 + 8 * (kStages + u % kStages), (u / kStages - 1) & 1);
      issue(u);
    } else if constexpr (kI8) {
      paged_flash::cp_async_commit();  // one group an iteration
    }
    paged_flash::mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
    const int c0 = c_begin + t * kT;
    const __nv_bfloat16* sT = sLat + (t % kStages) * kT * kStr;
    const float* sc = sSc + (t % kStages) * kT;  // kI8: the tile's scales
    if constexpr (kI8) {
      // this warp's 4 rows to bf16, its lanes' scales landed (tiles t + 1 ..
      // t + kLead may be in flight), then every warp's
      paged_flash::convert_rows<kDL, kStr * 2, kCopiesPerWarp>(reinterpret_cast<unsigned char*>(
          sLat + ((t % kStages) * kT + warp * kCopiesPerWarp) * kStr));
      paged_flash::cp_async_wait<kLead>();
      paged_flash::fence_proxy_async();  // the converted rows before the refill
      __syncwarp();
      if (lane == 0) mbar_arrive(conv0 + 8 * (t % kStages));
      paged_flash::mbar_wait(conv0 + 8 * (t % kStages), (t / kStages) & 1);
    }
    if (c0 <= vis) {  // the pair sees some of this tile
      // S = Q Lat^T: 16 rows x this half's 16 tokens, k over all 576 columns
      float s[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 8
      for (int kc = 0; kc < kDL / 16; ++kc) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, smem_u32(sQ + (rg * 16 + (lane & 15)) * kStr + kc * 16 + (lane >> 4) * 8));
        ldsm_x4(bb, smem_u32(sT + (ch * 16 + (lane >> 4) * 8 + (lane & 7)) * kStr + kc * 16 +
                             ((lane >> 3) & 1) * 8));
        mma_bf16(s[0], a, bb[0], bb[1]);
        mma_bf16(s[1], a, bb[2], bb[3]);
      }
      // scale, mask the tokens past vis, row max over both halves
      const bool full = c0 + kT - 1 <= vis;
      float mx[2] = {minus_inf(), minus_inf()};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = ch * 16 + n * 8 + 2 * t4 + (e & 1);  // token of the tile
          const float raw = kI8 ? s[n][e] * sc[j] : s[n][e];
          s[n][e] = full || c0 + j <= vis ? raw * scale_log2 : minus_inf();
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) mx[i] = quad_max(mx[i]);
      if (t4 == 0) {
        sMax[ch * kRows + r0] = mx[0];
        sMax[ch * kRows + r0 + 8] = mx[1];
      }
      pair_sync(rg);
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const float m_new = fmaxf(m[i], fmaxf(sMax[r], sMax[kRows + r]));
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
        // with kI8 the values' scale multiplies p after the row sum
        const float v0 = kI8 ? sc[col] : 1.f, v1 = kI8 ? sc[col + 1] : 1.f;
        *reinterpret_cast<uint32_t*>(sP + r0 * kPStr + col) = pack_bf16(p0 * v0, p1 * v1);
        *reinterpret_cast<uint32_t*>(sP + (r0 + 8) * kPStr + col) =
            pack_bf16(p2 * v0, p3 * v1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
      for (int n = 0; n < kOCols; ++n) {
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
          ldsm_x4_trans(bb, smem_u32(sT + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                             kStr +
                                     ch * (kDC / 2) + n2 * 16 + (lane >> 4) * 8));
          mma_bf16(o[2 * n2], pa, bb[0], bb[1]);
          mma_bf16(o[2 * n2 + 1], pa, bb[2], bb[3]);
        }
      }
    }
    // this warp is done with tile t's stage (and the pair with its P tile
    // and maxima, which its two pair barriers order)
    __syncwarp();
    if (lane == 0) mbar_arrive(bar0 + 8 * (kStages + t % kStages));
  }

  // the row sums of both halves, added in half order
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);
  if (t4 == 0) {
    sL[ch * kRows + r0] = l[0];
    sL[ch * kRows + r0 + 8] = l[1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = sL[r0 + 8 * i] + sL[kRows + r0 + 8 * i];
}

// Grid (B, ceil(H / 64), NS), 256 threads: heads h0 .. h0 + 63 of sequence
// b over context positions [z * split, min((z + 1) * split, kv_len)).
template <bool kI8>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_split_kernel(const __nv_bfloat16* __restrict__ q,    // [B, H, 576]
                        const void* __restrict__ lat,           // [NP, PS, 576] bf16 / int8
                        const float* __restrict__ lat_s,        // kI8: [NP, PS] scales
                        const int* __restrict__ page_table,     // [B, MP]
                        const int* __restrict__ kv_lens,        // [B]
                        __nv_bfloat16* __restrict__ out,        // [B, H, 512]
                        float* __restrict__ part,               // [NS, B, H, 516]
                        int B, int H, int PS, int MP, int split, float scale_log2) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kRows;
  const int z = blockIdx.z;
  const int nh = min(kRows, H - h0);  // a multiple of 16
  const int kvl = min(kv_lens[b], MP * PS);
  const int c_begin = z * split;
  if (z > 0 && c_begin >= kvl) return;  // uniform over the block
  const int c_end = min(c_begin + split, kvl);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int rg = warp & 3;
  const int ch = warp >> 2;
  const bool live = rg * 16 < nh;  // uniform over the warp and its pair

  float o[kOCols][4], m[2], l[2];
  attend<kI8>(dsmem,
              [&](int r) { return r < nh ? q + ((size_t)b * H + h0 + r) * kDL : nullptr; },
              live ? c_end - 1 : -1, lat, lat_s, page_table + (size_t)b * MP, PS, c_begin,
              c_end, scale_log2, o, m, l);
  if (!live) return;
  const bool direct = kvl <= split;  // one split: bf16 out, else partials
  const int r0 = rg * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = (size_t)b * H + h0 + r0 + 8 * i;
    if (direct) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = out + row * kDC + ch * (kDC / 2) + 2 * t4;
#pragma unroll
      for (int n = 0; n < kOCols; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            paged_flash::pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    } else {
      float* p = part + ((size_t)z * B * H + row) * (kDC + 4);
#pragma unroll
      for (int n = 0; n < kOCols; ++n)
        *reinterpret_cast<float2*>(p + ch * (kDC / 2) + n * 8 + 2 * t4) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (ch == 0 && t4 == 0) *reinterpret_cast<float2*>(p + kDC) = make_float2(m[i], l[i]);
    }
  }
}

// Grid (B, H), 128 threads: each head of a row longer than one split
// merges its splits' partials in split order and writes bf16, one float4
// of the 512 columns a thread, so that every thread has all its splits'
// loads in flight at once.
__global__ void __launch_bounds__(kMergeThreads, 8)  // 64 registers: no spill
mla_decode_merge_kernel(const float* __restrict__ part, const int* __restrict__ kv_lens,
                        __nv_bfloat16* __restrict__ out, int B, int H, int PS, int MP,
                        int split) {
  const int b = blockIdx.x;
  const int kvl = min(kv_lens[b], MP * PS);
  if (kvl <= split) return;  // written by its one block
  const size_t row = (size_t)b * H + blockIdx.y;
  paged_flash::merge_splits<kDC, kMergeThreads>(
      part + row * (kDC + 4), (size_t)B * H * (kDC + 4), (kvl + split - 1) / split, 1,
      [=](int) { return out + row * kDC; });
}

// Grid (ceil(S / kPreTokens), H / kPreHeads, B), 256 threads: query tokens
// sb * kPreTokens .. + kPreTokens - 1 of row b, heads h0 .. h0 + kPreHeads
// - 1; block row r is token r / kPreHeads (row group rg is token rg), head
// r % kPreHeads.
__global__ void __launch_bounds__(kThreads, 1)
mla_prefill_kernel(const __nv_bfloat16* __restrict__ q,    // [B, S, H, 576]
                   const __nv_bfloat16* __restrict__ lat,  // [NP, PS, 576]
                   const int* __restrict__ page_table,     // [B, MP]
                   const int* __restrict__ q_start,        // [B]
                   const int* __restrict__ q_len,          // [B]
                   const int* __restrict__ kv_lens,        // [B]
                   __nv_bfloat16* __restrict__ out,        // [B, S, H, 512]
                   int S, int H, int PS, int MP, float scale_log2) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  // heaviest first: block k of the launch order takes token group n_sb - 1 -
  // k / n_hg and head group k % n_hg
  const int k = blockIdx.x + gridDim.x * blockIdx.y;
  const int sb = gridDim.x - 1 - k / gridDim.y;
  const int h0 = (k % gridDim.y) * kPreHeads;
  const int b = blockIdx.z;
  const int qs = q_start[b];
  const int ql = min(q_len[b], S);
  const int kvl = min(kv_lens[b], MP * PS);
  // the last context position token j of the block sees; -1: a padding
  // token, or no context
  auto limit = [&](int j) {
    const int s = sb * kPreTokens + j;
    return s < ql ? min(qs + s, kvl - 1) : -1;
  };
  int last = -1;
#pragma unroll
  for (int j = 0; j < kPreTokens; ++j) last = max(last, limit(j));
  const int tid = threadIdx.x;
  // row r's output, or nullptr past S
  auto out_row = [&](int r) {
    const int s = sb * kPreTokens + r / kPreHeads;
    return s < S ? out + (((size_t)b * S + s) * H + h0 + r % kPreHeads) * kDC : nullptr;
  };
  if (last < 0) {  // nothing to attend: zeros, uniform over the block
    for (int i = tid; i < kRows * (kDC / 8); i += kThreads) {
      __nv_bfloat16* o = out_row(i / (kDC / 8));
      if (o) *reinterpret_cast<uint4*>(o + (i % (kDC / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int t4 = lane & 3;
  const int rg = warp & 3;
  const int ch = warp >> 2;
  const int vis = limit(rg);

  float o[kOCols][4], m[2], l[2];
  attend<false>(dsmem,
                [&](int r) -> const __nv_bfloat16* {
                  if (limit(r / kPreHeads) < 0) return nullptr;
                  return q + (((size_t)b * S + sb * kPreTokens + r / kPreHeads) * H + h0 +
                              r % kPreHeads) * kDL;
                },
                vis, lat, nullptr, page_table + (size_t)b * MP, PS, 0, last + 1, scale_log2,
                o, m, l);
  const int r0 = rg * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* orow = out_row(r0 + 8 * i);
    if (orow == nullptr) continue;
    orow += ch * (kDC / 2) + 2 * t4;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < kOCols; ++n) {
      const float a = vis >= 0 ? o[n][2 * i] * inv : 0.f;
      const float c = vis >= 0 ? o[n][2 * i + 1] * inv : 0.f;
      *reinterpret_cast<uint32_t*>(orow + n * 8) = paged_flash::pack_bf16(a, c);
    }
  }
}

template <bool kI8>
cudaError_t launch_decode(dim3 grid, cudaStream_t st, const void* q, const void* lat,
                          const void* lat_s, const void* page_table, const void* kv_lens,
                          void* out, void* part, int B, int H, int PS, int MP, int split,
                          float scale) {
  constexpr int smem = kI8 ? kSmemBytesI8 : kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_split_kernel<kI8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mla_decode_split_kernel<kI8><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), lat, static_cast<const float*>(lat_s),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), B, H, PS, MP, split,
      scale * paged_flash::kLog2e);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, 576], lat [NP, PS, 1, 576], page_table [B, MP], kv_lens [B]
// -> out [B, H, 512]; bf16, int32. lat_s: nullptr for a bf16 latent pool;
// for an int8 one (codes [NP, PS, 1, 576]) its f32 scales [NP, PS, 1].
// part: f32 scratch [NS, B, H, 516], NS = ceil(MP * PS / split); only the
// splits of rows longer than one split are written.
extern "C" int decode_mla_attention(const void* q, const void* lat, const void* lat_s,
                                    const void* page_table, const void* kv_lens,
                                    void* out, void* part, int B, int H, int dc,
                                    int dr, int PS, int MP, int split, float scale,
                                    void* stream) {
  if (dc != kDC || dc + dr != kDL || H % 16 != 0 || split < kT || split % kT != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const int NS = (MP * PS + split - 1) / split;
  const int n_hb = (H + kRows - 1) / kRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, n_hb, NS);
  cudaError_t err =
      lat_s != nullptr
          ? launch_decode<true>(grid, st, q, lat, lat_s, page_table, kv_lens, out, part, B,
                                H, PS, MP, split, scale)
          : launch_decode<false>(grid, st, q, lat, lat_s, page_table, kv_lens, out, part, B,
                                 H, PS, MP, split, scale);
  if (err != cudaSuccess || NS < 2) return static_cast<int>(err);
  mla_decode_merge_kernel<<<dim3(B, H), kMergeThreads, 0, st>>>(
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
  if (dc != kDC || dc + dr != kDL || H % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      mla_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_prefill_kernel<<<dim3((S + kPreTokens - 1) / kPreTokens, H / kPreHeads, B),
                       kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(lat),
      static_cast<const int*>(page_table), static_cast<const int*>(q_start),
      static_cast<const int*>(q_len), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), S, H, PS, MP, scale * paged_flash::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
