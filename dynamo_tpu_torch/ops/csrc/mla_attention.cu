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
// The two bf16 kernels are one block shape walked by one function,
// `attend`: a block of 256 threads owns 64 query rows and walks a range of
// the context in tiles of 32 tokens. (The int8 latent's decode is a kernel
// of its own, below.)
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
// int8 latent (decode only: `mla_decode_codes_kernel`, the TPU kernel's
// `_mla_kernel_int8`): the pool is models/quant.py's {"q": int8 [NP, PS, 1,
// 576], "s": f32 [NP, PS, 1]}, 580 bytes a token against 1152 in bf16. The
// one per-token scale multiplies the raw score and, after the row sum, p
// (the TPU kernel's fold), which is then rounded to bf16 for the value
// product. The bf16 walk would convert each tile to bf16 in shared memory
// behind a block-wide barrier and read every fragment 4 times (PERF.md §6:
// 1.15x the bf16 body's time on half its bytes); this kernel keeps codes
// as codes and builds bf16 fragments in registers (paged_flash.cuh
// i8_lo_bf16x2 / i8_hi_bf16x2) as the A operand of wgmma, each code's
// fragments built once a block for the scores and once for the values:
//   - Grid and splits as the bf16 decode (64 heads of one sequence a
//     block), the split the wrapper's MLA_INT8_SPLIT_TOKENS, a multiple of
//     the kernel's 64-token tiles.
//   - Codes in shared memory as a TMA box with the 128-byte swizzle lays
//     them: a tile is 5 column blocks of 64 token rows x 128 bytes (the
//     576-byte row padded to 640 by the last box's out-of-bounds zeros), 40
//     KB, half a bf16 tile of twice the tokens. The ring is 3 tiles deep,
//     so a 192-token split is in flight at once, its table entries read
//     together first. At page sizes 8 to 64 (or multiples of 64) a page's
//     rows arrive as 5 boxes from a 2-D tensor map of the codes and its
//     scales as one bulk copy, all on the stage's one `full` mbarrier;
//     other page sizes copy each token's 36 16-byte chunks by cp.async
//     into the same swizzled slots (counted on the barrier by
//     cp.async.mbarrier.arrive) and load and store its scale. Tokens past
//     the split's end that a page box carries, and slots never copied,
//     are masked by select: their codes are finite as any int8, and
//     neither their stale scales nor their scores reach P.
//   - Two warpgroups in turns (ping-pong): warpgroup t % 2 owns tile t's
//     S^T = Lat Q^T for all 64 heads (wgmma m64n64k16, A the tile's 64
//     tokens from registers: a warp's 16 rows are 16 tokens, bit-reversed
//     within each 8 so that its 16-byte loads of their codes meet no bank
//     conflict, and one word of codes gives the A pairs of four k-slices; B
//     Q, staged once a block in that dim order, 128-byte swizzled) and its
//     softmax down S^T's columns (each head's max over the 64 tokens by
//     shuffles and a 128-thread barrier, the running max from the last
//     tile's owner), then writes P^T [64 heads][64 tokens] through
//     movmatrix and publishes m, alpha and the running row sum l (mbarrier
//     `soft`). Every warpgroup then adds tile t into O^T for its own 256
//     dims (O^T = Lat[:, :512]^T P^T, A from ldmatrix.trans on code pairs,
//     B P^T), after rescaling by the published alpha. So one warpgroup's
//     S^T products and conversions run under the other's O^T, O^T takes
//     128 registers a thread and S^T 32, and P^T is double-buffered by tile
//     parity (mbarrier `pfree`: both warpgroups done with tile t - 2).
//   - What bounds it, measured on an H100 with phases cut out of copies
//     (PERF.md §6, int8 MLA decode): not the tensor cores (cutting every
//     product saves ~4%), but the conversions and their loads, the start
//     (every block stages its 73 KB of Q and its first tiles at once), the
//     f32 partials and their merge.
//   - The last of the block's warps to be done with a stage refills it (a
//     count in shared memory), so no warp waits on another's release.
//   - The merge, mla_decode_merge_codes_kernel, is merge_splits' result in
//     one pass (paged_flash.cuh merge_splits_chunked) launched as a
//     programmatic dependent of the split kernel.

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

#include <map>
#include <mutex>
#include <tuple>

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
constexpr int kWarps = kThreads / 32;
constexpr int kCopiesPerWarp = kT / kWarps;  // latent rows a warp copies a tile (4)
// tiles issued ahead of the one computed: the ring also holds the tile
// computed and the one before it, which the slowest warps may still read
constexpr int kLead = kStages - 2;
constexpr int kOCols = kDC / 2 / 8;    // 8-column blocks of a half's accumulator (32)
constexpr int kMergeThreads = kDC / 4; // a merge block: one head, a float4 a thread
constexpr int kPreHeads = 16;                   // heads a prefill block: a row group
constexpr int kPreTokens = kRows / kPreHeads;   // query tokens a prefill block (4)
static_assert(kSmemBytes <= 232448, "the ring fits shared memory");

// mla_decode_codes_kernel's shared memory, from a 1024-byte-aligned base
// (the 128-byte swizzle's repeat): Q [9 chunks of 64 dims][64 heads][128
// bytes] in the order of the codes' fragments, P^T [2 tiles][64 heads][128
// bytes], the code ring [kCStages][5 column blocks][64 tokens][128 bytes],
// the scale slabs [kCStages][64] f32, the softmax's exchange [2
// warpgroups][max, sum][4 warps][64 heads] f32, the published [2 tiles][m,
// alpha, row sum][64 heads] f32, then the mbarriers (`full` a stage, `soft`
// and `pfree` by tile parity) and a release count a stage
constexpr int kCT = 64;                  // context tokens a tile
constexpr int kCStages = 3;              // depth of the code ring
constexpr int kCBlocks = 5;              // 128-byte column blocks of a code row (576 -> 640)
constexpr int kCBlockBytes = kCT * 128;  // 8,192
constexpr int kCStageBytes = kCBlocks * kCBlockBytes;  // 40,960
constexpr int kQChunks = kDL / 64;       // 9
constexpr int kCPOff = kQChunks * kRows * 128;                  // 73,728
constexpr int kCRingOff = kCPOff + 2 * kRows * 128;             // 90,112
constexpr int kCScaleOff = kCRingOff + kCStages * kCStageBytes;  // 212,992
constexpr int kCRedOff = kCScaleOff + kCStages * kCT * 4;
constexpr int kCPubOff = kCRedOff + 2 * 2 * 4 * kRows * 4;
constexpr int kCBarOff = kCPubOff + 2 * 3 * kRows * 4;
constexpr int kCCntOff = kCBarOff + 8 * (kCStages + 4);
constexpr int kCSmemBytes = kCCntOff + 4 * kCStages + 1024;  // and the alignment
constexpr int kCMergeThreads = kDC / 4;  // the int8 merge: one head, a float4 a thread
static_assert(kCSmemBytes <= 232448, "the code ring fits shared memory");

// the 64 threads of row group rg's two warps
__device__ __forceinline__ void pair_sync(int rg) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(1 + rg) : "memory");
}

// The block's attention over context positions [c_begin, c_end), c_begin a
// multiple of kT, in the layout above: q_row(r) is row r's 576 query values
// in global memory (nullptr: staged as zeros), vis the last position this
// warp's row group sees (-1: none; at most c_end - 1), pt the row's page
// table over the bf16 pool [NP, PS, 576]. On return o holds rows r0 = rg * 16 +
// lane / 4 and r0 + 8 (index i) unnormalised, columns ch * 256 + n * 8 +
// 2 * (lane % 4) and the next; m the running max in base-2 units; l the sum
// over the whole row (both halves, added in half order). Every thread of
// the block must call it (it holds __syncthreads).
template <class QRow>
__device__ __forceinline__ void attend(unsigned char* dsmem, QRow q_row, int vis,
                                       const __nv_bfloat16* __restrict__ lat,
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
  const uint32_t bar0 = smem_u32(dsmem + kBarOff);
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
                            src ? src + c8 : lat,
                            src != nullptr);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // stage s: `full` at bar0 + 8 s, `empty` at bar0 + 8 (kStages + s), each
  // arrived on once a tile by every warp
  if (tid == 0) {
    for (int s = 0; s < 2 * kStages; ++s) paged_flash::mbar_init(bar0 + 8 * s, kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are visible

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
      paged_flash::mbar_expect_tx(full, min(max(n, 0), kCopiesPerWarp) * kDL * 2);
    }
    if (lane < min(n, kCopiesPerWarp)) {
      const size_t cell = (size_t)page * PS + (c0 + tok) % PS;
      paged_flash::bulk_copy(smem_u32(rows + lane * kStr), lat + cell * kDL, kDL * 2, full);
    }
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
    }
    paged_flash::mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
    const int c0 = c_begin + t * kT;
    const __nv_bfloat16* sT = sLat + (t % kStages) * kT * kStr;
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
          s[n][e] = full || c0 + j <= vis ? s[n][e] * scale_log2 : minus_inf();
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
        *reinterpret_cast<uint32_t*>(sP + r0 * kPStr + col) = pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t*>(sP + (r0 + 8) * kPStr + col) = pack_bf16(p2, p3);
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
    if (lane == 0) paged_flash::mbar_arrive(bar0 + 8 * (kStages + t % kStages));
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
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_split_kernel(const __nv_bfloat16* __restrict__ q,    // [B, H, 576]
                        const __nv_bfloat16* __restrict__ lat,  // [NP, PS, 576]
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
  attend(dsmem, [&](int r) { return r < nh ? q + ((size_t)b * H + h0 + r) * kDL : nullptr; },
         live ? c_end - 1 : -1, lat, page_table + (size_t)b * MP, PS, c_begin, c_end,
         scale_log2, o, m, l);
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

// -- int8 latent: mla_decode_codes_kernel -------------------------------------

// the k pairs of a code word as a bf16 pair: bytes 0 and 2 (lo), 1 and 3 (hi)
using paged_flash::bitrev3;
using paged_flash::i8_hi_bf16x2;
using paged_flash::i8_lo_bf16x2;

// the 128 threads of warpgroup wg
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

#define MLA_D8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16, this warp's 16 rows in a: mma.sync's A fragment) @ B
// (16 x 64 from shared memory, K-major, 128-byte swizzle); with scale_d 0
// the product overwrites d
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : MLA_D8(0), MLA_D8(8), MLA_D8(16), MLA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef MLA_D8

// Grid (B, ceil(H / 64), NS), 256 threads: heads h0 .. h0 + 63 of sequence
// b over context positions [z * split, min((z + 1) * split, kv_len)), split
// a multiple of kCT. Warpgroup wg computes S^T and the softmax of tiles t
// with t % 2 == wg (the tile's `owner`) for all 64 heads, and O^T of every
// tile for dims 256 wg .. 256 wg + 255.
// box_rows > 0: a run of box_rows tokens of one page arrives as 5 TMA boxes
// of lat_map (the codes as [NP PS, 576] bytes, boxes of 128 bytes x
// box_rows rows, 128-byte swizzle; the last box's bytes 576..639 are out of
// bounds and land as zeros) and one bulk copy of its box_rows scales; else
// each token's 36 16-byte chunks by cp.async into the same swizzled slots
// and its scale by a load and a store.
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_codes_kernel(const __nv_bfloat16* __restrict__ q,     // [B, H, 576]
                        const __grid_constant__ CUtensorMap lat_map,
                        const int8_t* __restrict__ lat,          // [NP PS, 576] codes
                        const float* __restrict__ lat_s,         // [NP PS] scales
                        const int* __restrict__ page_table,      // [B, MP]
                        const int* __restrict__ kv_lens,         // [B]
                        __nv_bfloat16* __restrict__ out,         // [B, H, 512]
                        float* __restrict__ part,                // [NS, B, H, 516]
                        int B, int H, int PS, int MP, int split, int box_rows,
                        float scale_log2) {
  using paged_flash::fence_acc;
  using paged_flash::mbar_arrive;
  using paged_flash::mbar_wait;
  using paged_flash::movmatrix_trans;
  using paged_flash::pack_bf16;
  using paged_flash::sw128_desc;
  // the merge (a programmatic dependent launch) may be scheduled now; it
  // waits for this grid to complete before it reads
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(1024) unsigned char csmem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(csmem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * kRows;
  const int z = blockIdx.z;
  const int nh = min(kRows, H - h0);  // a multiple of 16
  const int kvl = min(kv_lens[b], MP * PS);
  const int c_begin = z * split;
  if (z > 0 && c_begin >= kvl) return;  // uniform over the block
  const int c_end = min(c_begin + split, kvl);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kCT - 1) / kCT : 0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = warp >> 2;  // warpgroup
  const int wq = warp & 3;   // warp of the warpgroup: its rows 16 wq .. 16 wq + 15
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int* pt = page_table + (size_t)b * MP;
  const uint32_t base = smem_u32(sm);
  const uint32_t ring = base + kCRingOff;
  const uint32_t bar0 = base + kCBarOff;           // `full` a stage
  const uint32_t soft0 = bar0 + 8 * kCStages;      // a tile's softmax published, by parity
  const uint32_t pfree0 = soft0 + 16;              // a P^T slot free again, by parity
  float* sSc = reinterpret_cast<float*>(sm + kCScaleOff);
  float* s_pub = reinterpret_cast<float*>(sm + kCPubOff);  // [2][3][64]: m, alpha, l
  int* released = reinterpret_cast<int*>(sm + kCCntOff);
  if (tid == 0) {
    // a stage's `full`: the issuing lane's expect_tx and its warp's 32
    // cp.async arrivals
    for (int s = 0; s < kCStages; ++s) paged_flash::mbar_init(bar0 + 8 * s, 33);
    for (int s = 0; s < 2; ++s) {
      paged_flash::mbar_init(soft0 + 8 * s, 32);  // the owner's warp 0
      paged_flash::mbar_init(pfree0 + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < kCStages) released[tid] = 0;
  __syncthreads();  // the barriers and counts are visible

  // The pool row of this lane's box of tile u (lane i: the box of tokens
  // c0 + i box_rows ..), -1 past the tile's boxes (at most kCT / 8 a tile)
  auto box_row = [&](int u) {
    const int c0 = c_begin + u * kCT;
    const int c = c0 + lane * box_rows;
    return box_rows > 0 && u < n_tiles && c < min(c0 + kCT, c_end)
               ? __ldg(pt + c / PS) * PS + c % PS
               : -1;
  };
  // Tile u into stage u % kCStages, by one whole warp (row: box_row(u)):
  // the tokens [c0, c0 + n) it holds (a page's tokens past c_end ride along
  // in its box; tokens not copied keep stale codes, finite as any int8, and
  // are masked)
  auto issue = [&](int u, int row) {
    const int c0 = c_begin + u * kCT;
    const int n = min(kCT, c_end - c0);
    const int s = u % kCStages;
    const uint32_t full = bar0 + 8 * s;
    const uint32_t st = ring + s * kCStageBytes;
    const uint32_t sc = smem_u32(sSc + s * kCT);
    if (box_rows > 0) {
      if (lane == 0) {
        const int nb = (n + box_rows - 1) / box_rows;
        paged_flash::mbar_expect_tx(full, nb * box_rows * (kCBlocks * 128 + 4));
      }
      if (row >= 0) {
#pragma unroll
        for (int cb = 0; cb < kCBlocks; ++cb) {
          paged_flash::tma_load_2d(st + cb * kCBlockBytes + lane * box_rows * 128, &lat_map,
                                   full, cb * 128, row);
        }
        paged_flash::bulk_copy(sc + lane * box_rows * 4, lat_s + row, box_rows * 4, full);
      }
    } else {
      // a copy a token: its codes by cp.async (counted on `full` by the
      // lanes' cp.async arrivals below), its scale loaded and stored here,
      // ordered before the barrier by the warp's sync and lane 0's arrival
      for (int j = lane; j < n; j += 32) {
        const size_t row = (size_t)__ldg(pt + (c0 + j) / PS) * PS + (c0 + j) % PS;
        const int8_t* src = lat + row * kDL;
        for (int ch = 0; ch < kDL / 16; ++ch) {
          paged_flash::cp_async16(
              st + (ch >> 3) * kCBlockBytes + j * 128 + (((ch & 7) ^ (j & 7)) << 4),
              src + ch * 16, true);
        }
        sSc[s * kCT + j] = __ldg(lat_s + row);
      }
      __syncwarp();
      if (lane == 0) paged_flash::mbar_expect_tx(full, 0);
    }
    paged_flash::cp_async_arrive(full);
  };
  if (warp == 0) {  // the first tiles' table entries all read at once, then their copies
    int rows[kCStages];
#pragma unroll
    for (int u = 0; u < kCStages; ++u) rows[u] = box_row(u);
#pragma unroll
    for (int u = 0; u < kCStages; ++u) {
      if (u < n_tiles) issue(u, rows[u]);
    }
  }

  // Q of the block's 64 heads (zeros past nh), in the codes' order: within
  // a 64-dim chunk, k-slice j's position kk holds dim 16 t + 4 j + d for kk
  // = 2 t + (d >> 1) + 8 (d & 1) (the dims a thread's code word gives,
  // below). A 16-byte load of dims 8 c .. 8 c + 7 of a chunk puts (e0, e2)
  // at position 32 (c & 1) + 2 (c >> 1), (e1, e3) 8 on, (e4, e6) 16 on, (e5,
  // e7) 24 on: four 4-byte stores into the swizzled row. Each thread's 18
  // loads are all in flight before its first store (one after another
  // they cost ~4% of the call, PERF.md §6).
  {
    constexpr int kQLoads = kRows * (kDL / 8) / kThreads;  // 18
    static_assert(kQLoads * kThreads == kRows * (kDL / 8), "Q in whole rounds");
    uint4 x[kQLoads];
#pragma unroll
    for (int k = 0; k < kQLoads; ++k) {
      const int i = tid + k * kThreads;
      const int head = i / (kDL / 8);
      x[k] = head < nh ? __ldg(reinterpret_cast<const uint4*>(
                             q + ((size_t)b * H + h0 + head) * kDL) + i % (kDL / 8))
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kQLoads; ++k) {
      const int i = tid + k * kThreads;
      const int head = i / (kDL / 8);
      const int c16 = i % (kDL / 8);
      const int c = c16 & 7;
      const uint32_t row = base + (c16 >> 3) * (kRows * 128) + head * 128 + 4 * (c >> 1);
      const uint32_t w[4] = {
          __byte_perm(x[k].x, x[k].y, 0x5410), __byte_perm(x[k].x, x[k].y, 0x7632),
          __byte_perm(x[k].z, x[k].w, 0x5410), __byte_perm(x[k].z, x[k].w, 0x7632)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        asm volatile("st.shared.u32 [%0], %1;\n"
                     :: "r"(row + (((4 * (c & 1) + e) ^ (head & 7)) << 4)), "r"(w[e])
                     : "memory");
      }
    }
  }
  paged_flash::fence_proxy_async();  // Q's stores before wgmma reads them
  __syncthreads();

  // This thread's heads: 8 j + 2 t4 + c for j < 8, c < 2 (index 2 j + c).
  // O^T (dims x heads): m-block mb holds
  // dims 256 wg + 64 mb .. + 63; this warp's rows 16 wq + g and + 8 are
  // dims + 16 wq + 2 g and + 1 (the ldmatrix.trans order below);
  // o[mb][4 j + 2 h + c] is dim + h of head 8 j + 2 t4 + c.
  float o[4][32];
#pragma unroll
  for (int mb = 0; mb < 4; ++mb) {
#pragma unroll
    for (int e = 0; e < 32; ++e) o[mb][e] = 0.f;
  }
  // S^T (tokens x heads): this warp's row 8 h + i is the tile's token 16 wq
  // + 8 h + bitrev3(i) (eight 16-byte loads of a phase in eight bank
  // quads), so this thread's rows g and g + 8 are tokens tk and tk + 8
  const int tk = 16 * wq + bitrev3(g);
  const int sw = bitrev3(g);  // tk % 8: the swizzle of its rows
  // the V side's ldmatrix.trans rows: matrix x = lane / 8 of a pair of
  // k-slices holds slice 2 p + x / 2, its tokens 8 (x & 1) + bitrev3(i) for
  // lane i = lane % 8 (the S^T rows' order, so P^T's k follows them)
  const int v_tok = 16 * (lane >> 4) + 8 * ((lane >> 3) & 1) + bitrev3(lane & 7);
  const int v_sw = bitrev3(lane & 7);
  float* red = reinterpret_cast<float*>(sm + kCRedOff) + wg * 2 * 4 * kRows;  // max, sum

  // S^T of tile t and its softmax (this warpgroup owns t): P^T into slot t &
  // 1, then the running max m, its rescale alpha and the running row sum l
  // published in s_pub[t & 1]
  auto s_tile = [&](int t) {
    const int s = t % kCStages;
    const unsigned char* stp = sm + kCRingOff + s * kCStageBytes;
    mbar_wait(bar0 + 8 * s, (t / kCStages) & 1);
    // S^T = Lat Q^T, k-slices 4 gr .. 4 gr + 3 from one 16-byte load of each
    // row's codes (dims 64 gr + 16 t4 .. + 15): word j's bytes 0 and 2 are
    // the A pair of k 2 t4, 2 t4 + 1, bytes 1 and 3 that of k 2 t4 + 8, + 9
    float sacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
#pragma unroll
    for (int gr = 0; gr < kQChunks; ++gr) {
      const unsigned char* at = stp + (gr >> 1) * kCBlockBytes + tk * 128 +
                                (((4 * (gr & 1) + t4) ^ sw) << 4);
      const uint4 xa = *reinterpret_cast<const uint4*>(at);
      const uint4 xb = *reinterpret_cast<const uint4*>(at + 8 * 128);
      const uint32_t wa[4] = {xa.x, xa.y, xa.z, xa.w};
      const uint32_t wb[4] = {xb.x, xb.y, xb.z, xb.w};
      uint32_t a[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j][0] = i8_lo_bf16x2(wa[j]);
        a[j][1] = i8_lo_bf16x2(wb[j]);
        a[j][2] = i8_hi_bf16x2(wa[j]);
        a[j][3] = i8_hi_bf16x2(wb[j]);
      }
      paged_flash::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_rs(sacc, a[j], sw128_desc(base + gr * (kRows * 128) + 32 * j, 16, 1024),
                 (gr | j) != 0);
      }
      paged_flash::wgmma_commit();
      // the batch before this one is done, and its A registers free: two
      // batches in flight, the next one's conversion under this one
      paged_flash::wgmma_wait<1>();
    }
    paged_flash::wgmma_wait<0>();
    fence_acc(sacc);

    // the scale on the raw score, then log2 e and the score scale; tokens
    // past c_end -inf (selected, so a stale scale never reaches them); the
    // column max of each head over the tile's 64 tokens
    const int c0 = c_begin + t * kCT;
    const bool ok0 = c0 + tk < c_end;
    const bool ok1 = c0 + tk + 8 < c_end;
    const float sc0 = sSc[s * kCT + tk];
    const float sc1 = sSc[s * kCT + tk + 8];
    float mx[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x0 = ok0 ? sacc[4 * j + c] * sc0 * scale_log2 : minus_inf();
        const float x1 = ok1 ? sacc[4 * j + 2 + c] * sc1 * scale_log2 : minus_inf();
        sacc[4 * j + c] = x0;
        sacc[4 * j + 2 + c] = x1;
        mx[2 * j + c] = fmaxf(x0, x1);
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], x));
    }
    float* red_max = red;
    float* red_sum = red + 4 * kRows;
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(red_max + wq * kRows + 8 * j + 2 * t4) =
            make_float2(mx[2 * j], mx[2 * j + 1]);
      }
    }
    wg_sync(wg);
    // the last tile's m (published by its owner, the other warpgroup)
    if (t > 0) mbar_wait(soft0 + 8 * ((t - 1) & 1), ((t - 1) >> 1) & 1);
    const float* prev = s_pub + ((t - 1) & 1) * 3 * kRows;
    float mn[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 v = *reinterpret_cast<const float2*>(red_max + 8 * j + 2 * t4);
#pragma unroll
      for (int w = 1; w < 4; ++w) {
        const float2 u = *reinterpret_cast<const float2*>(red_max + w * kRows + 8 * j + 2 * t4);
        v.x = fmaxf(v.x, u.x);
        v.y = fmaxf(v.y, u.y);
      }
      const float2 mp = t > 0 ? *reinterpret_cast<const float2*>(prev + 8 * j + 2 * t4)
                              : make_float2(kNegInf, kNegInf);
      mn[2 * j] = fmaxf(mp.x, v.x);
      mn[2 * j + 1] = fmaxf(mp.y, v.y);
    }
    // P = exp2(S - m); the row sums before the scale; P times the token's
    // scale, rounded to bf16, transposed by movmatrix into P^T [head][k] of
    // slot t & 1 (once both warpgroups are done with tile t - 2's): row 8 h +
    // 2 t4 (+ 1) of this warp is k = 16 wq + 8 h + 2 t4 (+ 1)
    if (t >= 2) mbar_wait(pfree0 + 8 * (t & 1), ((t - 2) >> 1) & 1);
    const uint32_t p_slot = base + kCPOff + (t & 1) * kRows * 128;
    float rs[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pv[2][2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p0 = paged_flash::exp2_approx(sacc[4 * j + c] - mn[2 * j + c]);
        const float p1 = paged_flash::exp2_approx(sacc[4 * j + 2 + c] - mn[2 * j + c]);
        rs[2 * j + c] = p0 + p1;
        pv[0][c] = ok0 ? p0 * sc0 : 0.f;
        pv[1][c] = ok1 ? p1 * sc1 : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t y = movmatrix_trans(pack_bf16(pv[h][0], pv[h][1]));
        asm volatile("st.shared.u32 [%0], %1;\n"
                     :: "r"(p_slot + (8 * j + g) * 128 + (((2 * wq + h) ^ g) << 4) + 4 * t4),
                        "r"(y)
                     : "memory");
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) rs[k] += __shfl_xor_sync(0xffffffffu, rs[k], x);
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<float2*>(red_sum + wq * kRows + 8 * j + 2 * t4) =
            make_float2(rs[2 * j], rs[2 * j + 1]);
      }
    }
    paged_flash::fence_proxy_async();  // P^T's stores before wgmma reads them
    wg_sync(wg);
    // warp 0 publishes the tile's m, alpha = exp2(m_prev - m) and l = l_prev
    // alpha + the tile's row sums (the 4 warps' in warp order), and arrives
    // on soft[t & 1]
    if (wq == 0) {
      float* pub = s_pub + (t & 1) * 3 * kRows;
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int hd = 8 * j + 2 * t4;
          float2 v = make_float2(0.f, 0.f);
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const float2 u = *reinterpret_cast<const float2*>(red_sum + w * kRows + hd);
            v.x += u.x;
            v.y += u.y;
          }
          const float2 mp = t > 0 ? *reinterpret_cast<const float2*>(prev + hd)
                                  : make_float2(kNegInf, kNegInf);
          const float2 lp = t > 0 ? *reinterpret_cast<const float2*>(prev + 2 * kRows + hd)
                                  : make_float2(0.f, 0.f);
          const float2 al = make_float2(paged_flash::exp2_approx(mp.x - mn[2 * j]),
                                        paged_flash::exp2_approx(mp.y - mn[2 * j + 1]));
          *reinterpret_cast<float2*>(pub + hd) = make_float2(mn[2 * j], mn[2 * j + 1]);
          *reinterpret_cast<float2*>(pub + kRows + hd) = al;
          *reinterpret_cast<float2*>(pub + 2 * kRows + hd) =
              make_float2(lp.x * al.x + v.x, lp.y * al.y + v.y);
        }
      }
      mbar_arrive(soft0 + 8 * (t & 1));
    }
  };

  // O^T += Lat[:, :512]^T P^T for tile t, this warpgroup's 256 dims: after
  // the owner's softmax, O rescaled by its published alpha; m-block mb,
  // this warp's 16-byte column of codes
  // (dims 256 wg + 64 mb + 16 wq ..), four k-slices of 16 tokens from two
  // ldmatrix.trans on code pairs (a matrix register's bytes 0 and 2 are the
  // A pair of its row g, dim 2 g; bytes 1 and 3 that of row g + 8, dim 2 g
  // + 1)
  auto o_tile = [&](int t) {
    const int s = t % kCStages;
    const uint32_t st = ring + s * kCStageBytes;
    mbar_wait(bar0 + 8 * s, (t / kCStages) & 1);
    mbar_wait(soft0 + 8 * (t & 1), (t >> 1) & 1);
    const float* pub = s_pub + (t & 1) * 3 * kRows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 al = *reinterpret_cast<const float2*>(pub + kRows + 8 * j + 2 * t4);
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        o[mb][4 * j] *= al.x;
        o[mb][4 * j + 1] *= al.y;
        o[mb][4 * j + 2] *= al.x;
        o[mb][4 * j + 3] *= al.y;
      }
    }
    const uint32_t p_slot = base + kCPOff + (t & 1) * kRows * 128;
#pragma unroll
    for (int mb = 0; mb < 4; ++mb) {
      const int cc = 16 * wg + 4 * mb + wq;  // the 16-byte column
      const uint32_t at = st + (cc >> 3) * kCBlockBytes + v_tok * 128 + (((cc & 7) ^ v_sw) << 4);
      uint32_t r[2][4];
      paged_flash::ldsm_x4_trans(r[0], at);
      paged_flash::ldsm_x4_trans(r[1], at + 32 * 128);
      uint32_t a[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t* x = r[k >> 1] + 2 * (k & 1);
        a[k][0] = i8_lo_bf16x2(x[0]);
        a[k][1] = i8_hi_bf16x2(x[0]);
        a[k][2] = i8_lo_bf16x2(x[1]);
        a[k][3] = i8_hi_bf16x2(x[1]);
      }
      paged_flash::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_rs(o[mb], a[k], sw128_desc(p_slot + 32 * k, 16, 1024), 1);
      }
      paged_flash::wgmma_commit();
      paged_flash::wgmma_wait<1>();
    }
    // this warp is done reading stage s; the last warp to be done refills
    // it with tile t + kCStages
    __syncwarp();
    int refill = 0;
    if (lane == 0) {
      __threadfence_block();
      refill = atomicAdd(released + s, 1) % kWarps == kWarps - 1;
    }
    if (__shfl_sync(0xffffffffu, refill, 0) && t + kCStages < n_tiles) {
      issue(t + kCStages, box_row(t + kCStages));
    }
    // no product stays in flight past the tile (ptxas would serialize
    // them); then P^T's slot is free as far as this warp goes
    paged_flash::wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < 4; ++mb) fence_acc(o[mb]);
    __syncwarp();
    if (lane == 0) mbar_arrive(pfree0 + 8 * (t & 1));
  };

  // each warpgroup's S^T on its own tiles, the O^T of every tile in order
  int next_o = 0;
  for (int t = wg; t < n_tiles; t += 2) {
    s_tile(t);
    for (; next_o <= t; ++next_o) o_tile(next_o);
  }
  for (; next_o < n_tiles; ++next_o) o_tile(next_o);

  const bool direct = kvl <= split;  // one split: bf16 out, else partials
  // the last tile's m and l (no tile: l 0, so the row comes out 0)
  const float* last = s_pub + ((n_tiles - 1) & 1) * 3 * kRows;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int head = 8 * j + 2 * t4 + c;
      if (head >= nh) continue;
      const size_t row = (size_t)b * H + h0 + head;
      const int d0 = 256 * wg + 16 * wq + 2 * g;
      const float L = n_tiles > 0 ? last[2 * kRows + head] : 0.f;
      if (direct) {
        const float inv = 1.f / fmaxf(L, 1e-30f);
        __nv_bfloat16* orow = out + row * kDC + d0;
#pragma unroll
        for (int mb = 0; mb < 4; ++mb) {
          *reinterpret_cast<uint32_t*>(orow + 64 * mb) =
              pack_bf16(o[mb][4 * j + c] * inv, o[mb][4 * j + 2 + c] * inv);
        }
      } else {
        float* p = part + ((size_t)z * B * H + row) * (kDC + 4);
#pragma unroll
        for (int mb = 0; mb < 4; ++mb) {
          *reinterpret_cast<float2*>(p + 64 * mb + d0) =
              make_float2(o[mb][4 * j + c], o[mb][4 * j + 2 + c]);
        }
        if (wg == 0 && wq == 0 && g == 0) {
          *reinterpret_cast<float2*>(p + kDC) = make_float2(last[head], L);
        }
      }
    }
  }
}

// Grid (B, H), kCMergeThreads threads: the int8 launches' merge, a
// programmatic dependent of the split kernel (scheduled while that grid
// runs, waiting for its memory here), merge_splits' result in one pass
// (paged_flash.cuh merge_splits_chunked).
__global__ void __launch_bounds__(kCMergeThreads)
mla_decode_merge_codes_kernel(const float* __restrict__ part, const int* __restrict__ kv_lens,
                              __nv_bfloat16* __restrict__ out, int B, int H, int PS, int MP,
                              int split) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.x;
  const int kvl = min(kv_lens[b], MP * PS);
  if (kvl <= split) return;  // written by its one block
  const size_t row = (size_t)b * H + blockIdx.y;
  paged_flash::merge_splits_chunked<kDC, kCMergeThreads>(
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
  attend(dsmem,
         [&](int r) -> const __nv_bfloat16* {
           if (limit(r / kPreHeads) < 0) return nullptr;
           return q + (((size_t)b * S + sb * kPreTokens + r / kPreHeads) * H + h0 +
                       r % kPreHeads) * kDL;
         },
         vis, lat, page_table + (size_t)b * MP, PS, 0, last + 1, scale_log2, o, m, l);
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

cudaError_t launch_decode(dim3 grid, cudaStream_t st, const void* q, const void* lat,
                          const void* page_table, const void* kv_lens, void* out, void* part,
                          int B, int H, int PS, int MP, int split, float scale) {
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  mla_decode_split_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(lat),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part), B, H, PS, MP, split,
      scale * paged_flash::kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || grid.z < 2) return err;
  mla_decode_merge_kernel<<<dim3(B, H), kMergeThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), B, H, PS, MP, split);
  return cudaGetLastError();
}

// rows a TMA box of the int8 kernel at page size PS: min(PS, kCT) when that
// is a whole number of 8-row swizzle repeats (1024 bytes) and a tile holds
// whole boxes; else 0 (a copy a token)
int code_box_rows(int PS) {
  const int r = PS < kCT ? PS : kCT;
  return r % 8 == 0 && (PS % kCT == 0 || kCT % PS == 0) ? r : 0;
}

// an int8 latent pool's codes [NP PS, 576] as a 2-D map of boxes 128 bytes
// x `rows` rows, 128-byte swizzle (the last box of a row reads 64 bytes
// out of bounds: zeros). Pools live as long as their runner, so maps are
// kept, keyed by pointer and shape.
bool code_map(CUtensorMap* map, const void* ptr, int NP, int PS, int rows) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, CUtensorMap> cache;
  const auto key = std::make_tuple(ptr, NP, PS);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const paged_flash::EncodeTiled fn = paged_flash::encoder();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kDL), static_cast<cuuint64_t>(NP) * PS};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kDL)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(rows)};
  const cuuint32_t ones[2] = {1, 1};
  if (!fn || fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides,
                box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

cudaError_t launch_codes(dim3 grid, cudaStream_t st, const void* q, const void* lat,
                         const void* lat_s, const void* page_table, const void* kv_lens,
                         void* out, void* part, int B, int H, int PS, int MP, int NP,
                         int split, float scale) {
  CUtensorMap map = {};
  const int rows = code_box_rows(PS);
  if (rows > 0 && !code_map(&map, lat, NP, PS, rows)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_codes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCSmemBytes);
  if (err != cudaSuccess) return err;
  mla_decode_codes_kernel<<<grid, kThreads, kCSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), map, static_cast<const int8_t*>(lat),
      static_cast<const float*>(lat_s), static_cast<const int*>(page_table),
      static_cast<const int*>(kv_lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), B, H, PS, MP, split, rows, scale * paged_flash::kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || grid.z < 2) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, H);
  cfg.blockDim = dim3(kCMergeThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, mla_decode_merge_codes_kernel,
                            static_cast<const float*>(part), static_cast<const int*>(kv_lens),
                            static_cast<__nv_bfloat16*>(out), B, H, PS, MP, split);
}

}  // namespace

// q [B, H, 576], lat [NP, PS, 1, 576], page_table [B, MP], kv_lens [B]
// -> out [B, H, 512]; bf16, int32. lat_s: nullptr for a bf16 latent pool
// (split a multiple of 32); for an int8 one (codes [NP, PS, 1, 576]) its
// f32 scales [NP, PS, 1] (split a multiple of 64). part: f32 scratch [NS,
// B, H, 516], NS = ceil(MP * PS / split); only the splits of rows longer
// than one split are written.
extern "C" int decode_mla_attention(const void* q, const void* lat, const void* lat_s,
                                    const void* page_table, const void* kv_lens,
                                    void* out, void* part, int B, int H, int dc,
                                    int dr, int PS, int MP, int NP, int split, float scale,
                                    void* stream) {
  const int tile = lat_s != nullptr ? kCT : kT;
  if (dc != kDC || dc + dr != kDL || H % 16 != 0 || split < tile || split % tile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const int NS = (MP * PS + split - 1) / split;
  const dim3 grid(B, (H + kRows - 1) / kRows, NS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      lat_s != nullptr ? launch_codes(grid, st, q, lat, lat_s, page_table, kv_lens, out, part,
                                      B, H, PS, MP, NP, split, scale)
                       : launch_decode(grid, st, q, lat, page_table, kv_lens, out, part, B,
                                       H, PS, MP, split, scale));
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
