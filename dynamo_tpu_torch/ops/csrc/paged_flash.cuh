// Shared tile body of the GQA paged flash-attention kernels for Hopper
// (sm_90a): flash_prefill.cu (chunked prefill) and
// ragged_paged_attention.cu (the flat mixed step) walk a block's range
// with `attend` (bf16) or `attend_codes` (int8); paged_attention.cu
// (decode) gives each warp its own tiles through `tile_update`, the
// per-tile step `attend` runs, or, over int8 pools, `tile_update_codes`,
// the one `attend_codes` runs. The split-context launchers (ragged, GQA decode, MLA decode in
// mla_attention.cu) share `merge_splits`. Each keeps its own launcher
// and epilogue.
//
// A block of W warps owns up to 16 W query rows of one kv head (row =
// token * G + group, the TPU kernels' [Sq * G] flattening), 16 rows a
// warp, and walks a range of the context in tiles of 64 tokens, from the
// first position any of its rows sees (with a sliding window, the lowest
// row's position - window + 1: the CUDA form of the Pallas index-map
// clamp, so tiles wholly below the window are never copied). Per tile:
//   - Loads by the TMA unit. K and V tiles stay bf16 in dynamic shared
//     memory, 64 x D each, rows padded by 16 bytes so that ldmatrix's
//     eight row reads of a phase land in eight different bank quads. A
//     token's K row and V row of one head are D contiguous bf16 in the
//     pool, so each is one bulk copy (cp.async.bulk) that finds its own
//     page, pt[c / PS]: any page size works, and 128 threads each issue
//     one copy a tile, counted on the stage's mbarrier. Bulk copies
//     rather than 16-byte cp.async from every thread: those hold the
//     issuing warps for most of a tile while the load/store unit
//     throttles them, where the TMA unit takes a copy and lets the warp
//     go on to the products. The tiles arrive in a ring of two stages,
//     so tile t + 1 is in flight while tile t is computed; page-table
//     entries are read two tiles ahead. Tokens past the block's last
//     visible position are not copied and read no table entry, so table
//     entries past kv_len are never read; the V ring is zeroed once, so
//     their P = 0 never meets a NaN.
//   - Products on tensor cores: S = Q K^T and O += P V with
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate), A and B fragments from
//     ldmatrix (.trans for V); any D that is a multiple of 16 (64, 96, 128,
//     256 are built). Up to D 128 Q's fragments are loaded once
//     into registers; at D 256 they would take 64 registers beside O's
//     128 (32 x 4 f32 a thread), so each tile reloads them from the Q tile
//     in shared memory (QFrags), one slice of 16 dims for all 64 tokens at
//     a time. S is masked in registers to each row's visible span (kv_len,
//     causal top, padding rows; with a window, template flag kWin, also
//     its low edge): a tile that every live row of the warp sees whole
//     skips the mask, a tile that no row of the warp sees skips the
//     products. The plain body (kWin and kCap false) carries no window or
//     cap code: on an H100 a per-score window test slowed the D 128
//     prefill (PERF.md, section 6).
//   - Online softmax in registers. Scores are kept in base-2 units
//     (scale * log2 e folded in), row max and row sum by quad shuffles
//     (the sum only once, at the end), m and l in f32. With a soft cap
//     (template flag kCap, so the plain body carries none of it) the true
//     score cap * tanh(s * scale / cap) is formed first, then log2 e is
//     applied and the mask set, the reference's order (scale, cap, mask).
//     tanh is 1 - 2 / (2^(2 x log2 e) + 1) on ex2.approx and rcp.approx:
//     absolute error about 1e-7 (times the cap in the score), where
//     tanh.approx.f32's 2^-11 relative error would move a capped score of
//     50 by 0.02. P is rounded to
//     bf16 in registers and is the A operand of P V as it stands (the S
//     accumulator's layout is the A fragment's, FlashAttention-2's
//     identity). One __syncthreads a tile frees the stage for reuse.
// Numerics: the running max starts at -1e30 and masked scores are -inf,
// so masked keys give p = 0 exactly and a row that sees nothing keeps
// l = 0; the epilogue divides by max(l, 1e-30) and writes rows that see
// nothing as exact zeros. No atomics: results are the same bit for bit
// from run to run.
//
// Why mma.sync and not wgmma: a ragged unit holds 3-24 live rows, below
// wgmma's 64-row tile. Why bulk copies and not TMA tensor tiles here: a
// tensor map over the pool {D, Hk, NP PS} loads a page's rows of one head
// by one box, and a box D + 16 bytes wide lands each row in a padded slot
// (its last 16 bytes out of bounds, zeros), but a box row is at most 256
// elements (D 256's padded row is 264 bf16, 272 int8) and the prefill and
// ragged walks were not measured with it; the int8 decode kernel
// (paged_attention.cu) uses such boxes at D <= 128, 16 times fewer copies
// (PERF.md §6, int8 GQA decode).
//
// int8 KV (template flag kI8; the pools are models/quant.py's {"q": int8,
// "s": f32 [NP, PS, Hk]}): the TPU kernels' `_*_kernel_int8` bodies. The
// scales are folded as the TPU kernel folds them: the K scale multiplies
// the raw score before the score map (scale, soft cap); the row sum takes
// p as it is; the V scale multiplies p only for the value product, before
// P is rounded to bf16. Three walks:
//   - prefill and ragged (`attend_codes`, `tile_update_codes`): codes stay
//     codes. A stage holds 64 K and 64 V slots of D + 16 bytes (D + 16 is
//     16 mod 32, so any eight consecutive slots start in eight different
//     16-byte bank quads), each filled by one bulk copy of a token's D
//     codes on the stage's mbarrier, and the tile's scales in the stage's
//     slab [2][64] f32 (one 4-byte cp.async each: a bulk copy takes no
//     fewer than 16 bytes, and a head's scales lie Hk floats apart). A
//     stage is about half a bf16 one; each kernel picks its ring's depth
//     by measurement (kCodeStages). The products read bf16 fragments
//     built in registers from the codes: i8_lo_bf16x2 turns bytes 0 and 2
//     of a word into a bf16 pair, exactly (three operations), and
//     i8_hi_bf16x2 bytes 1 and 3. K: S = Q K^T sums over d, so d may be
//     taken in any fixed order if Q's fragments take the same one: a
//     thread reads 16 of its token's codes with one 16-byte load (8 with
//     one 8-byte load in D 96's last 32 dims) and each 4-byte word of it
//     is one slice's B pair; Q is staged in shared memory in that order
//     (code_slice). The eight tokens of an 8-token block are taken in
//     bit-reversed order, so that the 16-, 8- and 4-byte loads of a
//     warp meet no bank conflict; S's columns, the masks and the scales
//     follow that order. V: O += P V sums over tokens, and P's fragments
//     are S's accumulators as they stand, so V's B fragments must hold
//     two tokens at one d: ldmatrix.trans on code pairs viewed as b16
//     gives each thread (token a: d, d + 1; token b: d, d + 1), whose
//     bytes 0 and 2 are the B pair of column d and bytes 1 and 3 that of
//     d + 1. O's columns come out in that order and the epilogues
//     (store_rows, the ragged partials) put them back (code_cols). No
//     bf16 copy of a tile is made and there is no conversion barrier: a
//     warp waits on a stage's mbarrier only for a tile it computes, and
//     the one __syncthreads a tile frees the stage (and, after each
//     thread's cp.async.wait_group, makes the tile's scales visible).
//     The cost moves to the integer pipe: 5 of its operations (at half
//     the issue rate on an H100) per 4 codes, in every warp that computes
//     a tile. A block whose rows fill one or two of its warps (a ragged
//     decode or chunk unit) therefore splits each tile's tokens among its
//     warps and merges their softmax states at the end (attend_codes); a
//     full prefill block cannot, and its 8 warps each convert every tile
//     (PERF.md, section 6).
//   - GQA decode (paged_attention.cu `decode_codes_kernel`): the same
//     slots and fragment conversions, one tile slot a warp and every tile
//     of a block's split in flight at once, with products transposed
//     (tile_update_codes_t there): a decode row group has G <= 8 query
//     rows, so the tile's tokens take the products' 16-row side and the
//     rows the 8-column side.
//   - MLA decode (mla_attention.cu `mla_decode_codes_kernel`): the same
//     conversions into the A operand of wgmma, in 128-byte-swizzled code
//     slots; a warpgroup builds a tile's fragments once for its 32 heads.

#pragma once

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged_flash {

constexpr int kTile = 64;   // context tokens a tile
constexpr int kStages = 2;  // depth of the K/V tile ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int W>
struct Shape {
  static constexpr int kThreads = 32 * W;
  static constexpr int kRows = 16 * W;        // query rows a block
  static constexpr int kStride = D + 8;       // bf16 row stride in shared memory
  static constexpr int kChunks = D / 8;       // 16-byte chunks a row
  static constexpr int kKC = D / 16;          // 16-wide slices of the head dim
  static constexpr int kTileElems = kTile * kStride;
  static constexpr int kQElems = kRows * kStride;
  // Q tile, kStages x (K tile, V tile), then one mbarrier a stage
  static constexpr int kRingBytes = (kQElems + 2 * kStages * kTileElems) * 2;
  static constexpr int kSmemBytes = kRingBytes + 8 * kStages;
  static_assert(kThreads >= 2 * kTile, "one bulk copy a thread a tile");
};

// attend_codes' shared memory, kS stages: the Q tile (bf16, rows D + 8
// apart, dims in code_slice's order), kS x (K codes, V codes) of kTile
// slots of D + 16 bytes, the stages' scale slabs [kS][2][kTile] f32, then
// one mbarrier a stage
template <int D, int W, int kS>
struct CodeShape {
  static constexpr int kSlot = D + 16;
  static constexpr int kStageBytes = 2 * kTile * kSlot;
  static constexpr int kRingOff = Shape<D, W>::kQElems * 2;
  static constexpr int kScaleOff = kRingOff + kS * kStageBytes;
  static constexpr int kBarOff = kScaleOff + kS * 2 * kTile * 4;
  static constexpr int kSmemBytes = kBarOff + 8 * kS;
  static_assert(kSlot % 32 == 16, "eight consecutive slots in eight bank quads");
  static_assert(D % 32 == 0 && kS >= 2, "32-dim column groups; a ring");
};

// A GQA kernel's pools on the host side of a launch: bf16 pools (scales
// nullptr), or int8 codes with their f32 scales [NP, PS, Hk]
struct KvPools {
  const void* k;
  const float* ks;
  const void* v;
  const float* vs;
};

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with fill false nothing is read and the 16
// bytes are zeroed
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(fill ? 16 : 0) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// 4 bytes global -> shared (cp.async.ca: the only size under 16 bytes)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's cp.async groups, all but the newest n complete
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// this thread's shared-memory writes ordered before later bulk copies
// (the async proxy) into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` global -> shared by the TMA unit, counted on mbarrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// one arrival on mbarrier `bar`
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// one arrival on `bar` when this thread's cp.async copies so far complete
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar)
               : "memory");
}

// box {c0, c1} of a 2-D tensor map -> shared, counted on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// box {c0, c1, c2} of a 3-D tensor map -> shared, counted on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// an 8 x 8 b16 matrix transposed across the warp: a thread holding (row
// g, columns 2 t4, 2 t4 + 1) gets (rows 2 t4, 2 t4 + 1, column g)
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n>  // all but the newest n groups of this warpgroup complete
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(n) : "memory");
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous products' issue and wait
template <int n>
__device__ __forceinline__ void fence_acc(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {  // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {  // 1 / inf = 0
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (e^(2x) + 1): -1 and 1 at the far ends (e^(2x) flushes
// to 0 or overflows to inf), absolute error about 1e-7 in between
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - 2.f * rcp_approx(exp2_approx(x * (2.f * kLog2e)) + 1.f);
}

// How a raw score s = q . k becomes the base-2 logit the softmax runs on:
// plain, s * scale * log2 e; with the soft cap, cap * tanh(s * scale /
// cap) * log2 e. Built on the host by score_map.
struct ScoreMap {
  float scale_log2;  // scale * log2 e
  float scale_cap;   // scale / cap (soft cap only)
  float cap_log2;    // cap * log2 e (soft cap only)
};

inline ScoreMap score_map(float scale, float softcap) {
  return ScoreMap{scale * kLog2e, softcap > 0.f ? scale / softcap : 0.f,
                  softcap * kLog2e};
}

template <bool kCap>
__device__ __forceinline__ float base2_logit(float s, const ScoreMap& sm) {
  if constexpr (kCap) {
    return sm.cap_log2 * tanh_fast(s * sm.scale_cap);
  } else {
    return s * sm.scale_log2;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The int8 codes in bytes 0 and 2 of w -> a bf16 pair, byte 0 in the low
// half; exact. With x7 = code & 0x7f and h its sign bit, bf16 0x4300 | x7
// is 128 + x7 and 0x4300 | h << 7 is 128 (h 0) or 256 (h 1): their
// difference, x7 - 128 h, is the code, exact in bf16. Two lop3 and one
// bf16x2 subtraction.
__device__ __forceinline__ uint32_t i8_lo_bf16x2(uint32_t w) {
  const uint32_t m = (w & 0x007f007fu) | 0x43004300u;
  const uint32_t s = (w & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(m), "r"(s));
  return d;
}

// ... and the codes in bytes 1 and 3
__device__ __forceinline__ uint32_t i8_hi_bf16x2(uint32_t w) {
  return i8_lo_bf16x2(w >> 8);
}

// Two e4m3 codes (bits 0-7 and 8-15 of p) -> a bf16 pair, the first in the
// low half; exact: e4m3 -> f16 by cvt.rn.f16x2.e4m3x2, then f16 -> f32 ->
// bf16, and every e4m3 value is a bf16 value (the weight-only fp8 GEMMs,
// quant_gemm.cu and moe_grouped_gemm.cu)
__device__ __forceinline__ uint32_t e4m3x2_bf16x2(uint32_t p) {
  uint32_t h2;
  asm("{\n .reg .b16 c;\n cvt.u16.u32 c, %1;\n cvt.rn.f16x2.e4m3x2 %0, c;\n}\n"
      : "=r"(h2) : "r"(p));
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
  return pack_bf16(f.x, f.y);
}

// The dims a thread's K code word covers, in attend_codes' order. D is cut
// into groups of 64 dims (a thread's 16-byte load of a token's codes at
// byte 16 t4 of the group, 4 slices of 16) and, at D 96, one last group of
// 32 (an 8-byte load at byte 8 t4, 2 slices). Word j of the load is slice
// s = group's first slice + j, and holds dims d0 .. d0 + 3 with d0 =
// group's first dim + (width / 4) t4 + 4 j; as B fragments, bytes 0 and 2
// stand at the slice's k 2 t4 and 2 t4 + 1 (d0, d0 + 2), bytes 1 and 3 at
// k 2 t4 + 8 and 2 t4 + 9 (d0 + 1, d0 + 3). Q's A fragments must hold the
// same dims at the same k: code_slice gives, for d0 (a multiple of 4), the
// slice s and the quad lane t4 whose word starts there.
template <int D>
__device__ __forceinline__ int2 code_slice(int d0) {
  constexpr int kG64 = D / 64 * 64;  // dims in groups of 64
  const int width = d0 < kG64 ? 64 : 32;
  const int base = d0 < kG64 ? d0 / 64 * 64 : kG64;
  const int off = d0 - base;
  return make_int2(base / 16 + (off % (width / 4)) / 4, off / (width / 4));
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// What a thread holds after `attend`: rows r0 = warp * 16 + lane / 4 and
// r0 + 8 (index i = 0, 1); o[n][2i], o[n][2i + 1] are dims n * 8 +
// 2 * (lane % 4) and the next of row i (after `attend_codes`, the dims
// code_cols gives), unnormalised; m in base-2 units; l summed over the row
// (the quad agrees).
template <int D>
struct RowState {
  float o[D / 8][4];
  float m[2];
  float l[2];
  int lo[2];   // first context position the row sees (window low edge)
  int vis[2];  // last context position the row sees; -1: none, or no row
  int r0;      // row i = 0's index (set by attend_codes; attend's is warp * 16 + lane / 4)
};

// Q's A fragments for one warp's 16 rows, from the Q tile in shared memory
// (rows D + 8 bf16 apart). Up to D 128 they are loaded once into
// registers; at D 256 each tile reloads them, slice by slice, with
// ldmatrix (64 registers saved; the Q tile stays put for the whole walk).
// kInRegs false reloads at any D (attend_codes' two 16-row tiles a warp).
template <int D, bool kInRegs = (D <= 128)>
struct QFrags {
  static constexpr bool kRegs = kInRegs;
  uint32_t f[kRegs ? D / 16 : 1][4];
  uint32_t addr;  // this lane's ldmatrix address, slice 0

  // sq_row0: the warp's first Q row in shared memory
  __device__ __forceinline__ void init(const __nv_bfloat16* sq_row0) {
    const int lane = threadIdx.x & 31;
    addr = smem_u32(sq_row0 + (lane & 15) * (D + 8) + (lane >> 4) * 8);
    if constexpr (kRegs) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) ldsm_x4(f[kc], addr + kc * 32);
    }
  }

  __device__ __forceinline__ void get(int kc, uint32_t (&a)[4]) const {
    if constexpr (kRegs) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = f[kc][j];
    } else {
      ldsm_x4(a, addr + kc * 32);
    }
  }
};

// One 64-token tile of the online softmax, in one warp: S = Q K^T for the
// warp's 16 query rows (qf: Q's A fragments), the score map (scale, soft
// cap with kCap) and mask (a token c counts for row i when full or c <=
// st.vis[i], and with kWin st.lo[i] <= c), the running max and sum, P
// rounded to bf16, O += P V. sK is the tile's K rows, the V rows follow
// kTileElems later, both with rows D + 8 bf16 apart (bf16 pools only: the
// int8 walks run tile_update_codes).
template <int D, bool kCap, bool kWin>
__device__ __forceinline__ void tile_update(const QFrags<D>& qf,
                                            const __nv_bfloat16* sK, int c0,
                                            bool full, const ScoreMap& sm,
                                            RowState<D>& st) {
  constexpr int kStride = D + 8;
  constexpr int kKC = D / 16;
  const __nv_bfloat16* sV = sK + kTile * kStride;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  // S = Q K^T: 16 rows x 64 tokens, 8 n-blocks of 8 tokens
  float s[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  auto k_frag = [&](int n2, int kc, uint32_t (&b)[4]) {
    ldsm_x4(b, smem_u32(sK + (n2 * 16 + (lane >> 4) * 8 + (lane & 7)) * kStride +
                        kc * 16 + ((lane >> 3) & 1) * 8));
  };
  if constexpr (QFrags<D>::kRegs) {
    // 16 tokens at a time over all of D: the order the D 128 kernels
    // were timed in (slice-major slowed the D 128 prefill on an H100)
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        uint32_t b[4];
        k_frag(n2, kc, b);
        mma_bf16(s[2 * n2], qf.f[kc], b[0], b[1]);
        mma_bf16(s[2 * n2 + 1], qf.f[kc], b[2], b[3]);
      }
    }
  } else {
    // one Q slice from shared memory for all 64 tokens
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t a[4];
      qf.get(kc, a);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        k_frag(n2, kc, b);
        mma_bf16(s[2 * n2], a, b[0], b[1]);
        mma_bf16(s[2 * n2 + 1], a, b[2], b[3]);
      }
    }
  }

  // score map, mask, row max
  float mx[2] = {minus_inf(), minus_inf()};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int c = c0 + n * 8 + 2 * t4 + (e & 1);
      const float x = base2_logit<kCap>(s[n][e], sm);
      s[n][e] = (full || (c <= st.vis[i] && (!kWin || c >= st.lo[i]))) ? x : minus_inf();
      mx[i] = fmaxf(mx[i], s[n][e]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(st.m[i], quad_max(mx[i]));
    alpha[i] = exp2_approx(st.m[i] - m_new);
    st.m[i] = m_new;
  }

  // P = exp2(S - m), rounded to bf16 as P V's A fragments
  uint32_t pa[4][4];
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float p0 = exp2_approx(s[n][0] - st.m[0]);
    const float p1 = exp2_approx(s[n][1] - st.m[0]);
    const float p2 = exp2_approx(s[n][2] - st.m[1]);
    const float p3 = exp2_approx(s[n][3] - st.m[1]);
    sum[0] += p0 + p1;
    sum[1] += p2 + p3;
    pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
    pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * alpha[i] + sum[i];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
  }

  // O += P V: k = the tile's 64 tokens in 4 slices of 16
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) {
#pragma unroll
    for (int n2 = 0; n2 < kKC; ++n2) {
      uint32_t b[4];
      ldsm_x4_trans(b, smem_u32(sV + (k2 * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                         kStride +
                                n2 * 16 + (lane >> 4) * 8));
      mma_bf16(st.o[2 * n2], pa[k2], b[0], b[1]);
      mma_bf16(st.o[2 * n2 + 1], pa[k2], b[2], b[3]);
    }
  }
}

// Token (within an 8-token block) of B column g: g's three bits reversed,
// so that a warp's loads of eight tokens' codes meet no bank conflict
__device__ __forceinline__ int bitrev3(int g) {
  return ((g & 1) << 2) | (g & 2) | (g >> 2);
}

// tile_update on int8 codes (attend_codes' stages): the same step, with
// the K and V fragments built from the codes in registers (the header's
// int8 paragraph), for the warp's kM 16-row tiles (st[m], Q fragments
// qf[m]: each fragment built feeds kM products) over its share of the
// tile: with kSplit warps on the same rows, warp part p takes tokens [64 p
// / kSplit, 64 (p + 1) / kSplit) (whole 16-token slices of P V). sK is the
// stage's K codes (64 slots of D + 16 bytes), the V codes follow; sSc the
// tile's scales (K at [0, 64), V at [64, 128)). S's column 2 t4 + j of
// block n is token n * 8 + tok + 4 j, tok = bitrev3(2 t4); O's columns
// are code_cols'.
template <int D, bool kCap, bool kWin, int kSplit, int kM, bool kQRegs>
__device__ __forceinline__ void tile_update_codes(const QFrags<D, kQRegs> (&qf)[kM],
                                                  const unsigned char* sK, int c0,
                                                  bool full, const ScoreMap& sm,
                                                  RowState<D>* st, const float* sSc,
                                                  int part) {
  constexpr int kSlot = D + 16;
  constexpr int kG64 = D / 64;          // 64-dim groups: 16-byte loads
  constexpr bool kG32 = D % 64 != 0;    // D 96's last 32 dims: 8-byte loads
  constexpr int kN = 8 / kSplit;        // the warp's 8-token blocks
  static_assert(kSplit == 1 || kSplit == 2 || kSplit == 4, "whole P V slices");
  const int n0 = part * kN;             // its first block
  const unsigned char* sV = sK + kTile * kSlot;
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int tok = bitrev3(2 * t4);
  // this lane's token row in each 8-token block, for the K loads
  const unsigned char* kr = sK + (n0 * 8 + bitrev3(lane >> 2)) * kSlot;
  float s[kM][kN][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][n][e] = 0.f;
  // S += Q K^T over one load group of kJ slices from dim byte `at`
  // (kJ 4: 16-byte loads; 2: 8-byte loads at 8 t4), slices from kc
  auto qk = [&](auto kj, int at, int kc) {
    constexpr int kJ = decltype(kj)::value;
    uint32_t a[kM][kJ][4];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int j = 0; j < kJ; ++j) qf[m].get(kc + j, a[m][j]);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      uint32_t w[kJ];
      const unsigned char* src = kr + n * 8 * kSlot + at + t4 * 4 * kJ;
      if constexpr (kJ == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        w[0] = v.x, w[1] = v.y;
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const uint32_t lo = i8_lo_bf16x2(w[j]), hi = i8_hi_bf16x2(w[j]);
#pragma unroll
        for (int m = 0; m < kM; ++m) mma_bf16(s[m][n], a[m][j], lo, hi);
      }
    }
  };
#pragma unroll
  for (int g = 0; g < kG64; ++g) qk(std::integral_constant<int, 4>{}, g * 64, 4 * g);
  if constexpr (kG32) qk(std::integral_constant<int, 2>{}, kG64 * 64, 4 * kG64);

  // per row tile: score map (the K scale on the raw score first), mask,
  // row max; P = exp2(S - m), the row sum before the V scale, then P * V
  // scale rounded to bf16 as P V's A fragments
  uint32_t pa[kM][kN / 2][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    RowState<D>& r = st[m];
    float mx[2] = {minus_inf(), minus_inf()};
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int t0 = (n0 + n) * 8 + tok;  // the tile's token of column 2 t4
      const float ks[2] = {sSc[t0], sSc[t0 + 4]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = c0 + t0 + 4 * (e & 1);
        const float x = base2_logit<kCap>(s[m][n][e] * ks[e & 1], sm);
        s[m][n][e] = (full || (c <= r.vis[i] && (!kWin || c >= r.lo[i]))) ? x : minus_inf();
        mx[i] = fmaxf(mx[i], s[m][n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(r.m[i], quad_max(mx[i]));
      alpha[i] = exp2_approx(r.m[i] - m_new);
      r.m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float p0 = exp2_approx(s[m][n][0] - r.m[0]);
      const float p1 = exp2_approx(s[m][n][1] - r.m[0]);
      const float p2 = exp2_approx(s[m][n][2] - r.m[1]);
      const float p3 = exp2_approx(s[m][n][3] - r.m[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      const int t0 = kTile + (n0 + n) * 8 + tok;
      const float vs0 = sSc[t0], vs1 = sSc[t0 + 4];
      pa[m][n >> 1][(n & 1) * 2] = pack_bf16(p0 * vs0, p1 * vs1);
      pa[m][n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2 * vs0, p3 * vs1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) r.l[i] = r.l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      r.o[n][0] *= alpha[0];
      r.o[n][1] *= alpha[0];
      r.o[n][2] *= alpha[1];
      r.o[n][3] *= alpha[1];
    }
  }

  // O += P V over the warp's 16-token slices (slice k's k index 8 b + 2
  // t4 + j is token 16 k + 8 b + bitrev3(2 t4 + j), as in P); one
  // ldmatrix.trans a slice and 32 dims: matrix x (lanes 8x .. 8x + 7 give
  // its rows) holds tokens 16 k + 8 (x & 1) + bitrev3(row) at bytes 32 c +
  // 16 (x >> 1), and register x of a thread the two tokens of its k pair at
  // one code pair (d, d + 1)
  const unsigned char* vr = sV + (n0 * 8 + 8 * ((lane >> 3) & 1) + bitrev3(lane & 7)) * kSlot +
                            16 * (lane >> 4);
#pragma unroll
  for (int k2 = 0; k2 < kN / 2; ++k2) {
#pragma unroll
    for (int c = 0; c < D / 32; ++c) {
      uint32_t b[4];
      ldsm_x4_trans(b, smem_u32(vr + k2 * 16 * kSlot + c * 32));
      const uint32_t e0 = i8_lo_bf16x2(b[0]), e1 = i8_lo_bf16x2(b[1]);
      const uint32_t o0 = i8_hi_bf16x2(b[0]), o1 = i8_hi_bf16x2(b[1]);
      const uint32_t e2 = i8_lo_bf16x2(b[2]), e3 = i8_lo_bf16x2(b[3]);
      const uint32_t o2 = i8_hi_bf16x2(b[2]), o3 = i8_hi_bf16x2(b[3]);
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        mma_bf16(st[m].o[4 * c], pa[m][k2], e0, e1);
        mma_bf16(st[m].o[4 * c + 1], pa[m][k2], o0, o1);
        mma_bf16(st[m].o[4 * c + 2], pa[m][k2], e2, e3);
        mma_bf16(st[m].o[4 * c + 3], pa[m][k2], o2, o3);
      }
    }
  }
}

// After tile_update_codes, this thread's O of row i (0, 1) at dims 32 c +
// 16 h + 4 t4 + (0, 1, 2, 3): block 4 c + 2 h holds the even dims of
// those columns, block 4 c + 2 h + 1 the odd ones
template <int D>
__device__ __forceinline__ float4 code_cols(const RowState<D>& st, int c, int h, int i) {
  const float(&ev)[4] = st.o[4 * c + 2 * h];
  const float(&od)[4] = st.o[4 * c + 2 * h + 1];
  return make_float4(ev[2 * i], od[2 * i], ev[2 * i + 1], od[2 * i + 1]);
}

// The block's attention over context positions [c_begin, c_end), in
// tiles from c_begin: a multiple of kTile without a window; with one
// (kWin), any position (the first one a row of the block sees). q_row(r)
// is row r's D query values in global memory (nullptr: no row, staged as
// zeros); row_span(r) the first and last context positions row r sees
// (x: the window's low edge, read only with kWin; y: min(causal top,
// kv_len - 1), -1 if none or no row). pt is the row's page table, pool
// rows [NP, PS, Hk, D] of bf16. Every thread of the block must call it
// (it holds __syncthreads).
template <int D, int W, bool kCap, bool kWin, class QRow, class RowSpan>
__device__ __forceinline__ void attend(
    unsigned char* smem_raw, QRow q_row, RowSpan row_span,
    const void* __restrict__ k_pool, const void* __restrict__ v_pool,
    const int* __restrict__ pt, int PS, int Hk, int h, int c_begin, int c_end,
    const ScoreMap& sm, RowState<D>& st) {
  using Sh = Shape<D, W>;
  constexpr int kElem = 2;  // bytes a pool element
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sKV = sQ + Sh::kQElems;  // stage s: K at 2s, V at 2s + 1
  const uint32_t bar0 = smem_u32(smem_raw + Sh::kRingBytes);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_stride = (size_t)Hk * D;

  // stage Q with cp.async (zero rows where there is none)
  for (int i = tid; i < Sh::kRows * Sh::kChunks; i += Sh::kThreads) {
    const int r = i / Sh::kChunks;
    const int c8 = (i % Sh::kChunks) * 8;
    const __nv_bfloat16* src = q_row(r);
    cp_async16(smem_u32(sQ + r * Sh::kStride + c8),
               src ? src + c8 : static_cast<const __nv_bfloat16*>(k_pool), src != nullptr);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < kStages * Sh::kTileElems / 8; i += Sh::kThreads) {
    *reinterpret_cast<uint4*>(sKV + (2 * (i / (Sh::kTileElems / 8)) + 1) * Sh::kTileElems +
                              (i % (Sh::kTileElems / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] = 0.f;
  const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
    const int2 span = row_span(r0 + 8 * i);
    st.lo[i] = span.x;
    // with a window a tile may run past the range's end (c_begin need not
    // be aligned): its tokens there are not copied, so no row may count
    // them. Without one, tiles end at a split edge or past every row.
    st.vis[i] = kWin && span.y >= 0 ? min(span.y, c_end - 1) : span.y;
  }
  // over the warp's rows that see context: the highest and lowest last
  // positions and (kWin) the lowest and highest first positions
  constexpr int kBig = 0x7fffffff;
  const bool live0 = st.vis[0] >= 0, live1 = st.vis[1] >= 0;
  const int w_hi = warp_max(max(st.vis[0], st.vis[1]));
  const int w_lo = warp_min(min(live0 ? st.vis[0] : kBig, live1 ? st.vis[1] : kBig));
  int w_first_lo = 0, w_first_hi = 0;
  if constexpr (kWin) {
    w_first_lo = warp_min(min(live0 ? st.lo[0] : kBig, live1 ? st.lo[1] : kBig));
    w_first_hi = warp_max(max(live0 ? st.lo[0] : -1, live1 ? st.lo[1] : -1));
  }

  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kTile - 1) / kTile : 0;
  // tile u: thread i < 2 * kTile copies token i / 2's K row (i even) or V row
  const int j_tok = tid >> 1;
  const bool is_v = tid & 1;
  auto fetch_page = [&](int u) {
    const int c = c_begin + u * kTile + j_tok;
    return (tid < 2 * kTile && u < n_tiles && c < c_end) ? __ldg(pt + c / PS) : -1;
  };
  int pg_next = -1;   // page of j_tok in the next tile to issue
  int pg_after = -1;  // ... and in the one after
  auto issue = [&](int u) {
    const int c0 = c_begin + u * kTile;
    const uint32_t bar = bar0 + 8 * (u % kStages);
    if (tid == 0) mbar_expect_tx(bar, min(kTile, c_end - c0) * D * 2 * kElem);
    if (pg_next >= 0) {
      const int c = c0 + j_tok;
      const size_t cell = (size_t)pg_next * PS + c % PS;
      const size_t off = (cell * row_stride + (size_t)h * D) * kElem;
      unsigned char* dst = reinterpret_cast<unsigned char*>(
          sKV + (2 * (u % kStages) + is_v) * Sh::kTileElems + j_tok * Sh::kStride);
      bulk_copy(smem_u32(dst), static_cast<const unsigned char*>(is_v ? v_pool : k_pool) + off,
                D * kElem, bar);
    }
  };

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // Q
  __syncthreads();  // Q, the barriers and the zeroed V ring are visible
  pg_next = fetch_page(0);
  pg_after = fetch_page(1);
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) {
    if (u < n_tiles) issue(u);
    pg_next = pg_after;
    pg_after = fetch_page(u + 2);
  }

  QFrags<D> qf;
  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) __syncthreads();  // every warp is done with tile t - 1: its stage is free
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    pg_next = pg_after;
    pg_after = fetch_page(t + kStages + 1);
    if (t == 0 && w_hi >= 0) qf.init(sQ + warp * 16 * Sh::kStride);
    const int c0 = c_begin + t * kTile;
    __nv_bfloat16* sK = sKV + (2 * (t % kStages)) * Sh::kTileElems;
    // no row of this warp sees this tile: above every last or (window)
    // below every first. Some warp sees each tile: the rows' spans are
    // contiguous and cover [c_begin, c_end), so every copy is waited on
    // before its stage is refilled
    if (w_hi < c0 || (kWin && c0 + kTile - 1 < w_first_lo)) continue;
    mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
    // every live row sees the whole tile
    const bool full = (!kWin || c0 >= w_first_hi) && c0 + kTile - 1 <= w_lo;
    tile_update<D, kCap, kWin>(qf, sK, c0, full, sm, st);
  }
  // a warp that skipped tiles has not waited on them: every copy must land
  // before the block's shared memory goes
  for (int t = (n_tiles > kStages ? n_tiles - kStages : 0); t < n_tiles; ++t)
    mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = quad_sum(st.l[i]);
}

// attend on int8 pools (codes [NP, PS, Hk, D] with scales ks, vs [NP, PS,
// Hk]) through a ring of kS stages (CodeShape), the same walk and
// arguments otherwise: the stages hold codes, the products read fragments
// built from them (tile_update_codes), and nothing waits for a tile but
// the warps that compute it. The fragment conversion is integer work in
// every warp that computes a tile, so it is shared two ways. A warp holds
// kM 16-row tiles (st[0 .. kM - 1]; 16 kM rows), so each fragment it
// builds feeds kM products. And the block's idle warps share each tile's
// tokens: with its rows in nrg groups of 16 kM (rows are numbered from 0
// up), warp w computes group w % nrg over part w / nrg of each tile's
// tokens, split = the largest of 1, 2, 4 with split x nrg <= W ways (a
// ragged decode unit's 3-24 rows: 4 or 2 ways; a full block: 1); with kM 2
// split is 2 (kM 2 x all 64 tokens would not fit the registers). Each part
// keeps its own online softmax; once the walk is done the parts of a group
// are merged, in part order, through the shared memory of the Q tile and
// the ring into part 0, and only part 0's rows are the block's (the return
// value: this warp holds final rows). Rows past the last group (padding
// rows after row ceil(rows / 16 kM) x 16 kM) are no warp's: the caller
// writes them.
template <int D, int W, int kS, int kM, bool kCap, bool kWin, class QRow, class RowSpan>
__device__ __forceinline__ bool attend_codes(
    unsigned char* smem_raw, QRow q_row, RowSpan row_span,
    const int8_t* __restrict__ k_pool, const float* __restrict__ ks,
    const int8_t* __restrict__ v_pool, const float* __restrict__ vs,
    const int* __restrict__ pt, int PS, int Hk, int h, int c_begin, int c_end,
    const ScoreMap& sm, RowState<D>* st) {
  using Sh = Shape<D, W>;
  using Cs = CodeShape<D, W, kS>;
  static_assert(kM == 1 || (kM == 2 && D <= 128 && W % 2 == 0), "row tiles a warp");
  constexpr int kRowsW = 16 * kM;       // a warp's rows
  constexpr int kVals = kM * (D / 2 + 4);  // a thread's o, m, l
  constexpr int kSlots = kM == 1 ? W - 1 : W / 2;  // most parts handed over
  static_assert(kSlots * 32 * kVals * 4 <= Cs::kScaleOff,
                "the parts' merge fits the Q tile and the ring");
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* ring = smem_raw + Cs::kRingOff;  // stage s: K codes, then V codes
  float* sSc = reinterpret_cast<float*>(smem_raw + Cs::kScaleOff);
  const uint32_t bar0 = smem_u32(smem_raw + Cs::kBarOff);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_stride = (size_t)Hk * D;

  // stage Q with cp.async, one thread a (row, group of code_slice: 64
  // dims, or D 96's last 32), zero rows where there is none ...
  constexpr int kGroups = (D + 63) / 64;
  for (int it = tid; it < Sh::kRows * kGroups; it += Sh::kThreads) {
    const int r = it / kGroups;
    const int base = it % kGroups * 64;
    const __nv_bfloat16* src = q_row(r);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (base + 8 * c < D) {
        cp_async16(smem_u32(sQ + r * Sh::kStride + base + 8 * c),
                   src ? src + base + 8 * c : reinterpret_cast<const __nv_bfloat16*>(ks),
                   src != nullptr);
      }
    }
  }
  cp_async_commit();
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // scales of tokens never copied stay finite (0 x p = 0); their codes,
  // whatever bytes the slots hold, are finite numbers
  for (int i = tid; i < kS * 2 * kTile; i += Sh::kThreads) sSc[i] = 0.f;
  // ... then put each thread's own groups in code_slice's order: dims d0 ..
  // d0 + 3 go to the k pairs of slice s, quad lane t4 (all within the group)
  cp_async_wait<0>();
  for (int it = tid; it < Sh::kRows * kGroups; it += Sh::kThreads) {
    const int base = it % kGroups * 64;
    __nv_bfloat16* row = sQ + it / kGroups * Sh::kStride;
    uint2 x[16];
#pragma unroll
    for (int m = 0; m < 16; ++m)
      if (base + 4 * m < D) x[m] = *reinterpret_cast<const uint2*>(row + base + 4 * m);
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      if (base + 4 * m < D) {
        const int2 at = code_slice<D>(base + 4 * m);
        __nv_bfloat16* dst = row + at.x * 16 + 2 * at.y;
        *reinterpret_cast<uint32_t*>(dst) = __byte_perm(x[m].x, x[m].y, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + 8) = __byte_perm(x[m].x, x[m].y, 0x7632);
      }
    }
  }
  // Q, the barriers and the zeroed scales are visible; the row groups
  const int nrg =
      max(__syncthreads_count(lane == 0 && q_row(warp * kRowsW) != nullptr), 1);
  const int split = kM == 2 ? 2 : nrg * 4 <= W ? 4 : nrg * 2 <= W ? 2 : 1;
  const int rg = warp % nrg;
  const int part = warp / nrg;  // >= split: idle

  // over the warp's rows that see context: the highest and lowest last
  // positions and (kWin) the lowest and highest first positions
  constexpr int kBig = 0x7fffffff;
  int hi = -1, lo = kBig, first_lo = kBig, first_hi = -1;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    RowState<D>& r = st[m];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) r.o[n][e] = 0.f;
    r.r0 = rg * kRowsW + 16 * m + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r.m[i] = kNegInf;
      r.l[i] = 0.f;
      const int2 span = row_span(r.r0 + 8 * i);
      r.lo[i] = span.x;
      r.vis[i] = kWin && span.y >= 0 ? min(span.y, c_end - 1) : span.y;  // as attend
      if (r.vis[i] >= 0) {
        hi = max(hi, r.vis[i]);
        lo = min(lo, r.vis[i]);
        first_lo = min(first_lo, r.lo[i]);
        first_hi = max(first_hi, r.lo[i]);
      }
    }
  }
  const int w_hi = part < split ? warp_max(hi) : -1;
  const int w_lo = warp_min(lo);
  int w_first_lo = 0, w_first_hi = 0;
  if constexpr (kWin) {
    w_first_lo = warp_min(first_lo);
    w_first_hi = warp_max(first_hi);
  }
  const int share = kTile / split;  // the warp's tokens of a tile, from part * share

  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kTile - 1) / kTile : 0;
  // tile u: thread i < 2 * kTile copies token i / 2's K codes (i even) or
  // V codes, and their scale
  const int j_tok = tid >> 1;
  const bool is_v = tid & 1;
  auto fetch_page = [&](int u) {
    const int c = c_begin + u * kTile + j_tok;
    return (tid < 2 * kTile && u < n_tiles && c < c_end) ? __ldg(pt + c / PS) : -1;
  };
  int pg_next = -1;   // page of j_tok in the next tile to issue
  int pg_after = -1;  // ... and in the one after
  // one cp.async group a tile (the scales), committed by every thread
  // whether it copied or not
  auto issue = [&](int u) {
    const int c0 = c_begin + u * kTile;
    const int stage = u % kS;
    const uint32_t bar = bar0 + 8 * stage;
    if (tid == 0) mbar_expect_tx(bar, min(kTile, c_end - c0) * D * 2);
    if (pg_next >= 0) {
      const int c = c0 + j_tok;
      const size_t cell = (size_t)pg_next * PS + c % PS;
      bulk_copy(smem_u32(ring + stage * Cs::kStageBytes + (is_v * kTile + j_tok) * Cs::kSlot),
                (is_v ? v_pool : k_pool) + cell * row_stride + (size_t)h * D, D, bar);
      cp_async4(smem_u32(sSc + (stage * 2 + is_v) * kTile + j_tok),
                (is_v ? vs : ks) + cell * Hk + h);
    }
  };

  pg_next = fetch_page(0);
  pg_after = fetch_page(1);
#pragma unroll
  for (int u = 0; u < kS - 1; ++u) {
    if (u < n_tiles) issue(u);
    cp_async_commit();
    pg_next = pg_after;
    pg_after = fetch_page(u + 2);
  }

  QFrags<D, kM == 1 && D <= 128> qf[kM];
  for (int t = 0; t < n_tiles; ++t) {
    // groups of tiles 0 .. t + kS - 2 are committed: tile t's scales have
    // landed; after the barrier every thread sees them, and every warp is
    // done with tile t - 1, whose stage is refilled next
    cp_async_wait<kS - 2>();
    __syncthreads();
    if (t + kS - 1 < n_tiles) issue(t + kS - 1);
    cp_async_commit();
    pg_next = pg_after;
    pg_after = fetch_page(t + kS + 1);
    if (t == 0 && w_hi >= 0) {
#pragma unroll
      for (int m = 0; m < kM; ++m) qf[m].init(sQ + (rg * kRowsW + 16 * m) * Sh::kStride);
    }
    // as attend, over the warp's share: only the warps that see their
    // tokens of this tile wait for it (some warp sees each tile)
    const int c0 = c_begin + t * kTile + part * share;
    if (w_hi < c0 || (kWin && c0 + share - 1 < w_first_lo)) continue;
    const int stage = t % kS;
    mbar_wait(bar0 + 8 * stage, (t / kS) & 1);
    const bool full = (!kWin || c0 >= w_first_hi) && c0 + share - 1 <= w_lo;
    const unsigned char* sK = ring + stage * Cs::kStageBytes;
    const float* sc = sSc + stage * 2 * kTile;
    const int t0 = c_begin + t * kTile;
    if constexpr (kM == 2) {
      tile_update_codes<D, kCap, kWin, 2, 2>(qf, sK, t0, full, sm, st, sc, part);
    } else if (split == 4) {
      tile_update_codes<D, kCap, kWin, 4, 1>(qf, sK, t0, full, sm, st, sc, part);
    } else if (split == 2) {
      tile_update_codes<D, kCap, kWin, 2, 1>(qf, sK, t0, full, sm, st, sc, part);
    } else {
      tile_update_codes<D, kCap, kWin, 1, 1>(qf, sK, t0, full, sm, st, sc, 0);
    }
  }
  // every copy lands before the block's shared memory goes
  for (int t = (n_tiles > kS ? n_tiles - kS : 0); t < n_tiles; ++t)
    mbar_wait(bar0 + 8 * (t % kS), (t / kS) & 1);
  cp_async_wait<0>();

  if (split > 1) {
    // parts 1 .. split - 1 of each group hand their (o, m, l) to part 0
    // through the Q tile and the ring (both done with: every copy has
    // landed; a lane holds the same rows and columns in every part), which
    // folds them in in part order
    float* xs = reinterpret_cast<float*>(smem_raw);
    auto slot = [&](int p) { return xs + (size_t)((p - 1) * nrg + rg) * kVals * 32 + lane; };
    __syncthreads();  // every warp is done with the Q tile and the ring
    if (part > 0 && part < split) {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        float* x = slot(part) + m * (D / 2 + 4) * 32;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[(n * 4 + e) * 32] = st[m].o[n][e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          x[(D / 2 + i) * 32] = st[m].m[i];
          x[(D / 2 + 2 + i) * 32] = st[m].l[i];
        }
      }
    }
    __syncthreads();
    if (part == 0) {
      for (int p = 1; p < split; ++p) {
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          RowState<D>& r = st[m];
          const float* x = slot(p) + m * (D / 2 + 4) * 32;
          float a[2], b[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float m_p = x[(D / 2 + i) * 32];
            const float m_new = fmaxf(r.m[i], m_p);
            a[i] = exp2_approx(r.m[i] - m_new);
            b[i] = exp2_approx(m_p - m_new);
            r.m[i] = m_new;
            r.l[i] = r.l[i] * a[i] + x[(D / 2 + 2 + i) * 32] * b[i];
          }
#pragma unroll
          for (int n = 0; n < D / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              r.o[n][e] = r.o[n][e] * a[e >> 1] + x[(n * 4 + e) * 32] * b[e >> 1];
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) st[m].l[i] = quad_sum(st[m].l[i]);
  return part == 0;
}

// Rows r0, r0 + 8 of this thread normalised to bf16: out_row(r) is row r's
// D outputs (nullptr: not this block's to write). Rows that see nothing
// are written as exact zeros. kI8: after attend_codes (rows from st.r0,
// columns in code_cols' order).
template <int D, bool kI8, class ORow>
__device__ __forceinline__ void store_rows(ORow out_row, const RowState<D>& st) {
  const int lane = threadIdx.x & 31;
  const int r0 = kI8 ? st.r0 : (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* o = out_row(r0 + 8 * i);
    if (o == nullptr) continue;
    const bool live = st.vis[i] >= 0;
    const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
    if constexpr (kI8) {
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float4 x = code_cols(st, c, hh, i);
          const float a = live ? inv : 0.f;
          *reinterpret_cast<uint2*>(o + c * 32 + hh * 16 + 4 * (lane & 3)) =
              make_uint2(pack_bf16(x.x * a, x.y * a), pack_bf16(x.z * a, x.w * a));
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float a = live ? st.o[n][2 * i] * inv : 0.f;
        const float b = live ? st.o[n][2 * i + 1] * inv : 0.f;
        *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * (lane & 3)) = pack_bf16(a, b);
      }
    }
  }
}

// The split merge of every split-context launcher (ragged, GQA decode, MLA
// decode): `rows` rows whose split z partials sit at base + z *
// split_stride + row * (D + 4) as D floats of unnormalised O, then m (base
// 2) and l. Each row's splits are rescaled to their overall max and summed
// in split order, so the result is the same bit for bit from run to run;
// a split in which the row saw nothing (m = -1e30, l = 0) weighs 0, and a
// row that saw nothing comes out 0. out_row(r) is row r's D bf16 outputs.
// Called by all kThreads threads of a block.
template <int D, int kThreads, class ORow>
__device__ __forceinline__ void merge_splits(const float* __restrict__ base,
                                             size_t split_stride, int n_split,
                                             int rows, ORow out_row) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4);
    const int d = (i % (D / 4)) * 4;
    const float* p = base + (size_t)r * (D + 4);
    // unrolled so that a thread has 8 splits' loads in flight; the
    // sums stay in split order
    float m_all = kNegInf;
#pragma unroll 8
    for (int z = 0; z < n_split; ++z) m_all = fmaxf(m_all, p[z * split_stride + D]);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float l_all = 0.f;
#pragma unroll 8
    for (int z = 0; z < n_split; ++z) {
      const float* pz = p + z * split_stride;
      const float wz = exp2_approx(pz[D] - m_all);
      const float4 o = *reinterpret_cast<const float4*>(pz + d);
      l_all += wz * pz[D + 1];
      acc.x += wz * o.x;
      acc.y += wz * o.y;
      acc.z += wz * o.z;
      acc.w += wz * o.w;
    }
    const float inv = 1.f / fmaxf(l_all, 1e-30f);
    uint2 pk;
    pk.x = pack_bf16(acc.x * inv, acc.y * inv);
    pk.y = pack_bf16(acc.z * inv, acc.w * inv);
    *reinterpret_cast<uint2*>(out_row(r) + d) = pk;
  }
}


// The one-pass form of merge_splits (the int8 decode launches' merges,
// paged_attention.cu and mla_attention.cu): the same result for `rows` rows
// in the same layout, a row's splits read 8 at a time, all of a chunk's
// loads in flight together (merge_splits reads each split twice, in four
// dependent rounds for 9 to 16 splits), each chunk folded into the running
// (M, L, O) in split order. No atomics: the same bits from run to run.
template <int D, int kThreads, class ORow>
__device__ __forceinline__ void merge_splits_chunked(const float* __restrict__ base,
                                                     size_t split_stride, int n_split,
                                                     int rows, ORow out_row) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4);
    const int d = (i % (D / 4)) * 4;
    const float* p = base + (size_t)r * (D + 4);
    float M = kNegInf, L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < n_split; z0 += 8) {
      float2 ml[8];  // m, l
      float4 o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float* pz = p + (z0 + k) * split_stride;
        const bool live = z0 + k < n_split;
        ml[k] = live ? *reinterpret_cast<const float2*>(pz + D) : make_float2(kNegInf, 0.f);
        o[k] = live ? *reinterpret_cast<const float4*>(pz + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mc = M;
#pragma unroll
      for (int k = 0; k < 8; ++k) mc = fmaxf(mc, ml[k].x);
      const float a = exp2_approx(M - mc);
      L *= a;
      acc = make_float4(acc.x * a, acc.y * a, acc.z * a, acc.w * a);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float w = exp2_approx(ml[k].x - mc);
        L += w * ml[k].y;
        acc = make_float4(acc.x + w * o[k].x, acc.y + w * o[k].y, acc.z + w * o[k].z,
                          acc.w + w * o[k].w);
      }
      M = mc;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    *reinterpret_cast<uint2*>(out_row(r) + d) =
        make_uint2(pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
  }
}

// -- host side ---------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (no -lcuda); nullptr where the driver has none
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

}  // namespace paged_flash
