// Shared tile body of the GQA paged flash-attention kernels for Hopper
// (sm_90a): flash_prefill.cu (chunked prefill) and
// ragged_paged_attention.cu (the flat mixed step) walk a block's range
// with `attend`; paged_attention.cu (decode) gives each warp its own
// tiles through `tile_update`, the per-tile step `attend` runs. The
// split-context launchers (ragged, GQA decode, MLA decode in
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
// wgmma's 64-row tile. Why bulk copies and not TMA tensor tiles: a tensor
// map cannot follow a page table of 16-token pages without one descriptor
// copy per page.
//
// int8 KV (template flag kI8; the pools are models/quant.py's {"q": int8,
// "s": f32 [NP, PS, Hk]}): the TPU kernels' `_*_kernel_int8` bodies. A
// token's D codes are one bulk copy of D bytes into the last D bytes of
// its row slot (D + 8 bf16 = 2 D + 16 bytes), and its two scales (K and
// V) one 4-byte cp.async each into the stage's scale slab [2][64] f32
// (a bulk copy takes no fewer than 16 bytes, and a head's scales lie Hk
// floats apart). ldmatrix moves 16-bit elements, so once a tile has
// landed its rows are converted in place to bf16 (convert_rows: every
// code |q| <= 127 is exact in bf16, so both products stay exact) and the
// products run as in the bf16 body. The scales are folded as the TPU
// kernel folds them: the K scale multiplies the raw score before the
// score map (scale, soft cap); the row sum takes p as it is; the V scale
// multiplies p only for the value product, before P is rounded to bf16.
// The ring keeps its size, so the int8 bodies have the bf16 bodies'
// occupancy; conversion costs one block barrier a tile more.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  // Q tile, kStages x (K tile, V tile), then one mbarrier a stage; int8
  // adds the stages' scale slabs [kStages][2][kTile] f32
  static constexpr int kRingBytes = (kQElems + 2 * kStages * kTileElems) * 2;
  static constexpr int kSmemBytes = kRingBytes + 8 * kStages;
  static constexpr int kScaleOff = kSmemBytes;
  static constexpr int kSmemBytesI8 = kScaleOff + kStages * 2 * kTile * 4;
  static_assert(kThreads >= 2 * kTile, "one bulk copy a thread a tile");
  static_assert((2 * kTile) % W == 0, "a warp converts whole rows");
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

// 4 int8 codes (code j in byte j of w) -> 4 bf16, code 0 in the low half
// of .x; exact. Each code, biased by 128, is the low mantissa byte of 2^23
// in f32 (2^23 + code + 128); subtracting 2^23 + 128 leaves the code, a
// small integer whose f32 upper 16 bits are its bf16.
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  const float bias = 8388736.f;  // 2^23 + 128
  const uint32_t f0 = __float_as_uint(__uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540)) - bias);
  const uint32_t f1 = __float_as_uint(__uint_as_float(__byte_perm(x, 0x4b000000u, 0x7541)) - bias);
  const uint32_t f2 = __float_as_uint(__uint_as_float(__byte_perm(x, 0x4b000000u, 0x7542)) - bias);
  const uint32_t f3 = __float_as_uint(__uint_as_float(__byte_perm(x, 0x4b000000u, 0x7543)) - bias);
  return make_uint2(__byte_perm(f0, f1, 0x7632), __byte_perm(f2, f3, 0x7632));
}

// One warp converts rows [0, kRowsW) from row0 (rows kRowBytes apart)
// in place: each row's kD int8 codes, held in its last kD bytes (from
// byte kRowBytes - kD), become kD bf16 at its start. A row's codes overlap
// only its own bf16, and the warp reads a row whole (__syncwarp) before
// it writes it. Rows whose codes were never copied convert whatever bytes
// they hold: finite values, which their P = 0 (or mask) discards.
template <int kD, int kRowBytes, int kRowsW>
__device__ __forceinline__ void convert_rows(unsigned char* row0) {
  constexpr int kChunks = kD / 16;  // 16 codes a chunk
  constexpr int kPasses = (kRowsW * kChunks + 31) / 32;
  const int lane = threadIdx.x & 31;
#pragma unroll 2
  for (int p = 0; p < kPasses; ++p) {
    // pass p: chunks [32 p, 32 p + 32) of the warp's rows, row by row, so
    // that the rows a pass reads are the rows it writes
    const int i = p * 32 + lane;
    const bool live = i < kRowsW * kChunks;
    unsigned char* row = row0 + (size_t)(i / kChunks) * kRowBytes;
    const int ch = i % kChunks;
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
    if (live) c = *reinterpret_cast<const uint4*>(row + kRowBytes - kD + ch * 16);
    __syncwarp();
    if (live) {
      const uint2 a = i8x4_to_bf16x4(c.x), b = i8x4_to_bf16x4(c.y);
      const uint2 d = i8x4_to_bf16x4(c.z), e = i8x4_to_bf16x4(c.w);
      *reinterpret_cast<uint4*>(row + ch * 32) = make_uint4(a.x, a.y, b.x, b.y);
      *reinterpret_cast<uint4*>(row + ch * 32 + 16) = make_uint4(d.x, d.y, e.x, e.y);
    }
    __syncwarp();
  }
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
// 2 * (lane % 4) and the next of row i, unnormalised; m in base-2 units;
// l summed over the row (the quad agrees).
template <int D>
struct RowState {
  float o[D / 8][4];
  float m[2];
  float l[2];
  int lo[2];   // first context position the row sees (window low edge)
  int vis[2];  // last context position the row sees; -1: none, or no row
};

// Q's A fragments for one warp's 16 rows, from the Q tile in shared memory
// (rows D + 8 bf16 apart). Up to D 128 they are loaded once into
// registers; at D 256 each tile reloads them, slice by slice, with
// ldmatrix (64 registers saved; the Q tile stays put for the whole walk).
template <int D>
struct QFrags {
  static constexpr bool kRegs = D <= 128;
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
// kTileElems later, both with rows D + 8 bf16 apart. With kI8 the rows hold
// the converted codes and sSc the tile's scales (K at [0, 64), V at
// [64, 128)): the K scale multiplies the raw score, the V scale p after
// the row sum.
template <int D, bool kCap, bool kWin, bool kI8>
__device__ __forceinline__ void tile_update(const QFrags<D>& qf,
                                            const __nv_bfloat16* sK, int c0,
                                            bool full, const ScoreMap& sm,
                                            RowState<D>& st,
                                            const float* sSc = nullptr) {
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
    float2 ks = make_float2(1.f, 1.f);
    if constexpr (kI8) ks = *reinterpret_cast<const float2*>(sSc + n * 8 + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int c = c0 + n * 8 + 2 * t4 + (e & 1);
      const float raw = kI8 ? s[n][e] * ((e & 1) ? ks.y : ks.x) : s[n][e];
      const float x = base2_logit<kCap>(raw, sm);
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
    if constexpr (kI8) {  // the V scale, after the sum
      const float2 vs = *reinterpret_cast<const float2*>(sSc + kTile + n * 8 + 2 * t4);
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0 * vs.x, p1 * vs.y);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2 * vs.x, p3 * vs.y);
    } else {
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
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

// The block's attention over context positions [c_begin, c_end), in
// tiles from c_begin: a multiple of kTile without a window; with one
// (kWin), any position (the first one a row of the block sees). q_row(r)
// is row r's D query values in global memory (nullptr: no row, staged as
// zeros); row_span(r) the first and last context positions row r sees
// (x: the window's low edge, read only with kWin; y: min(causal top,
// kv_len - 1), -1 if none or no row). pt is the row's page table, pool
// rows [NP, PS, Hk, D] of bf16, or with kI8 of int8 codes with scales
// ks, vs [NP, PS, Hk] (unused without kI8). Every thread of the block must
// call it (it holds __syncthreads).
template <int D, int W, bool kCap, bool kWin, bool kI8, class QRow, class RowSpan>
__device__ __forceinline__ void attend(
    unsigned char* smem_raw, QRow q_row, RowSpan row_span,
    const void* __restrict__ k_pool, const float* __restrict__ ks,
    const void* __restrict__ v_pool, const float* __restrict__ vs,
    const int* __restrict__ pt, int PS, int Hk, int h, int c_begin, int c_end,
    const ScoreMap& sm, RowState<D>& st) {
  using Sh = Shape<D, W>;
  constexpr int kElem = kI8 ? 1 : 2;  // bytes a pool element
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sKV = sQ + Sh::kQElems;  // stage s: K at 2s, V at 2s + 1
  float* sSc = reinterpret_cast<float*>(smem_raw + Sh::kScaleOff);  // kI8 only
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
  if constexpr (kI8) {  // scales of tokens never copied stay finite
    for (int i = tid; i < kStages * 2 * kTile; i += Sh::kThreads) sSc[i] = 0.f;
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
  // with kI8 the codes land in each row slot's last D bytes and the K / V
  // scale in the stage's slab (one cp.async group a tile, committed by
  // every thread whether it copied or not)
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
      bulk_copy(smem_u32(dst + (kI8 ? D + 16 : 0)),
                static_cast<const unsigned char*>(is_v ? v_pool : k_pool) + off, D * kElem,
                bar);
      if constexpr (kI8) {
        cp_async4(smem_u32(sSc + ((u % kStages) * 2 + is_v) * kTile + j_tok),
                  (is_v ? vs : ks) + cell * Hk + h);
      }
    }
    if constexpr (kI8) cp_async_commit();
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
    if (t + kStages - 1 < n_tiles) {
      issue(t + kStages - 1);
    } else if constexpr (kI8) {
      cp_async_commit();  // one group an iteration
    }
    pg_next = pg_after;
    pg_after = fetch_page(t + kStages + 1);
    if (t == 0 && w_hi >= 0) qf.init(sQ + warp * 16 * Sh::kStride);
    const int c0 = c_begin + t * kTile;
    __nv_bfloat16* sK = sKV + (2 * (t % kStages)) * Sh::kTileElems;
    if constexpr (kI8) {
      // the block converts the tile: warp w its 2 kTile / W rows
      constexpr int kRowsW = 2 * kTile / W;
      mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
      convert_rows<D, 2 * Sh::kStride, kRowsW>(
          reinterpret_cast<unsigned char*>(sK + warp * kRowsW * Sh::kStride));
      cp_async_wait<kStages - 1>();  // this tile's scales
      fence_proxy_async();  // the converted rows before the stage's refill
      __syncthreads();
    }
    // no row of this warp sees this tile: above every last or (window)
    // below every first. Some warp sees each tile: the rows' spans are
    // contiguous and cover [c_begin, c_end), so every copy is waited on
    // before its stage is refilled
    if (w_hi < c0 || (kWin && c0 + kTile - 1 < w_first_lo)) continue;
    if constexpr (!kI8) mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
    // every live row sees the whole tile
    const bool full = (!kWin || c0 >= w_first_hi) && c0 + kTile - 1 <= w_lo;
    tile_update<D, kCap, kWin, kI8>(qf, sK, c0, full, sm, st,
                                    sSc + (t % kStages) * 2 * kTile);
  }
  // a warp that skipped tiles has not waited on them: every copy must land
  // before the block's shared memory goes
  for (int t = (n_tiles > kStages ? n_tiles - kStages : 0); t < n_tiles; ++t)
    mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = quad_sum(st.l[i]);
}

// Rows r0, r0 + 8 of this thread normalised to bf16: out_row(r) is row r's
// D outputs (nullptr: not this block's to write). Rows that see nothing
// are written as exact zeros.
template <int D, class ORow>
__device__ __forceinline__ void store_rows(ORow out_row, const RowState<D>& st) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* o = out_row(r0 + 8 * i);
    if (o == nullptr) continue;
    const bool live = st.vis[i] >= 0;
    const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float a = live ? st.o[n][2 * i] * inv : 0.f;
      const float b = live ? st.o[n][2 * i + 1] * inv : 0.f;
      *reinterpret_cast<uint32_t*>(o + n * 8 + 2 * (lane & 3)) = pack_bf16(a, b);
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

}  // namespace paged_flash
