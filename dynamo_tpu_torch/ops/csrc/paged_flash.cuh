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
// warp, and walks a range of the context in tiles of 64 tokens. Per tile:
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
//     ldmatrix (.trans for V); Q's fragments are loaded once. S is masked
//     in registers (kv_len, causal top, padding rows): a tile wholly below
//     the warp's lowest causal limit skips the mask, a tile wholly above
//     the warp's highest skips the products.
//   - Online softmax in registers. Scores are kept in base-2 units
//     (scale * log2 e folded in), row max and row sum by quad shuffles
//     (the sum only once, at the end), m and l in f32. P is rounded to
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
  // Q tile, kStages x (K tile, V tile), then one mbarrier a stage
  static constexpr int kRingBytes = (kQElems + 2 * kStages * kTileElems) * 2;
  static constexpr int kSmemBytes = kRingBytes + 8 * kStages;
  static_assert(kThreads >= 2 * kTile, "one bulk copy a thread a tile");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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
  int vis[2];  // last context position the row sees; -1: none, or no row
};

// One 64-token tile of the online softmax, in one warp: S = Q K^T for the
// warp's 16 query rows (qf: Q's A fragments), scale and mask (a token c
// counts for row i when full or c <= st.vis[i]), the running max and sum,
// P rounded to bf16, O += P V. sK is the tile's K rows, the V rows follow
// kTileElems later, both with rows D + 8 bf16 apart.
template <int D>
__device__ __forceinline__ void tile_update(const uint32_t (&qf)[D / 16][4],
                                            const __nv_bfloat16* sK, int c0,
                                            bool full, float scale_log2,
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
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(sK + (n2 * 16 + (lane >> 4) * 8 + (lane & 7)) * kStride +
                          kc * 16 + ((lane >> 3) & 1) * 8));
      mma_bf16(s[2 * n2], qf[kc], b[0], b[1]);
      mma_bf16(s[2 * n2 + 1], qf[kc], b[2], b[3]);
    }
  }

  // scale, mask, row max
  float mx[2] = {minus_inf(), minus_inf()};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + n * 8 + 2 * t4 + (e & 1);
      const float x = s[n][e] * scale_log2;
      s[n][e] = (full || c <= st.vis[e >> 1]) ? x : minus_inf();
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
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

// The block's attention over context positions [c_begin, c_end), c_begin
// a multiple of kTile. q_row(r) is row r's D query values in global memory
// (nullptr: no row, staged as zeros); row_vis(r) the last context position
// row r sees (min(causal top, kv_len - 1)), -1 if none or no row. pt is
// the row's page table, pool rows [NP, PS, Hk, D]. Every thread of the
// block must call it (it holds __syncthreads).
template <int D, int W, class QRow, class RowVis>
__device__ __forceinline__ void attend(
    unsigned char* smem_raw, QRow q_row, RowVis row_vis,
    const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ pt,
    int PS, int Hk, int h, int c_begin, int c_end, float scale_log2,
    RowState<D>& st) {
  using Sh = Shape<D, W>;
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
    cp_async16(smem_u32(sQ + r * Sh::kStride + c8), src ? src + c8 : k_pool,
               src != nullptr);
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
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] = 0.f;
  const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
    st.vis[i] = row_vis(r0 + 8 * i);
  }
  // the warp's highest and lowest causal limits over rows that see context
  const int w_hi = warp_max(max(st.vis[0], st.vis[1]));
  const int w_lo = warp_min(min(st.vis[0] >= 0 ? st.vis[0] : 0x7fffffff,
                                st.vis[1] >= 0 ? st.vis[1] : 0x7fffffff));

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
    if (tid == 0) mbar_expect_tx(bar, min(kTile, c_end - c0) * D * 4);
    if (pg_next >= 0) {
      const int c = c0 + j_tok;
      const size_t off = ((size_t)pg_next * PS + c % PS) * row_stride + (size_t)h * D;
      bulk_copy(smem_u32(sKV + (2 * (u % kStages) + is_v) * Sh::kTileElems + j_tok * Sh::kStride),
                (is_v ? v_pool : k_pool) + off, D * 2, bar);
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

  uint32_t qf[Sh::kKC][4];
  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) __syncthreads();  // every warp is done with tile t - 1: its stage is free
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    pg_next = pg_after;
    pg_after = fetch_page(t + kStages + 1);
    if (t == 0 && w_hi >= 0) {
#pragma unroll
      for (int kc = 0; kc < Sh::kKC; ++kc)
        ldsm_x4(qf[kc], smem_u32(sQ + (warp * 16 + (lane & 15)) * Sh::kStride +
                                 kc * 16 + (lane >> 4) * 8));
    }
    const int c0 = c_begin + t * kTile;
    if (w_hi < c0) continue;  // no row of this warp sees this tile
    mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
    const bool full = c0 + kTile - 1 <= w_lo;  // every live row sees the whole tile
    tile_update<D>(qf, sKV + (2 * (t % kStages)) * Sh::kTileElems, c0, full,
                   scale_log2, st);
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
