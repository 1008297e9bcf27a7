// Grouped GEMM of the routed MoE experts for Hopper (sm_90a).
//
// Replaces no TPU kernel. Off an expert mesh the reference computes every
// expert on every token with a vmap that XLA compiles
// (dynamo_tpu/models/moe.py:69, `one_expert`); this kernel computes the
// same SwiGLU experts over only the tokens routed to each expert. The
// (token, choice) pairs arrive sorted by expert (ops/moe_dispatch.py
// `route`), with a tile map of kBM-row tiles, each inside one expert:
// (expert or -1, first row, end row), live tiles first.
//   moe_gate_up: h[r] = silu(x[tok[r]] @ w_gate[e]) * (x[tok[r]] @ w_up[e])
//   moe_down:    y[r] = h[r] @ w_down[e]
//
// What bounds it on an H100: bytes. A row of an expert does 2 flops per
// weight element read once per tile, so a tile of m rows runs at m flops a
// weight byte, against the 295 the card needs to be bound by its tensor
// cores. qwen3-30b-a3b routes T * 8 pairs over 128 experts (32 rows an
// expert at a 512-token chunk, one or none at decode) and DeepSeek-V3
// T * 8 over 256: every shape the engine runs is bound by the weights of
// the experts it touches, and only a hot expert (thousands of rows) is a
// real GEMM, whose weight slices and rows then come from L2.
//
// Design: a persistent, warp-specialised kernel, one block an SM.
//   - Work items are (tile, column block), item = tile * column blocks +
//     column block, claimed in order from a counter in device memory
//     (`work_counter`, atomicAdd), so a block that drew a hot expert's
//     item takes fewer others; the walk stops at the first item whose
//     tile is -1, and the last block to stop resets the counter for the
//     next launch (launches on one device must therefore not overlap: the
//     port issues them on one stream). The tile map keeps its grid bound,
//     a function of shapes, and nothing comes back to the host.
//   - Two configurations (Cfg). Items of 128 rows x 128 columns, two
//     consumer warpgroups on each weight stage (a hot expert's weights are
//     read once per 128 rows), rings of 4 (gate/up) and 6 (down) stages;
//     and, for a launch of at most 64 pairs (a decode step of up to 8
//     tokens: no tile then holds more than 64 rows) whose 128-column items
//     would number under kSmallItems an SM, items of 64 x 64, one consumer
//     warpgroup, rings of 6 and 8 stages. A decode step streams each
//     touched expert's weights once; one block streams at most about 27
//     GB/s (bytes in flight per SM, not the ring's depth, set that), so an
//     SM whose items ran out early is bandwidth lost, and twice as many
//     items end closer together (qwen3-30b-a3b's gate/up at T 8: 1.28x ->
//     1.21x its bound on an H100 80GB HBM3 at 700 W). DeepSeek-V3's
//     decode, 1024 wide items or more, keeps them.
//   - The weights come by TMA: one 3-D tensor map per weight tensor
//     [n_experts, K, N], a box of 64 K rows x 64 columns (128 bytes, the
//     128-byte swizzle's width), one or two boxes a weight a stage. The
//     maps are encoded on the host (cuTensorMapEncodeTiled, reached through
//     the runtime's driver entry point: no -lcuda), cached by (pointer,
//     shape), and passed by value as __grid_constant__ kernel arguments,
//     so a launch captures into a CUDA graph like any other.
//   - The A rows. Contiguous rows (down's h; gate/up's x over more than
//     64 pairs, which the wrapper copies in sorted order first) come as
//     TMA boxes of 64 rows x 64 when the tile has more than kBoxRows rows
//     (a 2-D map of the matrix, encoded each launch). Gate/up's rows at
//     decode (at most 64 pairs: x's rows by token, a_rows) and the rows
//     of small tiles are copied by the producer warp with 16-byte
//     cp.async, eight lanes a 128-byte row, four rows an instruction, into
//     the 128-byte-swizzled layout (chunk c of row r at chunk c ^ (r % 8),
//     what a TMA box with that swizzle writes). A TMA box cannot gather
//     rows; one box a row cost the TMA unit as much as a weight box (128 a
//     stage held a hot expert's items to a tenth of the tensor cores'
//     rate), and 16-byte copies of 128 gathered rows a stage to half the
//     rate of boxes. Rows past the tile's end keep stale values or other
//     rows' (each output row depends on its own A row only, and those rows
//     are never stored).
//   - A ring of stages, each the A tile and the B boxes of one 64-deep K
//     step, with a full and an empty mbarrier a stage. The producer warp
//     waits for a free stage, arms its full barrier with the boxes' bytes
//     (lane 0, which also issues them) and copies the A rows, each lane's
//     copies counted on the same barrier (cp.async.mbarrier.arrive.noinc:
//     33 arrivals a phase). It runs ahead across items, claims the next
//     item as it starts one and reads that item's tile and rows while this
//     one streams, so no read of the tile map stalls the ring. An item's
//     first stage carries its (item, first row, rows, column) to the
//     consumers, and a last stage with item -1 tells them to stop. The
//     consumers compute no load address; each orders the stage's cp.async
//     writes before its products' reads with fence.proxy.async.
//   - Consumer warpgroups of 64 rows: wgmma.mma_async m64nNk16 (N 128 or
//     64; bf16 in, f32 accumulate), A from the stage in K-major order, B
//     in its stored [K, N] order through the transpose bit. Gate/up keeps
//     the gate and up accumulators side by side. A warpgroup waits for its
//     products before it frees the stage, so that every stage of the ring
//     is in flight (keeping one group in flight was slower at decode). A
//     warpgroup whose 64 rows are all past the tile's end issues no
//     products and only keeps the ring's count.
//   - The epilogue stores each live row's columns as bf16 pairs straight
//     from the accumulators (gate/up: through `swiglu`).
// No split K, no float atomics: every output is one f32 sum in a fixed
// order, so a greedy stream repeats bit for bit.
//
// Rounding (gate/up): g and u are rounded to bf16, silu(g) is computed in
// f32 and rounded to bf16, and the product of the two bf16 values is
// rounded once: the reference's bf16 `mm` -> `silu` -> `*`, and what the
// plain version (ops/moe_dispatch.py moe_gate_up_ref) does in bf16
// PyTorch. Down rounds the f32 sum to bf16 once.
//
// Quantized experts (template argument kCode: int8 or e4m3 codes [n_experts,
// K, N] with f32 scales [n_experts, 1, N], models/quant.py's weight-only
// convention; the reference runs them through its every-expert `mm`,
// dynamo_tpu/models/moe.py:66). The weights then come by TMA as codes, a
// box of 64 K rows x 64 columns in 4 KB (half a bf16 box's bytes) without
// swizzle. wgmma reads B from shared memory only, so the consumer
// warpgroups turn each stage's code boxes into bf16 boxes in the 128-byte
// swizzled layout a bf16 box's TMA load writes (16 codes a thread an
// instruction: int8 by paged_flash.cuh's exact i8 pair conversions, e4m3
// by cvt.rn.f16x2.e4m3x2, exact too), in one of two buffers taken in turn,
// order their writes before the products with fence.proxy.async and meet
// at a named barrier; the products then run as in the bf16 body. With
// two buffers one barrier a stage suffices: a warpgroup converts into a
// buffer again only after both passed the barrier of the stage between,
// which each reaches after its products on the buffer finished. The
// epilogue scales each expert's columns with the reference's `mm`
// roundings, bf16(bf16(acc) * bf16(s)), before the SwiGLU (gate/up) or
// the store (down). The codes as wgmma's register A operand (the int8 MLA
// decode kernel's transposed products) are later work.

#include <map>
#include <mutex>
#include <tuple>

#include "paged_flash.cuh"

namespace {

using bf16 = __nv_bfloat16;
using paged_flash::cp_async16;
using paged_flash::cp_async_arrive;
using paged_flash::EncodeTiled;
using paged_flash::encoder;
using paged_flash::fence_acc;
using paged_flash::fence_proxy_async;
using paged_flash::mbar_arrive;
using paged_flash::mbar_expect_tx;
using paged_flash::mbar_init;
using paged_flash::mbar_wait;
using paged_flash::smem_u32;
using paged_flash::sw128_desc;
using paged_flash::tma_load_2d;
using paged_flash::tma_load_3d;
using paged_flash::wgmma_commit;
using paged_flash::wgmma_fence;
using paged_flash::wgmma_wait;

constexpr int kBM = 128;      // rows a tile (ops/moe_dispatch.py MOE_BM)
constexpr int kWGRows = 64;   // rows a consumer warpgroup
constexpr int kBox = 64;      // columns a box (MOE_N_ALIGN)
constexpr int kBK = 64;       // K depth a stage (MOE_BK)
constexpr int kRowBytes = kBK * 2;         // one A row of a stage: 128
constexpr int kBoxBytes = kBK * kBox * 2;  // 8 KB
// launches of at most kSmallPairs pairs whose 128-column items would
// number under kSmallItems an SM take Cfg<., true>
constexpr int kSmallPairs = 64;
constexpr int kSmallItems = 4;
constexpr int kBoxRows = 16;     // contiguous A: tiles of more rows get TMA boxes
// ring depths (the small ones measured best below their 192 KB fill)
constexpr int kStagesGated = 4;        // 48 KB a stage: A 16, gate 16, up 16
constexpr int kStagesDown = 6;         // 32 KB: A 16, down 16
constexpr int kSmallStagesGated = 6;   // 24 KB: A 8, gate 8, up 8
constexpr int kSmallStagesDown = 8;    // 16 KB: A 8, down 8

// the weights' element type: bf16, or one-byte codes with f32 scales
constexpr int kBF16 = 0, kInt8 = 1, kE4M3 = 2;
constexpr int kCodeBoxBytes = kBK * kBox;  // 4 KB: a box of codes

template <bool kGated, bool kSmall, int kCode = kBF16>
struct Cfg {
  static constexpr int kWeights = kGated ? 2 : 1;
  static constexpr int kWGs = kSmall ? 1 : 2;  // consumer warpgroups
  static constexpr int kRows = kWGs * kWGRows;  // rows an item
  static constexpr int kBoxes = kSmall ? 1 : 2;  // boxes a weight a stage
  static constexpr int kBN = kBoxes * kBox;     // columns an item
  static constexpr int kThreads = kWGs * 128 + 32;  // and the producer warp
  static constexpr int kStages = kSmall ? (kGated ? kSmallStagesGated : kSmallStagesDown)
                                        : (kGated ? kStagesGated : kStagesDown);
  static constexpr int kABytes = kRows * kRowBytes;
  // a weight box as it arrives: bf16, or codes
  static constexpr int kWBoxBytes = kCode == kBF16 ? kBoxBytes : kCodeBoxBytes;
  static constexpr int kStageBytes = kABytes + kWeights * kBoxes * kWBoxBytes;
  // codes: each of two buffers holds a stage's weights converted to bf16
  static constexpr int kConvBytes = kCode == kBF16 ? 0 : kWeights * kBoxes * kBoxBytes;
  // and 1 KB to align the ring to the swizzle's 1024-byte repeat
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kConvBytes + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

// the work list's counters: the next item to claim, and the blocks that
// found none left; the last such block resets both for the next launch
__device__ int work_counter[2];

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// bf16(acc) * bf16(s), exact in f32: the reference's `mm` on quantized
// weights before its last rounding
__device__ __forceinline__ float scaled(float acc, float s) {
  return round_bf16(acc) * round_bf16(s);
}

// A stage's code boxes (64 K rows of 64 one-byte codes each) -> bf16 boxes
// in the 128-byte-swizzled layout (row r at 128 r, 16-byte chunk c at
// chunk c ^ (r % 8)), by the kThreads consumer threads, 16 codes a thread
// an instruction.
template <int kCode, int kBoxesIn, int kThreads>
__device__ __forceinline__ void convert_codes(uint32_t codes, uint32_t out, int tid) {
  constexpr int kChunks = kBoxesIn * kCodeBoxBytes / 16;
  static_assert(kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int c = tid; c < kChunks; c += kThreads) {
    const int box = c / (kCodeBoxBytes / 16), r = (c / 4) % kBK, q = c % 4;
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(codes + box * kCodeBoxBytes + r * kBK + q * 16)
                 : "memory");
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[8];  // 16 bf16 in column order
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kCode == kE4M3) {
        o[2 * i] = paged_flash::e4m3x2_bf16x2(w[i] & 0xffffu);
        o[2 * i + 1] = paged_flash::e4m3x2_bf16x2(w[i] >> 16);
      } else {
        const uint32_t p = __byte_perm(w[i], 0, 0x3120);  // bytes 0, 2, 1, 3
        o[2 * i] = paged_flash::i8_lo_bf16x2(p);
        o[2 * i + 1] = paged_flash::i8_hi_bf16x2(p);
      }
    }
    const uint32_t row = out + box * kBoxBytes + r * kRowBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(row + (((2 * q + h) ^ (r & 7)) << 4)), "r"(o[4 * h]),
                      "r"(o[4 * h + 1]), "r"(o[4 * h + 2]), "r"(o[4 * h + 3])
                   : "memory");
    }
  }
}

// the consumer warpgroups' barrier (id 1; the block's __syncthreads is 0)
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(n) : "memory");
}

// silu(g) * u with the reference's bf16 roundings (see above)
__device__ __forceinline__ float swiglu(float g, float u) {
  const float gb = round_bf16(g);
  const float s = round_bf16(gb / (1.f + expf(-gb)));
  return s * round_bf16(u);
}

#define MOE_D8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16, K-major) @ B (16 x N, N-major: transpose bit); with
// scale_d 0 the product overwrites d. N 128 (d[64]) or 64 (d[32]).
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : MOE_D8(0), MOE_D8(8), MOE_D8(16), MOE_D8(24), MOE_D8(32), MOE_D8(40),
        MOE_D8(48), MOE_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t da, uint64_t db,
                                      int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : MOE_D8(0), MOE_D8(8), MOE_D8(16), MOE_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef MOE_D8

// The next unclaimed item, for the whole producer warp.
__device__ __forceinline__ int claim_item(int lane) {
  int it = 0;
  if (lane == 0) it = atomicAdd(&work_counter[0], 1);
  return __shfl_sync(0xffffffffu, it, 0);
}

// An item's tile: (expert or -1 when there is no such item, first row,
// rows, first column).
template <int kBN>
__device__ __forceinline__ int4 item_tile(int item, const int* tiles, int n_items,
                                          int ncb) {
  if (item >= n_items) return make_int4(-1, 0, 0, 0);
  const int t = item / ncb;
  const int row0 = __ldg(tiles + 3 * t + 1);
  return make_int4(__ldg(tiles + 3 * t), row0, __ldg(tiles + 3 * t + 2) - row0,
                   (item - t * ncb) * kBN);
}

// The source rows of the tile's rows lane, lane + 32, ... (0 past its end).
template <int kN>
__device__ __forceinline__ void tile_rows(int (&src)[kN], int4 tile, const int* a_rows,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const int i = lane + 32 * j;
    src[j] = tile.x >= 0 && i < tile.z ? (a_rows ? __ldg(a_rows + tile.y + i) : tile.y + i)
                                       : 0;
  }
}

// a: [rows, K] bf16 (gate/up: x [T, K], rows picked by a_rows; down: h
// [T k, K], rows row0.. of the tile, also through a_map: boxes of 64 K x
// 64 rows); w0_map, w1_map: [n_experts, K, N] (w1 unused by down); tiles
// [n_tiles, 3] int32; out [T k, N] bf16.
template <bool kGated, bool kSmall, int kCode>
__global__ void __launch_bounds__(Cfg<kGated, kSmall, kCode>::kThreads, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap w0_map,
                const __grid_constant__ CUtensorMap w1_map,
                const __grid_constant__ CUtensorMap a_map,
                const bf16* __restrict__ a, const int* __restrict__ a_rows,
                const int* __restrict__ tiles, const float* __restrict__ s0,
                const float* __restrict__ s1, bf16* __restrict__ out, int n_tiles,
                int K, int N) {
  using C = Cfg<kGated, kSmall, kCode>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[S];
  __shared__ __align__(8) uint64_t empty_bar[S];
  __shared__ int src_rows[C::kRows];  // the producer's: the item's A rows
  // with the first stage of each item: (item or -1: stop, first row, rows,
  // first column)
  __shared__ int4 stage_item[S];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 33);  // lane 0's expect_tx, 32 lanes' copies
      mbar_init(smem_u32(&empty_bar[s]), C::kWGs);  // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ncb = (N + C::kBN - 1) / C::kBN;
  const int n_items = n_tiles * ncb;
  const int steps = K / kBK;

  if (threadIdx.x >= C::kWGs * 128) {
    // the producer warp
    const int lane = threadIdx.x & 31;
    const int chunk = lane & 7;  // the lane's 16 bytes of a row: 8 lanes a row
    const bf16* a_col = a + chunk * 8;
    int stage = 0, phase = 0;
    int item = claim_item(lane);
    int4 tile = item_tile<C::kBN>(item, tiles, n_items, ncb);
    int src[C::kRows / 32];
    tile_rows(src, tile, a_rows, lane);
    while (tile.x >= 0) {
      const int row0 = tile.y, rows = tile.z, n0 = tile.w;
      __syncwarp();  // the previous item's copies have read src_rows
#pragma unroll
      for (int j = 0; j < C::kRows / 32; ++j) {
        if (lane + 32 * j < rows) src_rows[lane + 32 * j] = src[j];
      }
      __syncwarp();
      // the next item, claimed now; its tile and rows are read while this
      // one streams, one and two stages on
      const int next = claim_item(lane);
      int4 next_tile = make_int4(-1, 0, 0, 0);
      const int boxes = min(C::kBoxes, (N - n0) / kBox);
      const int a_boxes = !a_rows && rows > kBoxRows ? (rows + kWGRows - 1) / kWGRows : 0;
      const int bytes = C::kWeights * boxes * C::kWBoxBytes + a_boxes * kBoxBytes;
      for (int kt = 0; kt < steps; ++kt) {
        mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
        const uint32_t st = ring + stage * C::kStageBytes;
        const uint32_t full = smem_u32(&full_bar[stage]);
        if (lane == 0) {
          if (kt == 0) stage_item[stage] = make_int4(item, row0, rows, n0);
          mbar_expect_tx(full, bytes);
#pragma unroll
          for (int p = 0; p < C::kWeights; ++p) {
            for (int b = 0; b < boxes; ++b) {
              tma_load_3d(st + C::kABytes + (C::kBoxes * p + b) * C::kWBoxBytes,
                          p ? &w1_map : &w0_map, full, n0 + b * kBox, kt * kBK, tile.x);
            }
          }
          for (int b = 0; b < a_boxes; ++b) {
            tma_load_2d(st + b * kBoxBytes, &a_map, full, kt * kBK, row0 + kWGRows * b);
          }
        }
        if (a_boxes == 0) {
          for (int r = lane >> 3; r < rows; r += 4) {
            cp_async16(st + r * kRowBytes + ((chunk ^ (r & 7)) << 4),
                       a_col + static_cast<size_t>(src_rows[r]) * K + kt * kBK, true);
          }
        }
        cp_async_arrive(full);
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
        if (kt == min(1, steps - 1)) next_tile = item_tile<C::kBN>(next, tiles, n_items, ncb);
        if (kt == min(2, steps - 1)) tile_rows(src, next_tile, a_rows, lane);
      }
      item = next;
      tile = next_tile;
    }
    // no item left: a last stage tells the consumers to stop, and the last
    // block to get here resets the counter for the next launch
    mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
    const uint32_t full = smem_u32(&full_bar[stage]);
    if (lane == 0) {
      stage_item[stage] = make_int4(-1, 0, 0, 0);
      mbar_expect_tx(full, 0);
      __threadfence();
      if (atomicAdd(&work_counter[1], 1) == static_cast<int>(gridDim.x) - 1) {
        work_counter[0] = 0;
        work_counter[1] = 0;
      }
    }
    cp_async_arrive(full);
  } else {
    // the consumer warpgroups
    const int wg = threadIdx.x >> 7;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    int stage = 0, phase = 0;
    int conv = 0;  // the converted-weights buffer this stage takes (codes)
    const uint32_t conv_base = ring + C::kStages * C::kStageBytes;
    float acc[C::kWeights][C::kBN / 2] = {};
    for (;;) {
      mbar_wait(smem_u32(&full_bar[stage]), phase);
      const int4 info = stage_item[stage];
      if (info.x < 0) break;
      const int row0 = info.y, rows = info.z, n0 = info.w;
      const bool live = rows > wg * kWGRows;  // uniform over the warpgroup
      for (int kt = 0; kt < steps; ++kt) {
        if (kt > 0) mbar_wait(smem_u32(&full_bar[stage]), phase);
        const uint32_t st = ring + stage * C::kStageBytes;
        // the B boxes: the stage's, or (codes) their bf16 conversion
        uint32_t wb = st + C::kABytes;
        if constexpr (kCode != kBF16) {
          wb = conv_base + conv * C::kConvBytes;
          convert_codes<kCode, C::kWeights * C::kBoxes, C::kWGs * 128>(
              st + C::kABytes, wb, threadIdx.x);
          fence_proxy_async();  // the conversion's writes, before wgmma reads
          consumers_sync(C::kWGs * 128);
          conv ^= 1;
        }
        if (live) {
          fence_proxy_async();  // the A rows' cp.async writes, before wgmma reads
          const uint32_t a0 = st + wg * kWGRows * kRowBytes;
#pragma unroll
          for (int p = 0; p < C::kWeights; ++p) fence_acc(acc[p]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            // A: 64 rows of 128 bytes, 8-row groups 1024 bytes apart; a
            // 16-deep slice starts 32 bytes on. B: boxes 8 KB apart along
            // N, 8 K rows 1024 bytes apart; a slice starts 16 rows (2048
            // bytes) on.
            const uint64_t da = sw128_desc(a0 + kk * 32, 16, 1024);
#pragma unroll
            for (int p = 0; p < C::kWeights; ++p) {
              const uint64_t db = sw128_desc(
                  wb + C::kBoxes * p * kBoxBytes + kk * 16 * kRowBytes, kBoxBytes, 1024);
              wgmma(acc[p], da, db, (kt | kk) != 0);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int p = 0; p < C::kWeights; ++p) fence_acc(acc[p]);
        }
        if (tid == 0) mbar_arrive(smem_u32(&empty_bar[stage]));
        if (++stage == S) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (!live) continue;
      // codes: the item's expert's scales
      const int expert = kCode != kBF16 ? __ldg(tiles + 3 * (info.x / ncb)) : 0;
      // d[4j + 2h + c]: row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + c
#pragma unroll
      for (int j = 0; j < C::kBN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wg * kWGRows + warp * 16 + (lane >> 2) + h * 8;
          const int n = n0 + j * 8 + (lane & 3) * 2;
          if (m < rows && n < N) {
            float v[C::kWeights][2];
#pragma unroll
            for (int p = 0; p < C::kWeights; ++p) {
              v[p][0] = acc[p][4 * j + 2 * h];
              v[p][1] = acc[p][4 * j + 2 * h + 1];
              if constexpr (kCode != kBF16) {
                const float2 sc = __ldg(reinterpret_cast<const float2*>(
                    (p ? s1 : s0) + static_cast<size_t>(expert) * N + n));
                v[p][0] = scaled(v[p][0], sc.x);
                v[p][1] = scaled(v[p][1], sc.y);
              }
            }
            float v0, v1;
            if constexpr (kGated) {
              v0 = swiglu(v[0][0], v[C::kWeights - 1][0]);
              v1 = swiglu(v[0][1], v[C::kWeights - 1][1]);
            } else {
              v0 = v[0][0];
              v1 = v[0][1];
            }
            *reinterpret_cast<__nv_bfloat162*>(
                out + static_cast<size_t>(row0 + m) * N + n) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// -- host side -------------------------------------------------------------

// a tensor of `rank` dims (innermost first): bf16 with the 128-byte
// swizzle, or one-byte codes unswizzled
bool encode(CUtensorMap* map, const void* ptr, cuuint32_t rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box, bool codes = false) {
  const EncodeTiled fn = encoder();
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn && fn(map, codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  rank, const_cast<void*>(ptr), dims, strides, box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  codes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// rows [R, K]: 64 rows x 64 a box
bool rows_map(CUtensorMap* map, const void* ptr, int R, int K) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(R)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {kBK, kWGRows};
  return encode(map, ptr, 2, dims, strides, box);
}

// weights [n_experts, K, N] (bf16, or codes): 64 x 64 a box. Weights live
// as long as the model, so their maps are kept, keyed by pointer, shape
// and element type.
bool weight_map(CUtensorMap* map, const void* ptr, int n_experts, int K, int N,
                bool codes) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int, bool>, CUtensorMap> cache;
  const auto key = std::make_tuple(ptr, n_experts, K, N, codes);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const cuuint64_t elem = codes ? 1 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(n_experts)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * elem,
                                 static_cast<cuuint64_t>(K) * N * elem};
  const cuuint32_t box[3] = {kBox, kBK, 1};
  if (!encode(map, ptr, 3, dims, strides, box, codes)) return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return counts[dev];
}

// one launch's operands: the weights' maps, the A rows, the scales (codes)
struct Args {
  CUtensorMap m0, m1, am;
  const bf16* a;
  const int* a_rows;
  const int* tiles;
  const float* s0;
  const float* s1;
  bf16* out;
  int n_tiles, K, N;
};

template <bool kGated, bool kSmall, int kCode>
int launch_cfg(const Args& g, cudaStream_t st) {
  using C = Cfg<kGated, kSmall, kCode>;
  static bool sized[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && !sized[dev]) {
    const cudaError_t rc =
        cudaFuncSetAttribute(moe_gemm_kernel<kGated, kSmall, kCode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    sized[dev] = true;
  }
  const int items = g.n_tiles * ((g.N + C::kBN - 1) / C::kBN);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  moe_gemm_kernel<kGated, kSmall, kCode><<<items < sms ? items : sms, C::kThreads,
                                           C::kSmemBytes, st>>>(
      g.m0, g.m1, g.am, g.a, g.a_rows, g.tiles, g.s0, g.s1, g.out, g.n_tiles, g.K, g.N);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGated, int kCode>
int launch_code(bool small, const Args& g, cudaStream_t st) {
  return small ? launch_cfg<kGated, true, kCode>(g, st)
               : launch_cfg<kGated, false, kCode>(g, st);
}

// a: rows picked by a_rows, or (a_rows NULL) the P sorted rows themselves;
// code kBF16 (s0, s1 NULL), kInt8 or kE4M3
int launch(bool gated, const void* a, int P, const void* a_rows, const void* w0,
           const void* w1, const void* s0, const void* s1, int code, int n_experts,
           const void* tiles, void* out, int n_tiles, int K, int N, void* stream) {
  if (n_tiles <= 0 || P <= 0 || n_experts <= 0 || K <= 0 || N <= 0 || K % kBK ||
      N % kBox || code < kBF16 || code > kE4M3 || (code != kBF16 && !s0) ||
      (code != kBF16 && gated && !s1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool codes = code != kBF16;
  Args g;
  if (!weight_map(&g.m0, w0, n_experts, K, N, codes) ||
      !weight_map(&g.m1, gated ? w1 : w0, n_experts, K, N, codes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a_rows) {
    g.am = g.m0;  // unused: the rows are gathered
  } else if (!rows_map(&g.am, a, P, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.a = static_cast<const bf16*>(a);
  g.a_rows = static_cast<const int*>(a_rows);
  g.tiles = static_cast<const int*>(tiles);
  g.s0 = static_cast<const float*>(s0);
  g.s1 = static_cast<const float*>(gated ? s1 : s0);
  g.out = static_cast<bf16*>(out);
  g.n_tiles = n_tiles;
  g.K = K;
  g.N = N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  constexpr int kWide = Cfg<true, false>::kBN;
  const int tiles_max = P < n_experts ? P : n_experts;  // live tiles, at most
  const bool small =
      P <= kSmallPairs && tiles_max * ((N + kWide - 1) / kWide) < kSmallItems * sms;
  if (gated) {
    return code == kBF16   ? launch_code<true, kBF16>(small, g, st)
           : code == kInt8 ? launch_code<true, kInt8>(small, g, st)
                           : launch_code<true, kE4M3>(small, g, st);
  }
  return code == kBF16   ? launch_code<false, kBF16>(small, g, st)
         : code == kInt8 ? launch_code<false, kInt8>(small, g, st)
                         : launch_code<false, kE4M3>(small, g, st);
}

}  // namespace

// x [T, K], tok [P] int32, w_gate / w_up [n_experts, K, N],
// tiles [n_tiles, 3] int32 -> h [P, N]
extern "C" int moe_gate_up(const void* x, const void* tok, const void* w_gate,
                           const void* w_up, const void* tiles, void* h, int P,
                           int n_experts, int n_tiles, int K, int N, void* stream) {
  return launch(true, x, P, tok, w_gate, w_up, nullptr, nullptr, kBF16, n_experts, tiles,
                h, n_tiles, K, N, stream);
}

// h [P, K], w_down [n_experts, K, N], tiles -> y [P, N]
extern "C" int moe_down(const void* h, const void* w_down, const void* tiles, void* y,
                        int P, int n_experts, int n_tiles, int K, int N, void* stream) {
  return launch(false, h, P, nullptr, w_down, nullptr, nullptr, nullptr, kBF16, n_experts,
                tiles, y, n_tiles, K, N, stream);
}

// quantized experts: codes [n_experts, K, N] (code 1 int8, 2 e4m3) with f32
// scales [n_experts, 1, N]; otherwise as moe_gate_up and moe_down
extern "C" int moe_gate_up_codes(const void* x, const void* tok, const void* w_gate,
                                 const void* w_up, const void* s_gate, const void* s_up,
                                 const void* tiles, void* h, int P, int n_experts,
                                 int n_tiles, int K, int N, int code, void* stream) {
  return launch(true, x, P, tok, w_gate, w_up, s_gate, s_up, code, n_experts, tiles, h,
                n_tiles, K, N, stream);
}

extern "C" int moe_down_codes(const void* h, const void* w_down, const void* s_down,
                              const void* tiles, void* y, int P, int n_experts,
                              int n_tiles, int K, int N, int code, void* stream) {
  return launch(false, h, P, nullptr, w_down, nullptr, s_down, nullptr, code, n_experts,
                tiles, y, n_tiles, K, N, stream);
}

// the rows of a tile the kernel takes (route's MOE_BM must equal it)
extern "C" int moe_tile_rows() { return kBM; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
