// Weight-only quantized GEMM for Hopper (sm_90a):
//   y[m, n] = bf16( bf16(sum_k x[m, k] w[k, n]) * bf16(s[n]) )
// x bf16 [M, K]; w int8 or e4m3 codes, KN ([K, N], scales [1, N]: every
// matrix of the forward, x @ W) or NK ([N, K], scales [N, 1]: the tied
// head over the row-quantized embedding, h @ E^T); y bf16 [M, N].
//
// Replaces no TPU kernel: the reference's weight-only product
// (dynamo_tpu/models/quant.py:41 `mm`, and :116 `tied_logits`) is left to
// XLA, which fuses the dequantization into the matmul's operand load.
// This kernel does the same by hand: the codes reach shared memory as
// codes (one byte a weight) and the bf16 operands are built from them in
// registers, so no bf16 copy of a weight is ever written.
//
// What bounds it on an H100: bytes at decode (M up to 64: a row of x
// does 2 flops a code byte, against the 295 a byte the card needs to be
// bound by its tensor cores), operations in prefill and the large ragged
// buckets. The roundings are the reference's `mm`: the f32 sum rounded
// to bf16, times the scale rounded to bf16, the product rounded to bf16.
//
// Design (simple and right first; wgmma and a TMA ring are later work):
//   - A block owns a BM x BN tile of y and walks K in stages (BK deep)
//     through a ring of cp.async copies (16 bytes a thread an
//     instruction): the x rows (bf16, rows past M zero-filled) and the
//     codes (KN: BK K rows of BN bytes; NK: BN rows of BK bytes), rows
//     padded by 16 bytes so that the fragment loads below meet no bank
//     conflict.
//   - Products on mma.sync m16n8k16 (bf16 in, f32 accumulate); a warp
//     computes 16 kMT rows x 32 columns (four n8 tiles). A's fragments
//     come by ldmatrix. B's are built in registers from the codes:
//       KN: ldmatrix.trans over the codes viewed as b16 pairs gives each
//           thread (k 2t: n 2g, 2g+1; k 2t+1: n 2g, 2g+1), so bytes 0 and
//           2 are column 2g's B pair and bytes 1 and 3 column 2g + 1's;
//           the n8 tiles' columns are interleaved and the epilogue puts
//           them back (each thread stores 4 consecutive columns a row);
//       NK: a code row is a B column, so each B pair is the two codes at
//           k 2t, 2t + 1 (and 2t + 8, 2t + 9) of row n: one 16-bit load.
//     int8 pairs become bf16 pairs exactly with paged_flash.cuh's
//     i8_lo_bf16x2 / i8_hi_bf16x2; e4m3 pairs by cvt.rn.f16x2.e4m3x2 and
//     f16 -> f32 -> bf16, exact (every e4m3 value is a bf16 value).
//   - Decode configurations (M <= 16: Small, M <= 64: Mid; the small
//     ragged buckets too; K a multiple of 256): 16 or 64 rows x 32
//     columns, or 64 columns from N 8192 on (the wide ones: more bytes a
//     code row, fewer blocks where there are plenty), warps that split
//     each 256-deep stage (8 in Small, 4 in Mid) and add their sums in a
//     fixed order at the end, rings of 3 to 5 stages. Such a block is
//     bound by its own latency, not by the bytes it streams: on an H100
//     (80GB HBM3, 700 W), weights out of L2, llama-3.1-8b's wq at M 8 ran
//     0.0256 ms on 64-deep stages, 0.0167 on 256-deep ones with 4 warps a
//     32-column block and 0.0136 with 8; its w_gate 0.0610, 0.0444 and,
//     with 64 columns and 16 warps, 0.0336 (scripts/quant_gemm_variants.py,
//     which builds copies of this file with other tile constants and
//     times them in turns).
//     Large (prefill, ragged buckets above 64 rows, any K a multiple of
//     64): 128 x 64 tiles, 2 x 2 warps of 64 x 32, a ring of 4 64-deep
//     stages; each B fragment built serves 4 m16 tiles.
// No split K across blocks, no float atomics: a run repeats bit for bit.

#include "paged_flash.cuh"

namespace {

using bf16 = __nv_bfloat16;
using paged_flash::cp_async16;
using paged_flash::cp_async_commit;
using paged_flash::cp_async_wait;
using paged_flash::e4m3x2_bf16x2;
using paged_flash::i8_hi_bf16x2;
using paged_flash::i8_lo_bf16x2;
using paged_flash::ldsm_x4;
using paged_flash::ldsm_x4_trans;
using paged_flash::mma_bf16;
using paged_flash::pack_bf16;
using paged_flash::smem_u32;

constexpr int kKAlign = 64;  // K a multiple of this (ops/quant_gemm.py QGEMM_BK)

template <int MT, int WM, int WN, int WK, int STAGES, int BK>
struct Tile {
  static constexpr int kMT = MT;  // m16 tiles a warp
  static constexpr int kWM = WM, kWN = WN, kWK = WK;  // warps along M, N, K
  static constexpr int kStages = STAGES;
  static constexpr int kBK = BK;  // K depth of a stage
  static constexpr int kThreads = 32 * WM * WN * WK;
  static constexpr int kBM = 16 * MT * WM;
  static constexpr int kBN = 32 * WN;
  static constexpr int kSlices = BK / 16 / WK;  // k16 slices a warp a stage
  static constexpr int kAStride = BK * 2 + 16;  // bytes: a row of the x tile
  static constexpr int kABytes = kBM * kAStride;
  static constexpr int kKNStride = kBN + 16;     // KN: a K row of codes
  static constexpr int kNKStride = BK + 16;      // NK: an N row of codes
  static constexpr int kCodeBytes =
      BK * kKNStride > kBN * kNKStride ? BK * kKNStride : kBN * kNKStride;
  static constexpr int kStageBytes = kABytes + kCodeBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static_assert(kSlices >= 1 && kStageBytes % 16 == 0 && BK % kKAlign == 0,
                "stage layout");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
  // the K split's partial sums, reduced through the ring's memory
  static_assert((WK - 1) * WM * WN * MT * 16 * 32 * 4 <= kSmemBytes, "reduction");
};
// decode, 256-deep stages split among the warps: 16 rows (Small) or 64
// (Mid) x 32 columns, or, for N >= kWideN, x 64 columns (two warp
// columns); prefill and large ragged steps: 128 x 64 (Large)
using Small = Tile<1, 1, 1, 8, 5, 256>;
using SmallWide = Tile<1, 1, 2, 8, 4, 256>;
using Mid = Tile<4, 1, 1, 4, 4, 256>;
using MidWide = Tile<4, 1, 2, 4, 3, 256>;
using Large = Tile<4, 2, 2, 1, 4, 64>;
constexpr int kSmallM = 64;  // rows at or below which Small or Mid runs (QGEMM_SMALL_M)
constexpr int kWideN = 8192;  // columns from which the 64-column decode tiles run

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr) : "memory");
  return v;
}

// the codes in bytes 0 and 2 of w -> a bf16 pair (byte 0 low)
template <bool kFp8>
__device__ __forceinline__ uint32_t lo_pair(uint32_t w) {
  if constexpr (kFp8) {
    return e4m3x2_bf16x2(__byte_perm(w, 0, 0x0020));
  } else {
    return i8_lo_bf16x2(w);
  }
}

// ... and in bytes 1 and 3
template <bool kFp8>
__device__ __forceinline__ uint32_t hi_pair(uint32_t w) {
  if constexpr (kFp8) {
    return e4m3x2_bf16x2(__byte_perm(w, 0, 0x0031));
  } else {
    return i8_hi_bf16x2(w);
  }
}

// the codes in bits 0-7 and 8-15 of p (a 16-bit load) -> a bf16 pair
template <bool kFp8>
__device__ __forceinline__ uint32_t pair16(uint32_t p) {
  if constexpr (kFp8) {
    return e4m3x2_bf16x2(p);
  } else {
    return i8_lo_bf16x2(__byte_perm(p, 0, 0x3120));
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the reference's two roundings: the sum to bf16, times the bf16 scale
// (exact in f32), rounded to bf16 by the caller's pack
__device__ __forceinline__ float scaled(float acc, float s) {
  return round_bf16(acc) * round_bf16(s);
}

template <bool kNK, bool kFp8, class T>
__global__ void __launch_bounds__(T::kThreads)
quant_gemm_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                  const float* __restrict__ scales, bf16* __restrict__ y, int M, int N,
                  int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the warp's K slice (fastest), column group and row group
  const int wk = warp % T::kWK;
  const int wn = (warp / T::kWK) % T::kWN;
  const int wm = warp / (T::kWK * T::kWN);
  const int m0 = blockIdx.x * T::kBM;
  const int n0 = blockIdx.y * T::kBN;
  constexpr int kBK = T::kBK;
  const int steps = K / kBK;
  const uint32_t base = smem_u32(smem);

  auto load_stage = [&](int kt, int slot) {
    const uint32_t st = base + slot * T::kStageBytes;
    const int k0 = kt * kBK;
    constexpr int kXCh = kBK / 8;  // 16-byte chunks of an x row
    for (int c = tid; c < T::kBM * kXCh; c += T::kThreads) {
      const int r = c / kXCh, ch = c % kXCh;
      const bool ok = m0 + r < M;
      cp_async16(st + r * T::kAStride + ch * 16,
                 x + static_cast<size_t>(ok ? m0 + r : 0) * K + k0 + ch * 8, ok);
    }
    const uint32_t cw = st + T::kABytes;
    if constexpr (kNK) {
      constexpr int kWCh = kBK / 16;  // BN rows of kBK codes
      for (int c = tid; c < T::kBN * kWCh; c += T::kThreads) {
        const int r = c / kWCh, ch = c % kWCh;
        const bool ok = n0 + r < N;
        cp_async16(cw + r * T::kNKStride + ch * 16,
                   w + static_cast<size_t>(ok ? n0 + r : 0) * K + k0 + ch * 16, ok);
      }
    } else {
      constexpr int kCh = T::kBN / 16;
      for (int c = tid; c < kBK * kCh; c += T::kThreads) {  // kBK rows of BN codes
        const int r = c / kCh, ch = c % kCh;
        const bool ok = n0 + ch * 16 < N;
        cp_async16(cw + r * T::kKNStride + ch * 16,
                   w + static_cast<size_t>(k0 + r) * N + (ok ? n0 + ch * 16 : 0), ok);
      }
    }
  };

  float acc[T::kMT][4][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();  // stage kt landed; the slot read at kt - 1 is free
    const int nxt = kt + T::kStages - 1;
    if (nxt < steps) load_stage(nxt, nxt % T::kStages);
    cp_async_commit();
    const uint32_t st = base + (kt % T::kStages) * T::kStageBytes;
    const uint32_t cw = st + T::kABytes;
#pragma unroll
    for (int sl = 0; sl < T::kSlices; ++sl) {
      const int kk = (wk * T::kSlices + sl) * 16;
      uint32_t b[4][2];  // n8 tile j: (b0, b1)
      if constexpr (kNK) {
        // tile j: code rows wn 32 + 8 j + g
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t row = cw + (wn * 32 + 8 * j + g) * T::kNKStride + kk + 2 * t;
          b[j][0] = pair16<kFp8>(lds_u16(row));
          b[j][1] = pair16<kFp8>(lds_u16(row + 8));
        }
      } else {
        // matrices: (k 0-7 | 8-15) x (columns 0-15 | 16-31) of the warp's 32;
        // tile 2 s + h holds columns 16 s + 2 g + h
        uint32_t r[4];
        const int mi = lane >> 3;
        ldsm_x4_trans(r, cw + (kk + (lane & 7) + 8 * (mi & 1)) * T::kKNStride + wn * 32 +
                             16 * (mi >> 1));
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          b[2 * s][0] = lo_pair<kFp8>(r[2 * s]);
          b[2 * s][1] = lo_pair<kFp8>(r[2 * s + 1]);
          b[2 * s + 1][0] = hi_pair<kFp8>(r[2 * s]);
          b[2 * s + 1][1] = hi_pair<kFp8>(r[2 * s + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        uint32_t a[4];
        const int row = wm * 16 * T::kMT + 16 * i + (lane & 15);
        ldsm_x4(a, st + row * T::kAStride + (kk + 8 * (lane >> 4)) * 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }

  if constexpr (T::kWK > 1) {
    // the K split's sums, added in a fixed order: warp wk = 0's, then 1's, ...
    cp_async_wait<0>();
    __syncthreads();
    constexpr int kSlab = T::kMT * 16 * 32;  // floats a warp
    float* red = reinterpret_cast<float*>(smem);
    const int group = (wm * T::kWN + wn) * (T::kWK - 1);
    if (wk > 0) {
      float* dst = red + (group + wk - 1) * kSlab;
#pragma unroll
      for (int i = 0; i < T::kMT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[((i * 4 + j) * 4 + e) * 32 + lane] = acc[i][j][e];
    }
    __syncthreads();
    if (wk > 0) return;
    for (int p = 0; p < T::kWK - 1; ++p) {
      const float* src = red + (group + p) * kSlab;
#pragma unroll
      for (int i = 0; i < T::kMT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += src[((i * 4 + j) * 4 + e) * 32 + lane];
    }
  }

  // c[e]: row g (e 0, 1) or g + 8 (e 2, 3), logical columns 2 t + (e & 1)
  const int nw = n0 + wn * 32;
  if (nw >= N) return;  // N % 32 == 0: a warp's columns are all in or all out
#pragma unroll
  for (int i = 0; i < T::kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 16 * T::kMT + 16 * i + g + 8 * h;
      if (m >= M) continue;
      bf16* out = y + static_cast<size_t>(m) * N;
      if constexpr (kNK) {
        // tile j: columns 8 j + 2 t, + 1
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = nw + 8 * j + 2 * t;
          const float2 s = *reinterpret_cast<const float2*>(scales + n);
          *reinterpret_cast<uint32_t*>(out + n) = pack_bf16(
              scaled(acc[i][j][2 * h], s.x), scaled(acc[i][j][2 * h + 1], s.y));
        }
      } else {
        // strip s: columns 16 s + 4 t + q from tile 2 s + (q & 1), logical
        // column 2 t + (q >> 1)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int n = nw + 16 * s + 4 * t;
          const float4 sc = *reinterpret_cast<const float4*>(scales + n);
          uint2 v;
          v.x = pack_bf16(scaled(acc[i][2 * s][2 * h], sc.x),
                          scaled(acc[i][2 * s + 1][2 * h], sc.y));
          v.y = pack_bf16(scaled(acc[i][2 * s][2 * h + 1], sc.z),
                          scaled(acc[i][2 * s + 1][2 * h + 1], sc.w));
          *reinterpret_cast<uint2*>(out + n) = v;
        }
      }
    }
  }
}

template <bool kNK, bool kFp8, class T>
int launch(const void* x, const void* w, const void* s, void* y, int M, int N, int K,
           cudaStream_t st) {
  static bool sized[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && !sized[dev]) {
    const cudaError_t rc =
        cudaFuncSetAttribute(quant_gemm_kernel<kNK, kFp8, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    sized[dev] = true;
  }
  const dim3 grid((M + T::kBM - 1) / T::kBM, (N + T::kBN - 1) / T::kBN);
  quant_gemm_kernel<kNK, kFp8, T><<<grid, T::kThreads, T::kSmemBytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(s), static_cast<bf16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool kNK, bool kFp8>
int launch_m(const void* x, const void* w, const void* s, void* y, int M, int N, int K,
             cudaStream_t st) {
  if (M <= kSmallM && K % Small::kBK == 0) {
    if (N >= kWideN) {
      return M <= 16 ? launch<kNK, kFp8, SmallWide>(x, w, s, y, M, N, K, st)
                     : launch<kNK, kFp8, MidWide>(x, w, s, y, M, N, K, st);
    }
    return M <= 16 ? launch<kNK, kFp8, Small>(x, w, s, y, M, N, K, st)
                   : launch<kNK, kFp8, Mid>(x, w, s, y, M, N, K, st);
  }
  return launch<kNK, kFp8, Large>(x, w, s, y, M, N, K, st);
}

}  // namespace

// x [M, K] bf16; w codes (nk: [N, K], scales [N, 1]; else [K, N], scales
// [1, N]), int8 or (fp8) e4m3; y [M, N] bf16
extern "C" int quant_gemm(const void* x, const void* w, const void* s, void* y, int M,
                          int N, int K, int nk, int fp8, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kKAlign || N % 32 || N / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nk) {
    return fp8 ? launch_m<true, true>(x, w, s, y, M, N, K, st)
               : launch_m<true, false>(x, w, s, y, M, N, K, st);
  }
  return fp8 ? launch_m<false, true>(x, w, s, y, M, N, K, st)
             : launch_m<false, false>(x, w, s, y, M, N, K, st);
}

// the rows at or below which a launch takes the small tiles
extern "C" int quant_gemm_small_m() { return kSmallM; }

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
