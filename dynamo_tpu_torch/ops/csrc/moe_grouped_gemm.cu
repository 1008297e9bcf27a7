// Grouped GEMM of the routed MoE experts for Hopper (sm_90a).
//
// Replaces no TPU kernel. Off an expert mesh the reference computes every
// expert on every token with a vmap that XLA compiles
// (dynamo_tpu/models/moe.py:69, `one_expert`); this kernel computes the
// same SwiGLU experts over only the tokens routed to each expert. The
// (token, choice) pairs arrive sorted by expert (ops/moe_dispatch.py
// `route`), with a tile map of kBM-row tiles, each inside one expert:
// (expert or -1, first row, end row).
//   moe_gate_up: h[r] = silu(x[tok[r]] @ w_gate[e]) * (x[tok[r]] @ w_up[e])
//   moe_down:    y[r] = h[r] @ w_down[e]
//
// What bounds it on an H100: bytes. A row of an expert does 2 flops per
// weight element read once per tile, so a tile of m rows runs at m flops a
// weight byte, against the 295 the card needs to be bound by its tensor
// cores. qwen3-30b-a3b routes T * 8 pairs over 128 experts (32 rows an
// expert at a 512-token chunk, one or none at decode) and DeepSeek-V3
// T * 8 over 256: every shape the engine runs is bound by the weights of
// the experts it touches.
//
// Design (the simple version; wgmma, TMA and warp specialisation are a
// later redesign): one block of 4 warps a (tile, 64-column block), grid
// (N / 64, tiles). Blocks of a tile map that is -1 (the grid is the upper
// bound ceil(T k / 64) + n_experts, fixed by shapes so that no count
// comes back to the host) exit at once. The block walks K in 32-deep
// steps through a two-stage cp.async ring: the A tile's rows are gathered
// by token index straight from x into shared memory (no permuted copy of
// x; rows past the tile's end are zero-filled), and the expert's B slices
// ([K, N] row-major, 64 columns) land beside them. Rows are padded by 16
// bytes so that ldmatrix reads eight rows in eight bank quads. Each warp
// owns a 32 x 32 quarter of the output (two products of it in gate/up)
// and runs mma.sync m16n8k16 (bf16 in, f32 accumulate): A fragments by
// ldmatrix, B fragments by ldmatrix.trans from the row-major slice. A warp
// whose 16-row halves hold no live row skips their MMAs (a decode tile
// holds one or two rows of 64).
//
// Rounding (gate/up): g and u are rounded to bf16, silu(g) is computed in
// f32 and rounded to bf16, and the product of the two bf16 values is
// rounded once: the reference's bf16 `mm` -> `silu` -> `*`, and what the
// plain version (ops/moe_dispatch.py moe_gate_up_ref) does in bf16
// PyTorch. Down rounds the f32 sum to bf16 once.

#include "paged_flash.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;   // rows a tile (ops/moe_dispatch.py MOE_BM)
constexpr int kBN = 64;   // output columns a block
constexpr int kBK = 32;   // K depth a step (MOE_BK)
constexpr int kThreads = 128;
constexpr int kAStride = kBK + 8;  // bf16 a row of the A tile: 80 bytes
constexpr int kBStride = kBN + 8;  // bf16 a row of a B slice: 144 bytes
constexpr int kAElems = kBM * kAStride;
constexpr int kBElems = kBK * kBStride;
constexpr int kMaxTiles = 65535;  // grid.y

template <int NB>  // B matrices a step: 2 (gate, up) or 1 (down)
struct Smem {
  bf16 a[2][kAElems];
  bf16 b[2][NB][kBElems];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// silu(g) * u with the reference's bf16 roundings (see above)
__device__ __forceinline__ float swiglu(float g, float u) {
  const float gb = round_bf16(g);
  const float s = round_bf16(gb / (1.f + expf(-gb)));
  return s * round_bf16(u);
}

// a: [rows, K] bf16 (gate/up: x [T, K], rows picked by a_rows; down: h
// [T k, K], rows row0.. of the tile); w0, w1: [n_experts, K, N] bf16;
// tiles [grid.y, 3] int32; out [T k, N] bf16.
template <bool kGated>
__global__ void __launch_bounds__(kThreads)
moe_gemm_kernel(const bf16* __restrict__ a, const int* __restrict__ a_rows,
                const bf16* __restrict__ w0, const bf16* __restrict__ w1,
                const int* __restrict__ tiles, bf16* __restrict__ out, int K,
                int N) {
  constexpr int NB = kGated ? 2 : 1;
  __shared__ __align__(16) Smem<NB> sm;
  const int* tile = tiles + 3 * blockIdx.y;
  const int expert = tile[0];
  if (expert < 0) return;
  const int row0 = tile[1];
  const int rows = tile[2] - row0;
  const int n0 = blockIdx.x * kBN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;  // the warp's 32 rows
  const int wn = warp & 1;   // and 32 columns

  const size_t woff = static_cast<size_t>(expert) * K * N;
  const bf16* wb[NB];
  wb[0] = w0 + woff;
  if constexpr (kGated) wb[1] = w1 + woff;

  // this thread's two 16-byte chunks of the A tile and of each B slice;
  // their sources move by k0 along the walk
  const bf16* a_src[2];
  bool a_ok[2];
  int a_dst[2];
  size_t b_src[2];
  bool b_ok[2];
  int b_dst[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2, ac = c & 3;  // 64 rows x 4 chunks
    a_ok[i] = r < rows;
    const int src_row = a_ok[i] ? (a_rows ? a_rows[row0 + r] : row0 + r) : 0;
    a_src[i] = a + static_cast<size_t>(src_row) * K + ac * 8;
    a_dst[i] = r * kAStride + ac * 8;
    const int kr = c >> 3, bc = c & 7;  // 32 rows x 8 chunks
    const int col = n0 + bc * 8;
    b_ok[i] = col < N;
    b_src[i] = static_cast<size_t>(kr) * N + col;
    b_dst[i] = kr * kBStride + bc * 8;
  }

  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      paged_flash::cp_async16(paged_flash::smem_u32(&sm.a[stage][a_dst[i]]),
                              a_ok[i] ? a_src[i] + k0 : a, a_ok[i]);
    }
#pragma unroll
    for (int p = 0; p < NB; ++p) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* src = b_ok[i] ? wb[p] + b_src[i] + static_cast<size_t>(k0) * N
                                  : wb[p];
        paged_flash::cp_async16(paged_flash::smem_u32(&sm.b[stage][p][b_dst[i]]),
                                src, b_ok[i]);
      }
    }
    paged_flash::cp_async_commit();
  };

  float acc[NB][2][4][4];
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][mi][ni][j] = 0.f;

  // warp-uniform: which of the warp's two 16-row halves hold a live row
  const bool live0 = wm * 32 < rows;
  const bool live1 = wm * 32 + 16 < rows;

  const int steps = K / kBK;
  load(0, 0);
  for (int kt = 0; kt < steps; ++kt) {
    if (kt + 1 < steps) {
      load((kt + 1) & 1, (kt + 1) * kBK);
      paged_flash::cp_async_wait<1>();
    } else {
      paged_flash::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
    if (live0) {
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          if (mi == 0 || live1) {
            paged_flash::ldsm_x4(
                af[mi], paged_flash::smem_u32(
                            &sm.a[st][(wm * 32 + mi * 16 + (lane & 15)) * kAStride +
                                      kk + (lane >> 4) * 8]));
          }
        }
#pragma unroll
        for (int p = 0; p < NB; ++p) {
          uint32_t bfr[4][2];
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t r[4];
            paged_flash::ldsm_x4_trans(
                r, paged_flash::smem_u32(
                       &sm.b[st][p][(kk + (lane & 15)) * kBStride + wn * 32 +
                                    np * 16 + (lane >> 4) * 8]));
            bfr[2 * np][0] = r[0];
            bfr[2 * np][1] = r[1];
            bfr[2 * np + 1][0] = r[2];
            bfr[2 * np + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (mi == 0 || live1) {
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                paged_flash::mma_bf16(acc[p][mi][ni], af[mi], bfr[ni][0],
                                      bfr[ni][1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // c0, c1: row lane / 4, columns 2 (lane % 4) + {0, 1}; c2, c3: 8 rows on
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = wm * 32 + mi * 16 + (lane >> 2) + half * 8;
        const int n = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        if (m < rows && n < N) {
          float v0, v1;
          if constexpr (kGated) {
            v0 = swiglu(acc[0][mi][ni][2 * half], acc[1][mi][ni][2 * half]);
            v1 = swiglu(acc[0][mi][ni][2 * half + 1], acc[1][mi][ni][2 * half + 1]);
          } else {
            v0 = acc[0][mi][ni][2 * half];
            v1 = acc[0][mi][ni][2 * half + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(row0 + m) * N + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

int launch(bool gated, const void* a, const void* a_rows, const void* w0,
           const void* w1, const void* tiles, void* out, int n_tiles, int K,
           int N, void* stream) {
  if (n_tiles <= 0 || n_tiles > kMaxTiles || K % kBK || N % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kBN - 1) / kBN, n_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const bf16*>(a);
  const auto* R = static_cast<const int*>(a_rows);
  const auto* W0 = static_cast<const bf16*>(w0);
  const auto* W1 = static_cast<const bf16*>(w1);
  const auto* T = static_cast<const int*>(tiles);
  auto* O = static_cast<bf16*>(out);
  if (gated) {
    moe_gemm_kernel<true><<<grid, kThreads, 0, st>>>(A, R, W0, W1, T, O, K, N);
  } else {
    moe_gemm_kernel<false><<<grid, kThreads, 0, st>>>(A, nullptr, W0, nullptr, T,
                                                      O, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [T, K], tok [T k] int32, w_gate / w_up [n_experts, K, N],
// tiles [n_tiles, 3] int32 -> h [T k, N]
extern "C" int moe_gate_up(const void* x, const void* tok, const void* w_gate,
                           const void* w_up, const void* tiles, void* h,
                           int n_tiles, int K, int N, void* stream) {
  return launch(true, x, tok, w_gate, w_up, tiles, h, n_tiles, K, N, stream);
}

// h [T k, K], w_down [n_experts, K, N], tiles -> y [T k, N]
extern "C" int moe_down(const void* h, const void* w_down, const void* tiles,
                        void* y, int n_tiles, int K, int N, void* stream) {
  return launch(false, h, nullptr, w_down, nullptr, tiles, y, n_tiles, K, N,
                stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
