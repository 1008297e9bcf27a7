// Decode paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dynamo_tpu/ops/paged_attention.py
// `decode_paged_attention` (body `_decode_kernel_body`), plain bf16 variant:
// one query token per sequence, all G query heads of each kv-head, attends
// over the sequence's pages of a token-major pool [NP, PS, Hk, D] up to
// kv_len, with an online softmax in f32.
//
// What bounds it on an H100: bytes. Each context token's K and V rows
// (2 x D bf16 per kv-head) are read once and used for G = 3 dot products
// and G axpys, about 1.5 flops per byte against the card's ~295 flops per
// byte balance point, so the kernel can at best stream the KV at the
// memory rate.
//
// Design: grid (Hk, B), 256 threads. A token row of D bf16 is D*2 bytes;
// D/8 lanes read it as 16-byte loads, so one warp covers 32/(D/8) token
// rows per load (2 at D = 128), coalesced. Each such lane group is an
// independent online-softmax stream (m, l, acc in registers, f32) that
// walks tokens grp, grp + n_groups, ... up to kv_len, reading page_table
// only for tokens below kv_len: entries past it are never trusted (the
// runner pads tables with page 0, a real page). Four tokens are loaded
// ahead of use per step for memory-level parallelism. Nothing crosses
// blocks: the TPU's sequential page grid carry becomes this in-block
// loop. At the end the streams merge through shared memory in a fixed
// order, so the result is deterministic. A row with kv_len = 0 comes out
// 0, like the TPU finalize's max(l, 1e-30). Split-K over the context
// (flash-decoding) is left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k_pool,
              const __nv_bfloat16* __restrict__ v_pool,
              const int* __restrict__ page_table,
              const int* __restrict__ kv_lens,
              __nv_bfloat16* __restrict__ out,
              int Hk, int PS, int MP, float scale) {
  constexpr int kLanes = D / 8;            // lanes per token row
  constexpr int kRows = 32 / kLanes;       // token rows per warp load
  constexpr int kGroups = kWarps * kRows;  // softmax streams per block
  __shared__ float s_m[kGroups][G];
  __shared__ float s_l[kGroups][G];
  __shared__ float s_acc[G][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane % kLanes;
  const int grp = warp * kRows + lane / kLanes;
  const int d0 = li * 8;

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + ((size_t)(b * Hk + h) * G + g) * D + d0, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] *= scale;
  }
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  const int kv_len = kv_lens[b];
  const int* pt = page_table + (size_t)b * MP;
  const size_t row_stride = (size_t)Hk * D;
  // `base` is uniform across the warp, so every lane reaches the shuffles
  for (int base = warp * kRows; base < kv_len; base += kGroups * kUnroll) {
    float kf[kUnroll][8], vf[kUnroll][8];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * kGroups + lane / kLanes;
      ok[u] = c < kv_len;
      if (ok[u]) {
        const int page = pt[c / PS];
        const size_t off =
            ((size_t)page * PS + c % PS) * row_stride + (size_t)h * D + d0;
        load8(k_pool + off, kf[u]);
        load8(v_pool + off, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) t = fmaf(qf[g][i], kf[u][i], t);
        s[g] = t;
      }
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      }
      if (ok[u]) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = __expf(m[g] - m_new);
          const float p = __expf(s[g] - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[u][i], acc[g][i] * alpha);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the streams: global max, rescaled denominators, then each
  // stream adds its rescaled numerator in a fixed order
  for (int i = threadIdx.x; i < G * D; i += kThreads) (&s_acc[0][0])[i] = 0.f;
  if (li == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s_m[grp][g] = m[g];
      s_l[grp][g] = l[g];
    }
  }
  __syncthreads();
  float M[G], L[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    M[g] = kNegInf;
    for (int j = 0; j < kGroups; ++j) M[g] = fmaxf(M[g], s_m[j][g]);
    L[g] = 0.f;
    for (int j = 0; j < kGroups; ++j) L[g] += s_l[j][g] * __expf(s_m[j][g] - M[g]);
  }
  for (int j = 0; j < kGroups; ++j) {
    if (grp == j) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float f = __expf(m[g] - M[g]);
#pragma unroll
        for (int i = 0; i < 8; ++i) s_acc[g][d0 + i] += acc[g][i] * f;
      }
    }
    __syncthreads();
  }
  __nv_bfloat16* o = out + (size_t)(b * Hk + h) * G * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float denom = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) denom = gg == g ? L[gg] : denom;
    o[i] = __float2bfloat16((&s_acc[0][0])[i] / fmaxf(denom, 1e-30f));
  }
}

template <int D>
cudaError_t launch_d(int G, dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
                     const __nv_bfloat16* k, const __nv_bfloat16* v,
                     const int* pt, const int* kvl, __nv_bfloat16* out,
                     int Hk, int PS, int MP, float scale) {
#define DYN_DECODE_CASE(GG)                                                  \
  case GG:                                                                   \
    decode_kernel<D, GG><<<grid, kThreads, 0, st>>>(q, k, v, pt, kvl, out,   \
                                                    Hk, PS, MP, scale);      \
    break;
  switch (G) {
    DYN_DECODE_CASE(1)
    DYN_DECODE_CASE(2)
    DYN_DECODE_CASE(3)
    DYN_DECODE_CASE(4)
    DYN_DECODE_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DYN_DECODE_CASE
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_paged_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_table,
                                      const void* kv_lens, void* out, int B,
                                      int Hk, int G, int D, int PS, int MP,
                                      float scale, void* stream) {
  const dim3 grid(Hk, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vv = static_cast<const __nv_bfloat16*>(v_pool);
  const auto* pt = static_cast<const int*>(page_table);
  const auto* kl = static_cast<const int*>(kv_lens);
  auto* oo = static_cast<__nv_bfloat16*>(out);
  if (B == 0) return 0;
  cudaError_t err;
  if (D == 128) {
    err = launch_d<128>(G, grid, st, qq, kk, vv, pt, kl, oo, Hk, PS, MP, scale);
  } else if (D == 64) {
    err = launch_d<64>(G, grid, st, qq, kk, vv, pt, kl, oo, Hk, PS, MP, scale);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
