// Batched KV page copies for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of dynamo_tpu/ops/block_copy.py:
// `gather_pages` (`_copy_kernel`, and `_permute_kernel` for the head-major
// layout), `scatter_pages` (`_scatter_kernel`) and `scatter_pages_layers`
// (`_scatter_layers_kernel`). They move whole KV pages between a paged pool
// [L, NP, PS, Hk, D] and a dense buffer [L, n, PS, Hk, D] (or, gathered
// head-major, [L, n, Hk, PS, D]) for the P->D transfer, the host-tier
// offload and the layer-streamed onboard.
//
// What bounds them on an H100: bytes. They compute nothing; each page is
// read once and written once, so the least time is 2 x the pages' bytes over
// the memory rate.
//
// Design: one block per (page, layer), grid (n, L), 256 threads. A
// token-major page is one contiguous PS*Hk*D run (32 KiB at PS 16, Hk 8,
// D 128 in bf16); threads move it as 16-byte vectors (uint4), neighbouring
// threads on neighbouring addresses, four loads in flight per thread before
// their stores. The head-major gather transposes [PS, Hk, D] -> [Hk, PS, D]
// in the same pass: it walks destination vectors in order and reads each
// from its token row; a D row (D*elem bytes) stays contiguous on both
// sides, so the 16-byte vector width holds. The page list and the layer
// offset are device int32 arrays read by each block (the TPU kernels take
// them as scalar prefetch), so a call is one launch and no host loop. The
// two scatters share one body: `scatter_pages` is the layer group that
// starts at layer 0 and spans the pool. The wrappers (ops/block_copy.py)
// check the operands, and that page ids are in range and unique, before a
// launch; nothing is checked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// Source vector of destination vector w in a head-major page: w walks
// [Hk, PS, R] and reads [PS, Hk, R], R = vectors per D row.
__device__ __forceinline__ int head_major_src(int w, int PS, int Hk, int R) {
  const int r = w % R;
  const int ht = w / R;
  const int t = ht % PS;
  const int h = ht / PS;
  return (t * Hk + h) * R + r;
}

template <bool kHeadMajor>
__device__ __forceinline__ void copy_page(const uint4* __restrict__ src,
                                          uint4* __restrict__ dst,
                                          int page_vecs, int PS, int Hk,
                                          int R) {
  for (int base = threadIdx.x; base < page_vecs; base += kThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = base + u * kThreads;
      if (w < page_vecs) {
        r[u] = __ldg(src + (kHeadMajor ? head_major_src(w, PS, Hk, R) : w));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = base + u * kThreads;
      if (w < page_vecs) dst[w] = r[u];
    }
  }
}

template <bool kHeadMajor>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint4* __restrict__ pool, const int* __restrict__ idx,
              uint4* __restrict__ out, int NP, int n, int PS, int Hk, int R) {
  const size_t i = blockIdx.x;
  const size_t l = blockIdx.y;
  const int page_vecs = PS * Hk * R;
  const uint4* src = pool + (l * NP + idx[i]) * page_vecs;
  uint4* dst = out + (l * n + i) * page_vecs;
  copy_page<kHeadMajor>(src, dst, page_vecs, PS, Hk, R);
}

// pages [Lg, n, page] -> pool layers [off, off + Lg) at slots idx
__global__ void __launch_bounds__(kThreads)
scatter_kernel(uint4* __restrict__ pool, const int* __restrict__ idx,
               const int* __restrict__ layer_off,
               const uint4* __restrict__ pages, int NP, int n, int page_vecs) {
  const size_t i = blockIdx.x;
  const size_t l = blockIdx.y;
  const size_t pl = l + (layer_off != nullptr ? layer_off[0] : 0);
  const uint4* src = pages + (l * n + i) * page_vecs;
  uint4* dst = pool + (pl * NP + idx[i]) * page_vecs;
  copy_page<false>(src, dst, page_vecs, 0, 0, 0);
}

int launch_scatter(void* pool, const void* idx, const void* layer_off,
                   const void* pages, int Lg, int NP, int n, int page_vecs,
                   void* stream) {
  scatter_kernel<<<dim3(n, Lg), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(pool), static_cast<const int*>(idx),
      static_cast<const int*>(layer_off), static_cast<const uint4*>(pages),
      NP, n, page_vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pool [L, NP, PS, Hk, R x 16 bytes] -> out [L, n, PS, Hk, R x 16 bytes]
// (head_major: [L, n, Hk, PS, R x 16 bytes])
extern "C" int gather_pages(const void* pool, const void* idx, void* out,
                            int L, int NP, int n, int PS, int Hk, int R,
                            int head_major, void* stream) {
  const dim3 grid(n, L);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint4*>(pool);
  const auto* ids = static_cast<const int*>(idx);
  auto* dst = static_cast<uint4*>(out);
  if (head_major) {
    gather_kernel<true><<<grid, kThreads, 0, st>>>(src, ids, dst, NP, n, PS,
                                                   Hk, R);
  } else {
    gather_kernel<false><<<grid, kThreads, 0, st>>>(src, ids, dst, NP, n, PS,
                                                    Hk, R);
  }
  return static_cast<int>(cudaGetLastError());
}

// pages [L, n, page] -> pool [L, NP, page] at slots idx
extern "C" int scatter_pages(void* pool, const void* idx, const void* pages,
                             int L, int NP, int n, int page_vecs,
                             void* stream) {
  return launch_scatter(pool, idx, nullptr, pages, L, NP, n, page_vecs,
                        stream);
}

// pages [Lg, n, page] -> pool layers [layer_off[0], layer_off[0] + Lg)
extern "C" int scatter_pages_layers(void* pool, const void* idx,
                                    const void* layer_off, const void* pages,
                                    int Lg, int NP, int n, int page_vecs,
                                    void* stream) {
  return launch_scatter(pool, idx, layer_off, pages, Lg, NP, n, page_vecs,
                        stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
