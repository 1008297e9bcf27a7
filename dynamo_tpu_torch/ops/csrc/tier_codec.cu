// The int8 tier codec of the KV tiers, on the device (Hopper, sm_90a).
//
// Replaces no TPU kernel: the reference quantizes demoted KV blocks on the
// host in numpy (dynamo_tpu/kvbm/quant.py:49 `quantize_block`, :66
// `dequantize_block`). Here a block is quantized before its device->host
// copy (half the bytes cross PCIe, no host codec on the step thread) and
// dequantized after its host->device copy, with the reference's arithmetic
// bit for bit:
//   s = max(amax, 1e-8) / 127 over each D vector, a true f32 division
//       (__fdiv_rn: not a product with the reciprocal, which the pool
//       quantizer of models/quant.py takes);
//   q = clip(rint(x / s), -127, 127), rint rounding half to even;
//   x' = cast(f32(q) * s) to the dense type, rounding to nearest even.
// The plain versions (dynamo_tpu_torch/kvbm/quant.py, on the CPU) are what
// the kernels are held against.
//
// What bounds them on an H100: bytes. A vector is read once and its codes
// and scale written once (or the codes and scale read and the vector
// written), a handful of operations an element.
//
// Design: one warp a vector, lanes striding over D. Quantize reduces the
// amax by shuffles and lane 0 writes the scale; dequantize reads the
// vector's scale once. Any D works (MLA's 1-wide stub pool included).
// The wrapper (ops/tier_codec.py) checks the operands.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ s, int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + static_cast<size_t>(row) * D;
  float amax = 0.f;
  for (int i = lane; i < D; i += 32) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  }
  const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (lane == 0) s[row] = sc;
  int8_t* qr = q + static_cast<size_t>(row) * D;
  for (int i = lane; i < D; i += 32) {
    const float v = rintf(__fdiv_rn(to_f32(xr[i]), sc));
    qr[i] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                  T* __restrict__ out, int rows, int D) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float sc = s[row];
  const int8_t* qr = q + static_cast<size_t>(row) * D;
  T* o = out + static_cast<size_t>(row) * D;
  for (int i = lane; i < D; i += 32) {
    o[i] = from_f32<T>(__fmul_rn(static_cast<float>(qr[i]), sc));
  }
}

}  // namespace

// x [rows, D] (dtype: 0 f32, 1 bf16, 2 f16) -> q [rows, D] int8, s [rows] f32
extern "C" int tier_quantize(const void* x, void* q, void* s, int rows, int D,
                             int dtype, void* stream) {
  if (rows == 0) return 0;
  const dim3 grid((rows + kThreads / 32 - 1) / (kThreads / 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<int8_t*>(q);
  auto* ss = static_cast<float*>(s);
  switch (dtype) {
    case kF32:
      quantize_kernel<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), qq, ss, rows, D);
      break;
    case kBF16:
      quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), qq, ss, rows, D);
      break;
    case kF16:
      quantize_kernel<__half><<<grid, kThreads, 0, st>>>(
          static_cast<const __half*>(x), qq, ss, rows, D);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q [rows, D] int8, s [rows] f32 -> out [rows, D] (dtype as above)
extern "C" int tier_dequantize(const void* q, const void* s, void* out,
                               int rows, int D, int dtype, void* stream) {
  if (rows == 0) return 0;
  const dim3 grid((rows + kThreads / 32 - 1) / (kThreads / 32));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const int8_t*>(q);
  const auto* ss = static_cast<const float*>(s);
  switch (dtype) {
    case kF32:
      dequantize_kernel<float><<<grid, kThreads, 0, st>>>(
          qq, ss, static_cast<float*>(out), rows, D);
      break;
    case kBF16:
      dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          qq, ss, static_cast<__nv_bfloat16*>(out), rows, D);
      break;
    case kF16:
      dequantize_kernel<__half><<<grid, kThreads, 0, st>>>(
          qq, ss, static_cast<__half*>(out), rows, D);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
