// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes a plain C entry point (loaded with ctypes by
// repro_torch/kernels/_build.py).  An entry point launches on the stream it
// is given and returns cudaGetLastError(), so a launch the driver refuses is
// reported to the Python wrapper, which raises.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (_build.DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// round-to-nearest-even, as torch's .to(dtype) rounds
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Grid size for a grid-stride elementwise loop: enough blocks to fill the
// 132 SMs several times over, never more than the work needs.
inline unsigned int elementwise_blocks(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = 132 * 32;
  return static_cast<unsigned int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace repro

// Instantiate BODY with T bound to the element type named by a dtype code;
// an unknown code is an invalid-value error for the caller to raise on.
#define REPRO_DISPATCH_DTYPE(code, T, ...)                   \
  switch (code) {                                            \
    case repro::kF32: { using T = float; __VA_ARGS__; break; }          \
    case repro::kBF16: { using T = __nv_bfloat16; __VA_ARGS__; break; } \
    default: return cudaErrorInvalidValue;                   \
  }
