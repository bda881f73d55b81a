// Fused RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, computed in f32.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm, pallas_call
// at :51).  On the H100 it is bound by bytes: one read of x, one write of the
// output.  One block normalises one row: its threads stride over the row
// with neighbouring threads on neighbouring elements, reduce the sum of
// squares through warp shuffles and one shared-memory step, then make a
// second pass that scales and writes.  The second read of the row hits L1/L2
// (a row is at most a few KiB), so device memory sees one read and one write.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = repro::to_f32(xr[i]);
    ss += v * v;
  }
  __shared__ float red[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = repro::warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? red[lane] : 0.f;
    ss = repro::warp_sum(ss);
    if (lane == 0) red[0] = ss;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    orow[i] = repro::from_f32<T>(repro::to_f32(xr[i]) * inv * repro::to_f32(w[i]));
  }
}

}  // namespace

extern "C" int repro_rmsnorm(int dtype, const void* x, const void* w, void* out,
                             int64_t rows, int d, float eps, void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T,
    rmsnorm_kernel<T><<<static_cast<unsigned int>(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), d, eps));
  return cudaGetLastError();
}

// Message for a CUDA error code the entry points returned (all kernel files
// link into one library; this is its one error-string export).
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
