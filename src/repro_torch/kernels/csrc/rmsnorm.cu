// Fused RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, computed in f32, and
// its backward (below).  With rounds > 0 the rsqrt is the Curry ALU's (the
// TPU kernel's curry_rounds, _newton_rsqrt at rmsnorm.py:18): a seed
// rsqrt of the bf16-rounded argument, then `rounds` Newton steps
// y <- y (1.5 - 0.5 v y y), each product and difference rounded on its own
// (__fmul_rn / __fsub_rn) as the plain version's separate tensor ops round
// them; rounds == 0 is the native rsqrt.
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
               int d, float eps, int rounds) {
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
  const float v = red[0] / static_cast<float>(d) + eps;
  float inv;
  if (rounds == 0) {
    inv = rsqrtf(v);
  } else {
    inv = rsqrtf(__bfloat162float(__float2bfloat16_rn(v)));
    for (int r = 0; r < rounds; ++r)
      inv = __fmul_rn(inv, __fsub_rn(1.5f, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, v), inv), inv)));
  }
  for (int i = threadIdx.x; i < d; i += kThreads) {
    orow[i] = repro::from_f32<T>(repro::to_f32(xr[i]) * inv * repro::to_f32(w[i]));
  }
}

}  // namespace

extern "C" int repro_rmsnorm(int dtype, const void* x, const void* w, void* out,
                             int64_t rows, int d, float eps, int rounds, void* stream) {
  if (rows <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T,
    rmsnorm_kernel<T><<<static_cast<unsigned int>(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), d, eps, rounds));
  return cudaGetLastError();
}

namespace {

// ---------------------------------------------------------------------------
// Backward: dx = rstd (g - x^ mean(g x^)) with x^ = x rstd, g = w dy, and
// dw = sum over rows of dy x^, all in f32.
//
// Bound by bytes: x and dy read once (a second read of the row hits L1/L2),
// dx written once.  dw is a column reduction over every row.  Without
// atomics it takes two passes: each block walks a contiguous run of rows,
// writing dx row by row and summing dy x^ into its own f32 column partials
// in shared memory (each thread owns its columns, so no two threads touch
// one entry); a second small kernel sums the blocks' partials column by
// column in block order.  The result does not depend on scheduling.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ dw_part, int64_t rows, int64_t rows_per_block,
                        int d, float eps) {
  extern __shared__ float dw_s[];
  for (int i = threadIdx.x; i < d; i += kThreads) dw_s[i] = 0.f;
  __shared__ float red[2][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (int64_t row = r0; row < r1; ++row) {
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    float ss = 0.f, sg = 0.f;   // sum x^2, sum w dy x
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xv = repro::to_f32(xr[i]);
      ss += xv * xv;
      sg += repro::to_f32(w[i]) * repro::to_f32(dyr[i]) * xv;
    }
    ss = repro::warp_sum(ss);
    sg = repro::warp_sum(sg);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = sg;
    }
    __syncthreads();
    ss = 0.f;
    sg = 0.f;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) {
      ss += red[0][k];
      sg += red[1][k];
    }
    __syncthreads();   // red is reused by the next row
    const float rstd = rsqrtf(ss / static_cast<float>(d) + eps);
    const float c = rstd * sg / static_cast<float>(d);   // mean(g x^)
    T* dxr = dx + row * d;
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xh = repro::to_f32(xr[i]) * rstd;
      const float dyv = repro::to_f32(dyr[i]);
      dxr[i] = repro::from_f32<T>(rstd * (repro::to_f32(w[i]) * dyv - xh * c));
      dw_s[i] += dyv * xh;
    }
  }
  for (int i = threadIdx.x; i < d; i += kThreads)
    dw_part[static_cast<int64_t>(blockIdx.x) * d + i] = dw_s[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_cols_kernel(const float* __restrict__ dw_part, T* __restrict__ dw, int blocks,
                        int d) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += dw_part[static_cast<int64_t>(b) * d + col];
  dw[col] = repro::from_f32<T>(sum);
}

}  // namespace

// x, dy, dx [rows, d]; w, dw [d]; dw_part [blocks, d] f32 scratch.
extern "C" int repro_rmsnorm_bwd(int dtype, const void* x, const void* w, const void* dy,
                                 void* dx, void* dw, float* dw_part, int64_t rows, int d,
                                 float eps, int blocks, void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t per_block = (rows + blocks - 1) / blocks;
  const size_t smem = sizeof(float) * d;
  REPRO_DISPATCH_DTYPE(dtype, T, {
    auto rows_kernel = rmsnorm_bwd_rows_kernel<T>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    rows_kernel<<<blocks, kThreads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(dy),
        static_cast<T*>(dx), dw_part, rows, per_block, d, eps);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    rmsnorm_bwd_cols_kernel<T><<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        dw_part, static_cast<T*>(dw), blocks, d);
  });
  return cudaGetLastError();
}

// Message for a CUDA error code the entry points returned (all kernel files
// link into one library; this is its one error-string export).
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
