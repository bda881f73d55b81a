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
// output, and device memory sees exactly that.  The row lives in registers:
// row_threads threads share a row (a power of two: part of a warp, a warp,
// or several), each holding kPer 16-byte vectors of x (8 bf16 or 4 f32) and
// the same columns of w, loaded once and kept across every row the thread
// walks.  The sum of squares is reduced by warp shuffles, plus one
// shared-memory step where a row spans warps; the scale comes from the
// registers and goes out as one 16-byte store a vector.  A block holds
// threads / row_threads rows at a time and walks row groups gridDim.x
// apart, so the grid is sized from the card (kernels/rmsnorm.py:plan), not
// from the row count.  kPer == 0 is the scalar route, for a width that is
// not a multiple of the vector or a base off a 16-byte boundary: the same
// walk, element by element, reading the row a second time (from L1/L2) to
// scale it.  No atomics: two calls give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // threads of the backward's blocks
constexpr int kMaxThreads = 512;    // threads of a forward block (the plan's largest)

// rsqrt(ss / d + eps), native or by the Curry ALU's Newton steps
__device__ __forceinline__ float inv_rms(float ss, int d, float eps, int rounds) {
  const float v = ss / static_cast<float>(d) + eps;
  if (rounds == 0) return rsqrtf(v);
  float inv = rsqrtf(__bfloat162float(__float2bfloat16_rn(v)));
  for (int r = 0; r < rounds; ++r)
    inv = __fmul_rn(inv, __fsub_rn(1.5f, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, v), inv), inv)));
  return inv;
}

// The sum of ss over the row_threads threads of a row (aligned groups of
// consecutive threads).  Every thread of the block calls it the same number
// of times; red[parity] is the shared step for rows that span warps (two
// buffers, so one barrier a row group suffices).
__device__ __forceinline__ float row_sum(float ss, int row_threads, float (*red)[kMaxThreads / 32],
                                         int parity) {
  if (row_threads <= 32) {
    for (int o = row_threads >> 1; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    return ss;
  }
  ss = repro::warp_sum(ss);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[parity][warp] = ss;
  __syncthreads();
  const int per_row = row_threads >> 5;
  const int first = warp / per_row * per_row;
  ss = 0.f;
  for (int k = 0; k < per_row; ++k) ss += red[parity][first + k];
  return ss;
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int64_t rows, int d, int row_threads, float eps, int rounds) {
  constexpr int kN = repro::Vec16<T>::kN;
  __shared__ float red[2][kMaxThreads / 32];
  const int groups = blockDim.x / row_threads;   // rows a block holds at a time
  const int g = threadIdx.x / row_threads;
  const int lane = threadIdx.x - g * row_threads;
  const int64_t step = static_cast<int64_t>(gridDim.x) * groups;
  int parity = 0;
  if constexpr (kPer == 0) {
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * groups; base < rows; base += step) {
      const int64_t row = base + g;
      const bool live = row < rows;
      const T* xr = x + row * d;
      float ss = 0.f;
      if (live)
        for (int i = lane; i < d; i += row_threads) {
          const float v = repro::to_f32(xr[i]);
          ss += v * v;
        }
      const float inv = inv_rms(row_sum(ss, row_threads, red, parity), d, eps, rounds);
      parity ^= 1;
      if (live) {
        T* orow = out + row * d;
        for (int i = lane; i < d; i += row_threads)
          orow[i] = repro::from_f32<T>(repro::to_f32(xr[i]) * inv * repro::to_f32(w[i]));
      }
    }
  } else {
    const int dv = d / kN;                        // vectors a row
    uint4 wv[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = lane + k * row_threads;
      if (i < dv) wv[k] = repro::load16(w + i * kN);
    }
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * groups; base < rows; base += step) {
      const int64_t row = base + g;
      const bool live = row < rows;
      uint4 xv[kPer];
      float ss = 0.f;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = lane + k * row_threads;
        if (live && i < dv) {
          xv[k] = repro::load16(x + row * d + i * kN);
          float f[kN];
          repro::unpack16<T>(xv[k], f);
#pragma unroll
          for (int e = 0; e < kN; ++e) ss += f[e] * f[e];
        }
      }
      const float inv = inv_rms(row_sum(ss, row_threads, red, parity), d, eps, rounds);
      parity ^= 1;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = lane + k * row_threads;
        if (live && i < dv) {
          float f[kN], s[kN];
          repro::unpack16<T>(xv[k], f);
          repro::unpack16<T>(wv[k], s);
#pragma unroll
          for (int e = 0; e < kN; ++e) f[e] = f[e] * inv * s[e];
          repro::store16(out + row * d + i * kN, repro::pack16<T>(f));
        }
      }
    }
  }
}

template <typename T>
int launch_rmsnorm(const T* x, const T* w, T* out, int64_t rows, int d, float eps, int rounds,
                   int per, int row_threads, int threads, int grid, cudaStream_t s) {
  void (*kernel)(const T*, const T*, T*, int64_t, int, int, float, int);
  switch (per) {
    case 0: kernel = rmsnorm_kernel<T, 0>; break;
    case 1: kernel = rmsnorm_kernel<T, 1>; break;
    case 2: kernel = rmsnorm_kernel<T, 2>; break;
    case 4: kernel = rmsnorm_kernel<T, 4>; break;
    default: return cudaErrorInvalidValue;
  }
  kernel<<<grid, threads, 0, s>>>(x, w, out, rows, d, row_threads, eps, rounds);
  return cudaGetLastError();
}

}  // namespace

// x, out [rows, d]; w [d].  The launch shape comes from kernels/rmsnorm.py:
// plan: per vectors a thread (0: the scalar route), row_threads threads a
// row, threads a block, grid blocks.  A shape the kernel cannot cover is an
// invalid-value error.
extern "C" int repro_rmsnorm(int dtype, const void* x, const void* w, void* out, int64_t rows,
                             int d, float eps, int rounds, int per, int row_threads, int threads,
                             int grid, void* stream) {
  if (rows <= 0) return cudaSuccess;
  if (d <= 0 || row_threads <= 0 || (row_threads & (row_threads - 1)) || threads > kMaxThreads ||
      threads % 32 || threads % row_threads || grid <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T, {
    constexpr int kN = repro::Vec16<T>::kN;
    if (per > 0 && (d % kN || d / kN > per * row_threads)) return cudaErrorInvalidValue;
    return launch_rmsnorm<T>(static_cast<const T*>(x), static_cast<const T*>(w),
                             static_cast<T*>(out), rows, d, eps, rounds, per, row_threads,
                             threads, grid, s);
  });
  return cudaSuccess;
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
