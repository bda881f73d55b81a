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

constexpr int kMaxThreads = 512;    // threads of a block (the plans' largest)

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
// Bound by bytes: x and dy read once, dx written once, and device memory
// sees exactly that.  The rows pass holds the row in registers as the
// forward does: row_threads threads a row, each with kPer 16-byte vectors of
// x and dy (loaded once, kept across the two sums and the dx store), its
// vectors of w and its f32 dw column partials kept across every row it
// walks.  sum x^2 and sum w dy x are reduced together (warp shuffles, plus
// one double-buffered shared step where a row spans warps: one barrier a
// row), and dx goes out as 16-byte vectors.  dw is a column sum over every
// row, taken without atomics: each block walks a contiguous run of rows
// (its row groups interleaved within the run), sums its groups' partials
// in group order and writes them to its row of dw_part; the column pass
// then gives each block 32 columns, one a lane, its kColWarps warps sum
// disjoint fixed slices of the blocks' partials, and warp 0 adds the
// slices in order.  The result does not depend on scheduling.  kPer == 0
// is the scalar route (a width that is not a multiple of the vector, a base
// off a 16-byte boundary): the same walk element by element, reading the
// row a second time (from L1/L2), the partials in shared memory.  The
// launch shape comes from kernels/rmsnorm.py:bwd_plan.
// ---------------------------------------------------------------------------

constexpr int kColWarps = 32;   // warps of a column-pass block

// The sums of a and b over the row_threads threads of a row, as row_sum
// takes one.
__device__ __forceinline__ float2 row_sum2(float a, float b, int row_threads,
                                           float2 (*red)[kMaxThreads / 32], int parity) {
  if (row_threads <= 32) {
    for (int o = row_threads >> 1; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    return make_float2(a, b);
  }
  a = repro::warp_sum(a);
  b = repro::warp_sum(b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[parity][warp] = make_float2(a, b);
  __syncthreads();
  const int per_row = row_threads >> 5;
  const int first = warp / per_row * per_row;
  float2 s = make_float2(0.f, 0.f);
  for (int k = 0; k < per_row; ++k) {
    s.x += red[parity][first + k].x;
    s.y += red[parity][first + k].y;
  }
  return s;
}

// this thread's kPer vectors of x and dy of row `row` (none past `end`)
template <typename T, int kPer>
__device__ __forceinline__ void load_row(const T* __restrict__ x, const T* __restrict__ dy,
                                         int64_t row, int64_t end, int d, int lane,
                                         int row_threads, uint4 (&xv)[kPer], uint4 (&gv)[kPer]) {
  constexpr int kN = repro::Vec16<T>::kN;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = lane + k * row_threads;
    if (row < end && i < d / kN) {
      xv[k] = repro::load16(x + row * d + i * kN);
      gv[k] = repro::load16(dy + row * d + i * kN);
    }
  }
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ dw_part, int64_t rows, int rows_per_block, int d,
                        int row_threads, float eps) {
  extern __shared__ float dw_s[];   // [groups][d]: each row group's dw partials
  __shared__ float2 red[2][kMaxThreads / 32];
  const int groups = blockDim.x / row_threads;   // rows a block holds at a time
  const int g = threadIdx.x / row_threads;
  const int lane = threadIdx.x - g * row_threads;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const int steps = r1 > r0 ? static_cast<int>((r1 - r0 + groups - 1) / groups) : 0;
  const float fd = static_cast<float>(d);
  float* part = dw_part + static_cast<int64_t>(blockIdx.x) * d;
  int parity = 0;
  if constexpr (kPer == 0) {
    float* acc = dw_s + g * d;
    for (int i = lane; i < d; i += row_threads) acc[i] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int64_t row = r0 + static_cast<int64_t>(s) * groups + g;
      const bool live = row < r1;
      const T* xr = x + row * d;
      const T* dyr = dy + row * d;
      float ss = 0.f, sg = 0.f;   // sum x^2, sum w dy x
      if (live)
        for (int i = lane; i < d; i += row_threads) {
          const float xv = repro::to_f32(xr[i]);
          ss += xv * xv;
          sg += repro::to_f32(w[i]) * repro::to_f32(dyr[i]) * xv;
        }
      const float2 t = row_sum2(ss, sg, row_threads, red, parity);
      parity ^= 1;
      const float rstd = rsqrtf(t.x / fd + eps);
      const float c = rstd * t.y / fd;   // mean(g x^)
      if (live) {
        T* dxr = dx + row * d;
        for (int i = lane; i < d; i += row_threads) {
          const float xh = repro::to_f32(xr[i]) * rstd;
          const float dyv = repro::to_f32(dyr[i]);
          dxr[i] = repro::from_f32<T>(rstd * (repro::to_f32(w[i]) * dyv - xh * c));
          acc[i] += dyv * xh;
        }
      }
    }
  } else {
    constexpr int kN = repro::Vec16<T>::kN;
    const int dv = d / kN;                        // vectors a row
    uint4 wv[kPer];
    float acc[kPer][kN];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = lane + k * row_threads;
      if (i < dv) wv[k] = repro::load16(w + i * kN);
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[k][e] = 0.f;
    }
    // x and dy of this group's first row, then each step loads the next
    // row's before it reduces this one: two rows of loads in flight
    uint4 xv[kPer], gv[kPer];
    load_row<T, kPer>(x, dy, r0 + g, r1, d, lane, row_threads, xv, gv);
    for (int s = 0; s < steps; ++s) {
      const int64_t row = r0 + static_cast<int64_t>(s) * groups + g;
      const bool live = row < r1;
      uint4 xn[kPer], gn[kPer];
      load_row<T, kPer>(x, dy, row + groups, r1, d, lane, row_threads, xn, gn);
      float ss = 0.f, sg = 0.f;   // sum x^2, sum w dy x
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = lane + k * row_threads;
        if (live && i < dv) {
          float xf[kN], gf[kN], wf[kN];
          repro::unpack16<T>(xv[k], xf);
          repro::unpack16<T>(gv[k], gf);
          repro::unpack16<T>(wv[k], wf);
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            ss += xf[e] * xf[e];
            sg += wf[e] * gf[e] * xf[e];
          }
        }
      }
      const float2 t = row_sum2(ss, sg, row_threads, red, parity);
      parity ^= 1;
      const float rstd = rsqrtf(t.x / fd + eps);
      const float c = rstd * t.y / fd;   // mean(g x^)
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = lane + k * row_threads;
        if (live && i < dv) {
          float xf[kN], gf[kN], wf[kN];
          repro::unpack16<T>(xv[k], xf);
          repro::unpack16<T>(gv[k], gf);
          repro::unpack16<T>(wv[k], wf);
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            const float xh = xf[e] * rstd;
            acc[k][e] += gf[e] * xh;
            xf[e] = rstd * (wf[e] * gf[e] - xh * c);
          }
          repro::store16(dx + row * d + i * kN, repro::pack16<T>(xf));
        }
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        xv[k] = xn[k];
        gv[k] = gn[k];
      }
    }
    // the partials of each column this thread owns: straight to the
    // block's row of dw_part when the block holds one row group, else to
    // its group's row of dw_s
    float* dst = groups == 1 ? part : dw_s + g * d;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = lane + k * row_threads;
      if (i < dv)
#pragma unroll
        for (int e = 0; e < kN; e += 4)
          *reinterpret_cast<float4*>(dst + i * kN + e) =
              make_float4(acc[k][e], acc[k][e + 1], acc[k][e + 2], acc[k][e + 3]);
    }
    if (groups == 1) return;
  }
  // the block's partials: its row groups' partials added in group order
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float sum = dw_s[i];
    for (int k = 1; k < groups; ++k) sum += dw_s[k * d + i];
    part[i] = sum;
  }
}

// dw[col] = the sum of the blocks' partials dw_part[b][col] over b < parts:
// warp k sums the fixed slice of blocks [k chunk, (k + 1) chunk) in order,
// warp 0 adds the kColWarps slices in order.
template <typename T>
__global__ void __launch_bounds__(32 * kColWarps)
rmsnorm_bwd_cols_kernel(const float* __restrict__ dw_part, T* __restrict__ dw, int parts,
                        int d) {
  __shared__ float red[kColWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int chunk = (parts + kColWarps - 1) / kColWarps;
  const int p0 = warp * chunk;
  const int p1 = p0 + chunk < parts ? p0 + chunk : parts;
  float sum = 0.f;
  if (col < d)
#pragma unroll 4
    for (int p = p0; p < p1; ++p) sum += dw_part[static_cast<int64_t>(p) * d + col];
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && col < d) {
    float total = red[0][lane];
#pragma unroll
    for (int k = 1; k < kColWarps; ++k) total += red[k][lane];
    dw[col] = repro::from_f32<T>(total);
  }
}

template <typename T>
int launch_rmsnorm_bwd(const T* x, const T* w, const T* dy, T* dx, T* dw, float* dw_part,
                       int64_t rows, int d, float eps, int per, int row_threads, int threads,
                       int grid, int rows_per_block, cudaStream_t s) {
  void (*kernel)(const T*, const T*, const T*, T*, float*, int64_t, int, int, int, float);
  switch (per) {
    case 0: kernel = rmsnorm_bwd_rows_kernel<T, 0>; break;
    case 1: kernel = rmsnorm_bwd_rows_kernel<T, 1>; break;
    case 2: kernel = rmsnorm_bwd_rows_kernel<T, 2>; break;
    case 4: kernel = rmsnorm_bwd_rows_kernel<T, 4>; break;
    default: return cudaErrorInvalidValue;
  }
  const int groups = threads / row_threads;
  const size_t smem = per == 0 || groups > 1 ? sizeof(float) * groups * d : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, s>>>(x, w, dy, dx, dw_part, rows, rows_per_block, d,
                                     row_threads, eps);
  if (cudaError_t e = cudaGetLastError()) return e;
  rmsnorm_bwd_cols_kernel<T><<<(d + 31) / 32, 32 * kColWarps, 0, s>>>(dw_part, dw, grid, d);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx [rows, d]; w, dw [d]; dw_part [grid, d] f32 scratch.  The launch
// shape comes from kernels/rmsnorm.py:bwd_plan: per vectors a thread (0:
// the scalar route), row_threads threads a row, threads a block, grid
// blocks of rows_per_block consecutive rows.  A shape the kernel cannot
// cover is an invalid-value error.
extern "C" int repro_rmsnorm_bwd(int dtype, const void* x, const void* w, const void* dy,
                                 void* dx, void* dw, float* dw_part, int64_t rows, int d,
                                 float eps, int per, int row_threads, int threads, int grid,
                                 int rows_per_block, void* stream) {
  if (rows <= 0 || d <= 0) return cudaSuccess;
  if (row_threads <= 0 || (row_threads & (row_threads - 1)) || threads > kMaxThreads ||
      threads % 32 || threads % row_threads || grid <= 0 || rows_per_block <= 0 ||
      static_cast<int64_t>(grid) * rows_per_block < rows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T, {
    constexpr int kN = repro::Vec16<T>::kN;
    if (per > 0 && (d % kN || d / kN > per * row_threads)) return cudaErrorInvalidValue;
    return launch_rmsnorm_bwd<T>(static_cast<const T*>(x), static_cast<const T*>(w),
                                 static_cast<const T*>(dy), static_cast<T*>(dx),
                                 static_cast<T*>(dw), dw_part, rows, d, eps, per, row_threads,
                                 threads, grid, rows_per_block, s);
  });
  return cudaSuccess;
}

// Message for a CUDA error code the entry points returned (all kernel files
// link into one library; this is its one error-string export).
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
