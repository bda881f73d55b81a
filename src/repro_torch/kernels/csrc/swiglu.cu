// Fused SwiGLU gating: out = round(silu(gate)) * up, and its backward.
//
// Replaces the TPU kernel src/repro/kernels/swiglu.py (silu_mul, pallas_call
// at :59).  On the H100 it is bound by bytes: two reads and one write per
// element, so the fusion's whole point is that silu(gate) never makes a trip
// to device memory, and the kernel's that device memory sees full-width
// accesses with enough of them in flight.  On the vector route (kVector)
// each thread takes a 16-byte vector of gate and one of up a step (8 bf16
// or 4 f32 each), neighbouring threads on neighbouring vectors, both loads
// issued before the math, and stores a 16-byte vector; the n mod 8 (or 4)
// elements past the last vector go one a thread.  Two and four vectors a
// step timed slower (tools/swiglu_norm_bwd_readings.py).  The grid walks
// the vectors with a stride of the whole grid, so its size comes from the
// card (kernels/swiglu.py:plan), not from n.  Without kVector the same walk
// goes element by element: the element route, for a call that fits one
// wave of the card's threads (decode's [8, 5632]: eight times the threads,
// each with one element's math, read faster than one vector each), and the
// scalar route, for a base off a 16-byte boundary.  Index math is 32-bit:
// the entry point launches once per 2^30 elements.
//
// Rounding follows the plain version (kernels/ref.py): silu(gate) is
// computed in f32 and rounded to the element type before the multiply.  The
// TPU kernel keeps it in f32, so the two differ by one rounding of the
// product in bf16.
//
// With rounds > 0 the kernel is the TPU kernel's curry_rounds form
// (swiglu.py:18-40): the sigmoid's exp(-|g|) by the Curry ALU's
// range-reduced Taylor series in Horner form, p <- p (xr / i) + 1 for
// i = rounds..1 with xr = -|g| / 16, then four squarings, and g sigma(g) u
// in f32 with one rounding, as the TPU kernel rounds.  The four squarings
// multiply a relative error by 16, so every step is pinned: xr / i is an
// IEEE division (__fdiv_rn, as the plain version divides by a tensor, not
// by a scalar's reciprocal), and each product and sum is rounded on its own
// (__fmul_rn / __fadd_rn), which keeps nvcc from contracting p * a + 1
// into an FMA.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;           // threads of a block (the plan's largest)
constexpr int64_t kLaunchElems = 1 << 30;  // elements a launch (32-bit indices)

// sigma(g) with exp(-|g|) by the Curry ALU's Taylor iteration
__device__ __forceinline__ float curry_sigmoid(float g, int rounds) {
  const float xr = __fmul_rn(-fabsf(g), 1.0f / 16.0f);
  float p = 1.0f;
  for (int i = rounds; i >= 1; --i)
    p = __fadd_rn(__fmul_rn(p, __fdiv_rn(xr, static_cast<float>(i))), 1.0f);
#pragma unroll
  for (int s = 0; s < 4; ++s) p = __fmul_rn(p, p);
  const float den = __fadd_rn(1.0f, p);
  return g >= 0.f ? __fdiv_rn(1.0f, den) : __fdiv_rn(p, den);
}

// one output before its rounding to T: round(g sigma(g)) u, or the curry
// form's g sigma(g) u
template <typename T>
__device__ __forceinline__ float silu_mul_f32(float g, float u, int rounds) {
  if (rounds == 0) {
    const T act = repro::from_f32<T>(g * (1.0f / (1.0f + expf(-g))));
    return repro::to_f32(act) * u;
  }
  return __fmul_rn(__fmul_rn(g, curry_sigmoid(g, rounds)), u);
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kMaxThreads)
silu_mul_kernel(const T* __restrict__ gate, const T* __restrict__ up, T* __restrict__ out,
                int n, int rounds) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  int i0 = tid;   // the first element this thread takes one at a time
  if constexpr (kVector) {
    constexpr int kN = repro::Vec16<T>::kN;
    const int nv = n / kN;
    for (int v = tid; v < nv; v += nthreads) {
      float g[kN], u[kN];
      repro::unpack16<T>(repro::load16(gate + v * kN), g);
      repro::unpack16<T>(repro::load16(up + v * kN), u);
#pragma unroll
      for (int e = 0; e < kN; ++e) g[e] = silu_mul_f32<T>(g[e], u[e], rounds);
      repro::store16(out + v * kN, repro::pack16<T>(g));
    }
    i0 += nv * kN;   // the elements past the last whole vector, one a thread
  }
  for (int i = i0; i < n; i += nthreads)
    out[i] = repro::from_f32<T>(
        silu_mul_f32<T>(repro::to_f32(gate[i]), repro::to_f32(up[i]), rounds));
}

template <typename T>
int launch_silu_mul(const T* gate, const T* up, T* out, int64_t n, int rounds, bool vector,
                    int threads, int grid, cudaStream_t s) {
  auto kernel = vector ? silu_mul_kernel<T, true> : silu_mul_kernel<T, false>;
  for (int64_t off = 0; off < n; off += kLaunchElems) {
    const int part = static_cast<int>(n - off < kLaunchElems ? n - off : kLaunchElems);
    kernel<<<grid, threads, 0, s>>>(gate + off, up + off, out + off, part, rounds);
    if (cudaError_t e = cudaGetLastError()) return e;
  }
  return cudaSuccess;
}

}  // namespace

// gate, up, out: n elements.  The launch shape comes from
// kernels/swiglu.py:plan: vector (1: 16-byte vectors; 0: one element a
// thread, the element and scalar routes), threads a block, grid blocks.
extern "C" int repro_silu_mul(int dtype, const void* gate, const void* up, void* out,
                              int64_t n, int rounds, int vector, int threads, int grid,
                              void* stream) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 || grid <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T,
    return launch_silu_mul<T>(static_cast<const T*>(gate), static_cast<const T*>(up),
                              static_cast<T*>(out), n, rounds, vector != 0, threads, grid,
                              s));
  return cudaSuccess;
}

// Backward, one elementwise pass: dup = dy * round(silu(g)) and dgate =
// round(dy * up) * sigma(g) (1 + g (1 - sigma(g))), each in f32 and rounded
// to the element type, at the forward's rounding point (kernels/ref.py
// silu_mul_bwd).  Bound by bytes: three reads and two writes per element.
// A grid-stride loop, one element a thread a step; the grid comes from the
// card (kernels/_build.py:stride_grid).
namespace {

constexpr int kBwdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
silu_mul_bwd_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                    const T* __restrict__ dy, T* __restrict__ dgate, T* __restrict__ dup,
                    int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBwdThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x; i < n;
       i += stride) {
    const float g = repro::to_f32(gate[i]);
    const float dyv = repro::to_f32(dy[i]);
    const float sig = 1.0f / (1.0f + expf(-g));
    const float act = repro::to_f32(repro::from_f32<T>(g * sig));
    dup[i] = repro::from_f32<T>(dyv * act);
    const float dact = repro::to_f32(repro::from_f32<T>(dyv * repro::to_f32(up[i])));
    dgate[i] = repro::from_f32<T>(dact * (sig * (1.0f + g * (1.0f - sig))));
  }
}

}  // namespace

extern "C" int repro_silu_mul_bwd(int dtype, const void* gate, const void* up, const void* dy,
                                  void* dgate, void* dup, int64_t n, int grid, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (grid <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T,
    silu_mul_bwd_kernel<T><<<grid, kBwdThreads, 0, s>>>(
        static_cast<const T*>(gate), static_cast<const T*>(up), static_cast<const T*>(dy),
        static_cast<T*>(dgate), static_cast<T*>(dup), n));
  return cudaGetLastError();
}
