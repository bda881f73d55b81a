// Fused SwiGLU gating: out = round(silu(gate)) * up, and its backward.
//
// Replaces the TPU kernel src/repro/kernels/swiglu.py (silu_mul, pallas_call
// at :59).  On the H100 it is bound by bytes: two reads and one write per
// element, so the fusion's whole point is that silu(gate) never makes a trip
// to device memory.  Grid-stride loop, one element per thread per step,
// neighbouring threads on neighbouring elements.  Rounding follows the plain
// version (kernels/ref.py): silu(gate) is computed in f32 and rounded to the
// element type before the multiply.  The TPU kernel keeps it in f32, so the
// two differ by one rounding of the product in bf16.
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

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
silu_mul_kernel(const T* __restrict__ gate, const T* __restrict__ up, T* __restrict__ out,
                int64_t n, int rounds) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float g = repro::to_f32(gate[i]);
    if (rounds == 0) {
      const T act = repro::from_f32<T>(g * (1.0f / (1.0f + expf(-g))));
      out[i] = repro::from_f32<T>(repro::to_f32(act) * repro::to_f32(up[i]));
    } else {
      const float sig = curry_sigmoid(g, rounds);
      out[i] = repro::from_f32<T>(__fmul_rn(__fmul_rn(g, sig), repro::to_f32(up[i])));
    }
  }
}

}  // namespace

extern "C" int repro_silu_mul(int dtype, const void* gate, const void* up, void* out,
                              int64_t n, int rounds, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = repro::elementwise_blocks(n, kThreads);
  REPRO_DISPATCH_DTYPE(dtype, T,
    silu_mul_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(gate),
                                                   static_cast<const T*>(up),
                                                   static_cast<T*>(out), n, rounds));
  return cudaGetLastError();
}

// Backward, one elementwise pass: dup = dy * round(silu(g)) and dgate =
// round(dy * up) * sigma(g) (1 + g (1 - sigma(g))), each in f32 and rounded
// to the element type, at the forward's rounding point (kernels/ref.py
// silu_mul_bwd).  Bound by bytes: three reads and two writes per element.
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
silu_mul_bwd_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                    const T* __restrict__ dy, T* __restrict__ dgate, T* __restrict__ dup,
                    int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
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
                                  void* dgate, void* dup, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = repro::elementwise_blocks(n, kThreads);
  REPRO_DISPATCH_DTYPE(dtype, T,
    silu_mul_bwd_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(gate), static_cast<const T*>(up), static_cast<const T*>(dy),
        static_cast<T*>(dgate), static_cast<T*>(dup), n));
  return cudaGetLastError();
}
