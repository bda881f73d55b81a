// Interleaved-pair RoPE with cos/sin computed in the kernel from int positions.
//
// Replaces the TPU kernel src/repro/kernels/rope.py (apply_rope, pallas_call
// at :52).  On the H100 it is bound by bytes: one read of x and of the
// positions, one write of the output; the angle math (powf, sincosf) is a
// few dozen instructions per pair and hides under the memory traffic.  One
// thread rotates one neighbour pair (x[2j], x[2j+1]), so the pair swap and
// negate never leave registers and no cos/sin table is read from memory.
// The inverse frequency is computed as 1 / theta^(j/half), the form of the
// plain version (kernels/ref.py), not the TPU kernel's exp(-ln(theta) j/half),
// and j/half as j * (1/half): PyTorch divides a CUDA tensor by a scalar as a
// product with the scalar's reciprocal, and the angle pos * inv magnifies a
// one-ulp difference in the exponent (a true division read 7.6e-5 off the
// plain version in f32 at head dim 112 and positions below 1024).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const int* __restrict__ pos, T* __restrict__ out,
            int64_t n_pairs, int heads, int half, float theta) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_pairs;
       i += stride) {
    // i indexes [B*S, H, half]; the position is shared by every head of a token
    const int j = static_cast<int>(i % half);
    const int64_t token = i / (static_cast<int64_t>(half) * heads);
    const float e = static_cast<float>(j) * (1.0f / static_cast<float>(half));
    const float inv = 1.0f / powf(theta, e);
    const float ang = static_cast<float>(pos[token]) * inv;
    float sn, cs;
    sincosf(ang, &sn, &cs);
    const float xe = repro::to_f32(x[2 * i]);
    const float xo = repro::to_f32(x[2 * i + 1]);
    out[2 * i] = repro::from_f32<T>(xe * cs - xo * sn);
    out[2 * i + 1] = repro::from_f32<T>(xe * sn + xo * cs);
  }
}

}  // namespace

extern "C" int repro_rope(int dtype, const void* x, const int* pos, void* out, int64_t tokens,
                          int heads, int head_dim, float theta, void* stream) {
  const int half = head_dim / 2;
  const int64_t n_pairs = tokens * heads * half;
  if (n_pairs <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = repro::elementwise_blocks(n_pairs, kThreads);
  REPRO_DISPATCH_DTYPE(dtype, T,
    rope_kernel<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x), pos,
                                               static_cast<T*>(out), n_pairs, heads, half,
                                               theta));
  return cudaGetLastError();
}
