// Interleaved-pair RoPE with cos/sin computed in the kernel from int positions,
// on one tensor or on q and k together (they share positions and theta).
//
// Replaces the TPU kernel src/repro/kernels/rope.py (apply_rope, pallas_call
// at :52).  On the H100 it is bound by bytes: one read of x (q and k) and of
// the positions, one write of the output.  The angle depends only on (token,
// pair j), not on the head, so a block takes a tile of tokens and first forms
// cos/sin for each (token, j) of the tile once, into shared memory; then its
// threads rotate every head of those tokens (q's heads, then k's) in 16-byte
// accesses, 4 bf16 or 2 f32 pairs each, with 32-bit index math inside the
// tile.  At few tokens (decode) the plan (kernels/rope.py:plan) splits each
// token's heads over blockIdx.y, so the grid is not as narrow as the token
// count; at many it caps the grid from the card and blocks walk tiles
// gridDim.x apart.  kPairs == 1 is the scalar route (a head dim that is not a
// multiple of the vector, or a base off a 16-byte boundary): one pair an
// access, element by element.
//
// The arithmetic is the plain version's (kernels/ref.py): the inverse
// frequency is 1 / theta^(j/half), not the TPU kernel's exp(-ln(theta)
// j/half), with j/half formed as j * (1/half): PyTorch divides a CUDA tensor
// by a scalar as a product with the scalar's reciprocal, and the angle
// pos * inv magnifies a one-ulp difference in the exponent (a true division
// read 7.6e-5 off the plain version in f32 at head dim 112 and positions
// below 1024).  The accurate powf and sincosf, never the fast forms: training
// positions reach 4096 rad, where those lose ~1e-3.  sign = -1 rotates by
// -pos (the backward: the rotation is orthogonal), exactly as a negated
// position tensor would.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

// pairs j0.. of one head's row: (x[2j], x[2j + 1]) as (e[p], o[p])
template <typename T, int kPairs>
__device__ __forceinline__ void load_pairs(const T* __restrict__ p, float (&e)[kPairs],
                                           float (&o)[kPairs]) {
  if constexpr (kPairs == 1) {
    e[0] = repro::to_f32(p[0]);
    o[0] = repro::to_f32(p[1]);
  } else {
    float f[2 * kPairs];
    repro::unpack16<T>(repro::load16(p), f);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      e[i] = f[2 * i];
      o[i] = f[2 * i + 1];
    }
  }
}

template <typename T, int kPairs>
__device__ __forceinline__ void store_pairs(T* __restrict__ p, const float (&e)[kPairs],
                                            const float (&o)[kPairs]) {
  if constexpr (kPairs == 1) {
    p[0] = repro::from_f32<T>(e[0]);
    p[1] = repro::from_f32<T>(o[0]);
  } else {
    float f[2 * kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      f[2 * i] = e[i];
      f[2 * i + 1] = o[i];
    }
    repro::store16(p, repro::pack16<T>(f));
  }
}

// q [tokens, hq, d] and k [tokens, hk, d] (hk = 0: no k) into oq, ok.  Block
// (x, y) rotates heads [y hpb, y hpb + hpb) of the q-then-k head list, for
// tiles of `tile` tokens x, x + gridDim.x, ...
template <typename T, int kPairs>
__global__ void __launch_bounds__(kMaxThreads)
rope_kernel(const T* __restrict__ q, const T* __restrict__ k, const int* __restrict__ pos,
            T* __restrict__ oq, T* __restrict__ ok, int64_t tokens, int hq, int hk, int d,
            float theta, int sign, int tile, int hpb) {
  extern __shared__ float2 cs[];                 // [tile][half] (cos, sin)
  const int half = d >> 1;
  float* inv = reinterpret_cast<float*>(cs + tile * half);   // [half]
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const float e = static_cast<float>(j) * (1.0f / static_cast<float>(half));
    inv[j] = 1.0f / powf(theta, e);
  }
  const int per_head = half / kPairs;            // accesses a head row
  const int h0 = blockIdx.y * hpb;
  const int nh = min(hpb, hq + hk - h0);
  const int per_token = nh * per_head;
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile; t0 < tokens;
       t0 += static_cast<int64_t>(gridDim.x) * tile) {
    const int nt = tokens - t0 < tile ? static_cast<int>(tokens - t0) : tile;
    __syncthreads();                             // inv written; the last tile's cs read
    for (int a = threadIdx.x; a < nt * half; a += blockDim.x) {
      const int tt = a / half;
      const float ang = static_cast<float>(sign * pos[t0 + tt]) * inv[a - tt * half];
      float sn, c;
      sincosf(ang, &sn, &c);
      cs[a] = make_float2(c, sn);
    }
    __syncthreads();
    for (int a = threadIdx.x; a < nt * per_token; a += blockDim.x) {
      const int tt = a / per_token;
      const int r = a - tt * per_token;
      const int hh = r / per_head;
      const int v = r - hh * per_head;
      const int head = h0 + hh;
      const int64_t token = t0 + tt;
      const int64_t off = head < hq ? (token * hq + head) * d
                                    : (token * hk + (head - hq)) * d;
      const int col = v * 2 * kPairs;
      const T* src = (head < hq ? q : k) + off + col;
      T* dst = (head < hq ? oq : ok) + off + col;
      float xe[kPairs], xo[kPairs], re[kPairs], ro[kPairs];
      load_pairs<T, kPairs>(src, xe, xo);
      const float2* c = cs + tt * half + v * kPairs;
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        re[p] = xe[p] * c[p].x - xo[p] * c[p].y;
        ro[p] = xe[p] * c[p].y + xo[p] * c[p].x;
      }
      store_pairs<T, kPairs>(dst, re, ro);
    }
  }
}

template <typename T>
int launch_rope(const T* q, const T* k, const int* pos, T* oq, T* ok, int64_t tokens, int hq,
                int hk, int d, float theta, int sign, int pairs, int tile, int hpb, int threads,
                int grid_x, int grid_y, cudaStream_t s) {
  constexpr int kVec = repro::Vec16<T>::kN / 2;  // pairs in 16 bytes
  void (*kernel)(const T*, const T*, const int*, T*, T*, int64_t, int, int, int, float, int, int,
                 int);
  if (pairs == 1) {
    kernel = rope_kernel<T, 1>;
  } else if (pairs == kVec && d % (2 * kVec) == 0) {
    kernel = rope_kernel<T, kVec>;
  } else {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float2) * tile * (d / 2) + sizeof(float) * (d / 2);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  kernel<<<dim3(grid_x, grid_y), threads, smem, s>>>(q, k, pos, oq, ok, tokens, hq, hk, d, theta,
                                                     sign, tile, hpb);
  return cudaGetLastError();
}

}  // namespace

// q, oq [tokens, hq, d]; k, ok [tokens, hk, d] (hk = 0 and null pointers for
// one tensor); pos [tokens] int32, multiplied by sign (+1 or -1).  The
// launch shape comes from kernels/rope.py:plan: pairs an access (1: the
// scalar route), tile tokens and hpb heads a block, threads, the grid.
extern "C" int repro_rope(int dtype, const void* q, const void* k, const int* pos, void* oq,
                          void* ok, int64_t tokens, int hq, int hk, int d, float theta, int sign,
                          int pairs, int tile, int hpb, int threads, int grid_x, int grid_y,
                          void* stream) {
  if (tokens <= 0 || hq + hk <= 0) return cudaSuccess;
  if (d <= 0 || d % 2 || hq < 0 || hk < 0 || (sign != 1 && sign != -1) || tile <= 0 ||
      hpb <= 0 || threads <= 0 || threads > kMaxThreads || grid_x <= 0 || grid_y <= 0 ||
      static_cast<int64_t>(grid_y) * hpb < hq + hk)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(dtype, T, {
    return launch_rope<T>(static_cast<const T*>(q), static_cast<const T*>(k), pos,
                          static_cast<T*>(oq), static_cast<T*>(ok), tokens, hq, hk, d, theta,
                          sign, pairs, tile, hpb, threads, grid_x, grid_y, st);
  });
  return cudaSuccess;
}
