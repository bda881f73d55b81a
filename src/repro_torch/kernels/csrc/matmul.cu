// Weight-stationary GEMM: out [M, N] = x [M, K] @ w [K, N], f32 accumulation
// over all of K and one rounding to the output type.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py weight_stationary_matmul
// (pallas_call at :50; _kernel at :22-27), the paper's SRAM-PIM lane: a
// weight panel stays put while the input rows stream past it.  On the TPU
// the [K, bn] panel sits in VMEM across the m tiles of one n panel.  On the
// H100 such a panel (1 MiB at K 2048 in bf16) does not fit a block's 227 KB
// of shared memory, so the reference's grid order is kept instead:
// blockIdx.x walks the m tiles (inner) and blockIdx.y the n panels (outer).
// Blocks are issued x first, so the blocks in flight together read one
// weight panel, which stays in the 50 MB L2 across its m tiles, and device
// memory sees each weight byte about once.  Each block walks K in BK-deep
// stages through shared memory, double-buffered through registers: the
// next stage's global loads are in flight while the current one computes.
//
// Ragged M, N and K tiles are masked inside the kernel with zero fill; the
// host pads nothing.  Rows whose length is not a multiple of 16 bytes
// (K or N not a multiple of 8 in bf16, or a base pointer not 16-byte
// aligned) take a guarded scalar load path; the others 16-byte loads.
// There is no split of K across blocks and no atomic: every output element
// is summed by one block in a fixed order, so two launches give the same
// bits.
//
// bf16 inputs run on the tensor cores with mma.sync m16n8k16 (bf16 -> f32).
// Two tile shapes, chosen by the caller (kernels/matmul.py: the narrow one
// for M <= 16):
//   wide (prefill):   a 64 x 64 block tile, 4 warps as 2 x 2, each warp
//                     32 x 32 (2 x 4 MMA tiles), BK 32;
//   narrow (decode):  a 16 x 32 block tile, BK 64, and the 4 warps split
//                     each stage's four 16-deep steps, their partial sums
//                     added in shared memory in warp order.  The narrow
//                     tile gives 64 blocks at N 2048 where the wide one
//                     gives 32; half of the 16 MMA rows idle at M 8.
// f32 inputs run as FFMA on the CUDA cores (no TF32): a 64 x 64 block tile,
// 256 threads of 4 x 4 outputs, BK 16.
//
// Bound on the H100: at decode (M 8) bytes, the weight read once (a [2048,
// 2048] bf16 weight: 2.5 us at 3.35 TB/s); at a 512-row prefill chunk
// operations (989 TFLOP/s in bf16).  This first version uses mma.sync from
// registers; wgmma with TMA and a persistent schedule are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;     // bf16 kernel: 4 warps
constexpr int kF32Threads = 256;  // f32 kernel

using repro::mma_bf16;
using repro::pack_bf16;

// Eight consecutive bf16 from p, the first `valid` of them real and the rest
// zero.  kVec: one 16-byte load (valid is then <= 0 or >= 8); else scalar
// loads guarded one by one.
template <bool kVec>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p, int valid) {
  if (kVec) {
    return valid > 0 ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat16 lo = 2 * j < valid ? p[2 * j] : zero;
    const __nv_bfloat16 hi = 2 * j + 1 < valid ? p[2 * j + 1] : zero;
    v[j] = pack_bf16(lo, hi);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// Block tile BM x BN, stage depth BK; warps WM x WN over the tile and WK
// over each stage's 16-deep steps.
template <int BM, int BN, int BK, int WM, int WN, int WK, bool kVec, typename OutT>
__global__ void __launch_bounds__(kThreads)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 OutT* __restrict__ out, int M, int N, int K) {
  static_assert(WM * WN * WK * 32 == kThreads, "4 warps");
  constexpr int TM = BM / WM, TN = BN / WN;   // warp tile
  constexpr int MT = TM / 16, NT = TN / 8;     // MMA tiles per warp
  constexpr int KSTEPS = BK / 16;
  static_assert(MT * 16 == TM && NT * 8 == TN && KSTEPS % WK == 0, "tile shape");
  constexpr int AV = BM * BK / 8 / kThreads;   // 16-byte vectors per thread
  constexpr int BV = BK * BN / 8 / kThreads;
  static_assert(AV * 8 * kThreads == BM * BK && BV * 8 * kThreads == BK * BN, "tile split");
  // rows padded by 16 bytes: the fragment reads below are free of bank
  // conflicts, and every row start stays 16-byte aligned
  constexpr int AS = BK + 8, BS = BN + 8, RS = BN + 4;

  __shared__ __align__(16) __nv_bfloat16 As[2][BM][AS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK][BS];
  __shared__ float red[WK][BM][RS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp / (WM * WN), wm = (warp % (WM * WN)) / WN, wn = warp % WN;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BM;   // m tiles inner: blocks in flight share a panel
  const int n0 = blockIdx.y * BN;

  uint4 ra[AV], rb[BV];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * kThreads, r = idx / (BK / 8), c = idx % (BK / 8);
      const int gm = m0 + r, gk = k0 + c * 8;
      const int valid = gm < M ? min(8, K - gk) : 0;
      ra[v] = load8<kVec>(valid > 0 ? x + static_cast<int64_t>(gm) * K + gk : x, valid);
    }
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * kThreads, r = idx / (BN / 8), c = idx % (BN / 8);
      const int gk = k0 + r, gn = n0 + c * 8;
      const int valid = gk < K ? min(8, N - gn) : 0;
      rb[v] = load8<kVec>(valid > 0 ? w + static_cast<int64_t>(gk) * N + gn : w, valid);
    }
  };
  auto store_stage = [&](int buf) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * kThreads;
      *reinterpret_cast<uint4*>(&As[buf][idx / (BK / 8)][(idx % (BK / 8)) * 8]) = ra[v];
    }
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * kThreads;
      *reinterpret_cast<uint4*>(&Bs[buf][idx / (BN / 8)][(idx % (BN / 8)) * 8]) = rb[v];
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load_stage(0);
  store_stage(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load_stage((kt + 1) * BK);
#pragma unroll
    for (int s0 = 0; s0 < KSTEPS; s0 += WK) {
      const int kk = (s0 + wk) * 16;
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * TM + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[cur][r][kk + tig * 2]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][kk + tig * 2]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[cur][r][kk + tig * 2 + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][kk + tig * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn * TN + j * 8 + g;
        const uint32_t b0 = pack_bf16(Bs[cur][kk + tig * 2][col], Bs[cur][kk + tig * 2 + 1][col]);
        const uint32_t b1 =
            pack_bf16(Bs[cur][kk + tig * 2 + 8][col], Bs[cur][kk + tig * 2 + 9][col]);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    if (kt + 1 < nk) store_stage(cur ^ 1);
    __syncthreads();
  }

  // the warps' tiles (and, for WK > 1, their partial sums over K) meet in
  // shared memory; each output is then summed in warp order and written by
  // neighbouring threads on neighbouring columns
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = wm * TM + i * 16 + g, c = wn * TN + j * 8 + tig * 2;
      red[wk][r][c] = acc[i][j][0];
      red[wk][r][c + 1] = acc[i][j][1];
      red[wk][r + 8][c] = acc[i][j][2];
      red[wk][r + 8][c + 1] = acc[i][j][3];
    }
  __syncthreads();
  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e % BN, gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      float sum = red[0][r][c];
#pragma unroll
      for (int q = 1; q < WK; ++q) sum += red[q][r][c];
      out[static_cast<int64_t>(gm) * N + gn] = repro::from_f32<OutT>(sum);
    }
  }
}

// f32: a 64 x 64 tile, thread (tx, ty) owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4), so the shared-memory reads of a step are broadcasts
// (A) and consecutive words (B).  A is stored k-major.
template <typename OutT>
__global__ void __launch_bounds__(kF32Threads)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                OutT* __restrict__ out, int M, int N, int K) {
  constexpr int BM = 64, BN = 64, BK = 16, PER = BM * BK / kF32Threads;
  __shared__ float As[2][BK][BM + 4];
  __shared__ float Bs[2][BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  float ra[PER], rb[PER];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int v = 0; v < PER; ++v) {
      const int e = tid + v * kF32Threads;
      const int gm = m0 + e / BK, gka = k0 + e % BK;
      ra[v] = gm < M && gka < K ? x[static_cast<int64_t>(gm) * K + gka] : 0.f;
      const int gkb = k0 + e / BN, gn = n0 + e % BN;
      rb[v] = gkb < K && gn < N ? w[static_cast<int64_t>(gkb) * N + gn] : 0.f;
    }
  };
  auto store_stage = [&](int buf) {
#pragma unroll
    for (int v = 0; v < PER; ++v) {
      const int e = tid + v * kF32Threads;
      As[buf][e % BK][e / BK] = ra[v];
      Bs[buf][e / BN][e % BN] = rb[v];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load_stage(0);
  store_stage(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load_stage((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[cur][kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[cur][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_stage(cur ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) out[static_cast<int64_t>(gm) * N + gn] = repro::from_f32<OutT>(acc[i][j]);
    }
}

template <int BM, int BN, int BK, int WM, int WN, int WK, typename OutT>
cudaError_t launch_bf16(const void* x, const void* w, void* out, int m, int n, int k,
                        bool vec, cudaStream_t s) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* op = static_cast<OutT*>(out);
  if (vec) {
    gemm_bf16_kernel<BM, BN, BK, WM, WN, WK, true, OutT><<<grid, kThreads, 0, s>>>(xp, wp, op, m, n, k);
  } else {
    gemm_bf16_kernel<BM, BN, BK, WM, WN, WK, false, OutT><<<grid, kThreads, 0, s>>>(xp, wp, op, m, n, k);
  }
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch(int dtype, const void* x, const void* w, void* out, int m, int n, int k,
                   bool narrow, cudaStream_t s) {
  if (dtype == repro::kF32) {
    const dim3 grid((m + 63) / 64, (n + 63) / 64);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gemm_f32_kernel<OutT><<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<OutT*>(out), m,
        n, k);
    return cudaGetLastError();
  }
  if (dtype != repro::kBF16) return cudaErrorInvalidValue;
  const bool vec = k % 8 == 0 && n % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (narrow) return launch_bf16<16, 32, 64, 1, 1, 4, OutT>(x, w, out, m, n, k, vec, s);
  return launch_bf16<64, 64, 32, 2, 2, 1, OutT>(x, w, out, m, n, k, vec, s);
}

}  // namespace

// x [m, k] and w [k, n] of element type `dtype`; out [m, n] of `out_dtype`;
// narrow != 0 takes the bf16 kernel's 16 x 32 tile (f32 has one tile).
extern "C" int repro_matmul(int dtype, int out_dtype, const void* x, const void* w, void* out,
                            int m, int n, int k, int narrow, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return cudaSuccess;
  if (narrow && dtype != repro::kBF16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(out_dtype, OutT,
                       return launch<OutT>(dtype, x, w, out, m, n, k, narrow != 0, s));
  return cudaErrorInvalidValue;
}
