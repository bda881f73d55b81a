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
// memory sees each weight byte about once.  There is no split of K across
// blocks and no atomic: every output element is summed by one block in a
// fixed order, so two launches give the same bits.
//
// Three kernels; kernels/matmul.py:plan picks one and its tile on the host
// from (M, N, K), the dtype and the alignment, before the launch:
//
// * bf16, rows 16-byte aligned (K % 8 == 0, N % 8 == 0, both bases 16-byte
//   aligned): gemm_wgmma_kernel, Hopper's warpgroup MMA fed by TMA.  A
//   producer warpgroup (one thread) keeps a ring of BK = 64 stages in
//   shared memory filled with cp.async.bulk.tensor loads of an x tile [BM,
//   64] (K-major, 128-byte swizzle) and a w tile [64, BN] (N-major, in
//   boxes of at most 64 columns under the 32 / 64 / 128-byte swizzle that
//   matches their width), each stage's arrival counted in bytes on its
//   `full` mbarrier.  NC consumer warpgroups (BM = 64 NC rows) wait on it,
//   issue four wgmma m64nWk16 per stage (W = BN, or 128-column halves of
//   it; A K-major, B N-major through the descriptor's transpose bit: no
//   host transpose) into a fresh partial, wait for them, add the partial
//   into the f32 accumulator (below), and release the stage on its `empty`
//   mbarrier.  Rows and columns past M, N and K arrive
//   from TMA as zeros, so the loads need no mask; the epilogue masks the
//   stores.  When M is below the tile, TMA loads only M rounded up to 8 rows
//   and the rows beneath stay zero from the start.  Tiles (BM x BN):
//     decode (M <= 64):  64 x 16 / 32 / 64, one consumer warpgroup, the
//                        widest tile that still gives ~132 blocks: the work
//                        is streaming the weight, and an 8-stage ring keeps
//                        16-64 KB of it in flight a block;
//     prefill (M > 64):  128 x 64 / 128 / 192 / 256, two consumer
//                        warpgroups of 64 rows with 232 registers each
//                        (setmaxnreg; the producer keeps 40), the width
//                        that fills the 132 SMs in the fewest waves.
// * bf16 otherwise (rows that are not 16 bytes, as TMA needs, or a base
//   off 16-byte alignment): gemm_bf16_kernel, mma.sync m16n8k16 from
//   registers, ragged tiles masked in the kernel with zero fill, a guarded
//   scalar load path where a row is not 16-byte aligned.  A 64 x 64 tile
//   (4 warps as 2 x 2, BK 32), or for M <= 16 a 16 x 32 tile, BK 64, whose
//   4 warps split each stage's four 16-deep steps and add their partial
//   sums in shared memory in warp order.
// * f32: gemm_f32_kernel, FFMA on the CUDA cores (no TF32): a 64 x 64
//   block tile, 256 threads of 4 x 4 outputs, BK 16.
//
// Accumulation: the tensor cores' own f32 accumulation truncates, so over a
// long K its error against the exact product grows linearly, well past what
// summing in another order costs.  At K 5632 it reaches ~3e-5, more than a
// bf16 output near zero may be off (FID_BF16_TOL in chip_smoke.py: 1e-5 +
// 2^-7 |x|) and than the f32 output's 1e-5 hold.  Both bf16 kernels
// therefore sum K in pieces on the tensor cores (mma.sync: a 32- or 64-deep
// stage; wgmma: one or two 64-deep stages, WgmmaTile::PROMOTE) into a fresh
// partial and add it into the f32 accumulator on the CUDA cores, in a fixed
// order.  The wait for each piece's wgmma costs the 128-row tiles part of
// their rate.
//
// Bound on the H100: at decode (M 8) bytes, the weight read once (a [2048,
// 2048] bf16 weight: 2.5 us at 3.35 TB/s); at a 512-row prefill chunk
// operations (989 TFLOP/s in bf16, which only wgmma reaches).  One output
// tile a block; a persistent schedule that overlaps a tile's epilogue with
// the next tile's loads is later work.
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

  // each stage's products are summed on the tensor cores into `part` and
  // added into acc on the CUDA cores (see the header)
  float part[MT][NT][4];

  const int nk = (K + BK - 1) / BK;
  load_stage(0);
  store_stage(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load_stage((kt + 1) * BK);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
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
        for (int i = 0; i < MT; ++i) mma_bf16(part[i][j], a[i], b0, b1);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
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

// ---------------------------------------------------------------------------
// bf16 on wgmma, fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

template <int NC, int BN>
struct WgmmaTile {
  static constexpr int BM = 64 * NC, BK = 64;
  static constexpr int THREADS = (NC + 1) * 128;        // consumers, then the producer
  static constexpr int BW = BN < 64 ? BN : 64;           // w box width: one swizzle atom
  static constexpr int SWIZZLE = BW * 2;                 // its row bytes: 32, 64 or 128
  static constexpr int NBOX = BN / BW;
  static constexpr int A_BYTES = BM * BK * 2;            // x tile [BM, 64], rows of 128 B
  static constexpr int B_BOX = BK * SWIZZLE;             // w box [64, BW]
  static constexpr int B_BYTES = NBOX * B_BOX;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // stages a consumer sums on the tensor cores into one partial before
  // adding it into acc on the CUDA cores (see the header): two where a
  // stage takes two 128-column halves (each half waits for its wgmma),
  // else one (holding two stages slowed the decode tiles and 128 x 64)
  static constexpr int PROMOTE = BN > 128 ? 2 : 1;
  static constexpr int STAGES = (200 * 1024) / STAGE < 8 ? (200 * 1024) / STAGE : 8;
  // the ring, its 2 x STAGES barriers, and slack to align the base to 1024
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(BN % BW == 0 && (BW == 16 || BW == 32 || BW == 64), "w box");
  static_assert(STAGES >= 4, "ring depth");
  static_assert(A_BYTES % 1024 == 0 && B_BOX % 1024 == 0, "1024-byte aligned tiles");
};

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = repro::pack_f32_bf16(a, b);
}

// One stage's four k16 steps over W output columns of the tile, starting
// at b (a w box): d [64, W] += a [64, 64] (this warpgroup's rows) b [64, W].
template <int NC, int BN, int W>
__device__ __forceinline__ void stage_wgmma(float (&d)[W / 2], const uint8_t* a,
                                            const uint8_t* b) {
  using T = WgmmaTile<NC, BN>;
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
    const uint64_t da = repro::wgmma_desc(a + kk * 32, 16, 1024, 128);
    const uint64_t db = repro::wgmma_desc(b + kk * 16 * T::SWIZZLE, T::B_BOX, 8 * T::SWIZZLE,
                                          T::SWIZZLE);
    repro::wgmma_bf16<W>(d, da, db);
  }
}

// The first n of the stages at (a[j], b[j]) over columns [OFF, OFF + W),
// summed on the tensor cores into a fresh `part` (retired before the
// function returns) and added into acc on the CUDA cores.
template <int NC, int BN, int W, int OFF>
__device__ __forceinline__ void promoted_chunk(float (&acc)[BN / 2],
                                               const uint8_t* (&a)[WgmmaTile<NC, BN>::PROMOTE],
                                               const uint8_t* (&b)[WgmmaTile<NC, BN>::PROMOTE],
                                               int n) {
  using T = WgmmaTile<NC, BN>;
  static_assert(OFF % T::BW == 0, "columns start on a w box");
  float part[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) part[i] = 0.f;
  repro::wgmma_fence_operands(part);
  repro::wgmma_fence();
#pragma unroll
  for (int j = 0; j < T::PROMOTE; ++j)
    if (j < n) stage_wgmma<NC, BN, W>(part, a[j], b[j] + (OFF / T::BW) * T::B_BOX);
  repro::wgmma_commit();
  repro::wgmma_wait<0>();
  repro::wgmma_fence_operands(part);
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[OFF / 2 + i] += part[i];
}

// xmap: x [M, K] with boxes [a_rows, 64]; wmap: w [K, N] with boxes [64, BW].
// a_rows is BM, or M rounded up to 8 when M < BM (the tile's lower rows are
// then zeroed once and never loaded).
// One consumer warpgroup: two blocks an SM where shared memory allows (the
// decode tiles); two: one block, its registers moved to the consumers.
template <int NC, int BN, typename OutT>
__global__ void __launch_bounds__(WgmmaTile<NC, BN>::THREADS, NC == 1 ? 2 : 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, OutT* __restrict__ out, int M,
                  int N, int K, int a_rows) {
  using T = WgmmaTile<NC, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (repro::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* a_ring = smem;                                  // [STAGES][A_BYTES]
  uint8_t* b_ring = smem + T::STAGES * T::A_BYTES;         // [STAGES][B_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_ring + T::STAGES * T::B_BYTES);
  uint64_t* empty = full + T::STAGES;

  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * BN;
  const int nk = (K + T::BK - 1) / T::BK;

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      repro::mbar_init(&full[s], 1);          // the producer's arrival, plus the bytes
      repro::mbar_init(&empty[s], NC * 4);    // one arrival a consumer warp
    }
    repro::mbar_fence_init();
  }
  if (a_rows < T::BM && wg < NC) {
    for (int i = tid; i < T::STAGES * T::A_BYTES / 16; i += NC * 128)
      reinterpret_cast<uint4*>(a_ring)[i] = make_uint4(0u, 0u, 0u, 0u);
    repro::fence_proxy_async();
  }
  __syncthreads();

  if (wg == NC) {
    // producer warpgroup: one thread issues every load
    if (NC > 1) repro::setmaxnreg_dec<40>();
    if (tid == NC * 128) {
      const uint32_t bytes = a_rows * T::BK * 2 + T::B_BYTES;
      int s = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < nk; ++kt) {
        repro::mbar_wait(&empty[s], phase ^ 1);   // round 0 passes: the ring starts empty
        repro::mbar_arrive_expect_tx(&full[s], bytes);
        const int k0 = kt * T::BK;
        repro::tma_load_2d(a_ring + s * T::A_BYTES, &xmap, &full[s], k0, m0);
#pragma unroll
        for (int j = 0; j < T::NBOX; ++j)
          repro::tma_load_2d(b_ring + s * T::B_BYTES + j * T::B_BOX, &wmap, &full[s],
                             n0 + j * T::BW, k0);
        if (++s == T::STAGES) { s = 0; phase ^= 1; }
      }
    }
  } else {
    // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the tile
    if (NC > 1) repro::setmaxnreg_inc<232>();
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int lane = tid & 31;
    int s = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < nk; kt += T::PROMOTE) {
      // PROMOTE stages (fewer at the end of K) summed on the tensor cores, at
      // most 128 columns at a time to stay within the registers, added into
      // acc, then given back to the producer
      const int n = nk - kt < T::PROMOTE ? nk - kt : T::PROMOTE;
      const uint8_t* a[T::PROMOTE];
      const uint8_t* b[T::PROMOTE];
      int held[T::PROMOTE];
#pragma unroll
      for (int j = 0; j < T::PROMOTE; ++j) {
        held[j] = s;
        a[j] = a_ring + s * T::A_BYTES + wg * 64 * 128;
        b[j] = b_ring + s * T::B_BYTES;
        if (j < n) {
          repro::mbar_wait(&full[s], phase);
          if (++s == T::STAGES) { s = 0; phase ^= 1; }
        }
      }
      promoted_chunk<NC, BN, (BN > 128 ? 128 : BN), 0>(acc, a, b, n);
      if constexpr (BN > 128) promoted_chunk<NC, BN, BN - 128, 128>(acc, a, b, n);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < T::PROMOTE; ++j)
          if (j < n) repro::mbar_arrive(&empty[held[j]]);
      }
    }

    const int warp = (tid & 127) >> 5;
    const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + h * 8;
        if (r >= M || c >= N) continue;
        OutT* p = out + static_cast<int64_t>(r) * N + c;
        if (c + 1 < N) {
          store_pair<OutT>(p, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          *p = repro::from_f32<OutT>(acc[4 * j + 2 * h]);
        }
      }
    }
  }
}

template <int NC, int BN, typename OutT>
cudaError_t launch_wgmma(const void* x, const void* w, void* out, int m, int n, int k,
                         cudaStream_t s) {
  using T = WgmmaTile<NC, BN>;
  const dim3 grid((m + T::BM - 1) / T::BM, (n + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int a_rows = m >= T::BM ? T::BM : (m + 7) / 8 * 8;
  CUtensorMap xmap, wmap;
  if (!repro::encode_tma_2d_bf16(&xmap, x, k, m, static_cast<uint64_t>(k) * 2, T::BK, a_rows,
                                 128) ||
      !repro::encode_tma_2d_bf16(&wmap, w, n, k, static_cast<uint64_t>(n) * 2, T::BW, T::BK,
                                 T::SWIZZLE))
    return cudaErrorInvalidValue;
  auto* kernel = gemm_wgmma_kernel<NC, BN, OutT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, T::THREADS, T::SMEM, s>>>(xmap, wmap, static_cast<OutT*>(out), m, n, k, a_rows);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int WM, int WN, int WK, typename OutT>
cudaError_t launch_bf16(const void* x, const void* w, void* out, int m, int n, int k,
                        cudaStream_t s) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  auto* op = static_cast<OutT*>(out);
  const bool vec = k % 8 == 0 && n % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec) {
    gemm_bf16_kernel<BM, BN, BK, WM, WN, WK, true, OutT><<<grid, kThreads, 0, s>>>(xp, wp, op, m, n, k);
  } else {
    gemm_bf16_kernel<BM, BN, BK, WM, WN, WK, false, OutT><<<grid, kThreads, 0, s>>>(xp, wp, op, m, n, k);
  }
  return cudaGetLastError();
}

// route codes shared with kernels/matmul.py (ROUTES)
enum Route : int { kFfma = 0, kMmaSync = 1, kWgmma = 2 };

template <typename OutT>
cudaError_t launch(int dtype, const void* x, const void* w, void* out, int m, int n, int k,
                   int route, int bm, int bn, cudaStream_t s) {
  if (route == kFfma) {
    if (dtype != repro::kF32 || bm != 64 || bn != 64) return cudaErrorInvalidValue;
    const dim3 grid((m + 63) / 64, (n + 63) / 64);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gemm_f32_kernel<OutT><<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<OutT*>(out), m,
        n, k);
    return cudaGetLastError();
  }
  if (dtype != repro::kBF16) return cudaErrorInvalidValue;
  if (route == kMmaSync) {
    if (bm == 16 && bn == 32) return launch_bf16<16, 32, 64, 1, 1, 4, OutT>(x, w, out, m, n, k, s);
    if (bm == 64 && bn == 64) return launch_bf16<64, 64, 32, 2, 2, 1, OutT>(x, w, out, m, n, k, s);
    return cudaErrorInvalidValue;
  }
  if (route != kWgmma || k <= 0 || k % 8 || n % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  if (bm == 64) {
    if (bn == 16) return launch_wgmma<1, 16, OutT>(x, w, out, m, n, k, s);
    if (bn == 32) return launch_wgmma<1, 32, OutT>(x, w, out, m, n, k, s);
    if (bn == 64) return launch_wgmma<1, 64, OutT>(x, w, out, m, n, k, s);
  } else if (bm == 128) {
    if (bn == 64) return launch_wgmma<2, 64, OutT>(x, w, out, m, n, k, s);
    if (bn == 128) return launch_wgmma<2, 128, OutT>(x, w, out, m, n, k, s);
    if (bn == 192) return launch_wgmma<2, 192, OutT>(x, w, out, m, n, k, s);
    if (bn == 256) return launch_wgmma<2, 256, OutT>(x, w, out, m, n, k, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x [m, k] and w [k, n] of element type `dtype`; out [m, n] of `out_dtype`;
// `route` (Route) and the block tile bm x bn as kernels/matmul.py:plan
// chose them.  A route or tile that does not fit the call is an
// invalid-value error, never another kernel.
extern "C" int repro_matmul(int dtype, int out_dtype, const void* x, const void* w, void* out,
                            int m, int n, int k, int route, int bm, int bn, void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  REPRO_DISPATCH_DTYPE(out_dtype, OutT,
                       return launch<OutT>(dtype, x, w, out, m, n, k, route, bm, bn, s));
  return cudaErrorInvalidValue;
}
