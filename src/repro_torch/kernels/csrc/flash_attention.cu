// Flash attention for training: forward (writes the log-sum-exp) and the
// deterministic backward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :109), which has no backward of its own:
// the JAX package differentiates its oracle (kernels/ref.py).  Here the
// backward is a kernel too, so training never builds score blocks in device
// memory.
//
// Layouts are the model's, used as they are: q [B, Sq, H, D]; k, v
// [B, Sk, KvH, D]; GQA by kv head h / (H / KvH); lse and the backward's
// row sums D are [B, H, Sq] f32.  Ragged tiles (S not a multiple of 64) are
// masked in the kernel; the host does no transpose or padding.  Masking
// follows the TPU kernel: NEG_INF = -1e30 (not -inf), causal kpos <= qpos,
// window kpos > qpos - window, l floored at 1e-30, and tiles wholly above
// the diagonal or wholly outside the window are skipped.
//
// The forward also takes an optional per-sequence key bound lens [B] int32
// (NULL: none), the ragged prefill of the dense-slab serving path: keys at
// kpos >= lens[b] are masked and key tiles wholly past the bound are not
// read.  The JAX package runs its plain version there, even on the TPU
// (src/repro/kernels/ops.py:96-106).  Serving never differentiates this
// path, so the bound has no backward.
//
// Tiling.  Every kernel works on 64 x 64 tiles with 256 threads; thread
// (ty, tx), ty = warp * 2 + lane / 16 and tx = lane % 16, owns the tile rows
// ty + 16 i (i < 4) and, of a score tile, the columns tx + 16 j (j < 4); of
// a [64, D] output tile the columns tx * D/16 + j.  The 16 threads of a row
// are one half-warp, so row max and row sum are four shuffles.  Tiles sit
// in shared memory as f32 rows padded to D + 4 floats: a float4 read along
// d by 8 neighbouring threads of a quarter-warp then touches all 32 banks
// once.  Products run on the CUDA cores in f32 (the plain version's
// arithmetic, and the only route for the fp32 parity runs); tensor cores
// (wgmma on bf16 tiles) are later work.
//
// Backward without atomics: one preprocessing kernel computes D =
// rowsum(do * o); one block per (key tile, kv head, batch) loops over the
// query heads of its kv head and the query tiles that can see its keys and
// keeps dK and dV in registers (so GQA's sum over the group happens inside
// the block, in a fixed order); one block per (query tile, head, batch)
// loops over the key tiles and keeps dQ in registers.  Both recompute p =
// exp(s - lse).  Every sum has a fixed order, so two runs on the same
// inputs give the same bits.
//
// Bound on the H100: operations (4 S^2 D H B / 2 FLOPs forward with the
// causal mask, 2.5x that backward) once S is a few hundred; these f32
// CUDA-core products reach a fraction of the card's 67 TFLOP/s f32 rate.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // query rows and keys per tile
constexpr int kSP = kTile + 4;        // row stride of a [64, 64] score tile
constexpr float kNegInf = -1e30f;

struct Geometry {
  int B, Sq, Sk, H, KvH, causal, window;
  float scale;
};

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float at(float4 v, int u) {
  return u == 0 ? v.x : (u == 1 ? v.y : (u == 2 ? v.z : v.w));
}

// Stage rows [r0, r0 + 64) of head `head` of a [B, S, heads, D] tensor into
// a [64, D + 4] f32 tile; rows past S read as zeros.
template <typename T, int D>
__device__ void load_tile(float* __restrict__ tile, const T* __restrict__ src, int b, int r0,
                          int S, int heads, int head) {
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D, row = r0 + r;
    float val = 0.f;
    if (row < S) val = repro::to_f32(src[((static_cast<int64_t>(b) * S + row) * heads + head) * D + d]);
    tile[r * LD + d] = val;
  }
}

// Stage 64 entries of a [B, H, S] f32 row statistic; past S reads as zero.
__device__ void load_stat(float* __restrict__ dst, const float* __restrict__ src, int64_t base,
                          int r0, int S) {
  if (threadIdx.x < kTile) {
    const int row = r0 + threadIdx.x;
    dst[threadIdx.x] = row < S ? src[base + row] : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sk, const Geometry& g) {
  return kpos < Sk && (!g.causal || kpos <= qpos) && (g.window <= 0 || kpos > qpos - g.window);
}

// acc[i][j] += sum_d a[(ty + 16 i)][d] * b[(tx + 16 j)][d] over two [64, D+4]
// tiles: the score-shaped product of two row-major tiles.
template <int D>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[4][4], const float* __restrict__ a,
                                              const float* __restrict__ b, int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += dot4(av[i], bv[j]);
  }
}

// acc[i][c] += sum_k p[(ty + 16 i)][k] * m[k][tx * D/16 + c]: a [64, 64]
// score tile (row stride kSP) times a [64, D+4] tile.
template <int D>
__device__ __forceinline__ void scores_times_tile(float (&acc)[4][D / 16], const float* __restrict__ p,
                                                  const float* __restrict__ m, int ty, int tx) {
  constexpr int LD = D + 4;
  constexpr int DPT = D / 16;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kSP + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float mv[DPT];
      const float* row = m + (k + u) * LD + tx * DPT;
      if constexpr (DPT % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DPT; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(row + c);
          mv[c] = t.x; mv[c + 1] = t.y; mv[c + 2] = t.z; mv[c + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < DPT; ++c) mv[c] = row[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pu = at(pv[i], u);
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] += pu * mv[c];
      }
    }
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// forward: grid (query tiles, H, B)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ lens, T* __restrict__ o, float* __restrict__ lse,
                 Geometry g) {
  constexpr int LD = D + 4;
  constexpr int DPT = D / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LD;

  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (g.H / g.KvH);
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, tx = lane & 15, ty = (threadIdx.x >> 5) * 2 + (lane >> 4);

  load_tile<T, D>(q_s, q, b, q0, g.Sq, g.H, h);

  // the keys any row of this tile can see; keys past the sequence's bound
  // are invisible to every row
  const int sk = lens != nullptr ? max(0, min(g.Sk, lens[b])) : g.Sk;
  const int k_end = g.causal ? min(sk, q0 + kTile) : sk;
  const int k_begin = g.window > 0 ? max(0, q0 - g.window + 1) : 0;

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_begin / kTile) * kTile; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's reads (and the q staging) are done
    load_tile<T, D>(k_s, k, b, k0, g.Sk, g.KvH, kvh);
    load_tile<T, D>(v_s, v, b, k0, g.Sk, g.KvH, kvh);
    __syncthreads();

    float s[4][4] = {};
    rows_dot_rows<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(qpos, k0 + tx + 16 * j, sk, g) ? s[i][j] * g.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * kSP + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(sum);
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncwarp();  // a row of p is written and read by one half-warp
    scores_times_tile<D>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.Sq) continue;
    const float lf = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * g.Sq + row) * g.H + h) * D + tx * DPT;
#pragma unroll
    for (int c = 0; c < DPT; ++c) orow[c] = repro::from_f32<T>(acc[i][c] / lf);
    if (tx == 0) lse[(static_cast<int64_t>(b) * g.H + h) * g.Sq + row] = m[i] + logf(lf);
  }
}

// ---------------------------------------------------------------------------
// backward 1: D = rowsum(do * o), one warp per (b, s, h) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int S, int H, int D) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32)
    sum += repro::to_f32(o[row * D + d]) * repro::to_f32(dout[row * D + d]);
  sum = repro::warp_sum(sum);
  if (lane == 0) {
    // row = (b * S + s) * H + h  ->  [B, H, S]
    const int h = static_cast<int>(row % H);
    const int64_t bs = row / H;
    const int s = static_cast<int>(bs % S);
    const int64_t b = bs / S;
    delta[(b * H + h) * S + s] = sum;
  }
}

// ---------------------------------------------------------------------------
// backward 2: dK, dV; grid (key tiles, KvH, B)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      Geometry g) {
  constexpr int LD = D + 4;
  constexpr int DPT = D / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* p_s = do_s + kTile * LD;     // [key][query]
  float* ds_s = p_s + kTile * kSP;    // [key][query]
  float* lse_s = ds_s + kTile * kSP;
  float* dl_s = lse_s + kTile;

  const int kvh = blockIdx.y, b = blockIdx.z, G = g.H / g.KvH;
  const int k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, tx = lane & 15, ty = (threadIdx.x >> 5) * 2 + (lane >> 4);

  load_tile<T, D>(k_s, k, b, k0, g.Sk, g.KvH, kvh);
  load_tile<T, D>(v_s, v, b, k0, g.Sk, g.KvH, kvh);

  // the query rows that can see a key of this tile
  const int q_begin = g.causal ? k0 : 0;
  const int q_end = g.window > 0 ? min(g.Sq, k0 + kTile - 1 + g.window) : g.Sq;

  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    const int64_t stat = (static_cast<int64_t>(b) * g.H + h) * g.Sq;
    for (int q0 = (q_begin / kTile) * kTile; q0 < q_end; q0 += kTile) {
      __syncthreads();  // the previous tile's reads (and the k/v staging) are done
      load_tile<T, D>(q_s, q, b, q0, g.Sq, g.H, h);
      load_tile<T, D>(do_s, dout, b, q0, g.Sq, g.H, h);
      load_stat(lse_s, lse, stat, q0, g.Sq);
      load_stat(dl_s, delta, stat, q0, g.Sq);
      __syncthreads();

      float s[4][4] = {}, dp[4][4] = {};
      rows_dot_rows<D>(s, k_s, q_s, ty, tx);     // s^T: rows keys, cols queries
      rows_dot_rows<D>(dp, v_s, do_s, ty, tx);   // dp^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qq = tx + 16 * j, qpos = q0 + qq;
          const float p = (qpos < g.Sq && visible(qpos, kpos, g.Sk, g))
                              ? expf(s[i][j] * g.scale - lse_s[qq]) : 0.f;
          p_s[(ty + 16 * i) * kSP + qq] = p;
          ds_s[(ty + 16 * i) * kSP + qq] = p * (dp[i][j] - dl_s[qq]);
        }
      }
      __syncwarp();
      scores_times_tile<D>(dv_acc, p_s, do_s, ty, tx);
      scores_times_tile<D>(dk_acc, ds_s, q_s, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= g.Sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * g.Sk + row) * g.KvH + kvh) * D + tx * DPT;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dk[off + c] = repro::from_f32<T>(dk_acc[i][c] * g.scale);
      dv[off + c] = repro::from_f32<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3: dQ; grid (query tiles, H, B)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Geometry g) {
  constexpr int LD = D + 4;
  constexpr int DPT = D / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;     // [query][key]
  float* lse_s = ds_s + kTile * kSP;
  float* dl_s = lse_s + kTile;

  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (g.H / g.KvH);
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, tx = lane & 15, ty = (threadIdx.x >> 5) * 2 + (lane >> 4);
  const int64_t stat = (static_cast<int64_t>(b) * g.H + h) * g.Sq;

  load_tile<T, D>(q_s, q, b, q0, g.Sq, g.H, h);
  load_tile<T, D>(do_s, dout, b, q0, g.Sq, g.H, h);
  load_stat(lse_s, lse, stat, q0, g.Sq);
  load_stat(dl_s, delta, stat, q0, g.Sq);

  const int k_end = g.causal ? min(g.Sk, q0 + kTile) : g.Sk;
  const int k_begin = g.window > 0 ? max(0, q0 - g.window + 1) : 0;

  float dq_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dq_acc[i][c] = 0.f;

  for (int k0 = (k_begin / kTile) * kTile; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(k_s, k, b, k0, g.Sk, g.KvH, kvh);
    load_tile<T, D>(v_s, v, b, k0, g.Sk, g.KvH, kvh);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    rows_dot_rows<D>(s, q_s, k_s, ty, tx);
    rows_dot_rows<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qq = ty + 16 * i, qpos = q0 + qq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (qpos < g.Sq && visible(qpos, k0 + tx + 16 * j, g.Sk, g))
                            ? expf(s[i][j] * g.scale - lse_s[qq]) : 0.f;
        ds_s[qq * kSP + tx + 16 * j] = p * (dp[i][j] - dl_s[qq]);
      }
    }
    __syncwarp();
    scores_times_tile<D>(dq_acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= g.Sq) continue;
    T* drow = dq + ((static_cast<int64_t>(b) * g.Sq + row) * g.H + h) * D + tx * DPT;
#pragma unroll
    for (int c = 0; c < DPT; ++c) drow[c] = repro::from_f32<T>(dq_acc[i][c] * g.scale);
  }
}

// dynamic shared memory of each kernel, in bytes
template <int D> constexpr size_t fwd_smem() { return sizeof(float) * (3 * kTile * (D + 4) + kTile * kSP); }
template <int D> constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * kTile * (D + 4) + 2 * kTile * kSP + 2 * kTile);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 4) + kTile * kSP + 2 * kTile);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, const int* lens, void* o, float* lse,
                const Geometry& g, cudaStream_t s) {
  auto kern = flash_fwd_kernel<T, D>;
  if (cudaError_t e = allow_smem(kern, fwd_smem<D>())) return e;
  const dim3 grid((g.Sq + kTile - 1) / kTile, g.H, g.B);
  kern<<<grid, kThreads, fwd_smem<D>(), s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                             static_cast<const T*>(v), lens, static_cast<T*>(o),
                                             lse, g);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
                const void* dout, float* delta, void* dq, void* dk, void* dv, const Geometry& g,
                cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(g.B) * g.Sq * g.H;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned int>((rows + 7) / 8), kThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, g.Sq, g.H, D);
  if (cudaError_t e = cudaGetLastError()) return e;

  auto kdkdv = flash_bwd_dkdv_kernel<T, D>;
  if (cudaError_t e = allow_smem(kdkdv, dkdv_smem<D>())) return e;
  const dim3 grid_kv((g.Sk + kTile - 1) / kTile, g.KvH, g.B);
  kdkdv<<<grid_kv, kThreads, dkdv_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), g);
  if (cudaError_t e = cudaGetLastError()) return e;

  auto kdq = flash_bwd_dq_kernel<T, D>;
  if (cudaError_t e = allow_smem(kdq, dq_smem<D>())) return e;
  const dim3 grid_q((g.Sq + kTile - 1) / kTile, g.H, g.B);
  kdq<<<grid_q, kThreads, dq_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), g);
  return cudaGetLastError();
}

Geometry make_geometry(int B, int Sq, int Sk, int H, int KvH, int D, int causal, int window) {
  return Geometry{B, Sq, Sk, H, KvH, causal, window, 1.0f / sqrtf(static_cast<float>(D))};
}

}  // namespace

#define REPRO_FLASH_DIMS(DIM_CASE) DIM_CASE(16) DIM_CASE(64) DIM_CASE(112) DIM_CASE(128)

// q [B, Sq, H, D]; k, v [B, Sk, KvH, D] -> o [B, Sq, H, D], lse [B, H, Sq]
// f32.  window <= 0 means no window; lens [B] int32 bounds each sequence's
// keys (NULL: all Sk).
extern "C" int repro_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                               const int* lens, void* o, float* lse, int B, int Sq, int Sk,
                               int H, int KvH, int D, int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaSuccess;
  if (KvH <= 0 || H % KvH) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = make_geometry(B, Sq, Sk, H, KvH, D, causal, window);
#define REPRO_FWD_CASE(DIM) \
  case DIM: return fwd<T, DIM>(q, k, v, lens, o, lse, g, s);
  REPRO_DISPATCH_DTYPE(dtype, T,
    switch (D) {
      REPRO_FLASH_DIMS(REPRO_FWD_CASE)
      default: return cudaErrorInvalidValue;
    });
#undef REPRO_FWD_CASE
  return cudaSuccess;
}

// The backward of repro_flash_fwd: dq like q, dk and dv like k; delta is
// [B, H, Sq] f32 scratch (it ends holding rowsum(do * o)).
extern "C" int repro_flash_bwd(int dtype, const void* q, const void* k, const void* v,
                               const void* o, const float* lse, const void* dout, float* delta,
                               void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                               int KvH, int D, int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return cudaSuccess;
  if (KvH <= 0 || H % KvH) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = make_geometry(B, Sq, Sk, H, KvH, D, causal, window);
#define REPRO_BWD_CASE(DIM) \
  case DIM: return bwd<T, DIM>(q, k, v, o, lse, dout, delta, dq, dk, dv, g, s);
  REPRO_DISPATCH_DTYPE(dtype, T,
    switch (D) {
      REPRO_FLASH_DIMS(REPRO_BWD_CASE)
      default: return cudaErrorInvalidValue;
    });
#undef REPRO_BWD_CASE
  return cudaSuccess;
}
