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
// path, so the bound has no backward.  A sequence whose bound is 0 reads no
// key tile, and its rows come out o = 0, lse = -1e30 in both forms (the
// plain version and the JAX oracle count its masked keys at p = 1, the
// mean of v; the dense-slab prefill bounds a prompt by its length, >= 1).
//
// Two forms, chosen by the element type.
//
// bf16 (the training and serving path) runs on the tensor cores, FA2-style
// on mma.sync m16n8k16 (bf16 operands, f32 accumulation).  A warp owns 16
// rows: the forward's block holds a 128-row query tile in 8 warps (64 rows
// in 4 warps at head dims 112 and 128, whose output fragments take 56-64
// registers a thread).  64-key K/V tiles stream through a cp.async ring
// (3 stages at D <= 64, else 2) of bf16 rows padded to D + 8 elements, an
// odd number of 16-byte chunks, so ldmatrix reads them free of bank
// conflicts.  Q's fragments are loaded once a block (ldmatrix); S = Q K^T
// takes K through ldmatrix; scale, mask and the online-softmax update run
// in f32 registers, row max and sum over the four threads of a quad.  l
// sums the f32 p; only the copy that feeds P V is rounded to bf16, and the
// score accumulator is repacked in registers as P V's A operand, so P
// never touches shared memory; V goes through ldmatrix.trans.  Every
// bf16 kernel's shared memory leaves room for two blocks an SM (forward
// 72-85 KiB at D 64-128, checked at compile time by two_per_sm).
//
// f32 (the fp32 parity runs) keeps the first version on the CUDA cores, the
// plain version's arithmetic: 64 x 64 tiles with 256 threads; thread
// (ty, tx), ty = warp * 2 + lane / 16 and tx = lane % 16, owns the tile rows
// ty + 16 i (i < 4) and, of a score tile, the columns tx + 16 j (j < 4); of
// a [64, D] output tile the columns tx * D/16 + j.  The 16 threads of a row
// are one half-warp, so row max and row sum are four shuffles.  Tiles sit
// in shared memory as f32 rows padded to D + 4 floats: a float4 read along
// d by 8 neighbouring threads of a quarter-warp then touches all 32 banks
// once.
//
// Backward without atomics, in both forms: one preprocessing kernel
// computes D = rowsum(do * o); one block per (key tile, kv head, batch)
// loops over the query heads of its kv head and the query tiles that can
// see its keys and keeps dK and dV in registers (so GQA's sum over the
// group happens inside the block, in a fixed order); one block per (query
// tile, head, batch) loops over the key tiles and keeps dQ in registers.
// Both recompute p = exp(s - lse).  Every sum has a fixed order, so two runs
// on the same inputs give the same bits.  In bf16 the dK/dV block (4 warps,
// 16 keys each) keeps K and V in shared memory and streams Q, dO, lse and
// D tiles (64 queries, 32 at D >= 112) through a cp.async ring; S^T = K Q^T
// and dP^T = V dO^T, dV += P^T dO and dK += dS^T Q run on mma.sync, p and
// ds = p (dp - D) in f32.  P and dS go in as bf16 hi + lo pairs (two MMAs
// each; see acc_to_a_split): one rounding put dV and dK outside the flash
// tolerances.  The dQ block (4 warps, 16 queries each) streams K and V
// tiles the same way: S, dP and dQ += dS K (hi + lo) on mma.sync.
//
// Bound on the H100: operations (4 S^2 D H B / 2 FLOPs forward with the
// causal mask, 2.5x that backward) once S is a few hundred: 989 TFLOP/s on
// bf16 tensor cores.  mma.sync from registers reaches a fraction of that;
// wgmma with TMA and warp specialisation are the next step.
#include <initializer_list>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (mma.sync m16n8k16 bf16 -> f32, ldmatrix,
// cp.async rings)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;

// Tiles sit in shared memory as bf16 rows of D + 8 elements: D / 8 + 1
// 16-byte chunks, an odd count at every head dim here, so the eight row
// addresses of an ldmatrix 8 x 8 matrix fall in eight different 16-byte
// bank groups and the reads are free of conflicts.
template <int D> __host__ __device__ constexpr int bf_lds() {
  static_assert((D / 8 + 1) % 2 == 1 && D % 16 == 0, "head dim");
  return D + 8;
}

// Forward plan: 16 query rows a warp; a 128-row tile (8 warps) where the
// registers allow two blocks an SM, a 64-row tile (4 warps) at head dims
// 112 and 128, whose output fragments take 56-64 registers a thread.
template <int D> struct FwdPlan {
  static constexpr int kWarps = D <= 64 ? 8 : 4;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kStages = D <= 64 ? 3 : 2;     // K/V ring depth
  static constexpr size_t kSmem = sizeof(bf16) * bf_lds<D>() * (kRows + kStages * 2 * kTile);
};

// Backward plan: 4 warps of 16 rows, 64 keys (dK/dV) or 64 queries (dQ) a
// block; the dK/dV kernel streams query tiles of kQTile rows (32 at head
// dims 112 and 128, where dK and dV take 112-128 accumulator registers).
template <int D> struct BwdPlan {
  static constexpr int kWarps = 4;
  static constexpr int kQTile = D <= 64 ? 64 : 32;
  static constexpr int kStages = 2;
  // one ring stage of the dK/dV kernel: Q, dO [kQTile, D + 8], lse, delta
  static constexpr size_t kStageBytes = sizeof(bf16) * 2 * kQTile * bf_lds<D>() +
                                        sizeof(float) * 2 * kQTile;
  static constexpr size_t kDkdvSmem = sizeof(bf16) * 2 * kTile * bf_lds<D>() + kStages * kStageBytes;
  static constexpr size_t kDqSmem = sizeof(bf16) * bf_lds<D>() * (2 * kTile + kStages * 2 * kTile);
};

// two blocks an SM: 228 KB of shared memory, 1 KB of it reserved a block
template <size_t Bytes> constexpr bool two_per_sm() { return 2 * (Bytes + 1024) <= 228 * 1024; }

// Rows [r0, r0 + ROWS) of head `head` of a [B, S, heads, D] bf16 tensor into
// a [ROWS, D + 8] shared tile, 16 bytes a cp.async, by all NT threads of the
// block; rows past S are zero-filled.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void cp_rows(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                        int b, int r0, int S, int heads, int head) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR, row = r0 + r;
    const bool ok = row < S;
    const int64_t off = ok ? ((static_cast<int64_t>(b) * S + row) * heads + head) * D + c * 8 : 0;
    repro::cp_async16(dst + r * bf_lds<D>() + c * 8, src + off, ok);
  }
}

// N entries [r0, r0 + N) of one (b, h) row `src` of a [B, H, S] f32
// statistic into shared memory; past S zero-filled
template <int N>
__device__ __forceinline__ void cp_stat(float* __restrict__ dst, const float* __restrict__ src,
                                        int r0, int S) {
  if (threadIdx.x < N) {
    const int row = r0 + threadIdx.x;
    repro::cp_async4(dst + threadIdx.x, src + (row < S ? row : 0), row < S);
  }
}

// the fragment loaders of csrc/common.cuh (A, and B stored as [n][k] or
// [k][n])
using repro::frag_a;
using repro::frag_b;
using repro::frag_bt;
using repro::quad_max;
using repro::quad_sum;

// A [16, 16] A operand from two f32 accumulator tiles (columns 8 j.. and
// 8 j + 8..): the accumulator layout of m16n8 is the A layout of m16k16, so
// a score tile feeds the next product without leaving registers.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = repro::pack_f32_bf16(lo[0], lo[1]);
  a[1] = repro::pack_f32_bf16(lo[2], lo[3]);
  a[2] = repro::pack_f32_bf16(hi[0], hi[1]);
  a[3] = repro::pack_f32_bf16(hi[2], hi[3]);
}

// The same operand carried as a bf16 pair, hi = bf16(x) and lo = bf16(x -
// hi), for two MMAs: x to ~2^-17 relative where hi alone carries 2^-9.  The
// backward's p and ds go in so: in rows that see few keys p ~ 1 and ds
// reaches |25|, and one rounding of either put dV or dK 0.031 off the plain
// version's f32 sums, outside the flash tolerances (chip_smoke.py phase 6,
// window 512); the forward's P V takes p rounded once and holds them.
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&a)[4], const float (&b)[4]) {
  const float x[8] = {a[0], a[1], a[2], a[3], b[0], b[1], b[2], b[3]};
  repro::split_bf16(hi, lo, x);
}

// The tile count of a key (or query) range [begin, end) walked in tiles of
// T from the tile holding `begin`.
template <int T>
__device__ __forceinline__ int tiles_from(int begin_aligned, int end) {
  return end > begin_aligned ? (end - begin_aligned + T - 1) / T : 0;
}

// ---------------------------------------------------------------------------
// bf16 forward: grid (query tiles, H, B), causal tiles heaviest first
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(FwdPlan<D>::kWarps * 32, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ lens,
                      bf16* __restrict__ o, float* __restrict__ lse, Geometry g) {
  using P = FwdPlan<D>;
  constexpr int NT = P::kWarps * 32, R = P::kRows, LDS = bf_lds<D>(), ST = P::kStages;
  constexpr int KS = D / 16, DT = D / 8, NK = kTile / 8;
  extern __shared__ uint4 fa_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(fa_smem);
  bf16* ring = q_s + R * LDS;          // stage s: a K tile, then a V tile

  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (g.H / g.KvH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;    // fragment row and column pair
  const int rw = q0 + warp * 16;              // the warp's first row

  // the keys any row of this tile can see (as the f32 kernel)
  const int sk = lens != nullptr ? max(0, min(g.Sk, lens[b])) : g.Sk;
  const int k_end = g.causal ? min(sk, q0 + R) : sk;
  const int k_begin = g.window > 0 ? max(0, q0 - g.window + 1) : 0;
  const int kt0 = k_begin / kTile * kTile;
  const int n_tiles = tiles_from<kTile>(kt0, k_end);

  auto load_kv = [&](int j) {
    bf16* dst = ring + (j % ST) * 2 * kTile * LDS;
    cp_rows<D, kTile, NT>(dst, k, b, kt0 + j * kTile, g.Sk, g.KvH, kvh);
    cp_rows<D, kTile, NT>(dst + kTile * LDS, v, b, kt0 + j * kTile, g.Sk, g.KvH, kvh);
  };
  if (n_tiles > 0) {
    cp_rows<D, R, NT>(q_s, q, b, q0, g.Sq, g.H, h);
    load_kv(0);
    repro::cp_async_commit();
#pragma unroll
    for (int j = 1; j < ST - 1; ++j) {
      if (j < n_tiles) load_kv(j);
      repro::cp_async_commit();
    }
  }

  uint32_t qa[KS][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's partial sums
  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    repro::cp_async_wait<ST - 2>();
    __syncthreads();   // tile j has landed, and every warp is done with tile j - 1's slot
    if (j + ST - 1 < n_tiles) load_kv(j + ST - 1);
    repro::cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) frag_a<LDS>(qa[kk], q_s, warp * 16, kk * 16, lane);
    }
    const int k0 = kt0 + j * kTile;
    const bf16* k_t = ring + (j % ST) * 2 * kTile * LDS;
    const bf16* v_t = k_t + kTile * LDS;
    // A tile that no row of the warp can see is skipped: in a row that has
    // seen no key yet its keys would count at p = 1, and the row's first
    // visible key multiplies that by exp(-1e30 - m) = 0.
    if ((g.causal && k0 > rw + 15) || (g.window > 0 && k0 + kTile - 1 <= rw - g.window)) continue;

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kb[4];
        frag_bt<LDS>(kb, k_t, n * 8, kk * 16, lane);
        repro::mma_bf16(s[n], qa[kk], kb[0], kb[1]);
        repro::mma_bf16(s[n + 1], qa[kk], kb[2], kb[3]);
      }
    }
    // scale, and mask unless every (row, key) pair of the warp is visible
    const bool whole = k0 + kTile <= sk && (!g.causal || k0 + kTile - 1 <= rw) &&
                       (g.window <= 0 || k0 > rw + 15 - g.window);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = rw + gr + (e >> 1) * 8, kpos = k0 + n * 8 + 2 * tq + (e & 1);
        s[n][e] = whole || visible(qpos, kpos, sk, g) ? s[n][e] * g.scale : kNegInf;
      }
    // online softmax in f32: rows gr and gr + 8 of the warp's 16, each
    // spread over the four threads of a quad
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NK; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
    // p in f32 feeds l; its bf16 rounding feeds P V, repacked in registers
    uint32_t pa[kTile / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) acc_to_a(pa[ks], s[2 * ks], s[2 * ks + 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      acc[t][0] *= corr[0];
      acc[t][1] *= corr[0];
      acc[t][2] *= corr[1];
      acc[t][3] *= corr[1];
    }
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
#pragma unroll
      for (int t = 0; t < DT; t += 2) {
        uint32_t vb[4];
        frag_b<LDS>(vb, v_t, ks * 16, t * 8, lane);
        repro::mma_bf16(acc[t], pa[ks], vb[0], vb[1]);
        repro::mma_bf16(acc[t + 1], pa[ks], vb[2], vb[3]);
      }
    }
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lf = fmaxf(quad_sum(l[r]), 1e-30f);
    const int row = rw + gr + 8 * r;
    if (row >= g.Sq) continue;
    bf16* orow = o + ((static_cast<int64_t>(b) * g.Sq + row) * g.H + h) * D + 2 * tq;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<uint32_t*>(orow + t * 8) =
          repro::pack_f32_bf16(acc[t][2 * r] / lf, acc[t][2 * r + 1] / lf);
    if (tq == 0) lse[(static_cast<int64_t>(b) * g.H + h) * g.Sq + row] = m[r] + logf(lf);
  }
}

// ---------------------------------------------------------------------------
// bf16 backward 2: dK, dV; grid (key tiles, KvH, B)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(BwdPlan<D>::kWarps * 32, 2)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, Geometry g) {
  using P = BwdPlan<D>;
  constexpr int NT = P::kWarps * 32, LDS = bf_lds<D>(), BQ = P::kQTile, ST = P::kStages;
  constexpr int KS = D / 16, DT = D / 8, NQ = BQ / 8;
  extern __shared__ uint4 fa_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(fa_smem);
  bf16* v_s = k_s + kTile * LDS;
  char* ring = reinterpret_cast<char*>(v_s + kTile * LDS);   // stage: Q, dO, lse, delta

  const int kvh = blockIdx.y, b = blockIdx.z, G = g.H / g.KvH;
  const int k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int kw = k0 + warp * 16;              // the warp's first key

  // the query rows that can see a key of this tile (as the f32 kernel),
  // walked for each query head of the kv head in order
  const int q_begin = g.causal ? k0 : 0;
  const int q_end = g.window > 0 ? min(g.Sq, k0 + kTile - 1 + g.window) : g.Sq;
  const int qt0 = q_begin / BQ * BQ;
  const int n_qt = tiles_from<BQ>(qt0, q_end);
  const int n_it = G * n_qt;

  auto stage = [&](int it) { return ring + (it % ST) * P::kStageBytes; };
  auto load_q = [&](int it) {
    const int h = kvh * G + it / n_qt, q0 = qt0 + (it % n_qt) * BQ;
    bf16* qd = reinterpret_cast<bf16*>(stage(it));
    bf16* dd = qd + BQ * LDS;
    float* ls = reinterpret_cast<float*>(dd + BQ * LDS);
    const int64_t stat = (static_cast<int64_t>(b) * g.H + h) * g.Sq;
    cp_rows<D, BQ, NT>(qd, q, b, q0, g.Sq, g.H, h);
    cp_rows<D, BQ, NT>(dd, dout, b, q0, g.Sq, g.H, h);
    cp_stat<BQ>(ls, lse + stat, q0, g.Sq);
    cp_stat<BQ>(ls + BQ, delta + stat, q0, g.Sq);
  };
  if (n_it > 0) {
    cp_rows<D, kTile, NT>(k_s, k, b, k0, g.Sk, g.KvH, kvh);
    cp_rows<D, kTile, NT>(v_s, v, b, k0, g.Sk, g.KvH, kvh);
    load_q(0);
    repro::cp_async_commit();
#pragma unroll
    for (int j = 1; j < ST - 1; ++j) {
      if (j < n_it) load_q(j);
      repro::cp_async_commit();
    }
  }

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    repro::cp_async_wait<ST - 2>();
    __syncthreads();
    if (it + ST - 1 < n_it) load_q(it + ST - 1);
    repro::cp_async_commit();
    const int q0 = qt0 + (it % n_qt) * BQ;
    const bf16* q_t = reinterpret_cast<const bf16*>(stage(it));
    const bf16* do_t = q_t + BQ * LDS;
    const float* lse_t = reinterpret_cast<const float*>(do_t + BQ * LDS);
    const float* dl_t = lse_t + BQ;
    if (kw >= g.Sk || (g.causal && q0 + BQ - 1 < kw) ||
        (g.window > 0 && kw + 15 <= q0 - g.window))
      continue;                                   // no query here sees the warp's keys
    const bool whole = q0 + BQ <= g.Sq && kw + 15 < g.Sk && (!g.causal || kw + 15 <= q0) &&
                       (g.window <= 0 || kw > q0 + BQ - 1 - g.window);

    // S^T = K Q^T: rows the warp's 16 keys, columns the tile's queries
    float st[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4];
      frag_a<LDS>(ka, k_s, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t qb[4];
        frag_bt<LDS>(qb, q_t, n * 8, kk * 16, lane);
        repro::mma_bf16(st[n], ka, qb[0], qb[1]);
        repro::mma_bf16(st[n + 1], ka, qb[2], qb[3]);
      }
    }
    // P^T = exp(scale s - lse) in f32, 0 where masked
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kw + gr + (e >> 1) * 8, qq = n * 8 + 2 * tq + (e & 1), qpos = q0 + qq;
        st[n][e] = whole || (qpos < g.Sq && visible(qpos, kpos, g.Sk, g))
                       ? __expf(st[n][e] * g.scale - lse_t[qq]) : 0.f;
      }
    // dV += P^T dO, P as a hi + lo pair
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
      uint32_t pa[4], pl[4];
      acc_to_a_split(pa, pl, st[2 * ks], st[2 * ks + 1]);
#pragma unroll
      for (int t = 0; t < DT; t += 2) {
        uint32_t ob[4];
        frag_b<LDS>(ob, do_t, ks * 16, t * 8, lane);
        repro::mma_bf16(dva[t], pa, ob[0], ob[1]);
        repro::mma_bf16(dva[t + 1], pa, ob[2], ob[3]);
        repro::mma_bf16(dva[t], pl, ob[0], ob[1]);
        repro::mma_bf16(dva[t + 1], pl, ob[2], ob[3]);
      }
    }
    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) in f32
    float dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t va[4];
      frag_a<LDS>(va, v_s, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NQ; n += 2) {
        uint32_t ob[4];
        frag_bt<LDS>(ob, do_t, n * 8, kk * 16, lane);
        repro::mma_bf16(dpt[n], va, ob[0], ob[1]);
        repro::mma_bf16(dpt[n + 1], va, ob[2], ob[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[n][e] = st[n][e] * (dpt[n][e] - dl_t[n * 8 + 2 * tq + (e & 1)]);
    // dK += dS^T Q, dS as a hi + lo pair
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
      uint32_t dh[4], dl[4];
      acc_to_a_split(dh, dl, dpt[2 * ks], dpt[2 * ks + 1]);
#pragma unroll
      for (int t = 0; t < DT; t += 2) {
        uint32_t qb[4];
        frag_b<LDS>(qb, q_t, ks * 16, t * 8, lane);
        repro::mma_bf16(dka[t], dh, qb[0], qb[1]);
        repro::mma_bf16(dka[t + 1], dh, qb[2], qb[3]);
        repro::mma_bf16(dka[t], dl, qb[0], qb[1]);
        repro::mma_bf16(dka[t + 1], dl, qb[2], qb[3]);
      }
    }
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kw + gr + 8 * r;
    if (row >= g.Sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * g.Sk + row) * g.KvH + kvh) * D + 2 * tq;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      *reinterpret_cast<uint32_t*>(dk + off + t * 8) =
          repro::pack_f32_bf16(dka[t][2 * r] * g.scale, dka[t][2 * r + 1] * g.scale);
      *reinterpret_cast<uint32_t*>(dv + off + t * 8) =
          repro::pack_f32_bf16(dva[t][2 * r], dva[t][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward 3: dQ; grid (query tiles, H, B), causal tiles heaviest first
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(BwdPlan<D>::kWarps * 32, 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dq, Geometry g) {
  using P = BwdPlan<D>;
  constexpr int NT = P::kWarps * 32, LDS = bf_lds<D>(), ST = P::kStages;
  constexpr int KS = D / 16, DT = D / 8, NK = kTile / 8;
  extern __shared__ uint4 fa_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(fa_smem);
  bf16* do_s = q_s + kTile * LDS;
  bf16* ring = do_s + kTile * LDS;     // stage s: a K tile, then a V tile

  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (g.H / g.KvH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;
  const int rw = q0 + warp * 16;
  const int64_t stat = (static_cast<int64_t>(b) * g.H + h) * g.Sq;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw + gr + 8 * r;
    lse_r[r] = row < g.Sq ? lse[stat + row] : 0.f;
    dl_r[r] = row < g.Sq ? delta[stat + row] : 0.f;
  }

  const int k_end = g.causal ? min(g.Sk, q0 + kTile) : g.Sk;
  const int k_begin = g.window > 0 ? max(0, q0 - g.window + 1) : 0;
  const int kt0 = k_begin / kTile * kTile;
  const int n_tiles = tiles_from<kTile>(kt0, k_end);

  auto load_kv = [&](int j) {
    bf16* dst = ring + (j % ST) * 2 * kTile * LDS;
    cp_rows<D, kTile, NT>(dst, k, b, kt0 + j * kTile, g.Sk, g.KvH, kvh);
    cp_rows<D, kTile, NT>(dst + kTile * LDS, v, b, kt0 + j * kTile, g.Sk, g.KvH, kvh);
  };
  if (n_tiles > 0) {
    cp_rows<D, kTile, NT>(q_s, q, b, q0, g.Sq, g.H, h);
    cp_rows<D, kTile, NT>(do_s, dout, b, q0, g.Sq, g.H, h);
    load_kv(0);
    repro::cp_async_commit();
#pragma unroll
    for (int j = 1; j < ST - 1; ++j) {
      if (j < n_tiles) load_kv(j);
      repro::cp_async_commit();
    }
  }

  float dqa[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[t][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    repro::cp_async_wait<ST - 2>();
    __syncthreads();
    if (j + ST - 1 < n_tiles) load_kv(j + ST - 1);
    repro::cp_async_commit();
    const int k0 = kt0 + j * kTile;
    const bf16* k_t = ring + (j % ST) * 2 * kTile * LDS;
    const bf16* v_t = k_t + kTile * LDS;
    if ((g.causal && k0 > rw + 15) || (g.window > 0 && k0 + kTile - 1 <= rw - g.window))
      continue;                                   // no row of the warp sees these keys
    const bool whole = k0 + kTile <= g.Sk && rw + 15 < g.Sq &&
                       (!g.causal || k0 + kTile - 1 <= rw) &&
                       (g.window <= 0 || k0 > rw + 15 - g.window);

    // S = Q K^T, then P = exp(scale s - lse) in f32, 0 where masked
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      frag_a<LDS>(qa, q_s, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t kb[4];
        frag_bt<LDS>(kb, k_t, n * 8, kk * 16, lane);
        repro::mma_bf16(s[n], qa, kb[0], kb[1]);
        repro::mma_bf16(s[n + 1], qa, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = rw + gr + (e >> 1) * 8, kpos = k0 + n * 8 + 2 * tq + (e & 1);
        s[n][e] = whole || (qpos < g.Sq && visible(qpos, kpos, g.Sk, g))
                      ? __expf(s[n][e] * g.scale - lse_r[e >> 1]) : 0.f;
      }
    // dP = dO V^T, then dS = P (dP - delta) in f32
    float dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t oa[4];
      frag_a<LDS>(oa, do_s, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        uint32_t vb[4];
        frag_bt<LDS>(vb, v_t, n * 8, kk * 16, lane);
        repro::mma_bf16(dp[n], oa, vb[0], vb[1]);
        repro::mma_bf16(dp[n + 1], oa, vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - dl_r[e >> 1]);
    // dQ += dS K, dS as a hi + lo pair
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t dh[4], dl[4];
      acc_to_a_split(dh, dl, dp[2 * ks], dp[2 * ks + 1]);
#pragma unroll
      for (int t = 0; t < DT; t += 2) {
        uint32_t kb[4];
        frag_b<LDS>(kb, k_t, ks * 16, t * 8, lane);
        repro::mma_bf16(dqa[t], dh, kb[0], kb[1]);
        repro::mma_bf16(dqa[t + 1], dh, kb[2], kb[3]);
        repro::mma_bf16(dqa[t], dl, kb[0], kb[1]);
        repro::mma_bf16(dqa[t + 1], dl, kb[2], kb[3]);
      }
    }
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rw + gr + 8 * r;
    if (row >= g.Sq) continue;
    bf16* drow = dq + ((static_cast<int64_t>(b) * g.Sq + row) * g.H + h) * D + 2 * tq;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<uint32_t*>(drow + t * 8) =
          repro::pack_f32_bf16(dqa[t][2 * r] * g.scale, dqa[t][2 * r + 1] * g.scale);
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

template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, const int* lens, void* o,
                     float* lse, const Geometry& g, cudaStream_t s) {
  using P = FwdPlan<D>;
  static_assert(two_per_sm<P::kSmem>(), "forward tile plan: two blocks an SM");
  auto kern = flash_fwd_bf16_kernel<D>;
  if (cudaError_t e = allow_smem(kern, P::kSmem)) return e;
  const dim3 grid((g.Sq + P::kRows - 1) / P::kRows, g.H, g.B);
  kern<<<grid, P::kWarps * 32, P::kSmem, s>>>(static_cast<const bf16*>(q),
                                              static_cast<const bf16*>(k),
                                              static_cast<const bf16*>(v), lens,
                                              static_cast<bf16*>(o), lse, g);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, void* dk, void* dv,
                     const Geometry& g, cudaStream_t s) {
  using P = BwdPlan<D>;
  static_assert(two_per_sm<P::kDkdvSmem>() && two_per_sm<P::kDqSmem>(),
                "backward tile plan: two blocks an SM");
  constexpr int threads = P::kWarps * 32;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dop = static_cast<const bf16*>(dout);
  auto kdkdv = flash_bwd_dkdv_bf16_kernel<D>;
  if (cudaError_t e = allow_smem(kdkdv, P::kDkdvSmem)) return e;
  const dim3 grid_kv((g.Sk + kTile - 1) / kTile, g.KvH, g.B);
  kdkdv<<<grid_kv, threads, P::kDkdvSmem, s>>>(qp, kp, vp, dop, lse, delta,
                                               static_cast<bf16*>(dk), static_cast<bf16*>(dv), g);
  if (cudaError_t e = cudaGetLastError()) return e;
  auto kdq = flash_bwd_dq_bf16_kernel<D>;
  if (cudaError_t e = allow_smem(kdq, P::kDqSmem)) return e;
  const dim3 grid_q((g.Sq + kTile - 1) / kTile, g.H, g.B);
  kdq<<<grid_q, threads, P::kDqSmem, s>>>(qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dq), g);
  return cudaGetLastError();
}

// bf16 runs on the tensor-core kernels above, f32 on the CUDA-core ones
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, const int* lens, void* o, float* lse,
                const Geometry& g, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value) {
    return fwd_bf16<D>(q, k, v, lens, o, lse, g, s);
  } else {
    auto kern = flash_fwd_kernel<T, D>;
    if (cudaError_t e = allow_smem(kern, fwd_smem<D>())) return e;
    const dim3 grid((g.Sq + kTile - 1) / kTile, g.H, g.B);
    kern<<<grid, kThreads, fwd_smem<D>(), s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                               static_cast<const T*>(v), lens, static_cast<T*>(o),
                                               lse, g);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
                const void* dout, float* delta, void* dq, void* dk, void* dv, const Geometry& g,
                cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(g.B) * g.Sq * g.H;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned int>((rows + 7) / 8), kThreads, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, g.Sq, g.H, D);
  if (cudaError_t e = cudaGetLastError()) return e;
  if constexpr (std::is_same<T, bf16>::value) {
    return bwd_bf16<D>(q, k, v, dout, lse, delta, dq, dk, dv, g, s);
  } else {
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
}

// the bf16 kernels copy 16-byte chunks, so each tensor's base must be 16-byte
// aligned (a row of D bf16 is a multiple of 16 bytes at every head dim)
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
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
  if (dtype == repro::kBF16 && !aligned16({q, k, v, o})) return cudaErrorMisalignedAddress;
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
  if (dtype == repro::kBF16 && !aligned16({q, k, v, dout, dq, dk, dv}))
    return cudaErrorMisalignedAddress;
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
