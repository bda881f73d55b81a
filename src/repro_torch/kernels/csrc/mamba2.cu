// Mamba2 SSD chunked scan: the forward (y and the final state, and for
// training the state at each chunk's entry) and its backward.
//
// Replaces the TPU kernel src/repro/kernels/mamba_chunk.py (mamba2_chunked,
// pallas_call at :86), which has no backward of its own: the JAX package
// differentiates its oracle.  Per (batch, head) the state h [P, N] is
// carried in shared memory in f32 across 64-row chunks:
//
//   y_t = sum_{u<=t} e^{cum_t - cum_u} (C_t . B_u) dt_u x_u + e^{cum_t} h C_t
//   h  <- e^{cT} h + sum_u e^{cT - cum_u} dt_u x_u B_u^T
//
// with cum the inclusive running sum of A dt within the chunk and cT its
// value at the chunk's last row.  Every exponent is <= 0: the pair term is
// computed only for u <= t (the TPU kernel takes exp of the whole [T, T]
// block and masks afterwards, and for u > t the exponent is positive, up
// to ~|A| dt T, inf in f32 once A dt is large).
//
// Layouts are the model's, used as they are: x, dy, y, dx [B, S, H, P] and
// B, C [B, S, N] in the working dtype; dt [B, S, H] f32; A [H] f32.  The
// ragged last chunk is masked in the kernel (padded rows read dt = 0 and
// x = B = C = dy = 0, which leaves the recurrence untouched); the host does
// no transpose or padding.
//
// One block of 256 threads per (batch, head): a sequential scan.  [T, X]
// products give thread (ty, tx) = (tid / 16, tid % 16) the rows ty + 16 i
// (i < 4) and the columns tx + 16 j, so the 16 threads of a row are one
// half-warp and a row sum is four shuffles; [P, N] state products give each
// thread the entries tid + 256 k.  Tiles sit in shared memory as f32 rows
// padded by one float, so a warp reading one column across rows touches
// distinct banks.  Products run on the CUDA cores in f32.
//
// The backward is one reverse pass over the chunks per (batch, head).  It
// reads the chunk-entry states h0 the training forward wrote ([B, H, NC, P,
// N] f32) and carries dS, the gradient of the chunk's exit state.  With
// M[s,u] = e^{cum_s - cum_u} C_s . B_u and Q[s,u] = e^{cum_s - cum_u}
// dy_s . x_u (u <= s), tail_t = e^{cT - cum_t} and head_t = e^{cum_t}:
//
//   dx_t  = dt_t (sum_s M[s,t] dy_s + tail_t dS B_t);  e_t = x_t . dx_t / dt_t
//   dB_t  = dt_t (sum_s Q[s,t] C_s + tail_t x_t^T dS)          (this head's part)
//   dC_t  = head_t h0^T dy_t + sum_u Q[t,u] dt_u B_u          (this head's part)
//   dl_j  = sum_{s>=j} sum_{u<j} M[s,u] dt_u dy_s . x_u + sum_{s>=j} head_s
//           C_s . h0^T dy_s + sum_{u<j} tail_u dt_u x_u^T dS B_u + e^{cT} <dS, h0>
//   ddt_t = e_t + A dl_t;   dA = sum_t dt_t dl_t;   dS <- e^{cT} dS + sum_t
//           head_t dy_t C_t^T
//
// dl_j, the gradient of the log decay A dt_j, is summed pair by pair over
// the terms that decay through step j, inside the chunk; written as a
// running sum over the whole sequence it would lose f32 digits to
// cancellation where the decays are strong.  dB and dC sum over the heads
// and dA over the batch: each block writes its own partials ([B, S, H, N]
// f32 and [B, H] f32), a second kernel sums the heads in order, and the
// wrapper sums dA's batch partials in order.  No atomics: two runs give
// the same bits.
//
// Bound on the H100: bytes (x, y, dy, dx in bf16 and the chunk states in
// f32, at ~4 FLOPs a byte forward).  This first version runs B * H blocks
// (224 at zamba2-7b's B = 2, H = 112) on 132 SMs, each recomputing C B^T,
// which all heads of a sequence share (the TPU kernel does the same).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;                 // rows per chunk
constexpr int kTP = kChunk + 1;            // row stride of a [T, T] tile
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk == 64 && kThreads == 256,
              "the cum scan gives each lane of one warp two rows, and the [T, X] "
              "tiles give each of 16 half-warps 4 rows");

struct Geo {
  int B, S, H, NC;
};

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Load rows t0 .. t0 + T of x (and dy) [B, S, H, P] into [T][P + 1] f32
// tiles, B and C [B, S, N] into [T][N + 1] tiles and dt [B, S, H] into
// dt_s; rows past S read 0.
template <typename T, int P, int N>
__device__ void load_chunk(const Geo& g, int b, int h, int t0, const T* x, const T* dy,
                           const float* dt, const T* Bm, const T* Cm, float* x_s, float* dy_s,
                           float* B_s, float* C_s, float* dt_s) {
  for (int i = threadIdx.x; i < kChunk * P; i += kThreads) {
    const int t = i / P, p = i % P, row = t0 + t;
    float xv = 0.f, dv = 0.f;
    if (row < g.S) {
      const int64_t off = ((static_cast<int64_t>(b) * g.S + row) * g.H + h) * P + p;
      xv = repro::to_f32(x[off]);
      if (dy != nullptr) dv = repro::to_f32(dy[off]);
    }
    x_s[t * (P + 1) + p] = xv;
    if (dy_s != nullptr) dy_s[t * (P + 1) + p] = dv;
  }
  for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
    const int t = i / N, n = i % N, row = t0 + t;
    float bv = 0.f, cv = 0.f;
    if (row < g.S) {
      const int64_t off = (static_cast<int64_t>(b) * g.S + row) * N + n;
      bv = repro::to_f32(Bm[off]);
      cv = repro::to_f32(Cm[off]);
    }
    B_s[t * (N + 1) + n] = bv;
    C_s[t * (N + 1) + n] = cv;
  }
  if (threadIdx.x < kChunk) {
    const int row = t0 + threadIdx.x;
    dt_s[threadIdx.x] = row < g.S ? dt[(static_cast<int64_t>(b) * g.S + row) * g.H + h] : 0.f;
  }
}

// Warp 0: cum_s = the inclusive running sum of A dt over the chunk (lane l
// owns rows 2l and 2l + 1), head_s = e^{cum}, tail_s = e^{cT - cum};
// returns cT on every lane of warp 0.
__device__ float chunk_scan(float A, const float* dt_s, float* cum_s, float* head_s,
                            float* tail_s) {
  const int lane = threadIdx.x & 31;
  const int ta = 2 * lane, tb = ta + 1;
  const float la = A * dt_s[ta], lb = A * dt_s[tb];
  float incl = la + lb;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  const float ca = excl + la, cb = ca + lb;
  const float cT = __shfl_sync(kFull, cb, 31);
  cum_s[ta] = ca;
  cum_s[tb] = cb;
  head_s[ta] = expf(ca);
  head_s[tb] = expf(cb);
  tail_s[ta] = expf(cT - ca);
  tail_s[tb] = expf(cT - cb);
  return cT;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int P, int N> constexpr size_t fwd_smem() {
  return sizeof(float) * (kChunk * (P + 1) + 2 * kChunk * (N + 1) + P * (N + 1) +
                          kChunk * kTP + 4 * kChunk + 1);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
mamba2_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ h_final,
                  float* __restrict__ states, Geo g) {
  constexpr int XP = P + 1, XN = N + 1;
  constexpr int PT = (P + 15) / 16;            // columns of a [T, P] tile per thread
  constexpr int EPT = (P * N + kThreads - 1) / kThreads;   // state entries per thread
  extern __shared__ float sm[];
  float* x_s = sm;
  float* B_s = x_s + kChunk * XP;
  float* C_s = B_s + kChunk * XN;
  float* h_s = C_s + kChunk * XN;            // [P][N + 1]
  float* W_s = h_s + P * XN;                 // [T][T + 1]
  float* dt_s = W_s + kChunk * kTP;
  float* cum_s = dt_s + kChunk;
  float* head_s = cum_s + kChunk;
  float* tail_s = head_s + kChunk;
  float* cT_s = tail_s + kChunk;

  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float a = A[h];
  for (int i = tid; i < P * XN; i += kThreads) h_s[i] = 0.f;

  for (int ic = 0; ic < g.NC; ++ic) {
    const int t0 = ic * kChunk;
    load_chunk<T, P, N>(g, b, h, t0, x, nullptr, dt, Bm, Cm, x_s, nullptr, B_s, C_s, dt_s);
    __syncthreads();
    if (states != nullptr) {
      float* dst = states + (static_cast<int64_t>(bh) * g.NC + ic) * P * N;
      for (int i = tid; i < P * N; i += kThreads) dst[i] = h_s[(i / N) * XN + i % N];
    }
    if (tid < 32) {
      const float cT = chunk_scan(a, dt_s, cum_s, head_s, tail_s);
      if (tid == 0) cT_s[0] = cT;
    }
    __syncthreads();

    // W[t][u] = e^{cum_t - cum_u} (C_t . B_u) dt_u for u <= t, else 0
    {
      float cb[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = C_s[(ty + 16 * i) * XN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = B_s[(tx + 16 * j) * XN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] += cv[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = tx + 16 * j;
          W_s[t * kTP + u] = u <= t ? expf(cum_s[t] - cum_s[u]) * cb[i][j] * dt_s[u] : 0.f;
        }
      }
    }
    __syncthreads();

    // y[t][p] = sum_u W[t][u] x[u][p] + head_t sum_n C[t][n] h[p][n]
    {
      float acc[4][PT] = {}, st[4][PT] = {};
      for (int u = 0; u < kChunk; ++u) {
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int p = tx + 16 * j;
          const float xv = p < P ? x_s[u * XP + p] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += W_s[(ty + 16 * i) * kTP + u] * xv;
        }
      }
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int p = tx + 16 * j;
          const float hv = p < P ? h_s[p * XN + n] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) st[i][j] += C_s[(ty + 16 * i) * XN + n] * hv;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t0 + t >= g.S) continue;
        const int64_t off = ((static_cast<int64_t>(b) * g.S + t0 + t) * g.H + h) * P;
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int p = tx + 16 * j;
          if (p < P) y[off + p] = repro::from_f32<T>(acc[i][j] + head_s[t] * st[i][j]);
        }
      }
    }
    __syncthreads();

    // h[p][n] <- e^{cT} h[p][n] + sum_u tail_u dt_u x[u][p] B[u][n]
    {
      const float dec = expf(cT_s[0]);
      float acc[EPT];
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int i = tid + kThreads * k;
        acc[k] = i < P * N ? dec * h_s[(i / N) * XN + i % N] : 0.f;
      }
      for (int u = 0; u < kChunk; ++u) {
        const float w = tail_s[u] * dt_s[u];
#pragma unroll
        for (int k = 0; k < EPT; ++k) {
          const int i = tid + kThreads * k;
          if (i < P * N) acc[k] += w * x_s[u * XP + i / N] * B_s[u * XN + i % N];
        }
      }
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int i = tid + kThreads * k;
        if (i < P * N) h_s[(i / N) * XN + i % N] = acc[k];
      }
    }
    __syncthreads();                         // before the next chunk's loads
  }
  float* hf = h_final + static_cast<int64_t>(bh) * P * N;
  for (int i = tid; i < P * N; i += kThreads) hf[i] = h_s[(i / N) * XN + i % N];
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <int P, int N> constexpr size_t bwd_smem() {
  return sizeof(float) * (2 * kChunk * (P + 1) + 2 * kChunk * (N + 1) + 2 * P * (N + 1) +
                          3 * kChunk * kTP + 8 * kChunk + kThreads / 32 + 1);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
mamba2_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const T* __restrict__ dy,
                  const float* __restrict__ states, T* __restrict__ dx,
                  float* __restrict__ ddt, float* __restrict__ dB_part,
                  float* __restrict__ dC_part, float* __restrict__ dA_part, Geo g) {
  constexpr int XP = P + 1, XN = N + 1;
  constexpr int PT = (P + 15) / 16, NT = (N + 15) / 16;
  constexpr int EPT = (P * N + kThreads - 1) / kThreads;
  extern __shared__ float sm[];
  float* x_s = sm;
  float* dy_s = x_s + kChunk * XP;
  float* B_s = dy_s + kChunk * XP;
  float* C_s = B_s + kChunk * XN;
  float* h0_s = C_s + kChunk * XN;           // [P][N + 1] chunk-entry state
  float* dS_s = h0_s + P * XN;               // [P][N + 1] gradient of the exit state
  float* M_s = dS_s + P * XN;                // [T][T + 1]
  float* Q_s = M_s + kChunk * kTP;
  float* K_s = Q_s + kChunk * kTP;           // M dt_u dy.x, then its row prefix sums
  float* dt_s = K_s + kChunk * kTP;
  float* cum_s = dt_s + kChunk;
  float* head_s = cum_s + kChunk;
  float* tail_s = head_s + kChunk;
  float* e_s = tail_s + kChunk;              // x_t . g_t B_t
  float* hc_s = e_s + kChunk;                // C_t . h0^T dy_t
  float* xd_s = hc_s + kChunk;               // x_t^T dS B_t
  float* dl_s = xd_s + kChunk;
  float* red_s = dl_s + kChunk;              // per-warp partials of <dS, h0>
  float* cT_s = red_s + kThreads / 32;

  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const float a = A[h];
  for (int i = tid; i < P * XN; i += kThreads) dS_s[i] = 0.f;
  float dA_acc = 0.f;                        // thread 0: sum_t dt_t dl_t

  for (int ic = g.NC - 1; ic >= 0; --ic) {
    const int t0 = ic * kChunk;
    load_chunk<T, P, N>(g, b, h, t0, x, dy, dt, Bm, Cm, x_s, dy_s, B_s, C_s, dt_s);
    const float* src = states + (static_cast<int64_t>(bh) * g.NC + ic) * P * N;
    for (int i = tid; i < P * N; i += kThreads) h0_s[(i / N) * XN + i % N] = src[i];
    __syncthreads();
    if (tid < 32) {
      const float cT = chunk_scan(a, dt_s, cum_s, head_s, tail_s);
      if (tid == 0) cT_s[0] = cT;
    }
    __syncthreads();

    // M, Q and K = M dt_u (dy_s . x_u) over the [T, T] tile, zero for u > s
    {
      float cb[4][4] = {}, dyx[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = C_s[(ty + 16 * i) * XN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = B_s[(tx + 16 * j) * XN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] += cv[i] * bv[j];
      }
      for (int p = 0; p < P; ++p) {
        float dv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = dy_s[(ty + 16 * i) * XP + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = x_s[(tx + 16 * j) * XP + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dyx[i][j] += dv[i] * xv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = tx + 16 * j;
          const float L = u <= s ? expf(cum_s[s] - cum_s[u]) : 0.f;
          const float m = L * cb[i][j];
          M_s[s * kTP + u] = m;
          Q_s[s * kTP + u] = L * dyx[i][j];
          K_s[s * kTP + u] = m * dt_s[u] * dyx[i][j];
        }
      }
    }
    __syncthreads();

    // [T, P]: g_t B_t = sum_s M[s][t] dy_s + tail_t dS B_t; dx = dt_t g_t B_t
    {
      float gb[4][PT] = {}, sb[4][PT] = {};
      for (int s = 0; s < kChunk; ++s) {
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int p = tx + 16 * j;
          const float dv = p < P ? dy_s[s * XP + p] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) gb[i][j] += M_s[s * kTP + ty + 16 * i] * dv;
        }
      }
      for (int n = 0; n < N; ++n) {
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int p = tx + 16 * j;
          const float dsv = p < P ? dS_s[p * XN + n] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) sb[i][j] += B_s[(ty + 16 * i) * XN + n] * dsv;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const int64_t off = ((static_cast<int64_t>(b) * g.S + t0 + t) * g.H + h) * P;
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int p = tx + 16 * j;
          if (p >= P) continue;
          const float v = gb[i][j] + tail_s[t] * sb[i][j];
          e += x_s[t * XP + p] * v;
          if (t0 + t < g.S) dx[off + p] = repro::from_f32<T>(dt_s[t] * v);
        }
        e = half_warp_sum(e);
        if (tx == 0) e_s[t] = e;
      }
    }

    // [T, N]: dB and dC (this head's parts), and the row sums hc and xd
    {
      float qc[4][NT] = {}, xs[4][NT] = {}, hd[4][NT] = {}, qb[4][NT] = {};
      for (int s = 0; s < kChunk; ++s) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = tx + 16 * j;
          const float cv = n < N ? C_s[s * XN + n] : 0.f;
          const float bv = n < N ? dt_s[s] * B_s[s * XN + n] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = ty + 16 * i;
            qc[i][j] += Q_s[s * kTP + t] * cv;     // sum_s Q[s][t] C_s
            qb[i][j] += Q_s[t * kTP + s] * bv;     // sum_u Q[t][u] dt_u B_u
          }
        }
      }
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = tx + 16 * j;
          const float dsv = n < N ? dS_s[p * XN + n] : 0.f;
          const float hv = n < N ? h0_s[p * XN + n] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = ty + 16 * i;
            xs[i][j] += x_s[t * XP + p] * dsv;     // x_t^T dS
            hd[i][j] += dy_s[t * XP + p] * hv;     // h0^T dy_t
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const int64_t off = ((static_cast<int64_t>(b) * g.S + t0 + t) * g.H + h) * N;
        float hc = 0.f, xd = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = tx + 16 * j;
          if (n >= N) continue;
          hc += C_s[t * XN + n] * hd[i][j];
          xd += B_s[t * XN + n] * xs[i][j];
          if (t0 + t < g.S) {
            dB_part[off + n] = dt_s[t] * (qc[i][j] + tail_s[t] * xs[i][j]);
            dC_part[off + n] = head_s[t] * hd[i][j] + qb[i][j];
          }
        }
        hc = half_warp_sum(hc);
        xd = half_warp_sum(xd);
        if (tx == 0) {
          hc_s[t] = hc;
          xd_s[t] = xd;
        }
      }
    }
    __syncthreads();

    // threads s < T: K's row prefix sums sum_{u<j} K[s][u], in place; every
    // thread: its entries of dS <- e^{cT} dS + sum_t head_t dy_t C_t^T and
    // its part of <dS, h0> (dS before the update)
    if (tid < kChunk) {
      float run = 0.f;
      for (int u = 0; u < kChunk; ++u) {
        const float k = K_s[tid * kTP + u];
        K_s[tid * kTP + u] = run;
        run += k;
      }
    }
    {
      const float dec = expf(cT_s[0]);
      float acc[EPT], dot = 0.f;
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int i = tid + kThreads * k;
        if (i < P * N) {
          const float d = dS_s[(i / N) * XN + i % N];
          dot += d * h0_s[(i / N) * XN + i % N];
          acc[k] = dec * d;
        } else {
          acc[k] = 0.f;
        }
      }
      for (int t = 0; t < kChunk; ++t) {
        const float w = head_s[t];
#pragma unroll
        for (int k = 0; k < EPT; ++k) {
          const int i = tid + kThreads * k;
          if (i < P * N) acc[k] += w * dy_s[t * XP + i / N] * C_s[t * XN + i % N];
        }
      }
      __syncthreads();                     // every thread has read the old dS
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int i = tid + kThreads * k;
        if (i < P * N) dS_s[(i / N) * XN + i % N] = acc[k];
      }
      dot = repro::warp_sum(dot);
      if (lane == 0) red_s[warp] = dot;
    }
    __syncthreads();

    // threads j < T: dl_j, then ddt_j = e_j + A dl_j
    if (tid < kChunk) {
      const int j = tid;
      float dsh = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) dsh += red_s[w];
      float dl = expf(cT_s[0]) * dsh;
      for (int s = j; s < kChunk; ++s) dl += K_s[s * kTP + j] + head_s[s] * hc_s[s];
      for (int u = 0; u < j; ++u) dl += tail_s[u] * dt_s[u] * xd_s[u];
      dl_s[j] = dl;
      if (t0 + j < g.S) ddt[(static_cast<int64_t>(b) * g.S + t0 + j) * g.H + h] = e_s[j] + a * dl;
    }
    __syncthreads();
    if (tid == 0)
      for (int t = 0; t < kChunk; ++t) dA_acc += dt_s[t] * dl_s[t];
    __syncthreads();                         // before the next chunk's loads
  }
  if (tid == 0) dA_part[bh] = dA_acc;
}

// dB[b, t, n] = sum_h dB_part[b, t, h, n] in head order (and dC alike),
// rounded to the working dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_head_sum_kernel(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                       T* __restrict__ dB, T* __restrict__ dC, int64_t rows, int H, int N) {
  const int64_t total = rows * N;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t row = i / N;
    const int n = static_cast<int>(i % N);
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      const int64_t off = (row * H + h) * N + n;
      sb += dB_part[off];
      sc += dC_part[off];
    }
    dB[i] = repro::from_f32<T>(sb);
    dC[i] = repro::from_f32<T>(sc);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int P, int N>
cudaError_t fwd(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                void* y, float* h_final, float* states, const Geo& g, cudaStream_t s) {
  auto kern = mamba2_fwd_kernel<T, P, N>;
  if (cudaError_t e = allow_smem(kern, fwd_smem<P, N>())) return e;
  kern<<<g.B * g.H, kThreads, fwd_smem<P, N>(), s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<T*>(y), h_final, states, g);
  return cudaGetLastError();
}

template <typename T, int P, int N>
cudaError_t bwd(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
                const void* dy, const float* states, void* dx, float* ddt, float* dB_part,
                float* dC_part, float* dA_part, void* dB, void* dC, const Geo& g,
                cudaStream_t s) {
  auto kern = mamba2_bwd_kernel<T, P, N>;
  if (cudaError_t e = allow_smem(kern, bwd_smem<P, N>())) return e;
  kern<<<g.B * g.H, kThreads, bwd_smem<P, N>(), s>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const T*>(dy), states, static_cast<T*>(dx), ddt, dB_part, dC_part, dA_part,
      g);
  if (cudaError_t e = cudaGetLastError()) return e;
  const int64_t rows = static_cast<int64_t>(g.B) * g.S;
  mamba2_head_sum_kernel<T><<<repro::elementwise_blocks(rows * N, kThreads), kThreads, 0, s>>>(
      dB_part, dC_part, static_cast<T*>(dB), static_cast<T*>(dC), rows, g.H, N);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_MAMBA_SHAPES(SHAPE_CASE) SHAPE_CASE(64, 64) SHAPE_CASE(16, 8)

// x [B, S, H, P] (dtype), dt [B, S, H] f32, A [H] f32, B, C [B, S, N] (dtype)
// -> y like x, h_final [B, H, P, N] f32 and, unless states is null, the
// state at each chunk's entry [B, H, ceil(S / 64), P, N] f32.
extern "C" int repro_mamba2_fwd(int dtype, const void* x, const float* dt, const float* A,
                                const void* Bm, const void* Cm, void* y, float* h_final,
                                float* states, int B, int S, int H, int P, int N,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, S, H, (S + kChunk - 1) / kChunk};
#define REPRO_FWD_CASE(PP, NN) \
  if (P == PP && N == NN) return fwd<T, PP, NN>(x, dt, A, Bm, Cm, y, h_final, states, g, s);
  REPRO_DISPATCH_DTYPE(dtype, T,
    REPRO_MAMBA_SHAPES(REPRO_FWD_CASE)
    return cudaErrorInvalidValue;);
#undef REPRO_FWD_CASE
  return cudaSuccess;
}

// The backward of repro_mamba2_fwd for the output gradient dy (a zero
// gradient on h_final), from the chunk-entry states the forward wrote: dx
// like x; ddt [B, S, H] f32; dB, dC like B (summed over the heads from the
// scratch dB_part, dC_part [B, S, H, N] f32); dA_part [B, H] f32, whose sum
// over B is dA.
extern "C" int repro_mamba2_bwd(int dtype, const void* x, const float* dt, const float* A,
                                const void* Bm, const void* Cm, const void* dy,
                                const float* states, void* dx, float* ddt, float* dB_part,
                                float* dC_part, float* dA_part, void* dB, void* dC, int B,
                                int S, int H, int P, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, S, H, (S + kChunk - 1) / kChunk};
#define REPRO_BWD_CASE(PP, NN)                                                               \
  if (P == PP && N == NN)                                                                    \
    return bwd<T, PP, NN>(x, dt, A, Bm, Cm, dy, states, dx, ddt, dB_part, dC_part, dA_part, \
                          dB, dC, g, s);
  REPRO_DISPATCH_DTYPE(dtype, T,
    REPRO_MAMBA_SHAPES(REPRO_BWD_CASE)
    return cudaErrorInvalidValue;);
#undef REPRO_BWD_CASE
  return cudaSuccess;
}
