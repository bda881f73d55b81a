// Mamba2 SSD chunked scan: the forward (y and the final state, and for
// training the state at each chunk's entry) and its backward.
//
// Replaces the TPU kernel src/repro/kernels/mamba_chunk.py (mamba2_chunked,
// the kernel body _kernel, pallas_call at :86), which has no backward of its
// own: the JAX package differentiates its oracle.  Per (batch, head) the
// state h [P, N] is carried on chip in f32 across 64-row chunks, from zero
// (training) or from a state h0 the caller carries in (recurrent serving: a
// slot's state between prefill chunks; the TPU path runs its plain chunked
// scan there, src/repro/kernels/ops.py:259-263, so the forward with h0
// replaces none):
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
// The backward reads the chunk-entry states h0 the training forward wrote
// ([B, H, NC, P, N] f32).  With dS the gradient of a chunk's exit state,
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
// cancellation where the decays are strong.  No atomics anywhere: dB and dC
// are summed over heads, and dA over (batch, chunk), in a fixed order, so
// two runs give the same bits.
//
// Bound on the H100: bytes (x, y, dy, dx in bf16 and the chunk states in
// f32; the forward does ~4 FLOPs a byte, far below the tensor cores' ~295).
// Two forms:
//
// * bf16, on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out).
//   - C B^T is shared by the heads (n_groups = 1): a pre-pass computes it
//     once per (batch, chunk), [B, NC, 64, 64] f32 (2 MB at zamba2-7b's
//     shapes), and the heads read it from L2.
//   - In every product one operand is exact in bf16 (x, dy, B or C); the
//     f32 scalings (dt, head, tail, the decays) are folded into the other
//     operand in f32, which enters as a bf16 hi + lo pair (~2^-17
//     relative).  Each 16-deep K piece's tensor-core sum is added on the
//     CUDA cores: the tensor cores' own accumulation truncates.
//   - The forward walks the chunks once per (batch, head), 4 warps: warp w
//     takes y's rows 16 w.. of a chunk and the state's rows p = 16 w.. in
//     registers (a state row depends only on its own x column).  Chunk
//     c + 1's x, B, C, dt and C B^T come in by 16-byte cp.async while
//     chunk c computes.  The state leaves the chip only as the saved
//     chunk-entry states.
//   - The backward is two passes after the pre-pass.  A reverse walk per
//     (batch, head), the forward's mirror, writes dS of every chunk
//     ([B, H, NC, P, N] f32 scratch, live only during the call).  Then,
//     given h0 and dS, every gradient of a chunk is local: one block per
//     (batch, chunk, group of G heads), G from the host's plan
//     (kernels/mamba_chunk.py:bwd_plan, fed by
//     repro_mamba2_bwd_occupancy), sums dB and dC over its heads in
//     registers, in head order, and writes [B, S, ceil(H / G), N] partials.
//     A last pass sums the groups in order, and dA's (batch, chunk)
//     partials.
// * f32 (the fp32 parity runs), on the CUDA cores: one block of 256
//   threads per (batch, head) scans the chunks in order, state in shared
//   memory, C B^T recomputed per head; its backward is one reverse pass
//   per (batch, head) writing per-head dB / dC partials ([B, S, H, N]),
//   summed by the same last pass.
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
template <int P, int N>
__device__ void load_chunk(const Geo& g, int b, int h, int t0, const float* x,
                           const float* dy, const float* dt, const float* Bm, const float* Cm,
                           float* x_s, float* dy_s, float* B_s, float* C_s, float* dt_s) {
  for (int i = threadIdx.x; i < kChunk * P; i += kThreads) {
    const int t = i / P, p = i % P, row = t0 + t;
    float xv = 0.f, dv = 0.f;
    if (row < g.S) {
      const int64_t off = ((static_cast<int64_t>(b) * g.S + row) * g.H + h) * P + p;
      xv = x[off];
      if (dy != nullptr) dv = dy[off];
    }
    x_s[t * (P + 1) + p] = xv;
    if (dy_s != nullptr) dy_s[t * (P + 1) + p] = dv;
  }
  for (int i = threadIdx.x; i < kChunk * N; i += kThreads) {
    const int t = i / N, n = i % N, row = t0 + t;
    float bv = 0.f, cv = 0.f;
    if (row < g.S) {
      const int64_t off = (static_cast<int64_t>(b) * g.S + row) * N + n;
      bv = Bm[off];
      cv = Cm[off];
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
// f32 forward, on the CUDA cores
// ---------------------------------------------------------------------------

template <int P, int N> constexpr size_t fwd_smem() {
  return sizeof(float) * (kChunk * (P + 1) + 2 * kChunk * (N + 1) + P * (N + 1) +
                          kChunk * kTP + 4 * kChunk + 1);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
mamba2_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ h_final,
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
  // the carried state h0 [B, H, P, N], or zeros
  const float* init = h0 != nullptr ? h0 + static_cast<int64_t>(bh) * P * N : nullptr;
  for (int i = tid; i < P * XN; i += kThreads)
    h_s[i] = init != nullptr && i % XN < N ? init[(i / XN) * N + i % XN] : 0.f;

  for (int ic = 0; ic < g.NC; ++ic) {
    const int t0 = ic * kChunk;
    load_chunk<P, N>(g, b, h, t0, x, nullptr, dt, Bm, Cm, x_s, nullptr, B_s, C_s, dt_s);
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
          if (p < P) y[off + p] = acc[i][j] + head_s[t] * st[i][j];
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
// f32 backward: one reverse pass per (batch, head) carrying dS
// ---------------------------------------------------------------------------

template <int P, int N> constexpr size_t bwd_smem() {
  return sizeof(float) * (2 * kChunk * (P + 1) + 2 * kChunk * (N + 1) + 2 * P * (N + 1) +
                          3 * kChunk * kTP + 8 * kChunk + kThreads / 32 + 1);
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
mamba2_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ dy,
                  const float* __restrict__ states, float* __restrict__ dx,
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
    load_chunk<P, N>(g, b, h, t0, x, dy, dt, Bm, Cm, x_s, dy_s, B_s, C_s, dt_s);
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
          if (t0 + t < g.S) dx[off + p] = dt_s[t] * v;
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core decomposition
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;             // 4 warps: 16 rows of a 64-row chunk each
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kCbF = kChunk + 8;            // f32 row stride of the forward's C B^T tile
constexpr int kCbB = kChunk + 4;            // ... and of the backward's (read transposed)
static_assert(kTcWarps * 16 == kChunk, "a warp a 16-row slice of the chunk");

template <int X> __host__ __device__ constexpr int pad16() { return (X + 15) / 16 * 16; }

using repro::lds;

// Rows t0 .. t0 + 64 of a bf16 tensor whose row r starts at base + r * rs,
// W elements a row (a multiple of 8), into a [64][WP + 8] tile by 16-byte
// cp.async; rows past S are zero-filled.  Columns W .. WP are left as they
// are (zero_pad_cols writes them once).
template <int W, int WP>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int64_t base, int64_t rs,
                                        int t0, int S) {
  constexpr int CPR = W / 8;
  for (int i = threadIdx.x; i < kChunk * CPR; i += kTcThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = t0 + r < S;
    repro::cp_async16(dst + r * lds<WP>() + c * 8,
                      ok ? src + base + static_cast<int64_t>(t0 + r) * rs + c * 8 : src, ok);
  }
}

// zero columns W .. WP of `rows` rows of a [rows][WP + 8] tile (N = 8 is
// carried as 16 for the 16-deep MMA)
template <int W, int WP>
__device__ __forceinline__ void zero_pad_cols(bf16* dst, int rows) {
  if constexpr (W < WP) {
    for (int i = threadIdx.x; i < rows * (WP - W); i += kTcThreads)
      dst[(i / (WP - W)) * lds<WP>() + W + i % (WP - W)] = __float2bfloat16_rn(0.f);
  }
}

// dt rows t0 .. t0 + 64 of head h ([B, S, H] f32) into dst, past S zero
__device__ __forceinline__ void cp_dt(float* dst, const float* dt, int b, int h, int t0,
                                      const Geo& g) {
  if (threadIdx.x < kChunk) {
    const int row = t0 + threadIdx.x;
    const bool ok = row < g.S;
    repro::cp_async4(dst + threadIdx.x,
                     ok ? dt + (static_cast<int64_t>(b) * g.S + row) * g.H + h : dt, ok);
  }
}

// The chunk's log-decay sums, computed by each warp for itself: lane l owns
// rows 2 l and 2 l + 1 (cum of those in ca, cb), writes cum (the inclusive
// sums of A dt) into the warp's cum_w and returns cT, the chunk's total, on
// every lane.  The caller __syncwarp()s before reading cum_w.
__device__ __forceinline__ float warp_cum(float a, const float* dt_s, float* cum_w, float& ca,
                                          float& cb) {
  const int lane = threadIdx.x & 31;
  const float la = a * dt_s[2 * lane], lb = a * dt_s[2 * lane + 1];
  float incl = la + lb;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  ca = excl + la;
  cb = ca + lb;
  cum_w[2 * lane] = ca;
  cum_w[2 * lane + 1] = cb;
  return __shfl_sync(kFull, cb, 31);
}

using repro::quad_sum;

// the exclusive scan along the four lanes of a quad
__device__ __forceinline__ float quad_excl(float v) {
  const int q = threadIdx.x & 3;
  float incl = v, t = __shfl_up_sync(kFull, incl, 1, 4);
  if (q >= 1) incl += t;
  t = __shfl_up_sync(kFull, incl, 2, 4);
  if (q >= 2) incl += t;
  return incl - v;
}

using repro::add;
using repro::zero;

// acc[16 x 8 NT] += A[16 x 16] B[16 x 8 NT] for one 16-deep piece: B's
// fragments two n tiles at a time from ldr(b, n0); A a hi + lo pair (ah,
// al) or, with al null, exact.  The piece is summed on the tensor cores in
// `part` and added to acc on the CUDA cores.
template <int NT, typename Ldr>
__device__ __forceinline__ void mma_a(float (&acc)[NT][4], const uint32_t (&ah)[4],
                                      const uint32_t* al, Ldr ldr) {
  float part[NT][4];
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    uint32_t bb[4];
    ldr(bb, n * 8);
    repro::mma_bf16_zero(part[n], ah, bb[0], bb[1]);
    repro::mma_bf16_zero(part[n + 1], ah, bb[2], bb[3]);
    if (al != nullptr) {
      const uint32_t a2[4] = {al[0], al[1], al[2], al[3]};
      repro::mma_bf16(part[n], a2, bb[0], bb[1]);
      repro::mma_bf16(part[n + 1], a2, bb[2], bb[3]);
    }
  }
  add(acc, part);
}

// the same with A exact and B a hi + lo pair of tiles (ldh, ldl)
template <int NT, typename LdH, typename LdL>
__device__ __forceinline__ void mma_b2(float (&acc)[NT][4], const uint32_t (&a)[4], LdH ldh,
                                       LdL ldl) {
  float part[NT][4];
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    uint32_t bh[4], bl[4];
    ldh(bh, n * 8);
    ldl(bl, n * 8);
    repro::mma_bf16_zero(part[n], a, bh[0], bh[1]);
    repro::mma_bf16_zero(part[n + 1], a, bh[2], bh[3]);
    repro::mma_bf16(part[n], a, bl[0], bl[1]);
    repro::mma_bf16(part[n + 1], a, bl[2], bl[3]);
  }
  add(acc, part);
}

// acc[16 x 8 NT] += sum over KT 16-deep pieces of A_kk B_kk, A exact from
// fa(a, kk) and B from fb(b, kk, n0)
template <int NT, int KT, typename Fa, typename Fb>
__device__ __forceinline__ void gemm_exact(float (&acc)[NT][4], Fa fa, Fb fb) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    fa(a, kk);
    mma_a<NT>(acc, a, nullptr, [&](uint32_t (&b)[4], int n0) { fb(b, kk, n0); });
  }
}

// acc[16 x 8 NT] += sum over KT pieces of A_kk (B_hi + B_lo)_kk, A exact
template <int NT, int KT, typename Fa, typename FbH, typename FbL>
__device__ __forceinline__ void gemm_b2(float (&acc)[NT][4], Fa fa, FbH fbh, FbL fbl) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t a[4];
    fa(a, kk);
    mma_b2<NT>(acc, a, [&](uint32_t (&b)[4], int n0) { fbh(b, kk, n0); },
               [&](uint32_t (&b)[4], int n0) { fbl(b, kk, n0); });
  }
}

// acc[state rows p0.., 8 NT cols] += sum_u w_u src[u][p] mat[u][:] over the
// 64 rows of a chunk: the forward's state update and the backward walk's
// dS update.  src^T comes through ldmatrix.trans, is scaled by w_u in f32
// and enters as a hi + lo pair; mat is exact.
template <int LS, int LM, int NT>
__device__ __forceinline__ void state_update(float (&acc)[NT][4], const bf16* src, const bf16* mat,
                                             const float* w, int p0, int lane) {
  const int q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    uint32_t a[4];
    repro::frag_at<LS>(a, src, kk * 16, p0, lane);
    const int u = kk * 16 + 2 * q;
    const float w0 = w[u], w1 = w[u + 1], w8 = w[u + 8], w9 = w[u + 9];
    const float v[8] = {repro::bf16_lo(a[0]) * w0, repro::bf16_hi(a[0]) * w1,
                        repro::bf16_lo(a[1]) * w0, repro::bf16_hi(a[1]) * w1,
                        repro::bf16_lo(a[2]) * w8, repro::bf16_hi(a[2]) * w9,
                        repro::bf16_lo(a[3]) * w8, repro::bf16_hi(a[3]) * w9};
    uint32_t ah[4], al[4];
    repro::split_bf16(ah, al, v);
    mma_a<NT>(acc, ah, al, [&](uint32_t (&b)[4], int n0) {
      repro::frag_b<LM>(b, mat, kk * 16, n0, lane);
    });
  }
}

// A [rows][N] f32 matrix held in accumulator fragments (rows r0 + l / 4
// and + 8, columns 8 n + 2 (l % 4) and + 1) into global memory, row stride
// N, columns past N dropped
template <int N, int NT>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[NT][4], int r0,
                                          int lane) {
  const int gr = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * q;
    if (col >= N) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(dst + (r0 + gr + 8 * r) * N + col) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ... its inverse: the fragments from a [rows][N] f32 matrix in global
// memory (row stride N; the columns past N read 0)
template <int N, int NT>
__device__ __forceinline__ void load_acc(float (&acc)[NT][4], const float* src, int r0,
                                         int lane) {
  const int gr = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * q;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = col < N ? *reinterpret_cast<const float2*>(src + (r0 + gr + 8 * r) * N + col)
                               : make_float2(0.f, 0.f);
      acc[n][2 * r] = v.x;
      acc[n][2 * r + 1] = v.y;
    }
  }
}

// ... and a state's fragments into a [P][LB] bf16 hi + lo tile pair
template <int LB, int NT>
__device__ __forceinline__ void acc_to_smem(bf16* hi, bf16* lo, const float (&acc)[NT][4],
                                            int p0, int lane) {
  const int gr = lane >> 2, q = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = (p0 + gr + 8 * r) * LB + n * 8 + 2 * q;
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(hi + off) = h2;
      *reinterpret_cast<__nv_bfloat162*>(lo + off) = __floats2bfloat162_rn(
          acc[n][2 * r] - __low2float(h2), acc[n][2 * r + 1] - __high2float(h2));
    }
}

// four f32 of a row into a bf16 hi + lo tile pair at offset off
__device__ __forceinline__ void f4_to_smem(bf16* hi, bf16* lo, int off, float4 v) {
  const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
  const __nv_bfloat162 l[2] = {
      __floats2bfloat162_rn(v.x - __low2float(h[0]), v.y - __high2float(h[0])),
      __floats2bfloat162_rn(v.z - __low2float(h[1]), v.w - __high2float(h[1]))};
  *reinterpret_cast<uint2*>(hi + off) = *reinterpret_cast<const uint2*>(h);
  *reinterpret_cast<uint2*>(lo + off) = *reinterpret_cast<const uint2*>(l);
}

// C B^T of every (batch, chunk): cb [B, NC, 64, 64] f32, cb[t][u] = C_t . B_u
// over the chunk's rows, zero past S.  B and C are exact in bf16; warp w
// takes rows 16 w...  Shared by the heads (n_groups = 1), so it is computed
// once per (batch, chunk), not once a head.
template <int N>
__device__ __forceinline__ void cb_block(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                                         float* __restrict__ cb, const Geo& g) {
  constexpr int NP = pad16<N>();
  constexpr int LB = lds<NP>(), NT = kChunk / 8;
  __shared__ __align__(16) bf16 b_s[kChunk * LB], c_s[kChunk * LB];
  const int b = blockIdx.x / g.NC, c = blockIdx.x % g.NC, t0 = c * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  zero_pad_cols<N, NP>(b_s, kChunk);
  zero_pad_cols<N, NP>(c_s, kChunk);
  const int64_t base = static_cast<int64_t>(b) * g.S * N;
  cp_tile<N, NP>(b_s, Bm, base, N, t0, g.S);
  cp_tile<N, NP>(c_s, Cm, base, N, t0, g.S);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  float acc[NT][4];
  zero(acc);
  gemm_exact<NT, NP / 16>(
      acc, [&](uint32_t (&a)[4], int kk) { repro::frag_a<LB>(a, c_s, warp * 16, kk * 16, lane); },
      [&](uint32_t (&bb)[4], int kk, int n0) { repro::frag_bt<LB>(bb, b_s, n0, kk * 16, lane); });
  store_acc<kChunk, NT>(cb + static_cast<int64_t>(blockIdx.x) * kChunk * kChunk, acc, warp * 16,
                        lane);
}

// one kernel name a pass, so a profile attributes the pre-pass to the
// forward or the backward
template <int N>
__global__ void __launch_bounds__(kTcThreads)
mamba2_fwd_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                     float* __restrict__ cb, Geo g) {
  cb_block<N>(Bm, Cm, cb, g);
}

template <int N>
__global__ void __launch_bounds__(kTcThreads)
mamba2_bwd_cb_kernel(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                     float* __restrict__ cb, Geo g) {
  cb_block<N>(Bm, Cm, cb, g);
}

// ---------------------------------------------------------------------------
// bf16 forward: a state walk per (batch, head)
// ---------------------------------------------------------------------------
//
// 4 warps.  Warp w computes y's rows 16 w.. of each chunk (all P columns)
// and, where 16 w < P, carries the state's rows p = 16 w.. (all N columns)
// in registers through the walk.  A chunk:
//   W x    W[t][u] = e^{cum_t - cum_u} CB[t][u] dt_u (u <= t), formed in f32
//          straight into A fragments from the staged C B^T, a hi + lo
//          pair; x exact.  Only the u tiles up to the warp's rows.
//   C h^T  C exact; h from the shared [P][N] hi + lo tiles.
//   y    = W x + e^{cum_t} C h^T
//   h   <- e^{cT} h + (tail dt x)^T B (state_update).
// x, B, C, dt and C B^T come in by cp.async into a 2-stage ring: chunk
// c + 1 loads while chunk c computes.  Two __syncthreads a chunk: one when
// its stage and the previous state's tiles have landed, one before the new
// state's tiles are written and its stage is refilled.

template <int P, int N> struct FwdTc {
  static constexpr int NP = pad16<N>();
  static constexpr int LX = lds<P>();
  static constexpr int LB = lds<NP>();
  static constexpr int kStages = 2;
  static constexpr int kX = 0;                                   // [64][LX] bf16
  static constexpr int kB = kX + kChunk * LX * 2;                // [64][LB] bf16
  static constexpr int kC = kB + kChunk * LB * 2;
  static constexpr int kCb = kC + kChunk * LB * 2;               // [64][kCbF] f32
  static constexpr int kDt = kCb + kChunk * kCbF * 4;            // [64] f32
  static constexpr int kStage = kDt + kChunk * 4;
  static constexpr int kH = kStages * kStage;                    // h hi, lo [P][LB] bf16
  static constexpr int kW = kH + 2 * P * LB * 2;                 // a warp's cum, weight [64]
  static constexpr size_t kSmem = kW + kTcWarps * 2 * kChunk * 4;
};

template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 2)
mamba2_fwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, const float* __restrict__ cb,
                     const float* __restrict__ h0, bf16* __restrict__ y,
                     float* __restrict__ h_final, float* __restrict__ states, Geo g) {
  using F = FwdTc<P, N>;
  constexpr int NP = F::NP, LX = F::LX, LB = F::LB, ST = F::kStages;
  constexpr int PT = P / 8, NT = NP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, q = lane & 3;
  const float a = A[h];
  bf16* hh = reinterpret_cast<bf16*>(smem + F::kH);
  bf16* hl = hh + P * LB;
  float* cum = reinterpret_cast<float*>(smem + F::kW) + warp * 2 * kChunk;
  float* wgt = cum + kChunk;                 // tail_u dt_u
  for (int i = tid; i < 2 * P * LB; i += kTcThreads) hh[i] = __float2bfloat16_rn(0.f);
  for (int s = 0; s < ST; ++s) {
    zero_pad_cols<N, NP>(reinterpret_cast<bf16*>(smem + s * F::kStage + F::kB), kChunk);
    zero_pad_cols<N, NP>(reinterpret_cast<bf16*>(smem + s * F::kStage + F::kC), kChunk);
  }
  auto load = [&](int c) {
    unsigned char* st = smem + (c % ST) * F::kStage;
    const int t0 = c * kChunk;
    const int64_t bn = static_cast<int64_t>(b) * g.S * N;
    cp_tile<P, P>(reinterpret_cast<bf16*>(st + F::kX), x,
                  static_cast<int64_t>(b) * g.S * g.H * P + static_cast<int64_t>(h) * P,
                  static_cast<int64_t>(g.H) * P, t0, g.S);
    cp_tile<N, NP>(reinterpret_cast<bf16*>(st + F::kB), Bm, bn, N, t0, g.S);
    cp_tile<N, NP>(reinterpret_cast<bf16*>(st + F::kC), Cm, bn, N, t0, g.S);
    const float* src = cb + (static_cast<int64_t>(b) * g.NC + c) * kChunk * kChunk;
    float* dst = reinterpret_cast<float*>(st + F::kCb);
    for (int i = tid; i < kChunk * kChunk / 4; i += kTcThreads)
      repro::cp_async16(dst + (i / 16) * kCbF + (i % 16) * 4, src + i * 4, true);
    cp_dt(reinterpret_cast<float*>(st + F::kDt), dt, b, h, t0, g);
  };
  for (int c = 0; c < ST; ++c) {
    if (c < g.NC) load(c);
    repro::cp_async_commit();
  }

  const bool owns = warp < P / 16;           // this warp carries state rows
  const int r0 = warp * 16;                  // its y rows, and its state rows
  const int ta = r0 + gr, tb = ta + 8;
  float hs[NT][4];
  zero(hs);
  if (h0 != nullptr) {
    // the carried state: the owning warps' rows into registers, and as the
    // hi + lo pair that chunk 0's C h^T reads (after the zeroing above)
    __syncthreads();
    if (owns) {
      load_acc<N, NT>(hs, h0 + static_cast<int64_t>(bh) * P * N, r0, lane);
      acc_to_smem<LB, NT>(hh, hl, hs, r0, lane);
    }
  }
  for (int c = 0; c < g.NC; ++c) {
    repro::cp_async_wait<ST - 1>();
    __syncthreads();
    const unsigned char* st = smem + (c % ST) * F::kStage;
    const bf16* x_s = reinterpret_cast<const bf16*>(st + F::kX);
    const bf16* B_s = reinterpret_cast<const bf16*>(st + F::kB);
    const bf16* C_s = reinterpret_cast<const bf16*>(st + F::kC);
    const float* cb_s = reinterpret_cast<const float*>(st + F::kCb);
    const float* dt_s = reinterpret_cast<const float*>(st + F::kDt);
    const int t0 = c * kChunk;
    {
      float ca, cbv;
      const float cT = warp_cum(a, dt_s, cum, ca, cbv);
      wgt[2 * lane] = expf(cT - ca) * dt_s[2 * lane];
      wgt[2 * lane + 1] = expf(cT - cbv) * dt_s[2 * lane + 1];
    }
    __syncwarp();
    if (owns && states != nullptr)
      store_acc<N, NT>(states + (static_cast<int64_t>(bh) * g.NC + c) * P * N, hs, r0, lane);

    // y's rows ta and tb: W x over the u tiles up to the diagonal, then
    // e^{cum_t} C h^T
    {
      const float cum_a = cum[ta], cum_b = cum[tb];
      float yw[PT][4];
      zero(yw);
      for (int j = 0; j <= warp; ++j) {
        float v[8];                          // A fragment order: (ta, tb) x (u, u + 8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = (e & 1) ? tb : ta, u = j * 16 + 2 * q + (e >> 1) * 8;
          const float ct = (e & 1) ? cum_b : cum_a;
          const float2 cbp = *reinterpret_cast<const float2*>(cb_s + t * kCbF + u);
          v[2 * e] = u <= t ? expf(ct - cum[u]) * cbp.x * dt_s[u] : 0.f;
          v[2 * e + 1] = u + 1 <= t ? expf(ct - cum[u + 1]) * cbp.y * dt_s[u + 1] : 0.f;
        }
        uint32_t wh[4], wl[4];
        repro::split_bf16(wh, wl, v);
        mma_a<PT>(yw, wh, wl, [&](uint32_t (&bb)[4], int n0) {
          repro::frag_b<LX>(bb, x_s, j * 16, n0, lane);
        });
      }
      float yc[PT][4];
      zero(yc);
      gemm_b2<PT, NP / 16>(
          yc, [&](uint32_t (&ca4)[4], int kk) { repro::frag_a<LB>(ca4, C_s, r0, kk * 16, lane); },
          [&](uint32_t (&bb)[4], int kk, int n0) { repro::frag_bt<LB>(bb, hh, n0, kk * 16, lane); },
          [&](uint32_t (&bb)[4], int kk, int n0) { repro::frag_bt<LB>(bb, hl, n0, kk * 16, lane); });
      const float head_a = expf(cum_a), head_b = expf(cum_b);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = t0 + (r ? tb : ta);
        if (row >= g.S) continue;
        const float hd = r ? head_b : head_a;
        bf16* yrow = y + ((static_cast<int64_t>(b) * g.S + row) * g.H + h) * P + 2 * q;
#pragma unroll
        for (int n = 0; n < PT; ++n)
          *reinterpret_cast<uint32_t*>(yrow + n * 8) =
              repro::pack_f32_bf16(yw[n][2 * r] + hd * yc[n][2 * r],
                                   yw[n][2 * r + 1] + hd * yc[n][2 * r + 1]);
      }
    }

    if (owns) {
      const float dec = expf(cum[kChunk - 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[n][e] *= dec;
      state_update<LX, LB, NT>(hs, x_s, B_s, wgt, r0, lane);
    }
    __syncthreads();                         // every read of this stage and of h is done
    if (owns) acc_to_smem<LB, NT>(hh, hl, hs, r0, lane);
    if (c + ST < g.NC) load(c + ST);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();
  if (owns) store_acc<N, NT>(h_final + static_cast<int64_t>(bh) * P * N, hs, r0, lane);
}

// ---------------------------------------------------------------------------
// bf16 backward, pass 1: the reverse walk of dS per (batch, head)
// ---------------------------------------------------------------------------
//
// dS_c, the gradient of chunk c's exit state, for every chunk: dS_{NC-1} =
// 0 and dS_{c-1} = e^{cT_c} dS_c + (head dy)^T C over chunk c.  Like the
// forward's state, a row p of dS depends only on dy's column p: warp w
// carries rows 16 w.. in registers.  dy, C and dt come in by cp.async in a
// 3-stage ring (the walk does little else).  Writes dstates [B, H, NC, P,
// N] f32.

template <int P, int N> struct WalkTc {
  static constexpr int NP = pad16<N>();
  static constexpr int LX = lds<P>();
  static constexpr int LB = lds<NP>();
  static constexpr int kStages = 3;
  static constexpr int kDy = 0;                                  // [64][LX] bf16
  static constexpr int kC = kDy + kChunk * LX * 2;               // [64][LB] bf16
  static constexpr int kDt = kC + kChunk * LB * 2;               // [64] f32
  static constexpr int kStage = kDt + kChunk * 4;
  static constexpr int kW = kStages * kStage;                    // a warp's cum, weight
  static constexpr size_t kSmem = kW + kTcWarps * 2 * kChunk * 4;
};

template <int P, int N>
__global__ void __launch_bounds__(kTcThreads)
mamba2_bwd_walk_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                       const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                       float* __restrict__ dstates, Geo g) {
  using F = WalkTc<P, N>;
  constexpr int NP = F::NP, LX = F::LX, LB = F::LB, ST = F::kStages, NT = NP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float a = A[h];
  float* cum = reinterpret_cast<float*>(smem + F::kW) + warp * 2 * kChunk;
  float* wgt = cum + kChunk;                 // head_t
  for (int s = 0; s < ST; ++s)
    zero_pad_cols<N, NP>(reinterpret_cast<bf16*>(smem + s * F::kStage + F::kC), kChunk);
  auto load = [&](int i) {                   // the i-th chunk from the end
    unsigned char* st = smem + (i % ST) * F::kStage;
    const int t0 = (g.NC - 1 - i) * kChunk;
    cp_tile<P, P>(reinterpret_cast<bf16*>(st + F::kDy), dy,
                  static_cast<int64_t>(b) * g.S * g.H * P + static_cast<int64_t>(h) * P,
                  static_cast<int64_t>(g.H) * P, t0, g.S);
    cp_tile<N, NP>(reinterpret_cast<bf16*>(st + F::kC), Cm, static_cast<int64_t>(b) * g.S * N, N,
                   t0, g.S);
    cp_dt(reinterpret_cast<float*>(st + F::kDt), dt, b, h, t0, g);
  };
  for (int i = 0; i < ST; ++i) {
    if (i < g.NC) load(i);
    repro::cp_async_commit();
  }
  const bool owns = warp < P / 16;
  const int r0 = warp * 16;
  float ds[NT][4];
  zero(ds);
  for (int i = 0; i < g.NC; ++i) {
    const int c = g.NC - 1 - i;
    repro::cp_async_wait<ST - 1>();
    __syncthreads();
    const unsigned char* st = smem + (i % ST) * F::kStage;
    const bf16* dy_s = reinterpret_cast<const bf16*>(st + F::kDy);
    const bf16* C_s = reinterpret_cast<const bf16*>(st + F::kC);
    const float* dt_s = reinterpret_cast<const float*>(st + F::kDt);
    float ca, cbv;
    const float cT = warp_cum(a, dt_s, cum, ca, cbv);
    wgt[2 * lane] = expf(ca);
    wgt[2 * lane + 1] = expf(cbv);
    __syncwarp();
    if (owns) {
      store_acc<N, NT>(dstates + (static_cast<int64_t>(bh) * g.NC + c) * P * N, ds, r0, lane);
      const float dec = expf(cT);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[n][e] *= dec;
      state_update<LX, LB, NT>(ds, dy_s, C_s, wgt, r0, lane);
    }
    __syncthreads();                         // the stage is read
    if (i + ST < g.NC) load(i + ST);
    repro::cp_async_commit();
  }
  repro::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// bf16 backward, pass 2: every gradient of a chunk from (h0, dS)
// ---------------------------------------------------------------------------
//
// One block per (batch, chunk, group of G heads); 4 warps, warp w the rows
// t = 16 w.. of the chunk.  B, C and C B^T are staged once a block; per
// head x, dy and dt come in by cp.async, and h0 and dS (f32) through
// registers into bf16 hi + lo tiles (their dot product on the way).  For
// the warp's rows (A operands in f32 are hi + lo pairs; x, dy, B, C exact):
//   gB = M^T dy (s tiles from the diagonal on) + tail B dS^T;
//        dx = dt gB, e = x . gB
//   dB = dt (Q^T C + tail x dS),  Q^T[t][s] = L[s,t] (x_t . dy_s) from an
//        exact x dy^T;  xd = B . (x dS)
//   dC = head dy h0 + (Q dt) B,  Q[t][u] = L[t,u] (dy_t . x_u) from an exact
//        dy x^T;  hc = C . (dy h0)
//   K[t][u] = Q[t][u] dt_u CB[t][u]: exclusive row prefixes along u in
//        registers (quad scans), then sums down the rows s >= j over the
//        warp's rows (shuffles), one partial a warp and column.
// Warp 0 then forms dl_j from the four warps' column partials, the suffix
// of head hc, the prefix of tail dt xd (shuffle scans) and e^{cT} <dS,
// h0>, and writes ddt and the head's dA partial.  dB and dC add up over
// the group's heads in registers, in head order.

template <int P, int N> struct BwdTc {
  static constexpr int NP = pad16<N>();
  static constexpr int LX = lds<P>();
  static constexpr int LB = lds<NP>();
  static constexpr int kB = 0;                                   // [64][LB] bf16
  static constexpr int kC = kB + kChunk * LB * 2;
  static constexpr int kCb = kC + kChunk * LB * 2;               // [64][kCbB] f32
  static constexpr int kX = kCb + kChunk * kCbB * 4;             // [64][LX] bf16
  static constexpr int kDy = kX + kChunk * LX * 2;
  static constexpr int kDt = kDy + kChunk * LX * 2;              // [64] f32
  static constexpr int kS = kDt + kChunk * 4;                    // h0 hi, lo, dS hi, lo [P][LB]
  static constexpr int kCum = kS + 4 * P * LB * 2;               // a warp's cum [64]
  static constexpr int kRow = kCum + kTcWarps * kChunk * 4;      // e, xd, hc [64]
  static constexpr int kCol = kRow + 3 * kChunk * 4;             // [warps][64] column partials
  static constexpr int kRed = kCol + kTcWarps * kChunk * 4;      // [2][warps] <dS, h0> partials
  static constexpr size_t kSmem = kRed + 2 * kTcWarps * 4;
};

template <int P, int N>
__global__ void __launch_bounds__(kTcThreads, 2)
mamba2_bwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                     const float* __restrict__ cb, const float* __restrict__ states,
                     const float* __restrict__ dstates, bf16* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dB_part,
                     float* __restrict__ dC_part, float* __restrict__ dA_part, Geo g, int G,
                     int NG) {
  using F = BwdTc<P, N>;
  constexpr int NP = F::NP, LX = F::LX, LB = F::LB;
  constexpr int PT = P / 8, NT = NP / 8, KP = P / 16, KN = NP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = blockIdx.x % NG, c = (blockIdx.x / NG) % g.NC, b = blockIdx.x / (NG * g.NC);
  const int t0 = c * kChunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, q = lane & 3;
  bf16* B_s = reinterpret_cast<bf16*>(smem + F::kB);
  bf16* C_s = reinterpret_cast<bf16*>(smem + F::kC);
  float* cb_s = reinterpret_cast<float*>(smem + F::kCb);
  bf16* x_s = reinterpret_cast<bf16*>(smem + F::kX);
  bf16* dy_s = reinterpret_cast<bf16*>(smem + F::kDy);
  float* dt_s = reinterpret_cast<float*>(smem + F::kDt);
  bf16* h0h = reinterpret_cast<bf16*>(smem + F::kS);
  bf16* h0l = h0h + P * LB;
  bf16* dSh = h0l + P * LB;
  bf16* dSl = dSh + P * LB;
  float* cum = reinterpret_cast<float*>(smem + F::kCum) + warp * kChunk;
  float* e_s = reinterpret_cast<float*>(smem + F::kRow);
  float* xd_s = e_s + kChunk;
  float* hc_s = xd_s + kChunk;
  float* colp = reinterpret_cast<float*>(smem + F::kCol);
  float* red = reinterpret_cast<float*>(smem + F::kRed);

  zero_pad_cols<N, NP>(B_s, kChunk);
  zero_pad_cols<N, NP>(C_s, kChunk);
  for (int i = 0; i < 4; ++i) zero_pad_cols<N, NP>(h0h + i * P * LB, P);
  {
    const int64_t bn = static_cast<int64_t>(b) * g.S * N;
    cp_tile<N, NP>(B_s, Bm, bn, N, t0, g.S);
    cp_tile<N, NP>(C_s, Cm, bn, N, t0, g.S);
    const float* src = cb + (static_cast<int64_t>(b) * g.NC + c) * kChunk * kChunk;
    for (int i = tid; i < kChunk * kChunk / 4; i += kTcThreads)
      repro::cp_async16(cb_s + (i / 16) * kCbB + (i % 16) * 4, src + i * 4, true);
  }

  const int r0 = warp * 16, ta = r0 + gr, tb = ta + 8;
  float dBa[NT][4], dCa[NT][4];
  zero(dBa);
  zero(dCa);
  const int h_end = min(g.H, (grp + 1) * G);
  for (int h = grp * G, it = 0; h < h_end; ++h, ++it) {
    const int64_t xo = static_cast<int64_t>(b) * g.S * g.H * P + static_cast<int64_t>(h) * P;
    cp_tile<P, P>(x_s, x, xo, static_cast<int64_t>(g.H) * P, t0, g.S);
    cp_tile<P, P>(dy_s, dy, xo, static_cast<int64_t>(g.H) * P, t0, g.S);
    cp_dt(dt_s, dt, b, h, t0, g);
    repro::cp_async_commit();
    {
      const int64_t so = ((static_cast<int64_t>(b) * g.H + h) * g.NC + c) * P * N;
      float dot = 0.f;
      for (int i = tid * 4; i < P * N; i += kTcThreads * 4) {
        const float4 hv = *reinterpret_cast<const float4*>(states + so + i);
        const float4 dv = *reinterpret_cast<const float4*>(dstates + so + i);
        dot += hv.x * dv.x + hv.y * dv.y + hv.z * dv.z + hv.w * dv.w;
        const int off = (i / N) * LB + i % N;
        f4_to_smem(h0h, h0l, off, hv);
        f4_to_smem(dSh, dSl, off, dv);
      }
      dot = repro::warp_sum(dot);
      if (lane == 0) red[(it & 1) * kTcWarps + warp] = dot;
    }
    repro::cp_async_wait<0>();
    __syncthreads();

    const float a = A[h];
    float ca, cbv;                           // warp 0's rows 2 lane, 2 lane + 1 (dl below)
    const float cT = warp_cum(a, dt_s, cum, ca, cbv);
    const float dt_la = dt_s[2 * lane], dt_lb = dt_s[2 * lane + 1];
    __syncwarp();
    const float cum_a = cum[ta], cum_b = cum[tb];
    const float dt_a = dt_s[ta], dt_b = dt_s[tb];
    const float tail_a = expf(cT - cum_a), tail_b = expf(cT - cum_b);
    const float head_a = expf(cum_a), head_b = expf(cum_b);

    // gB = M^T dy + tail B dS^T; dx = dt gB; e = x . gB
    {
      float gb[PT][4];
      zero(gb);
      for (int j = warp; j < kChunk / 16; ++j) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = (e & 1) ? tb : ta, s = j * 16 + 2 * q + (e >> 1) * 8;
          const float ct = (e & 1) ? cum_b : cum_a;
          v[2 * e] = s >= t ? expf(cum[s] - ct) * cb_s[s * kCbB + t] : 0.f;
          v[2 * e + 1] = s + 1 >= t ? expf(cum[s + 1] - ct) * cb_s[(s + 1) * kCbB + t] : 0.f;
        }
        uint32_t mh[4], ml[4];
        repro::split_bf16(mh, ml, v);
        mma_a<PT>(gb, mh, ml, [&](uint32_t (&bb)[4], int n0) {
          repro::frag_b<LX>(bb, dy_s, j * 16, n0, lane);
        });
      }
      float g2[PT][4];
      zero(g2);
      gemm_b2<PT, KN>(
          g2, [&](uint32_t (&ba)[4], int kk) { repro::frag_a<LB>(ba, B_s, r0, kk * 16, lane); },
          [&](uint32_t (&bb)[4], int kk, int n0) { repro::frag_bt<LB>(bb, dSh, n0, kk * 16, lane); },
          [&](uint32_t (&bb)[4], int kk, int n0) { repro::frag_bt<LB>(bb, dSl, n0, kk * 16, lane); });
      float ev[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r ? tb : ta;
        const float tl = r ? tail_b : tail_a, dtt = r ? dt_b : dt_a;
        bf16* drow = dx + ((static_cast<int64_t>(b) * g.S + t0 + t) * g.H + h) * P + 2 * q;
#pragma unroll
        for (int n = 0; n < PT; ++n) {
          const float g0 = gb[n][2 * r] + tl * g2[n][2 * r];
          const float g1 = gb[n][2 * r + 1] + tl * g2[n][2 * r + 1];
          const uint32_t xv = *reinterpret_cast<const uint32_t*>(x_s + t * LX + n * 8 + 2 * q);
          ev[r] += repro::bf16_lo(xv) * g0 + repro::bf16_hi(xv) * g1;
          if (t0 + t < g.S)
            *reinterpret_cast<uint32_t*>(drow + n * 8) = repro::pack_f32_bf16(dtt * g0, dtt * g1);
        }
      }
      ev[0] = quad_sum(ev[0]);
      ev[1] = quad_sum(ev[1]);
      if (q == 0) {
        e_s[ta] = ev[0];
        e_s[tb] = ev[1];
      }
    }

    // dB += dt (Q^T C + tail x dS); xd = B . (x dS)
    {
      float dq[NT][4];
      zero(dq);
      for (int j = warp; j < kChunk / 16; ++j) {
        float xy[2][4];                      // x_t . dy_s for s in tile j
        zero(xy);
        gemm_exact<2, KP>(
            xy, [&](uint32_t (&xa)[4], int kk) { repro::frag_a<LX>(xa, x_s, r0, kk * 16, lane); },
            [&](uint32_t (&bb)[4], int kk, int n0) {
              repro::frag_bt<LX>(bb, dy_s, j * 16 + n0, kk * 16, lane);
            });
        float v[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = (e & 1) ? tb : ta, s = j * 16 + 2 * q + (e >> 1) * 8;
          const float ct = (e & 1) ? cum_b : cum_a;
          v[2 * e] = s >= t ? expf(cum[s] - ct) * xy[e >> 1][(e & 1) * 2] : 0.f;
          v[2 * e + 1] = s + 1 >= t ? expf(cum[s + 1] - ct) * xy[e >> 1][(e & 1) * 2 + 1] : 0.f;
        }
        uint32_t qh[4], ql[4];
        repro::split_bf16(qh, ql, v);
        mma_a<NT>(dq, qh, ql, [&](uint32_t (&bb)[4], int n0) {
          repro::frag_b<LB>(bb, C_s, j * 16, n0, lane);
        });
      }
      float xs[NT][4];
      zero(xs);
      gemm_b2<NT, KP>(
          xs, [&](uint32_t (&xa)[4], int kk) { repro::frag_a<LX>(xa, x_s, r0, kk * 16, lane); },
          [&](uint32_t (&bb)[4], int kk, int n0) { repro::frag_b<LB>(bb, dSh, kk * 16, n0, lane); },
          [&](uint32_t (&bb)[4], int kk, int n0) { repro::frag_b<LB>(bb, dSl, kk * 16, n0, lane); });
      float xd[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r ? tb : ta;
        const float tl = r ? tail_b : tail_a, dtt = r ? dt_b : dt_a;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t bv = *reinterpret_cast<const uint32_t*>(B_s + t * LB + n * 8 + 2 * q);
          xd[r] += repro::bf16_lo(bv) * xs[n][2 * r] + repro::bf16_hi(bv) * xs[n][2 * r + 1];
          dBa[n][2 * r] += dtt * (dq[n][2 * r] + tl * xs[n][2 * r]);
          dBa[n][2 * r + 1] += dtt * (dq[n][2 * r + 1] + tl * xs[n][2 * r + 1]);
        }
      }
      xd[0] = quad_sum(xd[0]);
      xd[1] = quad_sum(xd[1]);
      if (q == 0) {
        xd_s[ta] = xd[0];
        xd_s[tb] = xd[1];
      }
    }

    // dC += head dy h0 + (Q dt) B; hc = C . (dy h0); K's column partials
    {
      float dh[NT][4];
      zero(dh);
      gemm_b2<NT, KP>(
          dh, [&](uint32_t (&da)[4], int kk) { repro::frag_a<LX>(da, dy_s, r0, kk * 16, lane); },
          [&](uint32_t (&bb)[4], int kk, int n0) { repro::frag_b<LB>(bb, h0h, kk * 16, n0, lane); },
          [&](uint32_t (&bb)[4], int kk, int n0) { repro::frag_b<LB>(bb, h0l, kk * 16, n0, lane); });
      float hc[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r ? tb : ta;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t cv = *reinterpret_cast<const uint32_t*>(C_s + t * LB + n * 8 + 2 * q);
          hc[r] += repro::bf16_lo(cv) * dh[n][2 * r] + repro::bf16_hi(cv) * dh[n][2 * r + 1];
        }
      }
      hc[0] = quad_sum(hc[0]);
      hc[1] = quad_sum(hc[1]);
      if (q == 0) {
        hc_s[ta] = hc[0];
        hc_s[tb] = hc[1];
      }
      float dc[NT][4];
      zero(dc);
      float base[2] = {0.f, 0.f};            // sum of K over the row's earlier u tiles
      for (int j = 0; j <= warp; ++j) {
        float yx[2][4];                      // dy_t . x_u for u in tile j
        zero(yx);
        gemm_exact<2, KP>(
            yx, [&](uint32_t (&da)[4], int kk) { repro::frag_a<LX>(da, dy_s, r0, kk * 16, lane); },
            [&](uint32_t (&bb)[4], int kk, int n0) {
              repro::frag_bt<LX>(bb, x_s, j * 16 + n0, kk * 16, lane);
            });
        float v[8], kv[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = (e & 1) ? tb : ta, u = j * 16 + 2 * q + (e >> 1) * 8;
          const float ct = (e & 1) ? cum_b : cum_a;
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const int uu = u + d;
            v[2 * e + d] = uu <= t ? expf(ct - cum[uu]) * yx[e >> 1][(e & 1) * 2 + d] * dt_s[uu]
                                   : 0.f;
            kv[2 * e + d] = v[2 * e + d] * cb_s[t * kCbB + uu];
          }
        }
        uint32_t qh[4], ql[4];
        repro::split_bf16(qh, ql, v);
        mma_a<NT>(dc, qh, ql, [&](uint32_t (&bb)[4], int n0) {
          repro::frag_b<LB>(bb, B_s, j * 16, n0, lane);
        });
        // R[t][u'] = sum_{u < u'} K[t][u] at this lane's columns u' = j 16 +
        // 2 q (+1, +8, +9), rows ta (e = 0, 2) and tb (e = 1, 3)
        float R[4][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float s1 = kv[2 * r] + kv[2 * r + 1];          // columns 2 q, 2 q + 1
          const float s2 = kv[2 * r + 4] + kv[2 * r + 5];      // columns 8 + 2 q, + 1
          const float ex1 = quad_excl(s1), tot1 = quad_sum(s1);
          const float ex2 = quad_excl(s2), tot2 = quad_sum(s2);
          R[0][r] = base[r] + ex1;
          R[1][r] = R[0][r] + kv[2 * r];
          R[2][r] = base[r] + tot1 + ex2;
          R[3][r] = R[2][r] + kv[2 * r + 4];
          base[r] += tot1 + tot2;
        }
        // sum over the warp's rows t >= u' (lanes with the same q)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int col = j * 16 + 2 * q + (k >> 1) * 8 + (k & 1);
          float s = (ta >= col ? R[k][0] : 0.f) + (tb >= col ? R[k][1] : 0.f);
          s += __shfl_xor_sync(kFull, s, 4);
          s += __shfl_xor_sync(kFull, s, 8);
          s += __shfl_xor_sync(kFull, s, 16);
          if (gr == 0) colp[warp * kChunk + col] = s;
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        dCa[n][0] += head_a * dh[n][0] + dc[n][0];
        dCa[n][1] += head_a * dh[n][1] + dc[n][1];
        dCa[n][2] += head_b * dh[n][2] + dc[n][2];
        dCa[n][3] += head_b * dh[n][3] + dc[n][3];
      }
    }
    __syncthreads();

    // warp 0: dl_j for j = 2 lane, 2 lane + 1; ddt; the head's dA partial
    if (warp == 0) {
      const int ja = 2 * lane, jb = ja + 1;
      float intra_a = 0.f, intra_b = 0.f;
      for (int w = ja / 16; w < kTcWarps; ++w) {
        intra_a += colp[w * kChunk + ja];
        intra_b += colp[w * kChunk + jb];
      }
      // sum_{s >= j} head_s hc_s: a suffix scan over the lanes
      const float ha = expf(ca) * hc_s[ja], hb = expf(cbv) * hc_s[jb];
      float suf = ha + hb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(kFull, suf, o);
        if (lane + o < 32) suf += v;
      }
      float later = __shfl_down_sync(kFull, suf, 1);
      if (lane == 31) later = 0.f;
      const float suf_b = later + hb, suf_a = suf_b + ha;
      // sum_{u < j} tail_u dt_u xd_u: a prefix scan
      const float pa = expf(cT - ca) * dt_la * xd_s[ja], pb = expf(cT - cbv) * dt_lb * xd_s[jb];
      float pre = pa + pb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(kFull, pre, o);
        if (lane >= o) pre += v;
      }
      float before = __shfl_up_sync(kFull, pre, 1);
      if (lane == 0) before = 0.f;
      const float pre_a = before, pre_b = before + pa;
      const float* rd = red + (it & 1) * kTcWarps;
      const float cst = expf(cT) * (rd[0] + rd[1] + rd[2] + rd[3]);
      const float dl_a = intra_a + suf_a + pre_a + cst;
      const float dl_b = intra_b + suf_b + pre_b + cst;
      float* drow = ddt + (static_cast<int64_t>(b) * g.S + t0) * g.H + h;
      if (t0 + ja < g.S) drow[static_cast<int64_t>(ja) * g.H] = e_s[ja] + a * dl_a;
      if (t0 + jb < g.S) drow[static_cast<int64_t>(jb) * g.H] = e_s[jb] + a * dl_b;
      const float da = repro::warp_sum(dt_la * dl_a + dt_lb * dl_b);
      if (lane == 0) dA_part[(static_cast<int64_t>(b) * g.NC + c) * g.H + h] = da;
    }
  }

  // this group's dB and dC partials: [B, S, NG, N]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + (r ? tb : ta);
    if (row >= g.S) continue;
    const int64_t off = ((static_cast<int64_t>(b) * g.S + row) * NG + grp) * N + 2 * q;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n * 8 + 2 * q >= N) continue;
      *reinterpret_cast<float2*>(dB_part + off + n * 8) = make_float2(dBa[n][2 * r], dBa[n][2 * r + 1]);
      *reinterpret_cast<float2*>(dC_part + off + n * 8) = make_float2(dCa[n][2 * r], dCa[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// the last pass of both backwards, and the launchers
// ---------------------------------------------------------------------------

// dB[r][n] = sum_k dB_part[r][k][n] over the NG groups (bf16: head groups;
// f32: heads) in order, and dC alike, rounded to the working dtype; dA[h] =
// sum_i dA_part[i][h] over the n_part (batch, chunk) or batch partials in
// order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_bwd_sum_kernel(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                      const float* __restrict__ dA_part, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA, int64_t rows, int N, int NG, int n_part, int H) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t i = i0; i < rows * N; i += stride) {
    const int64_t base = (i / N) * NG * N + i % N;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < NG; ++k) {
      sb += dB_part[base + static_cast<int64_t>(k) * N];
      sc += dC_part[base + static_cast<int64_t>(k) * N];
    }
    dB[i] = repro::from_f32<T>(sb);
    dC[i] = repro::from_f32<T>(sc);
  }
  for (int64_t j = i0; j < H; j += stride) {
    float s = 0.f;
    for (int k = 0; k < n_part; ++k) s += dA_part[static_cast<int64_t>(k) * H + j];
    dA[j] = s;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t bwd_sum(const float* dB_part, const float* dC_part, const float* dA_part, void* dB,
                    void* dC, float* dA, const Geo& g, int N, int NG, int n_part, int grid,
                    cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(g.B) * g.S;
  mamba2_bwd_sum_kernel<T><<<grid, kThreads, 0, s>>>(
      dB_part, dC_part, dA_part, static_cast<T*>(dB), static_cast<T*>(dC), dA, rows, N, NG,
      n_part, g.H);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t fwd_f32(const void* x, const float* dt, const float* A, const void* Bm,
                    const void* Cm, const float* h0, void* y, float* h_final, float* states,
                    const Geo& g, cudaStream_t s) {
  auto kern = mamba2_fwd_kernel<P, N>;
  if (cudaError_t e = allow_smem(kern, fwd_smem<P, N>())) return e;
  kern<<<g.B * g.H, kThreads, fwd_smem<P, N>(), s>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), h0, static_cast<float*>(y), h_final, states, g);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t fwd_bf16(const void* x, const float* dt, const float* A, const void* Bm,
                     const void* Cm, const float* h0, void* y, float* h_final, float* states,
                     float* cb, const Geo& g, cudaStream_t s) {
  const bf16* Bp = static_cast<const bf16*>(Bm);
  const bf16* Cp = static_cast<const bf16*>(Cm);
  mamba2_fwd_cb_kernel<N><<<g.B * g.NC, kTcThreads, 0, s>>>(Bp, Cp, cb, g);
  if (cudaError_t e = cudaGetLastError()) return e;
  auto kern = mamba2_fwd_tc_kernel<P, N>;
  constexpr size_t smem = FwdTc<P, N>::kSmem;
  if (cudaError_t e = allow_smem(kern, smem)) return e;
  kern<<<g.B * g.H, kTcThreads, smem, s>>>(static_cast<const bf16*>(x), dt, A, Bp, Cp, cb, h0,
                                           static_cast<bf16*>(y), h_final, states, g);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t bwd_f32(const void* x, const float* dt, const float* A, const void* Bm,
                    const void* Cm, const void* dy, const float* states, void* dx, float* ddt,
                    float* dA, void* dB, void* dC, float* dB_part, float* dC_part,
                    float* dA_part, int sum_grid, const Geo& g, cudaStream_t s) {
  auto kern = mamba2_bwd_kernel<P, N>;
  if (cudaError_t e = allow_smem(kern, bwd_smem<P, N>())) return e;
  kern<<<g.B * g.H, kThreads, bwd_smem<P, N>(), s>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dy), states,
      static_cast<float*>(dx), ddt, dB_part, dC_part, dA_part, g);
  if (cudaError_t e = cudaGetLastError()) return e;
  return bwd_sum<float>(dB_part, dC_part, dA_part, dB, dC, dA, g, N, g.H, g.B, sum_grid, s);
}

template <int P, int N>
cudaError_t bwd_bf16(const void* x, const float* dt, const float* A, const void* Bm,
                     const void* Cm, const void* dy, const float* states, void* dx, float* ddt,
                     float* dA, void* dB, void* dC, float* dB_part, float* dC_part,
                     float* dA_part, float* cb, float* dstates, int G, int sum_grid,
                     const Geo& g, cudaStream_t s) {
  const bf16* Bp = static_cast<const bf16*>(Bm);
  const bf16* Cp = static_cast<const bf16*>(Cm);
  const bf16* dyp = static_cast<const bf16*>(dy);
  const int NG = (g.H + G - 1) / G;
  mamba2_bwd_cb_kernel<N><<<g.B * g.NC, kTcThreads, 0, s>>>(Bp, Cp, cb, g);
  if (cudaError_t e = cudaGetLastError()) return e;
  auto walk = mamba2_bwd_walk_kernel<P, N>;
  constexpr size_t walk_smem = WalkTc<P, N>::kSmem;
  if (cudaError_t e = allow_smem(walk, walk_smem)) return e;
  walk<<<g.B * g.H, kTcThreads, walk_smem, s>>>(dt, A, Cp, dyp, dstates, g);
  if (cudaError_t e = cudaGetLastError()) return e;
  auto grad = mamba2_bwd_tc_kernel<P, N>;
  constexpr size_t grad_smem = BwdTc<P, N>::kSmem;
  if (cudaError_t e = allow_smem(grad, grad_smem)) return e;
  grad<<<g.B * g.NC * NG, kTcThreads, grad_smem, s>>>(
      static_cast<const bf16*>(x), dt, A, Bp, Cp, dyp, cb, states, dstates,
      static_cast<bf16*>(dx), ddt, dB_part, dC_part, dA_part, g, G, NG);
  if (cudaError_t e = cudaGetLastError()) return e;
  return bwd_sum<bf16>(dB_part, dC_part, dA_part, dB, dC, dA, g, N, NG, g.B * g.NC, sum_grid,
                       s);
}

template <int P, int N>
cudaError_t bwd_occupancy(int* blocks) {
  auto grad = mamba2_bwd_tc_kernel<P, N>;
  constexpr size_t smem = BwdTc<P, N>::kSmem;
  if (cudaError_t e = allow_smem(grad, smem)) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, grad, kTcThreads, smem);
}

}  // namespace

#define REPRO_MAMBA_SHAPES(SHAPE_CASE) SHAPE_CASE(64, 64) SHAPE_CASE(16, 8)

// x [B, S, H, P] (dtype), dt [B, S, H] f32, A [H] f32, B, C [B, S, N] (dtype)
// and the initial state h0 [B, H, P, N] f32 (null: zeros; 8-byte aligned)
// -> y like x, h_final [B, H, P, N] f32 and, unless states is null, the
// state at each chunk's entry [B, H, ceil(S / 64), P, N] f32.  bf16 takes
// the scratch cb [B, ceil(S / 64), 64, 64] f32 (C B^T); f32 ignores it.
extern "C" int repro_mamba2_fwd(int dtype, const void* x, const float* dt, const float* A,
                                const void* Bm, const void* Cm, const float* h0, void* y,
                                float* h_final, float* states, float* cb, int B, int S, int H,
                                int P, int N, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, S, H, (S + kChunk - 1) / kChunk};
#define REPRO_FWD_CASE(PP, NN)                                                         \
  if (P == PP && N == NN)                                                              \
    return dtype == repro::kBF16                                                       \
               ? fwd_bf16<PP, NN>(x, dt, A, Bm, Cm, h0, y, h_final, states, cb, g, s)  \
               : fwd_f32<PP, NN>(x, dt, A, Bm, Cm, h0, y, h_final, states, g, s);
  if ((dtype != repro::kF32 && dtype != repro::kBF16) || (dtype == repro::kBF16 && !cb))
    return cudaErrorInvalidValue;
  REPRO_MAMBA_SHAPES(REPRO_FWD_CASE)
#undef REPRO_FWD_CASE
  return cudaErrorInvalidValue;
}

// The backward of repro_mamba2_fwd for the output gradient dy (a zero
// gradient on h_final), from the chunk-entry states the forward wrote: dx
// like x; ddt [B, S, H] f32; dA [H] f32; dB, dC like B.  Scratch, all f32:
// dB_part, dC_part [B, S, NG, N] and dA_part [n_part, H], with NG = ceil(H
// / G) and n_part = B * ceil(S / 64) in bf16, NG = H and n_part = B in f32;
// in bf16 also cb [B, ceil(S / 64), 64, 64] and dstates like states (f32
// takes null for both and ignores G).  sum_grid: the blocks of the last
// pass's grid-stride loop over max(B S N, H) items
// (kernels/_build.py:stride_grid).
extern "C" int repro_mamba2_bwd(int dtype, const void* x, const float* dt, const float* A,
                                const void* Bm, const void* Cm, const void* dy,
                                const float* states, void* dx, float* ddt, float* dA, void* dB,
                                void* dC, float* dB_part, float* dC_part, float* dA_part,
                                float* cb, float* dstates, int G, int B, int S, int H, int P,
                                int N, int sum_grid, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, S, H, (S + kChunk - 1) / kChunk};
#define REPRO_BWD_CASE(PP, NN)                                                                \
  if (P == PP && N == NN)                                                                     \
    return dtype == repro::kBF16                                                              \
               ? bwd_bf16<PP, NN>(x, dt, A, Bm, Cm, dy, states, dx, ddt, dA, dB, dC, dB_part, \
                                  dC_part, dA_part, cb, dstates, G, sum_grid, g, s)           \
               : bwd_f32<PP, NN>(x, dt, A, Bm, Cm, dy, states, dx, ddt, dA, dB, dC, dB_part,  \
                                 dC_part, dA_part, sum_grid, g, s);
  if ((dtype != repro::kF32 && dtype != repro::kBF16) ||
      (dtype == repro::kBF16 && (!cb || !dstates || G <= 0)) || sum_grid <= 0)
    return cudaErrorInvalidValue;
  REPRO_MAMBA_SHAPES(REPRO_BWD_CASE)
#undef REPRO_BWD_CASE
  return cudaErrorInvalidValue;
}

// The blocks of the bf16 gradient kernel (the backward's chunk-parallel
// pass) that one SM of the current device holds at once, from the kernel's
// registers and shared memory: the input of the host's head-group plan.
extern "C" int repro_mamba2_bwd_occupancy(int P, int N, int* blocks) {
#define REPRO_OCC_CASE(PP, NN) \
  if (P == PP && N == NN) return bwd_occupancy<PP, NN>(blocks);
  REPRO_MAMBA_SHAPES(REPRO_OCC_CASE)
#undef REPRO_OCC_CASE
  return cudaErrorInvalidValue;
}
