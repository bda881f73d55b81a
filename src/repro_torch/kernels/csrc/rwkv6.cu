// RWKV-6 wkv recurrence, chunked: the forward (o and the final state, and
// for training the state at each chunk's entry) and its backward.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_chunk.py (rwkv6_chunked,
// pallas_call at :87), which has no backward of its own: the JAX package
// differentiates its oracle.  Per (batch, head) the state S [D, D] (key dim
// first) is carried in f32 across chunks of T rows, from zero (training) or
// from a state S0 the caller carries in (recurrent serving: a slot's state
// between prefill chunks; the TPU path runs its plain chunked scan there,
// src/repro/kernels/ops.py:247-253, so the forward with S0 replaces none):
//
//   o_t   = (r_t e^{cin_t}) S + sum_{u<t} att[t,u] v_u + (r_t u k_t) v_t
//   att[t,u] = sum_c r_t[c] e^{cin_t[c] - cum_u[c]} k_u[c]        (u < t)
//   S    <- diag(e^{cT}) S + sum_u (k_u e^{cT - cum_u}) v_u^T
//
// with cum the inclusive running sum of log max(w, 1e-20) within the chunk,
// cin = cum - log w and cT = cum at the chunk's last row.  Every exponent is
// <= 0: the pairwise term is computed only for u < t (the TPU kernel takes
// exp of the whole [T, T, D] block and masks afterwards, and for u >= t the
// exponent reaches ~46 T, inf in f32).
//
// Layouts are the model's, used as they are: r, k, v, do, o [B, S, H, D] in
// the working dtype; w [B, S, H, D] f32; u [H, D] f32.  The ragged last
// chunk is masked in the kernel (padded rows read k = v = r = do = 0 and
// w = 1, which leaves the recurrence untouched); the host does no
// transpose or padding.  For training the forward also writes the state at
// each chunk's entry ([B, H, NC, D, D] f32), which the backward reads.
// Bound on the H100: bytes (r, k, v, o in bf16, w and the states in f32; a
// few FLOPs a byte).  No atomics in either form: two runs give the same
// bits.  Two forms:
//
// * bf16 (below "bf16: chunk-parallel passes"), T = 64, every pass but one
//   trivial scan chunk-parallel, one block of 4 warps per (batch, chunk,
//   head) on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out).  The
//   forward is three launches: the chunks' state increments, an in-place
//   scan of them into the chunk-entry states (one thread per four state
//   values walks the chunks), then each chunk's output from its entry
//   state.  The backward mirrors it: the gradient increments, a reverse
//   scan into each chunk's exit-state gradient, then every gradient of a
//   chunk from that and its entry state alone, the decay's by the four
//   chunk-local groups of pairs (no running sum across chunks); a last
//   launch sums du's (batch, chunk) partials in order.  r, k, v and do
//   are exact in bf16; every f32 operand (decays, states, their gradients,
//   do . v, the scores) enters a product as a bf16 hi + lo pair, and each
//   16-deep piece's tensor-core sum is added on the CUDA cores.
// * f32 (the fp32 parity runs), T = 32, on the CUDA cores: one block of 256
//   threads per (batch, head) scans the chunks in order with the state in
//   shared memory.  Thread roles, with RG = 256 / D row groups: a channel
//   scan (thread c < D walks the chunk's rows); att and do . v with one
//   warp per row t and lane u (the chunk is one warp wide); products over
//   the state with thread (column e or channel c = tid % D, group g = tid /
//   D) owning the rows g + RG i.  [T, D] tiles sit in shared memory with a
//   row stride of D + 1 floats, so a warp reading one column across rows
//   touches 32 banks.  The backward is one reverse pass over the chunks
//   per (batch, head), carrying dS, the gradient of the chunk's exit state
//   (dS <- diag(e^{cT}) dS + sum_t (r_t e^{cin_t}) do_t^T), and the
//   running decay sum over later chunks: with dr', dk' the gradients
//   without the bonus term, dl_j = sum_{t>j} r_t dr'_t - sum_{t>=j} k_t
//   dk'_t (a reverse cumulative sum across chunk boundaries).  Each block
//   writes its own du partial, summed over the batch in order.
//
// Both: dw = dl / w where w > 1e-20 and 0 where the clamp holds.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;                 // rows per chunk (one warp wide)
constexpr int kAP = kChunk + 1;            // row stride of a [T, T] tile
constexpr float kFloor = 1e-20f;
static_assert(kChunk == 32, "att and do . v put one row's u on the lanes of a warp");

struct Geo {
  int B, S, H, NC;
};

__device__ __forceinline__ int64_t row_off(const Geo& g, int b, int t, int h, int D) {
  return ((static_cast<int64_t>(b) * g.S + t) * g.H + h) * D;
}

// Load rows t0 .. t0 + T of r, k, v (and do) into [T][D + 1] f32 tiles and
// log max(w, floor) into lw_s; rows past S read 0 (w: 1, log 0).
template <typename T, int D>
__device__ void load_chunk(const Geo& g, int b, int h, int t0, const T* r, const T* k,
                           const T* v, const float* w, const T* dout, float* r_s, float* k_s,
                           float* v_s, float* do_s, float* lw_s) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < kChunk * D; i += kThreads) {
    const int t = i / D, c = i % D, row = t0 + t;
    float rv = 0.f, kv = 0.f, vv = 0.f, dv = 0.f, lw = 0.f;
    if (row < g.S) {
      const int64_t off = row_off(g, b, row, h, D) + c;
      rv = repro::to_f32(r[off]);
      kv = repro::to_f32(k[off]);
      vv = repro::to_f32(v[off]);
      lw = logf(fmaxf(w[off], kFloor));
      if (dout != nullptr) dv = repro::to_f32(dout[off]);
    }
    r_s[t * DP + c] = rv;
    k_s[t * DP + c] = kv;
    v_s[t * DP + c] = vv;
    lw_s[t * DP + c] = lw;
    if (do_s != nullptr) do_s[t * DP + c] = dv;
  }
}

// Thread c < D: turn the log decays in cum_s into the inclusive running sum
// (cin_s the exclusive one), and form rd = r e^{cin}, kd = k e^{cT - cum}
// and dec = e^{cT}; cT_s keeps cT.
template <int D>
__device__ void channel_scan(const float* r_s, const float* k_s, float* cum_s, float* cin_s,
                             float* rd_s, float* kd_s, float* dec_s, float* cT_s) {
  constexpr int DP = D + 1;
  const int c = threadIdx.x;
  if (c >= D) return;
  float acc = 0.f;
  for (int t = 0; t < kChunk; ++t) {
    const float lw = cum_s[t * DP + c];
    cin_s[t * DP + c] = acc;
    acc += lw;
    cum_s[t * DP + c] = acc;
  }
  dec_s[c] = __expf(acc);
  if (cT_s != nullptr) cT_s[c] = acc;
  for (int t = 0; t < kChunk; ++t) {
    rd_s[t * DP + c] = r_s[t * DP + c] * __expf(cin_s[t * DP + c]);
    kd_s[t * DP + c] = k_s[t * DP + c] * __expf(acc - cum_s[t * DP + c]);
  }
}

// att[t][u] for u < t and the bonus r_t . (u k_t) on the diagonal; with
// do_s, also dov[t][u] = do_t . v_u for u <= t.  One warp per row, lane u.
template <int D>
__device__ void pair_tiles(const float* r_s, const float* k_s, const float* v_s,
                           const float* do_s, const float* cum_s, const float* cin_s,
                           const float* u_s, float* att_s, float* dov_s) {
  constexpr int DP = D + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < kChunk; t += kThreads / 32) {
    const int u = lane;
    float a = 0.f, dv = 0.f;
    if (u < t) {
      for (int c = 0; c < D; ++c)
        a += r_s[t * DP + c] * __expf(cin_s[t * DP + c] - cum_s[u * DP + c]) * k_s[u * DP + c];
    } else if (u == t) {
      for (int c = 0; c < D; ++c) a += r_s[t * DP + c] * u_s[c] * k_s[t * DP + c];
    }
    att_s[t * kAP + u] = a;
    if (dov_s != nullptr) {
      if (u <= t)
        for (int e = 0; e < D; ++e) dv += do_s[t * DP + e] * v_s[u * DP + e];
      dov_s[t * kAP + u] = dv;
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (7 * kChunk * (D + 1) + D * D + kChunk * kAP + 2 * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
rwkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ s_final,
                 float* __restrict__ states, Geo g) {
  constexpr int DP = D + 1, RG = kThreads / D, RPT = kChunk / RG, CPT = D / RG;
  static_assert(kThreads % D == 0 && kChunk % RG == 0 && D % RG == 0, "thread tiling");
  extern __shared__ float sm[];
  float* r_s = sm;
  float* k_s = r_s + kChunk * DP;
  float* v_s = k_s + kChunk * DP;
  float* cum_s = v_s + kChunk * DP;
  float* cin_s = cum_s + kChunk * DP;
  float* rd_s = cin_s + kChunk * DP;
  float* kd_s = rd_s + kChunk * DP;
  float* S_s = kd_s + kChunk * DP;           // [D][D], row c = key channel
  float* att_s = S_s + D * D;
  float* dec_s = att_s + kChunk * kAP;
  float* u_s = dec_s + D;

  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x, e = tid % D, grp = tid / D;
  // the carried state S0 [B, H, D, D] (key dim first), or zeros
  const float* init = s0 != nullptr ? s0 + static_cast<int64_t>(bh) * D * D : nullptr;
  for (int i = tid; i < D * D; i += kThreads) S_s[i] = init != nullptr ? init[i] : 0.f;
  if (tid < D) u_s[tid] = u[h * D + tid];
  __syncthreads();

  for (int ic = 0; ic < g.NC; ++ic) {
    const int t0 = ic * kChunk;
    load_chunk<T, D>(g, b, h, t0, r, k, v, w, nullptr, r_s, k_s, v_s, nullptr, cum_s);
    if (states != nullptr) {
      float* dst = states + (static_cast<int64_t>(bh) * g.NC + ic) * D * D;
      for (int i = tid; i < D * D; i += kThreads) dst[i] = S_s[i];
    }
    __syncthreads();
    channel_scan<D>(r_s, k_s, cum_s, cin_s, rd_s, kd_s, dec_s, nullptr);
    __syncthreads();
    pair_tiles<D>(r_s, k_s, v_s, nullptr, cum_s, cin_s, u_s, att_s, nullptr);
    __syncthreads();

    // o[t][e] = sum_c rd[t][c] S[c][e] + sum_{u<=t} att[t][u] v[u][e]
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float s = S_s[c * D + e];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] += rd_s[(grp + RG * i) * DP + c] * s;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = grp + RG * i;
      for (int uu = 0; uu <= t; ++uu) acc[i] += att_s[t * kAP + uu] * v_s[uu * DP + e];
      if (t0 + t < g.S) o[row_off(g, b, t0 + t, h, D) + e] = repro::from_f32<T>(acc[i]);
    }
    __syncthreads();

    // S[c][e] <- S[c][e] e^{cT[c]} + sum_u kd[u][c] v[u][e], c = grp + RG j
    float sacc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = grp + RG * j;
      sacc[j] = S_s[c * D + e] * dec_s[c];
    }
    for (int uu = 0; uu < kChunk; ++uu) {
      const float vv = v_s[uu * DP + e];
#pragma unroll
      for (int j = 0; j < CPT; ++j) sacc[j] += kd_s[uu * DP + grp + RG * j] * vv;
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) S_s[(grp + RG * j) * D + e] = sacc[j];
    __syncthreads();
  }
  float* sf = s_final + static_cast<int64_t>(bh) * D * D;
  for (int i = tid; i < D * D; i += kThreads) sf[i] = S_s[i];
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <int D> constexpr size_t bwd_smem() {
  return sizeof(float) * (10 * kChunk * (D + 1) + 2 * D * (D + 1) + 2 * kChunk * kAP +
                          kThreads * kChunk + 3 * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ w, const float* __restrict__ u,
                 const T* __restrict__ dout, const float* __restrict__ states,
                 T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ dw, float* __restrict__ du_part, Geo g) {
  constexpr int DP = D + 1, RG = kThreads / D, RPT = kChunk / RG, CPT = D / RG;
  static_assert(kThreads % D == 0 && kChunk % RG == 0 && D % RG == 0, "thread tiling");
  extern __shared__ float sm[];
  float* r_s = sm;
  float* k_s = r_s + kChunk * DP;
  float* v_s = k_s + kChunk * DP;
  float* do_s = v_s + kChunk * DP;
  float* cum_s = do_s + kChunk * DP;
  float* cin_s = cum_s + kChunk * DP;
  float* rd_s = cin_s + kChunk * DP;
  float* kd_s = rd_s + kChunk * DP;
  float* drp_s = kd_s + kChunk * DP;         // dr' (no bonus term)
  float* dkp_s = drp_s + kChunk * DP;        // dk' (no bonus term)
  float* S0_s = dkp_s + kChunk * DP;         // [D][D + 1] chunk-entry state
  float* dS_s = S0_s + D * DP;               // [D][D + 1] gradient of the exit state
  float* att_s = dS_s + D * DP;
  float* dov_s = att_s + kChunk * kAP;
  float* part_s = dov_s + kChunk * kAP;      // [RG][T][D] intra dk' partials
  float* dec_s = part_s + kThreads * kChunk;
  float* cT_s = dec_s + D;
  float* u_s = cT_s + D;

  const int bh = blockIdx.x, b = bh / g.H, h = bh % g.H;
  const int tid = threadIdx.x, ce = tid % D, grp = tid / D;
  for (int i = tid; i < D * DP; i += kThreads) dS_s[i] = 0.f;
  if (tid < D) u_s[tid] = u[h * D + tid];
  float dacc = 0.f, du_acc = 0.f;            // thread c < D: decay sum, du
  __syncthreads();

  for (int ic = g.NC - 1; ic >= 0; --ic) {
    const int t0 = ic * kChunk;
    load_chunk<T, D>(g, b, h, t0, r, k, v, w, dout, r_s, k_s, v_s, do_s, cum_s);
    const float* src = states + (static_cast<int64_t>(bh) * g.NC + ic) * D * D;
    for (int i = tid; i < D * D; i += kThreads) S0_s[(i / D) * DP + i % D] = src[i];
    __syncthreads();
    channel_scan<D>(r_s, k_s, cum_s, cin_s, rd_s, kd_s, dec_s, cT_s);
    __syncthreads();
    pair_tiles<D>(r_s, k_s, v_s, do_s, cum_s, cin_s, u_s, att_s, dov_s);
    __syncthreads();

    // thread (channel c = ce, group grp): intra-chunk pairs (t, u < t) for
    // its rows t; dr' complete for them, dk' partials for every u
    const int c = ce;
    float drp[RPT], dkpart[kChunk];
#pragma unroll
    for (int uu = 0; uu < kChunk; ++uu) dkpart[uu] = 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = grp + RG * i;
      const float cin_t = cin_s[t * DP + c], r_t = r_s[t * DP + c];
      float a = 0.f;
#pragma unroll
      for (int uu = 0; uu < kChunk; ++uu) {
        if (uu < t) {
          const float x = dov_s[t * kAP + uu] * __expf(cin_t - cum_s[uu * DP + c]);
          a += x * k_s[uu * DP + c];
          dkpart[uu] += x * r_t;
        }
      }
      // state term: e^{cin_t} sum_e S0[c][e] do_t[e]
      float sdo = 0.f;
      for (int ee = 0; ee < D; ++ee) sdo += S0_s[c * DP + ee] * do_s[t * DP + ee];
      drp[i] = a + __expf(cin_t) * sdo;
    }
#pragma unroll
    for (int uu = 0; uu < kChunk; ++uu) part_s[(grp * kChunk + uu) * D + c] = dkpart[uu];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = grp + RG * i;
      // dk'_t = e^{cT - cum_t} sum_e dS[c][e] v_t[e] + the intra partials
      float sv = 0.f;
      for (int ee = 0; ee < D; ++ee) sv += dS_s[c * DP + ee] * v_s[t * DP + ee];
      float dkp = __expf(cT_s[c] - cum_s[t * DP + c]) * sv;
      for (int gg = 0; gg < RG; ++gg) dkp += part_s[(gg * kChunk + t) * D + c];
      drp_s[t * DP + c] = drp[i];
      dkp_s[t * DP + c] = dkp;
      if (t0 + t < g.S) {
        const float bon = u_s[c] * dov_s[t * kAP + t];
        const int64_t off = row_off(g, b, t0 + t, h, D) + c;
        dr[off] = repro::from_f32<T>(drp[i] + bon * k_s[t * DP + c]);
        dk[off] = repro::from_f32<T>(dkp + bon * r_s[t * DP + c]);
      }
    }
    // thread (column e = ce, group grp): dv_u[e] = sum_{t>=u} att[t][u]
    // do_t[e] + sum_c kd[u][c] dS[c][e] for its rows u
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int uu = grp + RG * i, ee = ce;
      float a = 0.f;
      for (int t = uu; t < kChunk; ++t) a += att_s[t * kAP + uu] * do_s[t * DP + ee];
      for (int cc = 0; cc < D; ++cc) a += kd_s[uu * DP + cc] * dS_s[cc * DP + ee];
      if (t0 + uu < g.S) dv[row_off(g, b, t0 + uu, h, D) + ee] = repro::from_f32<T>(a);
    }
    __syncthreads();

    // dS[c][e] <- e^{cT[c]} dS[c][e] + sum_t rd[t][c] do[t][e], c = grp + RG j
    {
      const int ee = ce;
      float sacc[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int cc = grp + RG * j;
        sacc[j] = dS_s[cc * DP + ee] * dec_s[cc];
      }
      for (int t = 0; t < kChunk; ++t) {
        const float dd = do_s[t * DP + ee];
#pragma unroll
        for (int j = 0; j < CPT; ++j) sacc[j] += rd_s[t * DP + grp + RG * j] * dd;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) dS_s[(grp + RG * j) * DP + ee] = sacc[j];
    }
    // thread c < D: dl_j = dacc + sum_{t>j} r_t dr'_t - sum_{t>=j} k_t dk'_t
    // (reverse over the chunk's rows), dw = dl / w; du += r k (do . v)
    if (tid < D) {
      float sx = 0.f, sy = 0.f;
      for (int j = kChunk - 1; j >= 0; --j) {
        sy += k_s[j * DP + c] * dkp_s[j * DP + c];
        const float dl = dacc + sx - sy;
        sx += r_s[j * DP + c] * drp_s[j * DP + c];
        du_acc += r_s[j * DP + c] * k_s[j * DP + c] * dov_s[j * kAP + j];
        if (t0 + j < g.S) {
          const int64_t off = row_off(g, b, t0 + j, h, D) + c;
          const float wv = w[off];
          dw[off] = wv > kFloor ? dl / wv : 0.f;
        }
      }
      dacc += sx - sy;
    }
    __syncthreads();
  }
  if (tid < D) du_part[static_cast<int64_t>(bh) * D + tid] = du_acc;
}

// ---------------------------------------------------------------------------
// bf16: chunk-parallel passes on the tensor cores around an in-place scan
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcChunk = 64;               // rows per chunk
constexpr int kSub = 16;                   // rows per sub-chunk: one warp's rows
constexpr int kTcThreads = 128;            // 4 warps, warp w sub-chunk w
constexpr int kSubs = kTcChunk / kSub;
constexpr int kDgS = kSub + 1;             // row stride of a warp's diagonal block of A (f32)
constexpr int kScanThreads = 256;
constexpr int kScanAhead = 8;              // chunks a scan thread loads before it walks them
static_assert(kTcThreads / 32 == kSubs, "a warp a sub-chunk");

using repro::lds;
constexpr int kLT = lds<kTcChunk>();       // row stride of a [64][64] bf16 tile
// the log-decay sums' row stride (f32): D + 4 keeps the scalar reads of an
// MMA fragment's rows and columns to 2-way bank conflicts at most, and the
// 16-byte reads of neighbouring rows free of them
template <int D> __host__ __device__ constexpr int cum_stride() { return D + 4; }

// the (batch, chunk, head) of a chunk-parallel block; heads run fastest, so
// neighbouring blocks read neighbouring pieces of a row of r, k, v
struct ChunkBlock {
  int b, c, h, t0;
  int64_t slot;                            // (b, h, c) in [B, H, NC, ...] buffers
};

__device__ __forceinline__ ChunkBlock chunk_block(const Geo& g) {
  const int h = blockIdx.x % g.H, rest = blockIdx.x / g.H;
  const int c = rest % g.NC, b = rest / g.NC;
  return {b, c, h, c * kTcChunk, (static_cast<int64_t>(b) * g.H + h) * g.NC + c};
}

// Rows t0 .. t0 + 64 of head h of a [B, S, H, D] bf16 tensor into a
// [64][D + 8] tile by 16-byte cp.async; rows past S are zero-filled.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, const Geo& g,
                                           const ChunkBlock& k) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < kTcChunk * CPR; i += kTcThreads) {
    const int t = i / CPR, p = i % CPR, row = k.t0 + t;
    const bool ok = row < g.S;
    repro::cp_async16(dst + t * lds<D>() + p * 8, ok ? src + row_off(g, k.b, row, k.h, D) + p * 8 : src,
                      ok);
  }
}

// The chunk's log-decay sums into cx [65][D + 4] f32: cx[0] = 0 and cx[t +
// 1] = cum_t, the inclusive sum of log max(w, 1e-20) over rows 0..t (rows
// past S add 0).  So cin_t = cx[t], cum_t = cx[t + 1] and cT = cx[64].
// stage_w issues the decays' 16-byte cp.async copies as their own group;
// cum_logs waits for them (with kLater groups committed after them still
// in flight), turns them into their logs in place and sums each column by
// 128 / D threads, a segment of rows each, carrying the segments' totals.
// cum_logs ends with a __syncthreads.
template <int D>
__device__ __forceinline__ void stage_w(float* cx, const float* w, const Geo& g,
                                        const ChunkBlock& k) {
  constexpr int CS = cum_stride<D>(), CPR = D / 4;
  for (int i = threadIdx.x; i < kTcChunk * CPR; i += kTcThreads) {
    const int t = i / CPR, p = i % CPR, row = k.t0 + t;
    const bool ok = row < g.S;
    repro::cp_async16(cx + (t + 1) * CS + p * 4, ok ? w + row_off(g, k.b, row, k.h, D) + p * 4 : w,
                      ok);
  }
  repro::cp_async_commit();
}

template <int D, int kLater>
__device__ __forceinline__ void cum_logs(float* cx, const Geo& g, const ChunkBlock& k) {
  constexpr int CS = cum_stride<D>(), SEG = kTcThreads / D, RPS = kTcChunk / SEG;
  repro::cp_async_wait<kLater>();
  if (threadIdx.x < D) cx[threadIdx.x] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < kTcChunk * D; i += kTcThreads) {
    const int t = i / D, c = i % D;
    float* x = cx + (t + 1) * CS + c;
    *x = k.t0 + t < g.S ? __logf(fmaxf(*x, kFloor)) : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x % D, seg = threadIdx.x / D;
  float acc = 0.f;
  for (int t = seg * RPS + 1; t <= (seg + 1) * RPS; ++t) {
    acc += cx[t * CS + c];
    cx[t * CS + c] = acc;
  }
  __syncthreads();
  float carry = 0.f;
  for (int j = 0; j < seg; ++j) carry += cx[(j + 1) * RPS * CS + c];
  __syncthreads();
  for (int t = seg * RPS + 1; t <= (seg + 1) * RPS; ++t) cx[t * CS + c] += carry;
  __syncthreads();
}

// Fragment coordinates (common.cuh): value i of an A fragment's eight (its
// register i / 2, the lower column first) sits at row fr(i), column fc(i)
// of the 16 x 16 tile; value j of the four of one n tile of a B fragment
// (b0, b1) at depth fk(j), column lane / 4; value e of an accumulator at
// row ar(e), column ac(e) of its 16 x 8 tile.
__device__ __forceinline__ int fr(int i) { return (threadIdx.x & 31) / 4 + 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int fc(int i) { return 2 * (threadIdx.x & 3) + (i & 1) + 8 * (i >> 2); }
__device__ __forceinline__ int fk(int j) { return 2 * (threadIdx.x & 3) + (j & 1) + 8 * (j >> 1); }
__device__ __forceinline__ int ar(int e) { return (threadIdx.x & 31) / 4 + 8 * (e >> 1); }
__device__ __forceinline__ int ac(int e) { return 2 * (threadIdx.x & 3) + (e & 1); }

using repro::add;
using repro::zero;

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four f32 of one n tile of a B fragment as a bf16 hi + lo pair
__device__ __forceinline__ void split_b(uint32_t (&bh)[2], uint32_t (&bl)[2], const float (&x)[4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    bh[j] = as_u32(h);
    bl[j] = as_u32(__floats2bfloat162_rn(x[2 * j] - __low2float(h), x[2 * j + 1] - __high2float(h)));
  }
}

// eight bf16 (a 16-byte read of a tile row) as f32
__device__ __forceinline__ void unpack8(float (&x)[8], uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = repro::bf16_lo(w[i]);
    x[2 * i + 1] = repro::bf16_hi(w[i]);
  }
}

// The products.  Each 16-deep piece is summed on the tensor cores into a
// fresh accumulator (the _zero forms) that the caller adds on the CUDA
// cores: the tensor cores' own accumulation truncates.
// d = Ah Bh + Ah Bl + Al Bh: f32 times f32, both hi + lo (lo lo, ~2^-18
// relative, dropped)
__device__ __forceinline__ void mma3_zero(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                          const uint32_t (&bl)[2]) {
  repro::mma_bf16_zero(d, ah, bh[0], bh[1]);
  repro::mma_bf16(d, ah, bl[0], bl[1]);
  repro::mma_bf16(d, al, bh[0], bh[1]);
}

// d = (Ah + Al) B: an f32 A times an exact bf16 B
__device__ __forceinline__ void mma_fa_zero(float (&d)[4], const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4], uint32_t b0, uint32_t b1) {
  repro::mma_bf16_zero(d, ah, b0, b1);
  repro::mma_bf16(d, al, b0, b1);
}

// d = A (Bh + Bl): an exact bf16 A times an f32 B
__device__ __forceinline__ void mma_fb_zero(float (&d)[4], const uint32_t (&a)[4],
                                            const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  repro::mma_bf16_zero(d, a, bh[0], bh[1]);
  repro::mma_bf16(d, a, bl[0], bl[1]);
}

// The A fragment (rows r0.., columns c0..) of a bf16 tile, each value times
// scale(row, column) in f32, as a hi + lo pair
template <int LDS, typename Scale>
__device__ __forceinline__ void frag_a_scaled(uint32_t (&ah)[4], uint32_t (&al)[4],
                                              const bf16* tile, int r0, int c0, Scale scale) {
  uint32_t a[4];
  repro::frag_a<LDS>(a, tile, r0, c0, threadIdx.x & 31);
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x[i] = (i & 1 ? repro::bf16_hi(a[i / 2]) : repro::bf16_lo(a[i / 2])) *
           scale(r0 + fr(i), c0 + fc(i));
  repro::split_bf16(ah, al, x);
}

// ... and of A[m][k] = tile[k][m] (m rows m0.., depth k0..), scale(m, k)
template <int LDS, typename Scale>
__device__ __forceinline__ void frag_at_scaled(uint32_t (&ah)[4], uint32_t (&al)[4],
                                               const bf16* tile, int k0, int m0, Scale scale) {
  uint32_t a[4];
  repro::frag_at<LDS>(a, tile, k0, m0, threadIdx.x & 31);
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x[i] = (i & 1 ? repro::bf16_hi(a[i / 2]) : repro::bf16_lo(a[i / 2])) *
           scale(m0 + fr(i), k0 + fc(i));
  repro::split_bf16(ah, al, x);
}

// The B fragments of n tiles n0.. and n0 + 8.. (bh[t], bl[t] for tile t)
// from the four registers of frag_b / frag_bt, each value times scale(k, n)
template <typename Scale>
__device__ __forceinline__ void scale_b(uint32_t (&bh)[2][2], uint32_t (&bl)[2][2],
                                        const uint32_t (&b)[4], int k0, int n0, Scale scale) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int n = n0 + 8 * t + (threadIdx.x & 31) / 4;
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = (j & 1 ? repro::bf16_hi(b[2 * t + j / 2]) : repro::bf16_lo(b[2 * t + j / 2])) *
             scale(k0 + fk(j), n);
    split_b(bh[t], bl[t], x);
  }
}

// B[k][n] = tile[k][n] (rows k0.., columns n0..) times scale(k, n)
template <int LDS, typename Scale>
__device__ __forceinline__ void frag_b_scaled(uint32_t (&bh)[2][2], uint32_t (&bl)[2][2],
                                              const bf16* tile, int k0, int n0, Scale scale) {
  uint32_t b[4];
  repro::frag_b<LDS>(b, tile, k0, n0, threadIdx.x & 31);
  scale_b(bh, bl, b, k0, n0, scale);
}

// B[k][n] = tile[n][k] (rows n0.., columns k0..) times scale(k, n)
template <int LDS, typename Scale>
__device__ __forceinline__ void frag_bt_scaled(uint32_t (&bh)[2][2], uint32_t (&bl)[2][2],
                                               const bf16* tile, int n0, int k0, Scale scale) {
  uint32_t b[4];
  repro::frag_bt<LDS>(b, tile, n0, k0, threadIdx.x & 31);
  scale_b(bh, bl, b, k0, n0, scale);
}

// One warp's row block of the chunk's score matrix, A[t][u] for its rows t
// = r0.. (sub-chunk w) and u <= t:
//
//   A[t][u] = sum_c r_t[c] e^{cin_t[c] - cum_u[c]} k_u[c]  (u < t),
//   A[t][t] = sum_c r_t[c] u[c] k_t[c]                       (the bonus).
//
// For u in an earlier sub-chunk J the pair weight factors through the
// warp's entry value cin_{r0} (cum_u >= cin_{r0} >= cin_t):
// (r_t e^{cin_t - cin_{r0}}) . (k_u e^{cin_{r0} - cum_u}), both exponents
// <= 0, a product on mma.sync with each f32 side a hi + lo pair.  Where a
// factor underflows to 0 the true weight, their product, is smaller still.
// use(J, tile) takes each such 16 x 16 block J < w, in order, as two
// accumulator tiles.  The diagonal block is summed pair by pair on the
// CUDA cores, for u <= t only: entry e of its lower triangle (local row t,
// column u, e = t (t + 1) / 2 + u) to lane e % 32, eight channels a step by
// 16-byte reads; diag(t, u, value) takes each.
template <int D, typename Use, typename Diag>
__device__ __forceinline__ void score_rows(const bf16* r_s, const bf16* k_s, const float* cx,
                                           const float* u_s, int w, Use use, Diag diag) {
  constexpr int LD = lds<D>(), KD = D / 16, CS = cum_stride<D>();
  const int r0 = w * kSub;
  if (w > 0) {
    uint32_t rh[KD][4], rl[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      frag_a_scaled<LD>(rh[kk], rl[kk], r_s, r0, kk * 16,
                        [&](int t, int c) { return __expf(cx[t * CS + c] - cx[r0 * CS + c]); });
    for (int J = 0; J < w; ++J) {
      float acc[2][4];
      zero(acc);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t bh[2][2], bl[2][2];
        frag_bt_scaled<LD>(bh, bl, k_s, J * kSub, kk * 16, [&](int c, int u) {
          return __expf(cx[r0 * CS + c] - cx[(u + 1) * CS + c]);
        });
        float part[2][4];
        mma3_zero(part[0], rh[kk], rl[kk], bh[0], bl[0]);
        mma3_zero(part[1], rh[kk], rl[kk], bh[1], bl[1]);
        add(acc, part);
      }
      use(J, acc);
    }
  }
  for (int e = threadIdx.x & 31; e < kSub * (kSub + 1) / 2; e += 32) {
    int t = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
    if ((t + 1) * (t + 2) / 2 <= e) ++t;
    if (t * (t + 1) / 2 > e) --t;
    const int u = e - t * (t + 1) / 2;
    const bf16* rt = r_s + (r0 + t) * LD;
    const bf16* ku = k_s + (r0 + u) * LD;
    float a = 0.f;
    if (u < t) {
      const float* ci = cx + (r0 + t) * CS;
      const float* cu = cx + (r0 + u + 1) * CS;
      for (int c = 0; c < D; c += 8) {
        float rf[8], kf[8];
        unpack8(rf, *reinterpret_cast<const uint4*>(rt + c));
        unpack8(kf, *reinterpret_cast<const uint4*>(ku + c));
        const float4 i0 = *reinterpret_cast<const float4*>(ci + c);
        const float4 i1 = *reinterpret_cast<const float4*>(ci + c + 4);
        const float4 u0 = *reinterpret_cast<const float4*>(cu + c);
        const float4 u1 = *reinterpret_cast<const float4*>(cu + c + 4);
        const float d[8] = {i0.x - u0.x, i0.y - u0.y, i0.z - u0.z, i0.w - u0.w,
                            i1.x - u1.x, i1.y - u1.y, i1.z - u1.z, i1.w - u1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) a += rf[j] * __expf(d[j]) * kf[j];
      }
    } else {
      for (int c = 0; c < D; c += 8) {
        float rf[8], kf[8];
        unpack8(rf, *reinterpret_cast<const uint4*>(rt + c));
        unpack8(kf, *reinterpret_cast<const uint4*>(ku + c));
#pragma unroll
        for (int j = 0; j < 8; ++j) a += rf[j] * u_s[c + j] * kf[j];
      }
    }
    diag(t, u, a);
  }
}

// the eight values of a 16 x 16 block held as two accumulator tiles are,
// value for value, an A fragment (common.cuh); as a hi + lo pair
__device__ __forceinline__ void block_to_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                           const float (&blk)[2][4]) {
  const float x[8] = {blk[0][0], blk[0][1], blk[0][2], blk[0][3],
                      blk[1][0], blk[1][1], blk[1][2], blk[1][3]};
  repro::split_bf16(ah, al, x);
}

// a 16 x 16 block (two accumulator tiles) into rows r0.., columns c0.. of a
// [64][kLT] bf16 hi + lo tile pair
__device__ __forceinline__ void block_to_smem(bf16* hi, bf16* lo, const float (&blk)[2][4], int r0,
                                              int c0) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int off = (r0 + ar(2 * p)) * kLT + c0 + 8 * n + ac(0);
      const __nv_bfloat162 h = __floats2bfloat162_rn(blk[n][2 * p], blk[n][2 * p + 1]);
      *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
      *reinterpret_cast<__nv_bfloat162*>(lo + off) = __floats2bfloat162_rn(
          blk[n][2 * p] - __low2float(h), blk[n][2 * p + 1] - __high2float(h));
    }
}

// one f32 as a bf16 hi + lo pair at offset off of two tiles
__device__ __forceinline__ void put_hi_lo(bf16* hi, bf16* lo, int off, float v) {
  const bf16 h = __float2bfloat16_rn(v);
  hi[off] = h;
  lo[off] = __float2bfloat16_rn(v - __bfloat162float(h));
}

// ---------------------------------------------------------------------------
// pass 1: the chunk-local increments (forward and backward)
// ---------------------------------------------------------------------------
//
// Per (batch, chunk, head), into slot (b, h, c) of a [B, H, NC, D, D] f32
// buffer, and dec = e^{cT} into [B, H, NC, D]:
//   forward   dS_c = sum_u (k_u e^{cT - cum_u})^T v_u   (the state's increment)
//   backward  dG_c = sum_t (r_t e^{cin_t})^T do_t       (the gradient's)
// Warp w takes the increment's rows 16 w.. (key channels) while 16 w < D:
// the A operand (the scaled key side, transposed out of its [64][D] tile
// by ldmatrix.trans) a hi + lo pair, v or do exact.

template <int D> struct IncTc {
  static constexpr int LD = lds<D>();
  static constexpr int kA = 0;                                   // k or r [64][LD] bf16
  static constexpr int kB = kA + kTcChunk * LD * 2;              // v or do
  static constexpr int kCum = kB + kTcChunk * LD * 2;            // [65][D] f32
  static constexpr size_t kSmem = kCum + (kTcChunk + 1) * cum_stride<D>() * 4;
};

template <int D, bool kBwd>
__device__ __forceinline__ void inc_block(const bf16* __restrict__ a, const bf16* __restrict__ bm,
                                          const float* __restrict__ w, float* __restrict__ inc,
                                          float* __restrict__ dec, const Geo& g) {
  using F = IncTc<D>;
  constexpr int LD = F::LD, NT = D / 8, CS = cum_stride<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem + F::kA);
  bf16* b_s = reinterpret_cast<bf16*>(smem + F::kB);
  float* cx = reinterpret_cast<float*>(smem + F::kCum);
  const ChunkBlock blk = chunk_block(g);
  stage_w<D>(cx, w, g, blk);
  stage_rows<D>(a_s, a, g, blk);
  stage_rows<D>(b_s, bm, g, blk);
  repro::cp_async_commit();
  cum_logs<D, 1>(cx, g, blk);
  repro::cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < D) dec[blk.slot * D + threadIdx.x] = __expf(cx[kTcChunk * CS + threadIdx.x]);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp * 16 >= D) return;
  const int m0 = warp * 16;
  float acc[NT][4];
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < kSubs; ++kk) {
    uint32_t ah[4], al[4];
    frag_at_scaled<LD>(ah, al, a_s, kk * 16, m0, [&](int c, int t) {
      return kBwd ? __expf(cx[t * CS + c]) : __expf(cx[kTcChunk * CS + c] - cx[(t + 1) * CS + c]);
    });
    float part[NT][4];
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      repro::frag_b<LD>(b, b_s, kk * 16, n * 8, lane);
      mma_fa_zero(part[n], ah, al, b[0], b[1]);
      mma_fa_zero(part[n + 1], ah, al, b[2], b[3]);
    }
    add(acc, part);
  }
  float* dst = inc + blk.slot * D * D;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      *reinterpret_cast<float2*>(dst + (m0 + ar(2 * p)) * D + n * 8 + ac(0)) =
          make_float2(acc[n][2 * p], acc[n][2 * p + 1]);
}

// one kernel name a pass and direction, so a profile puts each with its own
template <int D>
__global__ void __launch_bounds__(kTcThreads)
rwkv6_fwd_inc_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const float* __restrict__ w, float* __restrict__ states,
                     float* __restrict__ dec, Geo g) {
  inc_block<D, false>(k, v, w, states, dec, g);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
rwkv6_bwd_inc_kernel(const bf16* __restrict__ r, const bf16* __restrict__ dout,
                     const float* __restrict__ w, float* __restrict__ dstates,
                     float* __restrict__ dec, Geo g) {
  inc_block<D, true>(r, dout, w, dstates, dec, g);
}

// ---------------------------------------------------------------------------
// pass 2: the in-place scan over the chunks
// ---------------------------------------------------------------------------
//
// One thread per four state values (b, h, c, e..e + 3) walks the chunks,
// forward in order or backward in reverse: it reads slot j's increment,
// writes the carried value there, then X <- dec_j[c] X + increment.  So the forward
// leaves the state at each chunk's entry in its slot (and S_final), the
// backward the gradient of each chunk's exit state (the last chunk's 0).
// The increments' loads do not wait on the carried value: each thread
// issues kScanAhead of them before it walks them, and the pass is bound by
// bytes.  The forward's carried value starts at the state S0 the caller
// carries in (init, [B, H, D, D], 16-byte aligned; null: zeros), so every
// chunk-entry state and S_final include S0 decayed through the chunks
// before them, and the output pass reads chunk 0's entry state, S0, from
// its slot like any other.
template <bool kReverse>
__device__ __forceinline__ void scan_elems(float* __restrict__ buf, const float* __restrict__ dec,
                                           const float* __restrict__ init, float* __restrict__ last,
                                           int64_t n, int D, int NC) {
  // thread i: elements 4 i .. 4 i + 3, one row of one state (D % 4 == 0)
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (4 * i >= n) return;
  const int64_t dd = static_cast<int64_t>(D) * D, bh = 4 * i / dd, e = 4 * i % dd;
  float4* p = reinterpret_cast<float4*>(buf + bh * NC * dd + e);
  const float* q = dec + bh * NC * D + e / D;
  const int64_t step = dd / 4;
  float4 x = init != nullptr ? reinterpret_cast<const float4*>(init)[i]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < NC; j0 += kScanAhead) {
    float4 inc[kScanAhead];
    float dk[kScanAhead];
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j) {
      const int c = kReverse ? NC - 1 - (j0 + j) : j0 + j;
      if (j0 + j < NC) {
        inc[j] = p[c * step];
        dk[j] = q[c * D];
      }
    }
#pragma unroll
    for (int j = 0; j < kScanAhead; ++j) {
      const int c = kReverse ? NC - 1 - (j0 + j) : j0 + j;
      if (j0 + j < NC) {
        p[c * step] = x;
        x = make_float4(dk[j] * x.x + inc[j].x, dk[j] * x.y + inc[j].y, dk[j] * x.z + inc[j].z,
                        dk[j] * x.w + inc[j].w);
      }
    }
  }
  if (last != nullptr) reinterpret_cast<float4*>(last)[i] = x;
}

__global__ void __launch_bounds__(kScanThreads)
rwkv6_fwd_scan_kernel(float* __restrict__ states, const float* __restrict__ dec,
                      const float* __restrict__ s0, float* __restrict__ s_final, int64_t n,
                      int D, int NC) {
  scan_elems<false>(states, dec, s0, s_final, n, D, NC);
}

__global__ void __launch_bounds__(kScanThreads)
rwkv6_bwd_scan_kernel(float* __restrict__ dstates, const float* __restrict__ dec, int64_t n,
                      int D, int NC) {
  scan_elems<true>(dstates, dec, nullptr, nullptr, n, D, NC);
}

// ---------------------------------------------------------------------------
// pass 3, forward: the chunk's output from its entry state
// ---------------------------------------------------------------------------
//
// One block per (batch, chunk, head); warp w the rows t = 16 w..:
//   o_t = (r_t e^{cin_t}) S_c + sum_{u<=t} A[t][u] v_u
// with A from score_rows (the bonus on its diagonal), each block of A a hi
// + lo pair straight from its accumulators, v exact; r e^{cin} a hi + lo
// pair against S_c's hi + lo tiles.

template <int D> struct OutTc {
  static constexpr int LD = lds<D>();
  static constexpr int kR = 0;                                   // r, k, v [64][LD] bf16
  static constexpr int kK = kR + kTcChunk * LD * 2;
  static constexpr int kV = kK + kTcChunk * LD * 2;
  static constexpr int kSh = kV + kTcChunk * LD * 2;             // S_c hi, lo [D][LD] bf16
  static constexpr int kSl = kSh + D * LD * 2;
  static constexpr int kCum = kSl + D * LD * 2;                  // [65][D] f32
  static constexpr int kU = kCum + (kTcChunk + 1) * cum_stride<D>() * 4;  // [D] f32
  static constexpr int kDt = kU + D * 4;                         // the warps' diagonal blocks
  static constexpr size_t kSmem = kDt + kSubs * kSub * kDgS * 4;  //   [4][16][17] f32
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
rwkv6_fwd_out_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ states,
                     bf16* __restrict__ o, Geo g) {
  using F = OutTc<D>;
  constexpr int LD = F::LD, KD = D / 16, NT = D / 8, CS = cum_stride<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* r_s = reinterpret_cast<bf16*>(smem + F::kR);
  bf16* k_s = reinterpret_cast<bf16*>(smem + F::kK);
  bf16* v_s = reinterpret_cast<bf16*>(smem + F::kV);
  bf16* s_hi = reinterpret_cast<bf16*>(smem + F::kSh);
  bf16* s_lo = reinterpret_cast<bf16*>(smem + F::kSl);
  float* cx = reinterpret_cast<float*>(smem + F::kCum);
  float* u_s = reinterpret_cast<float*>(smem + F::kU);
  float* dt_s = reinterpret_cast<float*>(smem + F::kDt);
  const ChunkBlock blk = chunk_block(g);
  stage_w<D>(cx, w, g, blk);
  stage_rows<D>(r_s, r, g, blk);
  stage_rows<D>(k_s, k, g, blk);
  stage_rows<D>(v_s, v, g, blk);
  repro::cp_async_commit();
  // S_c into hi + lo tiles: every read issued before the first store
  constexpr int SPT = (D * D / 4 + kTcThreads - 1) / kTcThreads;
  const float4* S = reinterpret_cast<const float4*>(states + blk.slot * D * D);
  float4 sv[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int i = threadIdx.x + j * kTcThreads;
    if (i < D * D / 4) sv[j] = S[i];
  }
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int i = 4 * (threadIdx.x + j * kTcThreads);
    if (i >= D * D) continue;
    const float4 x = sv[j];
    const int off = (i / D) * LD + i % D;
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(x.x, x.y), h23 = __floats2bfloat162_rn(x.z, x.w);
    *reinterpret_cast<__nv_bfloat162*>(s_hi + off) = h01;
    *reinterpret_cast<__nv_bfloat162*>(s_hi + off + 2) = h23;
    *reinterpret_cast<__nv_bfloat162*>(s_lo + off) =
        __floats2bfloat162_rn(x.x - __low2float(h01), x.y - __high2float(h01));
    *reinterpret_cast<__nv_bfloat162*>(s_lo + off + 2) =
        __floats2bfloat162_rn(x.z - __low2float(h23), x.w - __high2float(h23));
  }
  if (threadIdx.x < D) u_s[threadIdx.x] = u[blk.h * D + threadIdx.x];
  cum_logs<D, 1>(cx, g, blk);
  repro::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = warp * kSub;
  float acc[NT][4];
  zero(acc);
  // (r e^{cin}) S_c
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t ah[4], al[4];
    frag_a_scaled<LD>(ah, al, r_s, r0, kk * 16, [&](int t, int c) { return __expf(cx[t * CS + c]); });
    float part[NT][4];
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bh[4], bl[4];
      repro::frag_b<LD>(bh, s_hi, kk * 16, n * 8, lane);
      repro::frag_b<LD>(bl, s_lo, kk * 16, n * 8, lane);
      const uint32_t h0[2] = {bh[0], bh[1]}, l0[2] = {bl[0], bl[1]};
      const uint32_t h1[2] = {bh[2], bh[3]}, l1[2] = {bl[2], bl[3]};
      mma3_zero(part[n], ah, al, h0, l0);
      mma3_zero(part[n + 1], ah, al, h1, l1);
    }
    add(acc, part);
  }
  // A v, a 16 x 16 block of A at a time; the diagonal block through the
  // warp's [16][17] f32 tile into accumulator order
  auto a_v = [&](int J, const float (&a)[2][4]) {
    uint32_t ah[4], al[4];
    block_to_a(ah, al, a);
    float part[NT][4];
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      repro::frag_b<LD>(b, v_s, J * kSub, n * 8, lane);
      mma_fa_zero(part[n], ah, al, b[0], b[1]);
      mma_fa_zero(part[n + 1], ah, al, b[2], b[3]);
    }
    add(acc, part);
  };
  float* dt_w = dt_s + warp * kSub * kDgS;
  score_rows<D>(r_s, k_s, cx, u_s, warp, a_v,
                [&](int t, int u, float a) { dt_w[t * kDgS + u] = a; });
  __syncwarp();
  {
    float dblk[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = ar(e), u = 8 * n + ac(e);
        dblk[n][e] = u <= t ? dt_w[t * kDgS + u] : 0.f;
      }
    a_v(warp, dblk);
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int t = r0 + ar(2 * p);
    if (blk.t0 + t >= g.S) continue;
    bf16* dst = o + row_off(g, blk.b, blk.t0 + t, blk.h, D);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + ac(0)) =
          __floats2bfloat162_rn(acc[n][2 * p], acc[n][2 * p + 1]);
  }
}

// ---------------------------------------------------------------------------
// pass 3, backward: every gradient of a chunk from (S_c, dS_c)
// ---------------------------------------------------------------------------
//
// One block per (batch, chunk, head), from the chunk's entry state S0 and
// the gradient dS of its exit state.  With dov[t][u] = do_t . v_u, A as in
// the forward, kd_u = k_u e^{cT - cum_u}:
//
//   staging  S0 and dS by 16-byte reads into registers: dS goes to hi +
//            lo tiles, S0 waits in registers for A's place; e^{cT} <S0,
//            dS> per key channel
//   phase 1  warp w, its rows t: dov (exact products) and A, 16 x 16
//            blocks u <= t, into hi + lo tiles
//   phase 2  warp w, its rows as u:
//              dv_u = sum_{t>=u} A[t][u] do_t + kd_u dS       (A^T by ldmatrix.trans)
//              q'_u = e^{cX - cum_u} sum_{t>=r0+16} dov[t][u] (r_t e^{cin_t - cX}),
//                     cX = cum_{r0+15}, the warp's exit value
//              z'_u = e^{cT - cum_u} (dS v_u)
//            then S0 in hi + lo tiles where A was, and its rows as t:
//              dr'_t = e^{cin_t} (S0 do_t) + e^{cin_t - cin_{r0}} sum_{u<r0}
//                      dov[t][u] (k_u e^{cin_{r0} - cum_u})
//   phase 3  thread (channel c, sub-chunk I): the pairs u < t inside I of
//            dr' and q' on the CUDA cores
//   phase 4  dr = dr' + u k dov[t][t], dk = q' + z' + u r dov[t][t]; thread
//            (channel, segment) walks its rows: dl_j = sum_{t>j} r_t dr'_t -
//            sum_{u>=j} k_u q'_u + sum_{u<j} k_u z'_u + e^{cT} <S0, dS>_c
//            (the four groups of ref.rwkv6_bwd_local, all inside the
//            chunk), dw = dl / w where w > 1e-20 (w read ahead), and the
//            chunk's du partial sum_t r_t k_t dov[t][t].
// dr', q', z' (f32) take the place of A, v, do and dS after phase 2.

template <int D> struct GradTc {
  static constexpr int LD = lds<D>();
  static constexpr int kR = 0;                                   // r, k [64][LD] bf16
  static constexpr int kK = kR + kTcChunk * LD * 2;
  static constexpr int kCum = kK + kTcChunk * LD * 2;            // [65][D + 4] f32
  static constexpr int kU = kCum + (kTcChunk + 1) * cum_stride<D>() * 4;  // u [D] f32
  static constexpr int kEnd = kU + D * 4;                        // e^{cT} <S0, dS> [D] f32
  static constexpr int kRed = kEnd + D * 4;                      // per-thread partials [4][128] f32
  static constexpr int kX = kRed + 4 * kTcThreads * 4;           // phases 1-2:
  static constexpr int kAh = kX;                                 //   A hi, lo [64][kLT] bf16, then
  static constexpr int kAl = kAh + kTcChunk * kLT * 2;           //   S0 hi, lo [D][LD] in their place
  static constexpr int kV = kAl + kTcChunk * kLT * 2;            //   v, do [64][LD] bf16
  static constexpr int kDo = kV + kTcChunk * LD * 2;
  static constexpr int kSh = kDo + kTcChunk * LD * 2;            //   dS hi, lo [D][LD] bf16
  static constexpr int kSl = kSh + D * LD * 2;
  static constexpr int kQh = kSl + D * LD * 2;                   //   dov hi, lo [64][kLT] bf16,
  static constexpr int kQl = kQh + kTcChunk * kLT * 2;           //   kept to the end
  static constexpr int kDr = kX;                                 // phases 3-4: dr', q', z' [64][D] f32
  static constexpr int kQ = kDr + kTcChunk * D * 4;
  static constexpr int kZ = kQ + kTcChunk * D * 4;
  static constexpr size_t kSmem = kQl + kTcChunk * kLT * 2;
  static_assert(kZ + kTcChunk * D * 4 <= kQh, "dr', q', z' leave dov's tiles alone");
  static_assert(2 * D * LD <= 2 * kTcChunk * kLT, "S0's tiles fit where A's were");
};

// two f32 as bf16 hi + lo pairs at offsets off, off + 1 (off even) of two tiles
__device__ __forceinline__ void put2_hi_lo(bf16* hi, bf16* lo, int off, float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + off) =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2)
rwkv6_bwd_grad_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const bf16* __restrict__ dout,
                      const float* __restrict__ states, const float* __restrict__ dstates,
                      bf16* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_part, Geo g) {
  using F = GradTc<D>;
  constexpr int LD = F::LD, KD = D / 16, NT = D / 8, CS = cum_stride<D>();
  constexpr int SEG = kTcThreads / D, RPS = kTcChunk / SEG;   // threads a channel, rows each
  constexpr int TPR = D / 4;                                   // threads a state row, 4 values each
  constexpr int SPT = (D * D / 4 + kTcThreads - 1) / kTcThreads;   // float4 of a state a thread
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* r_s = reinterpret_cast<bf16*>(smem + F::kR);
  bf16* k_s = reinterpret_cast<bf16*>(smem + F::kK);
  float* cx = reinterpret_cast<float*>(smem + F::kCum);
  float* u_s = reinterpret_cast<float*>(smem + F::kU);
  float* end_s = reinterpret_cast<float*>(smem + F::kEnd);
  float* red_s = reinterpret_cast<float*>(smem + F::kRed);
  bf16* a_hi = reinterpret_cast<bf16*>(smem + F::kAh);
  bf16* a_lo = reinterpret_cast<bf16*>(smem + F::kAl);
  bf16* s0_hi = a_hi;                          // after dv: S0 [D][LD] where A was
  bf16* s0_lo = a_hi + D * LD;
  bf16* v_s = reinterpret_cast<bf16*>(smem + F::kV);
  bf16* do_s = reinterpret_cast<bf16*>(smem + F::kDo);
  bf16* ds_hi = reinterpret_cast<bf16*>(smem + F::kSh);
  bf16* ds_lo = reinterpret_cast<bf16*>(smem + F::kSl);
  bf16* q_hi = reinterpret_cast<bf16*>(smem + F::kQh);
  bf16* q_lo = reinterpret_cast<bf16*>(smem + F::kQl);
  float* drp_s = reinterpret_cast<float*>(smem + F::kDr);
  float* qp_s = reinterpret_cast<float*>(smem + F::kQ);
  float* zp_s = reinterpret_cast<float*>(smem + F::kZ);

  const ChunkBlock blk = chunk_block(g);
  stage_w<D>(cx, w, g, blk);
  stage_rows<D>(r_s, r, g, blk);
  stage_rows<D>(k_s, k, g, blk);
  stage_rows<D>(v_s, v, g, blk);
  stage_rows<D>(do_s, dout, g, blk);
  repro::cp_async_commit();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = warp * kSub;
  const int ch = threadIdx.x % D, seg = threadIdx.x / D;
  // S0 and dS by 16-byte reads across the block (float4 i = tid + 128 j:
  // row i / TPR, columns 4 (i % TPR)..); dS goes to its tiles, S0 waits in
  // registers for A's place
  float4 s0v[SPT], dsv[SPT];
  {
    const float4* s0p = reinterpret_cast<const float4*>(states + blk.slot * D * D);
    const float4* dsp = reinterpret_cast<const float4*>(dstates + blk.slot * D * D);
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int i = threadIdx.x + j * kTcThreads;
      if (i < D * D / 4) s0v[j] = s0p[i], dsv[j] = dsp[i];
    }
  }
  if (threadIdx.x < D) u_s[threadIdx.x] = u[blk.h * D + threadIdx.x];
  cum_logs<D, 1>(cx, g, blk);
  // e^{cT} <S0, dS> per key channel: each row's TPR threads are neighbouring
  // lanes of one warp
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int i = threadIdx.x + j * kTcThreads;
    float sum = 0.f;
    if (i < D * D / 4) {
      const float4 a = s0v[j], b4 = dsv[j];
      sum = a.x * b4.x + a.y * b4.y + a.z * b4.z + a.w * b4.w;
      const int off = (i / TPR) * LD + 4 * (i % TPR);
      put2_hi_lo(ds_hi, ds_lo, off, b4.x, b4.y);
      put2_hi_lo(ds_hi, ds_lo, off + 2, b4.z, b4.w);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (i < D * D / 4 && i % TPR == 0)
      end_s[i / TPR] = __expf(cx[kTcChunk * CS + i / TPR]) * sum;
  }
  repro::cp_async_wait<0>();
  __syncthreads();

  // ---- phase 1: dov and A, the warp's rows, blocks u <= t ----
  for (int J = 0; J <= warp; ++J) {
    float acc[2][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4], b[4];
      repro::frag_a<LD>(a, do_s, r0, kk * 16, lane);
      repro::frag_bt<LD>(b, v_s, J * kSub, kk * 16, lane);
      float part[2][4];
      repro::mma_bf16_zero(part[0], a, b[0], b[1]);
      repro::mma_bf16_zero(part[1], a, b[2], b[3]);
      add(acc, part);
    }
    block_to_smem(q_hi, q_lo, acc, r0, J * kSub);
  }
  score_rows<D>(
      r_s, k_s, cx, u_s, warp,
      [&](int J, const float (&a)[2][4]) { block_to_smem(a_hi, a_lo, a, r0, J * kSub); },
      [&](int t, int uu, float a) { put_hi_lo(a_hi, a_lo, (r0 + t) * kLT + r0 + uu, a); });
  for (int e = lane; e < kSub * kSub; e += 32)   // A's diagonal block is 0 above its diagonal
    if (e % kSub > e / kSub) put_hi_lo(a_hi, a_lo, (r0 + e / kSub) * kLT + r0 + e % kSub, 0.f);
  __syncthreads();

  // ---- phase 2, the warp's rows as u: dv, q', z' ----
  {
    float acc[NT][4];
    zero(acc);
    for (int I = warp; I < kSubs; ++I) {
      uint32_t ah[4], al[4];
      repro::frag_at<kLT>(ah, a_hi, I * kSub, r0, lane);
      repro::frag_at<kLT>(al, a_lo, I * kSub, r0, lane);
      float part[NT][4];
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t b[4];
        repro::frag_b<LD>(b, do_s, I * kSub, n * 8, lane);
        mma_fa_zero(part[n], ah, al, b[0], b[1]);
        mma_fa_zero(part[n + 1], ah, al, b[2], b[3]);
      }
      add(acc, part);
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ah[4], al[4];
      frag_a_scaled<LD>(ah, al, k_s, r0, kk * 16, [&](int t, int c) {
        return __expf(cx[kTcChunk * CS + c] - cx[(t + 1) * CS + c]);
      });
      float part[NT][4];
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bh[4], bl[4];
        repro::frag_b<LD>(bh, ds_hi, kk * 16, n * 8, lane);
        repro::frag_b<LD>(bl, ds_lo, kk * 16, n * 8, lane);
        const uint32_t h0[2] = {bh[0], bh[1]}, l0[2] = {bl[0], bl[1]};
        const uint32_t h1[2] = {bh[2], bh[3]}, l1[2] = {bl[2], bl[3]};
        mma3_zero(part[n], ah, al, h0, l0);
        mma3_zero(part[n + 1], ah, al, h1, l1);
      }
      add(acc, part);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int t = r0 + ar(2 * p);
      if (blk.t0 + t >= g.S) continue;
      bf16* dst = dv + row_off(g, blk.b, blk.t0 + t, blk.h, D);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + ac(0)) =
            __floats2bfloat162_rn(acc[n][2 * p], acc[n][2 * p + 1]);
    }
  }
  float qp[NT][4], zp[NT][4];
  {
    zero(qp);
    const int rx = r0 + kSub;                  // cx[rx] = cum_{r0+15}
    for (int I = warp + 1; I < kSubs; ++I) {
      uint32_t ah[4], al[4];
      repro::frag_at<kLT>(ah, q_hi, I * kSub, r0, lane);
      repro::frag_at<kLT>(al, q_lo, I * kSub, r0, lane);
      float part[NT][4];
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bh[2][2], bl[2][2];
        frag_b_scaled<LD>(bh, bl, r_s, I * kSub, n * 8, [&](int t, int c) {
          return __expf(cx[t * CS + c] - cx[rx * CS + c]);
        });
        mma3_zero(part[n], ah, al, bh[0], bl[0]);
        mma3_zero(part[n + 1], ah, al, bh[1], bl[1]);
      }
      add(qp, part);
    }
    zero(zp);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      repro::frag_a<LD>(a, v_s, r0, kk * 16, lane);
      float part[NT][4];
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bh[4], bl[4];
        repro::frag_bt<LD>(bh, ds_hi, n * 8, kk * 16, lane);
        repro::frag_bt<LD>(bl, ds_lo, n * 8, kk * 16, lane);
        const uint32_t h0[2] = {bh[0], bh[1]}, l0[2] = {bl[0], bl[1]};
        const uint32_t h1[2] = {bh[2], bh[3]}, l1[2] = {bl[2], bl[3]};
        mma_fb_zero(part[n], a, h0, l0);
        mma_fb_zero(part[n + 1], a, h1, l1);
      }
      add(zp, part);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int uu = r0 + ar(e), c = n * 8 + ac(e);
        const float cu = cx[(uu + 1) * CS + c];
        qp[n][e] *= __expf(cx[rx * CS + c] - cu);
        zp[n][e] *= __expf(cx[kTcChunk * CS + c] - cu);
      }
  }
  __syncthreads();                             // A is dead: S0 takes its place
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int i = threadIdx.x + j * kTcThreads;
    if (i >= D * D / 4) continue;
    const int off = (i / TPR) * LD + 4 * (i % TPR);
    put2_hi_lo(s0_hi, s0_lo, off, s0v[j].x, s0v[j].y);
    put2_hi_lo(s0_hi, s0_lo, off + 2, s0v[j].z, s0v[j].w);
  }
  __syncthreads();

  // ---- phase 2, the warp's rows as t: dr' off the diagonal blocks ----
  float drp[NT][4];
  {
    float acc[NT][4];
    zero(acc);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      repro::frag_a<LD>(a, do_s, r0, kk * 16, lane);
      float part[NT][4];
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bh[4], bl[4];
        repro::frag_bt<LD>(bh, s0_hi, n * 8, kk * 16, lane);
        repro::frag_bt<LD>(bl, s0_lo, n * 8, kk * 16, lane);
        const uint32_t h0[2] = {bh[0], bh[1]}, l0[2] = {bl[0], bl[1]};
        const uint32_t h1[2] = {bh[2], bh[3]}, l1[2] = {bl[2], bl[3]};
        mma_fb_zero(part[n], a, h0, l0);
        mma_fb_zero(part[n + 1], a, h1, l1);
      }
      add(acc, part);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        drp[n][e] = acc[n][e] * __expf(cx[(r0 + ar(e)) * CS + n * 8 + ac(e)]);
    if (warp > 0) {
      zero(acc);
      for (int J = 0; J < warp; ++J) {
        uint32_t ah[4], al[4];
        repro::frag_a<kLT>(ah, q_hi, r0, J * kSub, lane);
        repro::frag_a<kLT>(al, q_lo, r0, J * kSub, lane);
        float part[NT][4];
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bh[2][2], bl[2][2];
          frag_b_scaled<LD>(bh, bl, k_s, J * kSub, n * 8, [&](int uu, int c) {
            return __expf(cx[r0 * CS + c] - cx[(uu + 1) * CS + c]);
          });
          mma3_zero(part[n], ah, al, bh[0], bl[0]);
          mma3_zero(part[n + 1], ah, al, bh[1], bl[1]);
        }
        add(acc, part);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + ac(e);
          drp[n][e] += acc[n][e] * __expf(cx[(r0 + ar(e)) * CS + c] - cx[r0 * CS + c]);
        }
    }
  }
  __syncthreads();                             // phases 1-2 tiles but dov's are dead
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int off = (r0 + ar(2 * p)) * D + n * 8 + ac(0);
      *reinterpret_cast<float2*>(drp_s + off) = make_float2(drp[n][2 * p], drp[n][2 * p + 1]);
      *reinterpret_cast<float2*>(qp_s + off) = make_float2(qp[n][2 * p], qp[n][2 * p + 1]);
      *reinterpret_cast<float2*>(zp_s + off) = make_float2(zp[n][2 * p], zp[n][2 * p + 1]);
    }
  // w for phase 4's rows, read ahead
  const int j0 = seg * RPS;
  float wv[RPS];
#pragma unroll
  for (int j = 0; j < RPS; ++j) {
    const int row = blk.t0 + j0 + j;
    wv[j] = row < g.S ? w[row_off(g, blk.b, row, blk.h, D) + ch] : 1.f;
  }
  __syncthreads();

  // ---- phase 3: the diagonal blocks' pairs, thread (channel c, sub-chunk I) ----
  auto dov_at = [&](int t, int uu) {
    return __bfloat162float(q_hi[t * kLT + uu]) + __bfloat162float(q_lo[t * kLT + uu]);
  };
  for (int p = threadIdx.x; p < kSubs * D; p += kTcThreads) {
    const int c = p % D, i0 = (p / D) * kSub;
    float ku[kSub], cu[kSub], qa[kSub];
#pragma unroll
    for (int uu = 0; uu < kSub; ++uu) {
      ku[uu] = __bfloat162float(k_s[(i0 + uu) * LD + c]);
      cu[uu] = cx[(i0 + uu + 1) * CS + c];
      qa[uu] = 0.f;
    }
    float ra[kSub];                          // sums in registers: no store until the end,
#pragma unroll                                 // so every read can be issued early
    for (int t = 1; t < kSub; ++t) {
      const float rt = __bfloat162float(r_s[(i0 + t) * LD + c]), ci = cx[(i0 + t) * CS + c];
      float a = 0.f;
#pragma unroll
      for (int uu = 0; uu < t; ++uu) {
        const float x = dov_at(i0 + t, i0 + uu) * __expf(ci - cu[uu]);
        a += x * ku[uu];
        qa[uu] += x * rt;
      }
      ra[t] = a;
    }
#pragma unroll
    for (int t = 1; t < kSub; ++t) drp_s[(i0 + t) * D + c] += ra[t];
#pragma unroll
    for (int uu = 0; uu < kSub - 1; ++uu) qp_s[(i0 + uu) * D + c] += qa[uu];
  }
  __syncthreads();

  // ---- phase 4 ----
  for (int i = threadIdx.x; i < kTcChunk * D; i += kTcThreads) {
    const int t = i / D, c = i % D;
    if (blk.t0 + t >= g.S) continue;
    const float bon = u_s[c] * dov_at(t, t);
    const int64_t off = row_off(g, blk.b, blk.t0 + t, blk.h, D) + c;
    dr[off] = __float2bfloat16_rn(drp_s[i] + bon * __bfloat162float(k_s[t * LD + c]));
    dk[off] = __float2bfloat16_rn(qp_s[i] + zp_s[i] + bon * __bfloat162float(r_s[t * LD + c]));
  }
  // dl down each channel: thread (ch, seg) takes rows j0.. of its segment;
  // with X = r dr', Y = k q', Z = k z' (and du's r k dov[t][t]), each
  // segment's totals first, then dl_j = sum_{t>j} X_t - sum_{u>=j} Y_u +
  // sum_{u<j} Z_u + e^{cT} <S0, dS>
  {
    float tx = 0.f, ty = 0.f, tz = 0.f, tu = 0.f;
    for (int j = j0; j < j0 + RPS; ++j) {
      const float rj = __bfloat162float(r_s[j * LD + ch]), kj = __bfloat162float(k_s[j * LD + ch]);
      tx += rj * drp_s[j * D + ch];
      ty += kj * qp_s[j * D + ch];
      tz += kj * zp_s[j * D + ch];
      tu += rj * kj * dov_at(j, j);
    }
    __syncthreads();                           // dr, dk have read z'
    red_s[threadIdx.x] = tx;
    red_s[kTcThreads + threadIdx.x] = ty;
    red_s[2 * kTcThreads + threadIdx.x] = tz;
    red_s[3 * kTcThreads + threadIdx.x] = tu;
  }
  __syncthreads();
  float sx = 0.f, sy = 0.f, pz = 0.f;          // X, Y of the later segments, Z of the earlier
  for (int o = 0; o < SEG; ++o) {
    const int q = o * D + ch;
    if (o > seg) sx += red_s[q], sy += red_s[kTcThreads + q];
    if (o < seg) pz += red_s[2 * kTcThreads + q];
  }
  float before[RPS];                          // sum_{u<j} Z_u
#pragma unroll
  for (int jj = 0; jj < RPS; ++jj) {
    before[jj] = pz;
    pz += __bfloat162float(k_s[(j0 + jj) * LD + ch]) * zp_s[(j0 + jj) * D + ch];
  }
#pragma unroll
  for (int jj = RPS - 1; jj >= 0; --jj) {
    const int j = j0 + jj;
    sy += __bfloat162float(k_s[j * LD + ch]) * qp_s[j * D + ch];
    const float dl = sx - sy + before[jj] + end_s[ch];
    sx += __bfloat162float(r_s[j * LD + ch]) * drp_s[j * D + ch];
    if (blk.t0 + j < g.S)
      dw[row_off(g, blk.b, blk.t0 + j, blk.h, D) + ch] = wv[jj] > kFloor ? dl / wv[jj] : 0.f;
  }
  if (seg == 0) {
    float du = 0.f;
    for (int o = 0; o < SEG; ++o) du += red_s[3 * kTcThreads + o * D + ch];
    du_part[((static_cast<int64_t>(blk.b) * g.NC + blk.c) * g.H + blk.h) * D + ch] = du;
  }
}

// du [H, D] = sum_i du_part[i] over the n_part partials ([n_part, H, D]) in
// order: the batches (f32) or the (batch, chunk)s (bf16)
__global__ void __launch_bounds__(kScanThreads)
rwkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du, int n_part,
                    int hd) {
  const int i = blockIdx.x * kScanThreads + threadIdx.x;
  if (i >= hd) return;
  float s = 0.f;
  for (int p = 0; p < n_part; ++p) s += du_part[static_cast<int64_t>(p) * hd + i];
  du[i] = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
cudaError_t fwd_f32(const void* r, const void* k, const void* v, const float* w, const float* u,
                    const float* s0, void* o, float* s_final, float* states, const Geo& g,
                    cudaStream_t s) {
  auto kern = rwkv6_fwd_kernel<float, D>;
  if (cudaError_t e = allow_smem(kern, fwd_smem<D>())) return e;
  kern<<<g.B * g.H, kThreads, fwd_smem<D>(), s>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v), w,
      u, s0, static_cast<float*>(o), s_final, states, g);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_bf16(const void* r, const void* k, const void* v, const float* w, const float* u,
                     const float* s0, void* o, float* s_final, float* states, float* dec,
                     const Geo& g, cudaStream_t s) {
  const int blocks = g.B * g.NC * g.H;
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  auto inc = rwkv6_fwd_inc_kernel<D>;
  if (cudaError_t e = allow_smem(inc, IncTc<D>::kSmem)) return e;
  inc<<<blocks, kTcThreads, IncTc<D>::kSmem, s>>>(kp, vp, w, states, dec, g);
  if (cudaError_t e = cudaGetLastError()) return e;
  const int64_t n = static_cast<int64_t>(g.B) * g.H * D * D;
  rwkv6_fwd_scan_kernel<<<(n / 4 + kScanThreads - 1) / kScanThreads, kScanThreads, 0, s>>>(
      states, dec, s0, s_final, n, D, g.NC);
  if (cudaError_t e = cudaGetLastError()) return e;
  auto out = rwkv6_fwd_out_kernel<D>;
  if (cudaError_t e = allow_smem(out, OutTc<D>::kSmem)) return e;
  out<<<blocks, kTcThreads, OutTc<D>::kSmem, s>>>(static_cast<const bf16*>(r), kp, vp, w, u,
                                                  states, static_cast<bf16*>(o), g);
  return cudaGetLastError();
}

cudaError_t du_sum(const float* du_part, float* du, int n_part, int hd, cudaStream_t s) {
  rwkv6_bwd_du_kernel<<<(hd + kScanThreads - 1) / kScanThreads, kScanThreads, 0, s>>>(
      du_part, du, n_part, hd);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_f32(const void* r, const void* k, const void* v, const float* w, const float* u,
                    const void* dout, const float* states, void* dr, void* dk, void* dv,
                    float* dw, float* du_part, float* du, const Geo& g, cudaStream_t s) {
  using F = float;
  auto kern = rwkv6_bwd_kernel<F, D>;
  if (cudaError_t e = allow_smem(kern, bwd_smem<D>())) return e;
  kern<<<g.B * g.H, kThreads, bwd_smem<D>(), s>>>(
      static_cast<const F*>(r), static_cast<const F*>(k), static_cast<const F*>(v), w, u,
      static_cast<const F*>(dout), states, static_cast<F*>(dr), static_cast<F*>(dk),
      static_cast<F*>(dv), dw, du_part, g);
  if (cudaError_t e = cudaGetLastError()) return e;
  return du_sum(du_part, du, g.B, g.H * D, s);
}

template <int D>
cudaError_t bwd_bf16(const void* r, const void* k, const void* v, const float* w, const float* u,
                     const void* dout, const float* states, void* dr, void* dk, void* dv,
                     float* dw, float* du_part, float* du, float* dstates, float* dec,
                     const Geo& g, cudaStream_t s) {
  const int blocks = g.B * g.NC * g.H;
  const bf16* rp = static_cast<const bf16*>(r);
  const bf16* dop = static_cast<const bf16*>(dout);
  auto inc = rwkv6_bwd_inc_kernel<D>;
  if (cudaError_t e = allow_smem(inc, IncTc<D>::kSmem)) return e;
  inc<<<blocks, kTcThreads, IncTc<D>::kSmem, s>>>(rp, dop, w, dstates, dec, g);
  if (cudaError_t e = cudaGetLastError()) return e;
  const int64_t n = static_cast<int64_t>(g.B) * g.H * D * D;
  rwkv6_bwd_scan_kernel<<<(n / 4 + kScanThreads - 1) / kScanThreads, kScanThreads, 0, s>>>(
      dstates, dec, n, D, g.NC);
  if (cudaError_t e = cudaGetLastError()) return e;
  auto grad = rwkv6_bwd_grad_kernel<D>;
  if (cudaError_t e = allow_smem(grad, GradTc<D>::kSmem)) return e;
  grad<<<blocks, kTcThreads, GradTc<D>::kSmem, s>>>(
      rp, static_cast<const bf16*>(k), static_cast<const bf16*>(v), w, u, dop, states, dstates,
      static_cast<bf16*>(dr), static_cast<bf16*>(dk), static_cast<bf16*>(dv), dw, du_part, g);
  if (cudaError_t e = cudaGetLastError()) return e;
  return du_sum(du_part, du, g.B * g.NC, g.H * D, s);
}

}  // namespace

#define REPRO_RWKV_DIMS(DIM_CASE) DIM_CASE(16) DIM_CASE(32) DIM_CASE(64)

// r, k, v [B, S, H, D] (dtype), w [B, S, H, D] f32, u [H, D] f32 and the
// initial state s0 [B, H, D, D] f32 (key dim first; null: zeros, bf16: 16-byte
// aligned) -> o like r, s_final [B, H, D, D] f32 and the state at each
// chunk's entry [B, H, NC, D, D] f32 (NC = ceil(S / 32) in f32, ceil(S / 64)
// in bf16).  f32: states may be null (not wanted) and dec is ignored.  bf16:
// states is required (scratch when not wanted) and so is dec [B, H, NC, D]
// f32 (scratch).
extern "C" int repro_rwkv6_fwd(int dtype, const void* r, const void* k, const void* v,
                               const float* w, const float* u, const float* s0, void* o,
                               float* s_final, float* states, float* dec, int B, int S, int H,
                               int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16) {
    if (states == nullptr || dec == nullptr) return cudaErrorInvalidValue;
    const Geo g{B, S, H, (S + kTcChunk - 1) / kTcChunk};
#define REPRO_FWD_CASE(DIM) \
  case DIM: return fwd_bf16<DIM>(r, k, v, w, u, s0, o, s_final, states, dec, g, s);
    switch (D) {
      REPRO_RWKV_DIMS(REPRO_FWD_CASE)
      default: return cudaErrorInvalidValue;
    }
#undef REPRO_FWD_CASE
  }
  if (dtype != repro::kF32) return cudaErrorInvalidValue;
  const Geo g{B, S, H, (S + kChunk - 1) / kChunk};
#define REPRO_FWD_CASE(DIM) \
  case DIM: return fwd_f32<DIM>(r, k, v, w, u, s0, o, s_final, states, g, s);
  switch (D) {
    REPRO_RWKV_DIMS(REPRO_FWD_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FWD_CASE
}

// The backward of repro_rwkv6_fwd for the output gradient dout (a zero
// gradient on s_final), from the chunk-entry states the forward wrote:
// dr, dk, dv like r; dw [B, S, H, D] f32; du [H, D] f32, the sum in order
// of the partials du_part [n_part, H, D] f32 (scratch; n_part = B in f32,
// B * NC in bf16).  bf16 also takes the scratch dstates (like states) and
// dec [B, H, NC, D] f32; f32 ignores both.
extern "C" int repro_rwkv6_bwd(int dtype, const void* r, const void* k, const void* v,
                               const float* w, const float* u, const void* dout,
                               const float* states, void* dr, void* dk, void* dv, float* dw,
                               float* du_part, float* du, float* dstates, float* dec, int B,
                               int S, int H, int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16) {
    if (dstates == nullptr || dec == nullptr) return cudaErrorInvalidValue;
    const Geo g{B, S, H, (S + kTcChunk - 1) / kTcChunk};
#define REPRO_BWD_CASE(DIM)                                                                 \
  case DIM:                                                                                 \
    return bwd_bf16<DIM>(r, k, v, w, u, dout, states, dr, dk, dv, dw, du_part, du, dstates, \
                         dec, g, s);
    switch (D) {
      REPRO_RWKV_DIMS(REPRO_BWD_CASE)
      default: return cudaErrorInvalidValue;
    }
#undef REPRO_BWD_CASE
  }
  if (dtype != repro::kF32) return cudaErrorInvalidValue;
  const Geo g{B, S, H, (S + kChunk - 1) / kChunk};
#define REPRO_BWD_CASE(DIM) \
  case DIM:                 \
    return bwd_f32<DIM>(r, k, v, w, u, dout, states, dr, dk, dv, dw, du_part, du, g, s);
  switch (D) {
    REPRO_RWKV_DIMS(REPRO_BWD_CASE)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}
