// RWKV-6 wkv recurrence, chunked: the forward (o and the final state, and
// for training the state at each chunk's entry) and its backward.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_chunk.py (rwkv6_chunked,
// pallas_call at :87), which has no backward of its own: the JAX package
// differentiates its oracle.  Per (batch, head) the state S [D, D] (key dim
// first) is carried in shared memory in f32 across 32-token chunks:
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
// transpose or padding.
//
// One block of 256 threads per (batch, head): a sequential scan.  Thread
// roles, with RG = 256 / D row groups: a channel scan (thread c < D walks
// the chunk's rows); att and do . v with one warp per row t and lane u
// (the chunk is one warp wide); products over the state with thread
// (column e or channel c = tid % D, group g = tid / D) owning the rows
// g + RG i.  [T, D] tiles sit in shared memory with a row stride of D + 1
// floats, so a warp reading one column across rows touches 32 banks.
//
// The backward is one reverse pass over the chunks per (batch, head).  It
// reads the chunk-entry states S0 the training forward wrote ([B, H, NC,
// D, D] f32) and carries dS, the gradient of the chunk's exit state
// (dS <- diag(e^{cT}) dS + sum_t (r_t e^{cin_t}) do_t^T), and the running
// decay sum over later chunks.  With dr', dk' the gradients without the
// bonus term, the decay gradient is dl_j = sum_{t>j} r_t dr'_t -
// sum_{t>=j} k_t dk'_t (a reverse cumulative sum across chunk boundaries)
// and dw = dl / w where w > 1e-20.  du [H, D] sums over batch and time:
// each block writes its own [D] partial; the wrapper sums the B partials
// in a fixed order.  No atomics: two runs give the same bits.
//
// Bound on the H100: bytes (r, k, v, o in bf16 and w in f32 at ~0.8 FLOP a
// byte in f32).  This first version runs B * H blocks (80 at rwkv6-3b's
// B = 2, H = 40) on 132 SMs in f32 on the CUDA cores; the state's value
// columns are independent, so splitting them over blocks is the first lever.
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
                 const float* __restrict__ w, const float* __restrict__ u, T* __restrict__ o,
                 float* __restrict__ s_final, float* __restrict__ states, Geo g) {
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
  for (int i = tid; i < D * D; i += kThreads) S_s[i] = 0.f;
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
cudaError_t fwd(const void* r, const void* k, const void* v, const float* w, const float* u,
                void* o, float* s_final, float* states, const Geo& g, cudaStream_t s) {
  auto kern = rwkv6_fwd_kernel<T, D>;
  if (cudaError_t e = allow_smem(kern, fwd_smem<D>())) return e;
  kern<<<g.B * g.H, kThreads, fwd_smem<D>(), s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      static_cast<T*>(o), s_final, states, g);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* r, const void* k, const void* v, const float* w, const float* u,
                const void* dout, const float* states, void* dr, void* dk, void* dv, float* dw,
                float* du_part, const Geo& g, cudaStream_t s) {
  auto kern = rwkv6_bwd_kernel<T, D>;
  if (cudaError_t e = allow_smem(kern, bwd_smem<D>())) return e;
  kern<<<g.B * g.H, kThreads, bwd_smem<D>(), s>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      static_cast<const T*>(dout), states, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dv), dw, du_part, g);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_RWKV_DIMS(DIM_CASE) DIM_CASE(16) DIM_CASE(32) DIM_CASE(64)

// r, k, v [B, S, H, D] (dtype), w [B, S, H, D] f32, u [H, D] f32 -> o like
// r, s_final [B, H, D, D] f32 and, unless states is null, the state at each
// chunk's entry [B, H, ceil(S / 32), D, D] f32.
extern "C" int repro_rwkv6_fwd(int dtype, const void* r, const void* k, const void* v,
                               const float* w, const float* u, void* o, float* s_final,
                               float* states, int B, int S, int H, int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, S, H, (S + kChunk - 1) / kChunk};
#define REPRO_FWD_CASE(DIM) \
  case DIM: return fwd<T, DIM>(r, k, v, w, u, o, s_final, states, g, s);
  REPRO_DISPATCH_DTYPE(dtype, T,
    switch (D) {
      REPRO_RWKV_DIMS(REPRO_FWD_CASE)
      default: return cudaErrorInvalidValue;
    });
#undef REPRO_FWD_CASE
  return cudaSuccess;
}

// The backward of repro_rwkv6_fwd for the output gradient dout (a zero
// gradient on s_final), from the chunk-entry states the forward wrote:
// dr, dk, dv like r; dw [B, S, H, D] f32; du_part [B, H, D] f32, whose sum
// over B is du.
extern "C" int repro_rwkv6_bwd(int dtype, const void* r, const void* k, const void* v,
                               const float* w, const float* u, const void* dout,
                               const float* states, void* dr, void* dk, void* dv, float* dw,
                               float* du_part, int B, int S, int H, int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geo g{B, S, H, (S + kChunk - 1) / kChunk};
#define REPRO_BWD_CASE(DIM) \
  case DIM: return bwd<T, DIM>(r, k, v, w, u, dout, states, dr, dk, dv, dw, du_part, g, s);
  REPRO_DISPATCH_DTYPE(dtype, T,
    switch (D) {
      REPRO_RWKV_DIMS(REPRO_BWD_CASE)
      default: return cudaErrorInvalidValue;
    });
#undef REPRO_BWD_CASE
  return cudaSuccess;
}
