// Flash-decoding over a dense KV slab: one new query row per sequence
// against its cached keys.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py _decode
// (pallas_call at :114), behind decode_attention (:143) and
// decode_attention_partial (:151).
//
// q [B, H, D]; k, v [B, Sk, KvH, D], the model's slab of one layer, read in
// place: a block computes its own offsets from blockIdx and the strides, so
// the host never permutes, pads or copies the slab.  GQA: the G = H / KvH
// query heads of kv head kvh are kvh * G + r, r < G.  The key at slab row j
// has global position kv_offset + j and is valid below
// min(lens[b], kv_offset + Sk) (lens NULL: the whole slab), as in the TPU
// kernel (decode_attention.py:104-106).
//
// Grid (row tiles, KvH, B).  A block owns kRows = 4 query rows of one
// (sequence, kv head) and walks only the sequence's live keys.  Its four
// warps split them: warp w takes the 32-key steps w, w + 4, w + 8, ...,
// stages each step's K and V in its own shared-memory area as f32 (K rows
// padded to D + 1 floats, so lane j reading key j is free of bank
// conflicts; the loads are 16 bytes a lane, up to 16 in flight before the
// first store, since a load -> store loop of scalars serialises on memory
// latency), lane j scores key j against the four rows, and a warp
// max/sum gives the online-softmax update; each lane accumulates D / 32
// output dims.  q and p stay in f32, as in the TPU kernel
// (decode_attention.py:48-87).  At the end the four warps' (acc, m, l)
// are merged in shared memory by the partials algebra.  Masking uses
// NEG_INF = -1e30, the normaliser is floored at 1e-30, and a row that sees
// no key returns the combine identity (acc, m, l) = (0, -1e30, 0), as the
// port's paged kernel does.  (The TPU kernel and the JAX oracle count
// masked keys at p = 1 in such a row; both forms combine to zero weight
// beside any non-empty partial, and decode always sees >= 1 key.)
//
// Bound on the H100: bytes.  Each live K/V byte is read once per row tile
// (once in all when G <= 4), and the products are a few FLOPs per byte on
// the CUDA cores.  This first version keeps a plain load -> syncwarp ->
// compute loop per step: a cp.async double buffer and a split of the keys
// across blocks are later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;    // query rows per block; warp w finalises row w
constexpr int kKeys = 32;   // keys a warp stages per step: one per lane
constexpr float kNegInf = -1e30f;

// shared memory: q [kRows][D], then per warp K [kKeys][D + 1] and V
// [kKeys][D]; after the walk the warps' partials [kWarps][kRows][D + 2]
// reuse the staging areas
template <int D> __host__ __device__ constexpr int warp_floats() {
  return kKeys * (2 * D + 1);
}
template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) * (kRows * D + kWarps * warp_floats<D>());
}

// Stage keys [base, base + 32) of one (sequence, kv head) into a warp's
// K [kKeys][D + 1] and V [kKeys][D] f32 tiles; rows at or past n_live read
// as zeros.  Lane l moves the 16-byte chunks l, l + 32, ... of the step.
template <typename T, int D>
__device__ __forceinline__ void stage_step(float* __restrict__ k_s, float* __restrict__ v_s,
                                           const T* __restrict__ k, const T* __restrict__ v,
                                           int64_t head0, int64_t key_stride, int base,
                                           int n_live, int lane) {
  constexpr int kVec = 16 / sizeof(T);           // elements of a 16-byte chunk
  constexpr int kRowChunks = D / kVec;           // chunks of one key row
  constexpr int kPerLane = kKeys * kRowChunks / 32;
  constexpr int kBatch = kPerLane < 8 ? kPerLane : 8;
  static_assert(kPerLane % kBatch == 0, "whole batches");
#pragma unroll
  for (int t0 = 0; t0 < kPerLane; t0 += kBatch) {
    uint4 kr[kBatch], vr[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = lane + 32 * (t0 + u), row = base + c / kRowChunks;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (row < n_live) {
        const int64_t off = head0 + row * key_stride + (c % kRowChunks) * kVec;
        kr[u] = *reinterpret_cast<const uint4*>(k + off);
        vr[u] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = lane + 32 * (t0 + u), j = c / kRowChunks, d0 = (c % kRowChunks) * kVec;
      const T* kt = reinterpret_cast<const T*>(&kr[u]);
      const T* vt = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[j * (D + 1) + d0 + e] = repro::to_f32(kt[e]);
        v_s[j * D + d0 + e] = repro::to_f32(vt[e]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lens, int kv_offset, T* __restrict__ out,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int Sk, int H, int KvH, float scale) {
  static_assert(kWarps == kRows, "warp w finalises row w");
  constexpr int kDimsPerLane = (D + 31) / 32;
  extern __shared__ float smem[];
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KvH;
  const int row0 = tile * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q_s = smem;
  float* k_s = q_s + kRows * D + warp * warp_floats<D>();
  float* v_s = k_s + kKeys * (D + 1);

  // live keys, as slab rows [0, n_live)
  int end = kv_offset + Sk;
  if (lens != nullptr) end = min(end, lens[b]);
  const int n_live = max(0, end - kv_offset);

  for (int i = threadIdx.x; i < kRows * D; i += kWarps * 32) {
    const int row = row0 + i / D;
    q_s[i] = row < G
        ? repro::to_f32(q[(static_cast<int64_t>(b) * H + kvh * G + row) * D + i % D])
        : 0.f;
  }
  __syncthreads();

  float m[kRows], l[kRows], acc[kRows][kDimsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) acc[rr][dd] = 0.f;
  }

  const int64_t key_stride = static_cast<int64_t>(KvH) * D;   // slab row to slab row
  const int64_t head0 = (static_cast<int64_t>(b) * Sk * KvH + kvh) * D;
  for (int base = warp * kKeys; base < n_live; base += kWarps * kKeys) {
    __syncwarp();  // the warp's reads of the previous step are done
    stage_step<T, D>(k_s, v_s, k, v, head0, key_stride, base, n_live, lane);
    __syncwarp();

    // lane owns key base + lane: its score against each row of the tile
    float s[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane * (D + 1) + d];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) s[rr] += q_s[rr * D + d] * kd;
    }
    const bool valid = base + lane < n_live;
    float p[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const float sv = valid ? s[rr] * scale : kNegInf;
      const float m_new = fmaxf(m[rr], repro::warp_max(sv));
      p[rr] = expf(sv - m_new);
      const float corr = expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + repro::warp_sum(p[rr]);
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) acc[rr][dd] *= corr;
      m[rr] = m_new;
    }
    for (int j = 0; j < kKeys; ++j) {
      float pj[kRows];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) pj[rr] = __shfl_sync(0xffffffffu, p[rr], j);
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) {
        const int d = lane + 32 * dd;
        const float vd = d < D ? v_s[j * D + d] : 0.f;
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) acc[rr][dd] += pj[rr] * vd;
      }
    }
  }

  // merge the four warps' partials: m = max m_w, l = sum l_w e^(m_w - m),
  // acc likewise (a warp that saw no key holds (0, -1e30, 0))
  __syncthreads();  // every warp is done with its staging area
  float* part = q_s + kRows * D;  // [kWarps][kRows][D + 2]: acc, m, l
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    float* dst = part + (warp * kRows + rr) * (D + 2);
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) dst[d] = acc[rr][dd];
    }
    if (lane == 0) {
      dst[D] = m[rr];
      dst[D + 1] = l[rr];
    }
  }
  __syncthreads();

  const int rr = warp, row = row0 + rr;
  if (row >= G) return;
  float mw[kWarps], mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    mw[w] = part[(w * kRows + rr) * (D + 2) + D];
    mx = fmaxf(mx, mw[w]);
  }
  float lsum = 0.f, a[kDimsPerLane];
#pragma unroll
  for (int dd = 0; dd < kDimsPerLane; ++dd) a[dd] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float* src = part + (w * kRows + rr) * (D + 2);
    const float c = expf(mw[w] - mx);
    lsum += src[D + 1] * c;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) a[dd] += src[d] * c;
    }
  }
  const int64_t idx = static_cast<int64_t>(b) * H + kvh * G + row;
  if (out != nullptr) {
    const float lf = fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) out[idx * D + d] = repro::from_f32<T>(a[dd] / lf);
    }
  } else {
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) acc_out[idx * D + d] = a[dd];
    }
    if (lane == 0) {
      m_out[idx] = mx;
      l_out[idx] = lsum;
    }
  }
}

template <typename T, int D>
cudaError_t launch(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
                   const int* lens, int kv_offset, void* out, float* acc, float* m, float* l,
                   int Sk, int H, int KvH) {
  auto kern = dense_decode_kernel<T, D>;
  if (cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_bytes<D>())))
    return e;
  kern<<<grid, kWarps * 32, smem_bytes<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lens,
      kv_offset, static_cast<T*>(out), acc, m, l, Sk, H, KvH,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

// q [B, H, D]; k, v [B, Sk, KvH, D] (16-byte aligned); lens [B] int32
// (NULL: the whole slab); kv_offset is the global position of slab row 0.
// Either out [B, H, D] (normalised, element type) or the f32 partials acc
// [B, H, D], m and l [B, H] are written; the other is NULL.
extern "C" int repro_decode_attention(int dtype, const void* q, const void* k, const void* v,
                                      const int* lens, int kv_offset, void* out, float* acc,
                                      float* m, float* l, int B, int Sk, int H, int KvH, int D,
                                      void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (KvH <= 0 || H % KvH) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((H / KvH + kRows - 1) / kRows, KvH, B);
#define REPRO_DENSE_CASE(DIM) \
  case DIM: return launch<T, DIM>(grid, s, q, k, v, lens, kv_offset, out, acc, m, l, Sk, H, KvH);
  REPRO_DISPATCH_DTYPE(dtype, T,
    switch (D) {
      REPRO_DENSE_CASE(16)
      REPRO_DENSE_CASE(64)
      REPRO_DENSE_CASE(128)
      default: return cudaErrorInvalidValue;
    });
#undef REPRO_DENSE_CASE
  return cudaSuccess;
}
