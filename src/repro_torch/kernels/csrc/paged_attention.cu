// Paged prefill attention over a block-table-addressed KV pool.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py
// _paged_prefill (pallas_call at :273).  Decode runs csrc/decode_attention.cu.
//
// Queries are [B, C, H, D] (a prefill chunk: B = 1); KV pages are [KvH, NB,
// BS, D]; the block table is [B, MB] int32.  Query rows of one kv head are
// numbered row-major (position, group): row r is chunk position r / G and
// query head kvh * G + r % G, G = H / KvH.
//
// Grid (row tiles, KvH, B).  A block owns kRows = 16 query rows of one
// (sequence, kv head), reads its own block-table entries, and walks the keys
// [0, tile_end) in steps of 32: tile_end = min(total, q_offset + last
// position of the tile + 1), so a q-tile never touches a page past its causal
// end (the TPU kernel's per-q-tile live-page clamp).  Each step stages 32
// keys of K and V in shared memory as f32 (K rows padded to D + 1 floats so
// that lane j reading key j is free of bank conflicts); every warp then
// handles 4 query rows: lane j scores key j, a warp max/sum gives the
// online-softmax update, and each lane accumulates D / 32 output dims.
// m, l and acc stay in registers in f32 for the whole walk, and nothing is
// carried between blocks.  Masking uses NEG_INF = -1e30 (not -inf), the
// normaliser is floored at 1e-30, and a row that sees no key returns the
// combine identity (acc, m, l) = (0, -1e30, 0), all as the TPU kernels do.
//
// int8 pool (the TPU kernel's quantized branch, prefill_attention.py
// :165-170): pages are int8_t and k_scales / v_scales [KvH, NB] f32 hold one
// scale per (kv head, page).  The page element type P is a template
// parameter apart from the query type T (q and out stay f32 or bf16), and
// the staging loop multiplies each int8 value by its scale in f32
// before it goes to shared memory -- the product the plain version's gather
// forms, rounded once -- so everything after it (online softmax, masking,
// partials, the causal tile end) is the float pool's code unchanged.
//
// Sequence-sharded pools (the TPU kernel's skip_null mode,
// prefill_attention.py:142-146): a shard is the view pages[:,
// s*nbl:(s+1)*nbl] of the one pool, read in place through the kv-head
// strides `page_stride` / `scale_stride` (elements), with its shard-local
// table.  With `skip_null` set, a key whose table entry is 0 (a page another
// shard owns) is masked and its K/V bytes are never loaded; the test is per
// key, since a 32-key step straddles two pages at BS 16, and a step none of
// whose keys is live is skipped whole.  Masked keys still add expf(-1e30 -
// m) to a row's sums while its m is -1e30; the first live key's corr = 0
// wipes that, and a row that never sees one (m still -1e30) is written as
// the identity (0, -1e30, 0).  The mode is a runtime argument, so the
// instantiations stay those of the float and int8 pools.
// Each step's page ids are looked up once per key (a step ahead, hiding the
// load) and published in shared memory for the staging loop, which then
// needs no table load or division per element.
//
// Bound on the H100: bytes.  Every live K/V byte is read once per (row tile,
// kv head); the products run on the CUDA cores in f32.  This first version
// keeps a simple load -> sync -> compute loop with scalar loads (one int8
// value a thread a step on the int8 pool); vectorised loads, a cp.async/TMA
// double buffer and tensor-core products are later work.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys staged per step: one per lane
constexpr float kNegInf = -1e30f;

// Blocks an SM each instantiation keeps resident (the kernel is
// latency-bound): 5 at D 128, where shared memory allows no more, else 8
// with bf16 queries (64 registers a thread) and 7 with f32.  Left to itself
// the compiler gives this kernel 72-132 registers, fewer blocks an SM, and
// the bf16 prefill at D 64 reads 15-22% slower on the H100.
template <typename T, int D>
constexpr int min_blocks() { return D > 64 ? 5 : sizeof(T) == 2 ? 8 : 7; }

// T: query and output type; P: page type (T, or int8_t with scales)
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<T, D>())
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                       const P* __restrict__ v_pages, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales, const int* __restrict__ tables,
                       int qoff, int tot, int skip_null, T* __restrict__ out,
                       float* __restrict__ acc_out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int C, int H, int KvH,
                       int64_t page_stride, int64_t scale_stride, int BS, int MB,
                       float scale) {
  constexpr int kDimsPerLane = (D + 31) / 32;
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KvH;
  const int n_rows = C * G;
  const int row0 = tile * kRows;

  // qoff and tot (the live keys, pre-clamped to MB * BS) are global
  // positions; the walk runs over the keys [0, tile_end)
  const int last_row = min(row0 + kRows, n_rows) - 1;
  const int tile_end = min(tot, qoff + last_row / G + 1);

  __shared__ float q_s[kRows][D];
  __shared__ float k_s[kKeys][D + 1];
  __shared__ float v_s[kKeys][D];
  __shared__ int page_s[kKeys];  // the step's page per key; -1: not loaded
  const int* table = tables + static_cast<int64_t>(b) * MB;

  for (int i = threadIdx.x; i < kRows * D; i += kWarps * 32) {
    const int r = i / D, d = i % D, row = row0 + r;
    float val = 0.f;
    if (row < n_rows) {
      const int pos = row / G, head = kvh * G + row % G;
      val = repro::to_f32(q[((static_cast<int64_t>(b) * C + pos) * H + head) * D + d]);
    }
    q_s[r][d] = val;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wrow0 = warp * kRowsPerWarp;  // this warp's first row in the tile
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
    qpos[rr] = qoff + (row0 + wrow0 + rr) / G;
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) acc[rr][dd] = 0.f;
  }

  const int64_t head_base = static_cast<int64_t>(kvh) * page_stride;
  // table entry of lane's key in the next step, loaded a step ahead so that
  // its latency hides behind the step before
  int next_tp = lane < tile_end ? table[lane / BS] : 0;
  for (int base = 0; base < tile_end; base += kKeys) {
    // lane's key of this step: its page if the key is inside the walk and,
    // under skip_null, on a page this shard owns (one table lookup per key,
    // never per step); warp 0 publishes the step's pages for the staging
    // loop, whose reads of the last step's ended at its second barrier
    const int key = base + lane;
    const int tp = next_tp;
    const int page = key < tile_end && (!skip_null || tp != 0) ? tp : -1;
    next_tp = key + kKeys < tile_end ? table[(key + kKeys) / BS] : 0;
    if (warp == 0) page_s[lane] = page;
    const bool live = page >= 0;
    // the previous step's reads (and the q staging) are done; a step with
    // no live key changes no row's (acc, m, l) and is skipped
    if (!__syncthreads_or(live)) continue;
    for (int i = threadIdx.x; i < kKeys * D; i += kWarps * 32) {
      const int j = i / D, d = i % D, kpos = base + j;
      float kv = 0.f, vv = 0.f;
      const int pg = page_s[j];
      if (pg >= 0) {
        const int64_t off = head_base + (static_cast<int64_t>(pg) * BS + kpos % BS) * D + d;
        kv = repro::to_f32(k_pages[off]);
        vv = repro::to_f32(v_pages[off]);
        if constexpr (kInt8) {  // dequantize: int8 * (kv head, page) scale
          const int64_t si = static_cast<int64_t>(kvh) * scale_stride + pg;
          kv *= k_scales[si];
          vv *= v_scales[si];
        }
      }
      k_s[j][d] = kv;
      v_s[j][d] = vv;
    }
    __syncthreads();

    // lane owns key base + lane: its score against each of the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) s[rr] += q_s[wrow0 + rr][d] * kd;
    }
    float p[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const bool valid = live && key <= qpos[rr] && key < tot;
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
      float pj[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) pj[rr] = __shfl_sync(0xffffffffu, p[rr], j);
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) {
        const int d = lane + 32 * dd;
        const float v = d < D ? v_s[j][d] : 0.f;
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) acc[rr][dd] += pj[rr] * v;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + wrow0 + rr;
    if (row >= n_rows) continue;
    if (m[rr] == kNegInf) {  // the row saw no key: the combine identity
      l[rr] = 0.f;
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) acc[rr][dd] = 0.f;
    }
    const int pos = row / G, head = kvh * G + row % G;
    const int64_t idx = (static_cast<int64_t>(b) * C + pos) * H + head;
    if (out != nullptr) {
      const float lf = fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) {
        const int d = lane + 32 * dd;
        if (d < D) out[idx * D + d] = repro::from_f32<T>(acc[rr][dd] / lf);
      }
    } else {
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) {
        const int d = lane + 32 * dd;
        if (d < D) acc_out[idx * D + d] = acc[rr][dd];
      }
      if (lane == 0) {
        m_out[idx] = m[rr];
        l_out[idx] = l[rr];
      }
    }
  }
}

// the head dims of _paged.HEAD_DIMS; another is an invalid-value error
template <typename T, typename P>
int launch(int D, dim3 grid, cudaStream_t s, const void* q, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* bt, int q_offset, int total,
           int skip_null, void* out, float* acc, float* m, float* l,
           int C, int H, int KvH, int64_t page_stride, int64_t scale_stride, int BS, int MB) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
#define REPRO_PAGED_CASE(DIM)                                                                 \
  case DIM:                                                                                   \
    paged_attention_kernel<T, P, DIM><<<grid, kWarps * 32, 0, s>>>(                           \
        static_cast<const T*>(q), static_cast<const P*>(kp), static_cast<const P*>(vp), ks,   \
        vs, bt, q_offset, total, skip_null, static_cast<T*>(out), acc, m, l,                  \
        C, H, KvH, page_stride, scale_stride, BS, MB, scale);                                \
    return cudaSuccess;
  switch (D) {
    REPRO_PAGED_CASE(16)
    REPRO_PAGED_CASE(64)
    REPRO_PAGED_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_CASE
}

}  // namespace

// q [B, C, H, D] of type `dtype`; k_pages, v_pages [KvH, NB, BS, D] of the
// same type, or int8 when k_scales / v_scales [KvH, NB] f32 are given (both
// NULL for a float pool), each dense but for its kv-head stride
// (page_stride, scale_stride elements: a shard's view of the pool); tables
// [B, MB] int32; q_offset and total = min(q_offset + length, MB * BS).
// skip_null nonzero masks the keys of zero table entries.  Either out [B,
// C, H, D] (normalised, element type) or the f32 partials acc [B, C, H, D],
// m and l [B, C, H] are written; the other is NULL.
extern "C" int repro_paged_attention(int dtype, const void* q, const void* k_pages,
                                     const void* v_pages, const float* k_scales,
                                     const float* v_scales, const int* tables, int q_offset,
                                     int total, int skip_null,
                                     void* out, float* acc, float* m, float* l, int B, int C,
                                     int H, int KvH, int64_t page_stride, int64_t scale_stride,
                                     int BS, int D, int MB, int n_tiles, void* stream) {
  if (B <= 0 || n_tiles <= 0) return cudaSuccess;
  if ((k_scales == nullptr) != (v_scales == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, KvH, B);
  REPRO_DISPATCH_DTYPE(dtype, T, {
    const int rc = k_scales != nullptr
        ? launch<T, int8_t>(D, grid, s, q, k_pages, v_pages, k_scales, v_scales, tables,
                            q_offset, total, skip_null, out, acc, m, l, C, H, KvH,
                            page_stride, scale_stride, BS, MB)
        : launch<T, T>(D, grid, s, q, k_pages, v_pages, nullptr, nullptr, tables, q_offset,
                       total, skip_null, out, acc, m, l, C, H, KvH, page_stride,
                       scale_stride, BS, MB);
    if (rc != cudaSuccess) return rc;
  });
  return cudaGetLastError();
}
