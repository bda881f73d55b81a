// Paged prefill attention over a block-table-addressed KV pool.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention.py
// _paged_prefill (_paged_prefill_kernel at :115, pallas_call at :273): its
// float pool, its int8 pool (the quantized branch, :165-170) and its
// skip_null mode (:142-146), each writing the normalised output or the f32
// partials.  Decode runs csrc/decode_attention.cu.
//
// Queries are [B, C, H, D] (a prefill chunk: B = 1); KV pages are [KvH, NB,
// BS, D]; the block table is [B, MB] int32.  Query rows of one kv head are
// numbered row-major (position, group): row r is chunk position r / G and
// query head kvh * G + r % G, G = H / KvH.  A block owns a tile of rows of
// one (sequence, kv head) and walks the keys [0, tile_end), tile_end =
// min(total, q_offset + last position of the tile + 1), so a q-tile never
// touches a page past its causal end (the TPU kernel's per-q-tile live-page
// clamp).  Masking uses NEG_INF = -1e30 (not -inf), the normaliser is
// floored at 1e-30, and a row that sees no key returns the combine identity
// (acc, m, l) = (0, -1e30, 0), all as the TPU kernels do.  Nothing is
// carried between blocks and nothing is summed with atomics: two launches
// give the same bits.
//
// Two forms, chosen by the query type (kernels/_paged.py:prefill_rows).
//
// bf16 (the serving path) runs on the tensor cores, the bf16 flash forward
// (flash_attention.cu) adapted to pages.  Grid (row tiles, KvH, B), the
// tiles with the most keys first; a block of 4 warps holds kTcRows = 64
// query rows, 16 a warp, so the G query heads of a kv head share every K/V
// byte a stage loads.  Warp 0 reads the tile's table prefix [0,
// ceil(tile_end / BS)) once and lists its pages in shared memory, (page id,
// table index) each; under skip_null only the nonzero entries, the pages
// this shard owns, compacted with a ballot and a popc prefix.  The walk
// runs over the listed pages' keys, page after page (only the last listed
// page can reach past tile_end), in stages of kStage = 64 keys: 4 pages at
// BS 16, 8 at BS 8, half a page at BS 128.  Each stage's K and V rows
// (BS x D contiguous elements a page) stream through a cp.async ring of 3
// stages (2 at D 128) in 16-byte copies, kept as bf16 rows padded to D + 8
// elements so that ldmatrix reads them free of bank conflicts, and the
// loader records each staged key's logical position (the mask's) beside
// them.  Q's fragments are loaded once a block; S = Q K^T runs on mma.sync
// m16n8k16 (bf16 operands, f32 accumulation); scale, mask and the online
// softmax stay in f32 registers, row max and sum over the four threads of
// a quad, and only a stage that is not full or reaches past the warp's
// first position applies the mask.  A warp skips a stage whose first key
// lies past its last row's position.  l sums the f32 p; P enters P V as a
// bf16 hi + lo pair (repacked from the score accumulator, V through
// ldmatrix.trans): one rounding of p left outputs near zero more than one
// bf16 ulp off the plain version's f32 p.  On the int8 pool the stages
// arrive as int8 by cp.async, with each key's (kv head, page) scales, and
// are widened to bf16 tiles in shared memory (integers up to 127 are exact
// in bf16); K's scale multiplies each score column in f32, V's is folded
// into P's column before the hi + lo split, and l sums the unscaled p, so
// no element-by-element dequantise pass remains.
//
// A sliding window (window > 0; 0 = none: the model's attn_window, which the
// TPU package runs through its plain version) keeps only the keys kpos >
// qpos - window, on both forms and both pools: a key is seen iff 0 <= qpos
// - kpos < window, one unsigned compare.  A tile's walk starts at the first
// key its earliest query can see, win_lo = qoff + row0 / G - window + 1 (the
// bf16 form lists its pages from win_lo's page on; the f32 form steps from
// win_lo itself), so a window costs the keys it keeps, not the prefix.  A
// key that is masked for a row whose running max is still the initial -1e30
// weighs 0 there (its exponent is taken against 0, not against -1e30): a
// windowed chunk's late rows meet whole stages of keys below their window
// before they see any key.  Without a window such weights are wiped by the
// row's first visible key (corr = exp(-1e30 - m) = 0), as before, and the
// bf16 form runs its own instantiations (kWin false): the window's extra
// compares in the stage loop cost the windowless row 2 14% when they were
// runtime tests in the one kernel (tools/prefill_readings.py, H100 at 700 W).
//
// f32 (the fp32 parity runs) keeps the first version on the CUDA cores:
// grid (row tiles, KvH, B), a block of kRows = 16 query rows walks the keys
// [0, tile_end) in steps of 32, each step staged in shared memory as f32 (K
// rows padded to D + 1 floats so that lane j reading key j is free of bank
// conflicts); every warp then handles 4 query rows: lane j scores key j, a
// warp max/sum gives the online-softmax update, and each lane accumulates
// ceil(D / 32) output dims (lane + 32 k, guarded below D).  Its int8 variant multiplies each int8 value by its
// scale in f32 as it stages it (the product the plain version's gather
// forms, rounded once).  Under skip_null a key whose table entry is 0 (a
// page another shard owns) is masked and its K/V bytes are never loaded;
// the test is per key, since a 32-key step straddles two pages at BS 16,
// and a step none of whose keys is live is skipped whole.  Masked keys
// still add expf(-1e30 - m) to a row's sums while its m is -1e30; the first
// live key's corr = 0 wipes that, and a row that never sees one (m still
// -1e30) is written as the identity.
//
// Sequence-sharded pools (both forms): a shard is the view pages[:,
// s*nbl:(s+1)*nbl] of the one pool, read in place through the kv-head
// strides `page_stride` / `scale_stride` (elements), with its shard-local
// table; the mode is a runtime argument, so the instantiations stay those
// of the float and int8 pools.
//
// Bound on the H100: at the serving shapes (a 512-row chunk over 768 keys,
// head dim 64) the bf16 form does ~1.9 FLOP a K/V byte per query row and
// reads each live K/V byte once per row tile; both bounds sit near 2-3 us,
// and a block's chain of stage latencies, not either peak, is what the
// kernel meets.  The f32 form keeps a load -> sync -> compute loop with
// scalar loads on the CUDA cores.
#include "common.cuh"

#include <climits>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys staged per step: one per lane
constexpr float kNegInf = -1e30f;

// Blocks an SM each instantiation keeps resident (the kernel is
// latency-bound): 5 at D 128, where shared memory allows no more, else 7.
// Left to itself the compiler gives this kernel 72-132 registers, fewer
// blocks an SM, and the prefill at D 64 read 15-22% slower on the H100.
template <int D>
constexpr int min_blocks() { return D > 64 ? 5 : 7; }

// T: query and output type; P: page type (T, or int8_t with scales)
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kWarps * 32, min_blocks<D>())
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                       const P* __restrict__ v_pages, const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales, const int* __restrict__ tables,
                       int qoff, int tot, int skip_null, int window, T* __restrict__ out,
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
  // positions; the walk runs over the keys [win_lo, tile_end)
  const int last_row = min(row0 + kRows, n_rows) - 1;
  const int tile_end = min(tot, qoff + last_row / G + 1);
  const int win_lo = window > 0 ? max(0, qoff + row0 / G - window + 1) : 0;
  // a key at kpos is visible to a query at qpos iff 0 <= qpos - kpos < W
  // (one unsigned compare; W = INT_MAX is causal masking alone)
  const unsigned W = window > 0 ? window : INT_MAX;

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
  int next_tp = win_lo + lane < tile_end ? table[(win_lo + lane) / BS] : 0;
  for (int base = win_lo; base < tile_end; base += kKeys) {
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
      const bool valid = live && key < tot && static_cast<unsigned>(qpos[rr] - key) < W;
      const float sv = valid ? s[rr] * scale : kNegInf;
      const float m_new = fmaxf(m[rr], repro::warp_max(sv));
      // a row that has seen no key yet weighs the masked ones 0
      p[rr] = expf(sv - (m_new == kNegInf ? 0.f : m_new));
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = 16 * kTcWarps;      // query rows a block (_paged.TC_ROWS)
constexpr int kStage = 64;                  // keys a stage (_paged.PREFILL_STAGE)
constexpr int kNoKey = 0x7fffffff;          // the position of a stage slot with no key
constexpr size_t kMaxSmem = 232448;         // a block's shared memory on sm_90

// Dynamic shared memory, in bytes: Q [kTcRows][D + 8] bf16; the ring, each
// stage K then V [kStage] rows (bf16 rows of D + 8, or int8 rows of D); on
// the int8 pool the widened K and V tiles [kStage][D + 8] bf16; per ring
// stage the keys' positions [kStage] int and, int8, their K and V scales
// [kStage] f32 each; the page count; the page list, an int2 a page.
template <typename P, int D>
struct TcLayout {
  static constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  static constexpr int LDS = repro::lds<D>();
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kRowBytes = kInt8 ? D : LDS * 2;
  static constexpr int kTileBytes = kStage * kRowBytes;
  static constexpr int kKeyWords = kInt8 ? 3 * kStage : kStage;
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + kTcRows * LDS * 2;
  static constexpr int kWide = kRing + kStages * 2 * kTileBytes;
  static constexpr int kKeys = kWide + (kInt8 ? 2 * kStage * LDS * 2 : 0);
  static constexpr int kCount = kKeys + kStages * kKeyWords * 4;
  static constexpr int kList = kCount + 16;
  static_assert(kRing % 16 == 0 && kTileBytes % 16 == 0 && kWide % 16 == 0 &&
                kList % 16 == 0, "16-byte aligned copies");
  static constexpr size_t bytes(int n_list) {
    return kList + static_cast<size_t>(n_list) * 8;
  }
};

// P: page type (bf16, or int8_t with scales); kWin: a window is given (the
// instantiations without one are the windowless kernel, compare for compare)
template <typename P, int D, bool kWin>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 3 : 2)
paged_prefill_tc_kernel(const bf16* __restrict__ q, const P* __restrict__ k_pages,
                        const P* __restrict__ v_pages, const float* __restrict__ k_scales,
                        const float* __restrict__ v_scales, const int* __restrict__ tables,
                        int qoff, int tot, int skip_null, int window, bf16* __restrict__ out,
                        float* __restrict__ acc_out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int C, int H, int KvH,
                        int64_t page_stride, int64_t scale_stride, int BS, int MB,
                        float scale) {
  using L = TcLayout<P, D>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int LDS = L::LDS, ST = L::kStages, KS = D / 16, DT = D / 8, NK = kStage / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::kQ);
  unsigned char* ring = smem + L::kRing;
  int* keys_s = reinterpret_cast<int*>(smem + L::kKeys);
  int* count_s = reinterpret_cast<int*>(smem + L::kCount);
  int2* list = reinterpret_cast<int2*>(smem + L::kList);

  const int tile = gridDim.x - 1 - blockIdx.x;   // the tiles with the most keys first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KvH, n_rows = C * G, row0 = tile * kTcRows;
  const int tile_end = min(tot, qoff + (min(row0 + kTcRows, n_rows) - 1) / G + 1);
  // the first key the tile's earliest query sees under a window; a key at
  // kpos is then visible to a query at qpos iff 0 <= qpos - kpos < W (one
  // unsigned compare)
  const int win_lo = kWin ? max(0, qoff + row0 / G - window + 1) : 0;
  const int W = kWin ? window : INT_MAX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, tq = lane & 3;     // fragment row and column pair
  const int wr0 = row0 + warp * 16;            // the warp's first row

  // Q's rows, 16 bytes a cp.async (rows past C * G zero-filled): their own
  // group, committed first
  {
    constexpr int CPR = D / 8;
    for (int i = threadIdx.x; i < kTcRows * CPR; i += kTcThreads) {
      const int r = i / CPR, c = i % CPR, row = row0 + r;
      const bool ok = row < n_rows;
      const int64_t off =
          ok ? ((static_cast<int64_t>(b) * C + row / G) * H + kvh * G + row % G) * D + c * 8 : 0;
      repro::cp_async16(q_s + r * LDS + c * 8, q + off, ok);
    }
    repro::cp_async_commit();
  }

  // the tile's pages in table order, (page id, table index), from win_lo's
  // page on; under skip_null only the ones this shard owns
  if (warp == 0) {
    const int* table = tables + static_cast<int64_t>(b) * MB;
    const int n_prefix = tile_end > 0 ? (tile_end + BS - 1) / BS : 0;
    int n = 0;
    for (int base = win_lo / BS; base < n_prefix; base += 32) {
      const int p = base + lane;
      const int pg = p < n_prefix ? table[p] : 0;
      const bool live = p < n_prefix && (!skip_null || pg != 0);
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) list[n + __popc(mask & ((1u << lane) - 1u))] = make_int2(pg, p);
      n += __popc(mask);
    }
    if (lane == 0) *count_s = n;
  }
  __syncthreads();
  // walk key w is row w % BS of list entry w / BS; only the last entry can
  // reach past tile_end, so the keys below it are a prefix of the walk
  const int n_pages = *count_s;
  const int n_walk =
      n_pages > 0 ? (n_pages - 1) * BS + min(BS, tile_end - list[n_pages - 1].y * BS) : 0;
  const int n_stages = (n_walk + kStage - 1) / kStage;

  const int64_t head_base = static_cast<int64_t>(kvh) * page_stride;
  auto load_stage = [&](int j) {
    unsigned char* k_dst = ring + (j % ST) * 2 * L::kTileBytes;
    unsigned char* v_dst = k_dst + L::kTileBytes;
    int* keys = keys_s + (j % ST) * L::kKeyWords;
    constexpr int CPR = D * static_cast<int>(sizeof(P)) / 16;   // 16-byte pieces of a row
    constexpr int EPC = 16 / static_cast<int>(sizeof(P));       // elements of a piece
    for (int i = threadIdx.x; i < kStage * CPR; i += kTcThreads) {
      const int r = i / CPR, c = i % CPR, w = j * kStage + r;
      const bool ok = w < n_walk;
      int64_t off = 0;
      int pg = 0, pos = kNoKey;
      if (ok) {
        const int e = w / BS, pr = w - e * BS;
        const int2 ent = list[e];
        pg = ent.x;
        pos = ent.y * BS + pr;
        off = head_base + (static_cast<int64_t>(pg) * BS + pr) * D + c * EPC;
      }
      repro::cp_async16(k_dst + r * L::kRowBytes + c * 16, k_pages + off, ok);
      repro::cp_async16(v_dst + r * L::kRowBytes + c * 16, v_pages + off, ok);
      if (c == 0) {
        keys[r] = pos;
        if constexpr (kInt8) {
          const int64_t si = ok ? static_cast<int64_t>(kvh) * scale_stride + pg : 0;
          float* sc = reinterpret_cast<float*>(keys + kStage);
          repro::cp_async4(sc + r, k_scales + si, ok);
          repro::cp_async4(sc + kStage + r, v_scales + si, ok);
        }
      }
    }
  };

  if (n_stages > 0) {
    load_stage(0);
    repro::cp_async_commit();
#pragma unroll
    for (int j = 1; j < ST - 1; ++j) {
      if (j < n_stages) load_stage(j);
      repro::cp_async_commit();
    }
  }

  // this thread's two rows (gr, gr + 8 of the warp's 16) and the warp's
  // first and last positions; a warp wholly past C * G computes nothing
  const bool warp_live = wr0 < n_rows;
  const int qpos0 = qoff + (wr0 + gr) / G, qpos1 = qoff + (wr0 + gr + 8) / G;
  const int wq_first = qoff + wr0 / G;
  const int wq_last = qoff + (min(wr0 + 15, n_rows - 1)) / G;

  uint32_t qa[KS][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's partial sums
  float acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int j = 0; j < n_stages; ++j) {
    repro::cp_async_wait<ST - 2>();
    __syncthreads();   // stage j has landed, and every warp is done with stage j - 1
    if (j + ST - 1 < n_stages) load_stage(j + ST - 1);
    repro::cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) repro::frag_a<LDS>(qa[kk], q_s, warp * 16, kk * 16, lane);
    }
    const int* keys = keys_s + (j % ST) * L::kKeyWords;
    const unsigned char* k_raw = ring + (j % ST) * 2 * L::kTileBytes;
    const bf16* k_t = reinterpret_cast<const bf16*>(k_raw);
    const bf16* v_t = k_t + kStage * LDS;
    if constexpr (kInt8) {
      // widen the stage's int8 K and V rows to the bf16 tiles (exact)
      bf16* kw = reinterpret_cast<bf16*>(smem + L::kWide);
      constexpr int CPR = D / 16;
      for (int i = threadIdx.x; i < 2 * kStage * CPR; i += kTcThreads) {
        const int t = i / (kStage * CPR), r = (i / CPR) % kStage, c = i % CPR;
        const int4 raw = *reinterpret_cast<const int4*>(k_raw + t * L::kTileBytes + r * D + c * 16);
        const int8_t* e8 = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          w[u] = repro::pack_f32_bf16(static_cast<float>(e8[2 * u]), static_cast<float>(e8[2 * u + 1]));
        uint4* dst = reinterpret_cast<uint4*>(kw + (t * kStage + r) * LDS + c * 16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      k_t = kw;
      v_t = kw + kStage * LDS;
    }
    // A stage no row of the warp can see is skipped: every key past the
    // warp's last position, or (under a window) every key of a full stage
    // at or below its first row's window (a short stage is the walk's last,
    // whose slots past the walk read kNoKey).
    if (!warp_live || keys[0] > wq_last || (kWin && wq_first - keys[kStage - 1] >= W))
      continue;

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
        repro::frag_bt<LDS>(kb, k_t, n * 8, kk * 16, lane);
        repro::mma_bf16(s[n], qa[kk], kb[0], kb[1]);
        repro::mma_bf16(s[n + 1], qa[kk], kb[2], kb[3]);
      }
    }
    if constexpr (kInt8) {   // K's scale, one a key, on its score column
      const float* ks = reinterpret_cast<const float*>(keys + kStage);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float2 sc = *reinterpret_cast<const float2*>(ks + n * 8 + 2 * tq);
        s[n][0] *= sc.x;
        s[n][1] *= sc.y;
        s[n][2] *= sc.x;
        s[n][3] *= sc.y;
      }
    }
    // scale, and mask unless the stage is full, the warp's first row sees
    // its last key and (under a window) its last row its first key (keys
    // past the walk read kNoKey)
    const bool whole = keys[kStage - 1] <= wq_first && (!kWin || wq_last - keys[0] < W);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int2 kp = whole ? make_int2(0, 0) : *reinterpret_cast<const int2*>(keys + n * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = (e & 1) ? kp.y : kp.x;
        const int qp = (e >> 1) ? qpos1 : qpos0;
        const bool seen = kWin ? static_cast<unsigned>(qp - kpos) < static_cast<unsigned>(W)
                               : kpos <= qp;
        s[n][e] = whole || seen ? s[n][e] * scale : kNegInf;
      }
    }
    // online softmax in f32: rows gr and gr + 8 of the warp's 16, each
    // spread over the four threads of a quad
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NK; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m[r], repro::quad_max(mx));
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
    // under a window, a row that has seen no key yet (m still -1e30) weighs
    // the stage's masked keys 0: their exponents are taken against 0
    const float mu[2] = {kWin && m[0] == kNegInf ? 0.f : m[0],
                         kWin && m[1] == kNegInf ? 0.f : m[1]};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = __expf(s[n][e] - mu[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      acc[t][0] *= corr[0];
      acc[t][1] *= corr[0];
      acc[t][2] *= corr[1];
      acc[t][3] *= corr[1];
    }
    // P V, 16 keys at a time: p (times V's scale on the int8 pool) as a
    // bf16 hi + lo pair, repacked from the score accumulator
#pragma unroll
    for (int ks = 0; ks < kStage / 16; ++ks) {
      float x[8] = {s[2 * ks][0], s[2 * ks][1], s[2 * ks][2], s[2 * ks][3],
                    s[2 * ks + 1][0], s[2 * ks + 1][1], s[2 * ks + 1][2], s[2 * ks + 1][3]};
      if constexpr (kInt8) {
        const float* vs = reinterpret_cast<const float*>(keys + 2 * kStage) + ks * 16 + 2 * tq;
        const float2 a = *reinterpret_cast<const float2*>(vs);
        const float2 c = *reinterpret_cast<const float2*>(vs + 8);
        x[0] *= a.x;
        x[1] *= a.y;
        x[2] *= a.x;
        x[3] *= a.y;
        x[4] *= c.x;
        x[5] *= c.y;
        x[6] *= c.x;
        x[7] *= c.y;
      }
      uint32_t hi[4], lo[4];
      repro::split_bf16(hi, lo, x);
#pragma unroll
      for (int t = 0; t < DT; t += 2) {
        uint32_t vb[4];
        repro::frag_b<LDS>(vb, v_t, ks * 16, t * 8, lane);
        repro::mma_bf16(acc[t], hi, vb[0], vb[1]);
        repro::mma_bf16(acc[t + 1], hi, vb[2], vb[3]);
        repro::mma_bf16(acc[t], lo, vb[0], vb[1]);
        repro::mma_bf16(acc[t + 1], lo, vb[2], vb[3]);
      }
    }
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = repro::quad_sum(l[r]);
    const int row = wr0 + gr + 8 * r;
    if (row >= n_rows) continue;
    const bool none = m[r] == kNegInf;     // the row saw no key: the combine identity
    const int64_t idx = (static_cast<int64_t>(b) * C + row / G) * H + kvh * G + row % G;
    if (out != nullptr) {
      const float lf = fmaxf(none ? 0.f : lsum, 1e-30f);
      bf16* orow = out + idx * D + 2 * tq;
#pragma unroll
      for (int t = 0; t < DT; ++t)
        *reinterpret_cast<uint32_t*>(orow + t * 8) = repro::pack_f32_bf16(
            none ? 0.f : acc[t][2 * r] / lf, none ? 0.f : acc[t][2 * r + 1] / lf);
    } else {
      float* arow = acc_out + idx * D + 2 * tq;
#pragma unroll
      for (int t = 0; t < DT; ++t)
        *reinterpret_cast<float2*>(arow + t * 8) =
            none ? make_float2(0.f, 0.f) : make_float2(acc[t][2 * r], acc[t][2 * r + 1]);
      if (tq == 0) {
        m_out[idx] = m[r];
        l_out[idx] = none ? 0.f : lsum;
      }
    }
  }
}

template <typename P, int D, bool kWin>
cudaError_t launch_tc(dim3 grid, cudaStream_t s, const void* q, const void* kp, const void* vp,
                      const float* ks, const float* vs, const int* bt, int q_offset, int total,
                      int skip_null, int window, void* out, float* acc, float* m, float* l,
                      int C, int H, int KvH, int64_t page_stride, int64_t scale_stride, int BS,
                      int MB) {
  using L = TcLayout<P, D>;
  auto kern = paged_prefill_tc_kernel<P, D, kWin>;
  // the page list holds at most the table prefix of the last tile
  const int n_list = total > 0 ? (total + BS - 1) / BS : 0;
  const size_t smem = L::bytes(n_list);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem)))
      return e;
  }
  kern<<<grid, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const P*>(kp), static_cast<const P*>(vp), ks, vs,
      bt, q_offset, total, skip_null, window, static_cast<bf16*>(out), acc, m, l, C, H, KvH,
      page_stride, scale_stride, BS, MB, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename P>
cudaError_t by_dim_tc(int D, dim3 grid, cudaStream_t s, const void* q, const void* kp,
                      const void* vp, const float* ks, const float* vs, const int* bt,
                      int q_offset, int total, int skip_null, int window, void* out, float* acc,
                      float* m, float* l, int C, int H, int KvH, int64_t page_stride,
                      int64_t scale_stride, int BS, int MB) {
#define REPRO_PREFILL_TC_CASE(DIM)                                                            \
  case DIM:                                                                                   \
    return window > 0                                                                         \
        ? launch_tc<P, DIM, true>(grid, s, q, kp, vp, ks, vs, bt, q_offset, total, skip_null, \
                                  window, out, acc, m, l, C, H, KvH, page_stride,             \
                                  scale_stride, BS, MB)                                       \
        : launch_tc<P, DIM, false>(grid, s, q, kp, vp, ks, vs, bt, q_offset, total,           \
                                   skip_null, 0, out, acc, m, l, C, H, KvH, page_stride,      \
                                   scale_stride, BS, MB);
  switch (D) {
    REPRO_PREFILL_TC_CASE(16)
    REPRO_PREFILL_TC_CASE(64)
    REPRO_PREFILL_TC_CASE(112)
    REPRO_PREFILL_TC_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PREFILL_TC_CASE
}

// the head dims of _paged.HEAD_DIMS; another is an invalid-value error
template <typename T, typename P>
int launch(int D, dim3 grid, cudaStream_t s, const void* q, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* bt, int q_offset, int total,
           int skip_null, int window, void* out, float* acc, float* m, float* l,
           int C, int H, int KvH, int64_t page_stride, int64_t scale_stride, int BS, int MB) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
#define REPRO_PAGED_CASE(DIM)                                                                 \
  case DIM:                                                                                   \
    paged_attention_kernel<T, P, DIM><<<grid, kWarps * 32, 0, s>>>(                           \
        static_cast<const T*>(q), static_cast<const P*>(kp), static_cast<const P*>(vp), ks,   \
        vs, bt, q_offset, total, skip_null, window, static_cast<T*>(out), acc, m, l,          \
        C, H, KvH, page_stride, scale_stride, BS, MB, scale);                                \
    return cudaSuccess;
  switch (D) {
    REPRO_PAGED_CASE(16)
    REPRO_PAGED_CASE(64)
    REPRO_PAGED_CASE(112)
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
// skip_null nonzero masks the keys of zero table entries; window > 0 keeps
// only the keys kpos > qpos - window (0: no window).  Either out [B,
// C, H, D] (normalised, element type) or the f32 partials acc [B, C, H, D],
// m and l [B, C, H] are written; the other is NULL.  n_tiles counts the
// query-row tiles of a (sequence, kv head): of kTcRows rows for bf16 (whose
// q, k_pages and v_pages start 16-byte aligned), of kRows for f32.
extern "C" int repro_paged_attention(int dtype, const void* q, const void* k_pages,
                                     const void* v_pages, const float* k_scales,
                                     const float* v_scales, const int* tables, int q_offset,
                                     int total, int skip_null, int window,
                                     void* out, float* acc, float* m, float* l, int B, int C,
                                     int H, int KvH, int64_t page_stride, int64_t scale_stride,
                                     int BS, int D, int MB, int n_tiles, void* stream) {
  if (B <= 0 || n_tiles <= 0) return cudaSuccess;
  if ((k_scales == nullptr) != (v_scales == nullptr) || BS <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles, KvH, B);
  int rc;
  switch (dtype) {
    case repro::kF32:
      rc = k_scales != nullptr
          ? launch<float, int8_t>(D, grid, s, q, k_pages, v_pages, k_scales, v_scales, tables,
                                  q_offset, total, skip_null, window, out, acc, m, l, C, H,
                                  KvH, page_stride, scale_stride, BS, MB)
          : launch<float, float>(D, grid, s, q, k_pages, v_pages, nullptr, nullptr, tables,
                                 q_offset, total, skip_null, window, out, acc, m, l, C, H,
                                 KvH, page_stride, scale_stride, BS, MB);
      break;
    case repro::kBF16:
      rc = k_scales != nullptr
          ? by_dim_tc<int8_t>(D, grid, s, q, k_pages, v_pages, k_scales, v_scales, tables,
                              q_offset, total, skip_null, window, out, acc, m, l, C, H, KvH,
                              page_stride, scale_stride, BS, MB)
          : by_dim_tc<bf16>(D, grid, s, q, k_pages, v_pages, nullptr, nullptr, tables, q_offset,
                            total, skip_null, window, out, acc, m, l, C, H, KvH, page_stride,
                            scale_stride, BS, MB);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}
