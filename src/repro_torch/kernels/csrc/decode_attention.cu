// Flash-decoding on Hopper: one new query row per sequence (all G query
// heads of a kv head) against its cached keys, read from the paged KV pool
// or from a dense KV slab.
//
// Replaces two TPU kernels of src/repro/kernels/decode_attention.py:
//   _paged_decode (pallas_call at :300; its float, int8, skip_null and
//                  kv_offset modes)
//   _decode       (pallas_call at :114; the dense slab)
//
// Both run one kernel template over a key source (PoolKeys, SlabKeys), so
// the walk, the online softmax and the merge are written once.  Two forms,
// chosen by shapes and dtype (kernels/_paged.py:decode_form): the CUDA-core
// form described here (f32 queries; bf16 at G = 1 up to head dim 64), and
// the tensor-core form (bf16 at head dims 112 / 128, and at 64 with grouped
// KV), described before flash_decode_tc_kernel below, with instantiations
// and entry points of its own.
//
// Grid (n_split, KvH * row_tiles, B) in clusters of (n_split, 1, 1).  The
// keys of one (sequence, kv head) are cut into n_split fixed ranges of
// split_keys table keys (a multiple of BS on the pool, so each page lies in
// one split; the host picks n_split <= 8 and split_keys from shapes only,
// kernels/_paged.py:decode_plan), and block `split` of the cluster walks
// range [split * split_keys, min((split + 1) * split_keys, end)), where
// end = min(len, kv_offset + keys) - kv_offset is the live end in table keys
// (key j at global position kv_offset + j).  A block holds all the rows of
// its kv head (row tiles of kMaxRows past G = 8), so each K/V byte is read
// once and no padding row is computed.
//
// Inside a block the keys are numbered in walk order: the slab's live rows
// of the split; on the pool the keys of the split's live pages, page after
// page, where a page is live if its first key is below the end and, under
// skip_null, its table entry is nonzero (warp 0 lists them once, with their
// int8 scales, so a skipped page costs no copy and no arithmetic).  The
// walk is cut into 32-key stages, and warp w takes stages w, w + 4, ...: each
// lane finds its key's row (one lookup in the list), and the warp moves the
// stage's K and V rows with 16-byte cp.async into its own ring in shared
// memory, kept in their storage type (K rows padded by 16 bytes, so lane j
// reading row j is free of bank conflicts) and converted to f32 in
// registers.  Lane j scores key j against the block's rows (a sum per
// 16-byte chunk), a warp max gives the online-softmax update (l is summed
// per lane, over the warp once at the end), and p goes through shared
// memory to the PV product, where each lane accumulates ceil(D / 32)
// output dims (at D 16 and 112 the last lanes hold none).  q and p stay in
// f32.  On the int8 pool each value is dequantized as int8 * scale(kv
// head, page) in f32, rounded once, the plain version's gather.
//
// The merge.  Each block merges its warps' (acc, m, l) in shared memory,
// in warp order, and stores the result into slot `split` of rank 0's
// shared memory through distributed shared memory; a release arrive on the
// cluster barrier publishes it, and a peer is then done.  Rank 0 waits for
// every block's, merges them in rank order by the partials algebra (m =
// max m_r, l = sum l_r e^(m_r - m), acc likewise) and writes the normalised
// output or the partials.  (Pulling every warp's partial into rank 0
// instead costs 32 serial remote loads a row while the peers wait on a
// second barrier.)  No
// atomics and no scratch in device memory: two launches give the same
// bits.  This is the in-transit combine the paper puts in its NoC, done
// over the SM-to-SM network.  Masking uses -1e30, the normaliser is floored
// at 1e-30, and a row with no live key (an empty split, a shard that owns
// none of its pages, a sequence that ends below kv_offset) is the combine
// identity (acc, m, l) = (0, -1e30, 0).
//
// Bound on the H100: bytes.  Decode does ~2 G FLOPs a K/V element, far
// below the card's 295 FLOP/byte line; the CUDA-core form keeps the
// products on the CUDA cores in f32.  What holds it back is latency: a block's chain (the table
// and lengths, its copies, the merge) costs a few microseconds, and every
// wave of blocks pays it again.  So the plan keeps the grid to one wave
// (~4 blocks an SM) and splits only as far as that allows (2 splits of 512
// keys at stablelm-1.6b's 8 x 32 x 1024 keys), and a warp keeps one ring
// slot, more only where the whole grid still fits in one wave with them
// (a small grid over a long cache).
#include "common.cuh"

#include <cooperative_groups.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 32;                       // keys of a stage: one per lane
constexpr int kMaxRows = 8;                     // query rows a block holds
constexpr int kMaxSplit = 8;                    // the portable cluster size
constexpr int kMaxSlots = 4;                    // ring slots a warp keeps
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;             // a block's shared memory on sm_90
constexpr size_t kSmSmem = 233472;              // an SM's, less 1 KB a resident block

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scales;
  const float* v_scales;
  const int* tables;        // pool: [B, MB]
  const int* lens;          // [B], or NULL: every key
  void* out;                // normalised [B, H, D], or NULL
  float* acc;               // partials: acc [B, H, D], m and l [B, H]
  float* m;
  float* l;
  int64_t head_stride;      // elements between kv heads (pool: page_stride; slab: D)
  int64_t key_stride;       // slab: elements between key rows (KvH * D)
  int64_t batch_stride;     // slab: elements between sequences (Sk * KvH * D)
  int64_t scale_stride;     // int8 pool: scales' kv-head stride
  int kv_offset, skip_null, H, KvH, G, row_tiles, BS, MB, keys, split_keys;
  int n_slots, pages;       // set by the launch: ring slots a warp, pages a split
  float scale;
};

// Dynamic shared memory, in bytes: q [R][D] f32; per warp the stage's p
// [R][kKeys] and, on the int8 pool, its keys' V scales [kKeys]; the
// live-page count; the warps' rings, each slot K [kKeys][D + 16 bytes] and
// V [kKeys][D] in the storage type; then, at offsets the launch fixes, the
// pool's live-page list (an int4 a page) and the cluster's block partials
// [n_split][R][D + 2] f32, which the peers push into rank 0.
template <typename P, int D, int R>
struct Layout {
  static constexpr int kRowK = D * static_cast<int>(sizeof(P)) + 16;
  static constexpr int kRowV = D * static_cast<int>(sizeof(P));
  static constexpr int kSlot = kKeys * (kRowK + kRowV);
  static constexpr int kPart = R * (D + 2);     // floats of one partial: acc, m, l
  static constexpr int kQ = 0;
  static constexpr int kP = kQ + R * D * 4;
  static constexpr int kPWarp = (R + 1) * kKeys;  // floats of a warp's p area
  static constexpr int kCount = kP + kWarps * kPWarp * 4;
  static constexpr int kRing = kCount + 16;
  // a warp's partial [R][D + 2] reuses its first K slot
  static_assert(kPart * 4 <= kKeys * kRowK, "a partial fits a K slot");
  static_assert(kRing % 16 == 0 && kSlot % 16 == 0, "16-byte aligned copies");
  static __host__ __device__ constexpr size_t list(int n_slots) {
    return kRing + static_cast<size_t>(kWarps) * n_slots * kSlot;
  }
  static __host__ __device__ constexpr size_t merge(int n_slots, int pages) {
    return list(n_slots) + static_cast<size_t>(pages) * 16;
  }
  static __host__ __device__ constexpr size_t bytes(int n_slots, int pages, int n_split) {
    return merge(n_slots, pages) + static_cast<size_t>(n_split) * kPart * 4;
  }
};

// The split's live slab rows, in order: walk key i is row start + i.
struct SlabKeys {
  int64_t base;     // element offset of the split's first row (this b, kv head)
  int64_t stride;   // elements between rows
  int n;            // live rows of the split
  __device__ __forceinline__ bool key(int i, int64_t& off, float& ks, float& vs) const {
    off = base + static_cast<int64_t>(i) * stride;
    ks = vs = 1.f;
    return i < n;
  }
};

// The split's live pages, listed in table order: walk key i is row i % BS of
// list entry i / BS = (page id, its first table key, K scale, V scale).  Only
// the last page can end past the live end, so the live keys are a prefix.
struct PoolKeys {
  const int4* list;
  int64_t base;     // element offset of the kv head in the pool (view)
  int bs, d, n;     // n: live keys of the split
  __device__ __forceinline__ bool key(int i, int64_t& off, float& ks, float& vs) const {
    off = 0;
    ks = vs = 1.f;
    if (i >= n) return false;
    const int pl = i / bs, r = i - pl * bs;
    const int4 e = list[pl];
    off = base + (static_cast<int64_t>(e.x) * bs + r) * d;
    ks = __int_as_float(e.z);
    vs = __int_as_float(e.w);
    return true;
  }
};

// a 16-byte chunk of a K row in f32; int8 values times their page's scale
template <typename P, int N>
__device__ __forceinline__ void chunk_f32(const uint4& raw, float (&f)[N], float sc) {
  const P* e = reinterpret_cast<const P*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f[i] = repro::to_f32(e[i]);
    if constexpr (std::is_same<P, int8_t>::value) f[i] *= sc;
  }
}

// Warp 0 lists the split's live pages of sequence b in table order into
// `list` (page id, its first table key, K scale, V scale), a ballot per 32
// pages (the table loads do not wait for the length), and their count
template <bool kInt8>
__device__ __forceinline__ void list_pages(const Args& a, int4* list, int* count, int b,
                                           int kvh, int start, int stop, int lane) {
  const int p0 = start / a.BS;
  const int np = min(a.split_keys / a.BS, a.MB - p0);
  const int* table = a.tables + static_cast<int64_t>(b) * a.MB + p0;
  int n = 0;
  for (int base = 0; base < np; base += 32) {
    const int p = base + lane;
    const int pg = p < np ? table[p] : 0;
    const bool live = p < np && start + p * a.BS < stop && (!a.skip_null || pg != 0);
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) {
      float ks = 1.f, vs = 1.f;
      if constexpr (kInt8) {
        const int64_t si = static_cast<int64_t>(kvh) * a.scale_stride + pg;
        ks = a.k_scales[si];
        vs = a.v_scales[si];
      }
      list[n + __popc(mask & ((1u << lane) - 1u))] =
          make_int4(pg, start + p * a.BS, __float_as_int(ks), __float_as_int(vs));
    }
    n += __popc(mask);
  }
  if (lane == 0) *count = n;
}

// The block's partial [rows][D + 2]: its warps' (warp w's at ring + w *
// warp_bytes) merged in warp order into dst, slot `split` of rank 0's
// shared memory
template <int D>
__device__ __forceinline__ void merge_warps(const unsigned char* ring, int warp_bytes,
                                            int rows, float* dst) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mw[kWarps], mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = reinterpret_cast<const float*>(ring + w * warp_bytes)[g * (D + 2) + D];
      mx = fmaxf(mx, mw[w]);
    }
    float sum = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = reinterpret_cast<const float*>(ring + w * warp_bytes);
      const float c = expf(mw[w] - mx);
      sum = fmaf(pw[g * (D + 2) + d], c, sum);
      ls = fmaf(pw[g * (D + 2) + D + 1], c, ls);
    }
    dst[g * (D + 2) + d] = sum;
    if (d == 0) {
      dst[g * (D + 2) + D] = mx;
      dst[g * (D + 2) + D + 1] = ls;
    }
  }
}

// Rank 0: the cluster's block partials (part_floats apart in `merged`)
// merged in rank order into the normalised output (type T) or the f32
// partials of query rows idx0 .. idx0 + rows - 1
template <typename T, int D>
__device__ __forceinline__ void merge_cluster(const Args& a, const float* merged,
                                              int part_floats, int rows, int64_t idx0) {
  const int n_split = static_cast<int>(gridDim.x);
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mr[kMaxSplit], mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      mr[r] = r < n_split ? merged[r * part_floats + g * (D + 2) + D] : kNegInf;
      mx = fmaxf(mx, mr[r]);
    }
    float sum = 0.f, ls = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < n_split) {
        const float* pr = merged + r * part_floats + g * (D + 2);
        const float c = expf(mr[r] - mx);
        sum = fmaf(pr[d], c, sum);
        ls = fmaf(pr[D + 1], c, ls);
      }
    }
    const int64_t idx = idx0 + g;
    if (a.out != nullptr) {
      static_cast<T*>(a.out)[idx * D + d] = repro::from_f32<T>(sum / fmaxf(ls, 1e-30f));
    } else {
      a.acc[idx * D + d] = sum;
      if (d == 0) {
        a.m[idx] = mx;
        a.l[idx] = ls;
      }
    }
  }
}

// T: query and output type; P: K/V type (T, or int8_t with scales on the
// pool); R: rows a block holds (1 at G = 1, else kMaxRows, guarded)
template <typename T, typename P, int D, int R, bool kPool>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const Args a) {
  using L = Layout<P, D, R>;
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  constexpr int kChunks = L::kRowV / 16;        // 16-byte chunks of a row
  constexpr int kE = 16 / static_cast<int>(sizeof(P));   // elements of a chunk
  // output dims a lane holds: ceil(D / 32), the lanes past D holding none
  // (D 16: lanes 16-31; D 112: lanes 28-31, each of the others 4 dims)
  constexpr int kDpl = (D + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  // phase 0 of the cluster barrier: this block has started (a peer waits
  // for it before its first store into rank 0's shared memory)
  repro::cluster_arrive_relaxed();

  const int split = blockIdx.x;                 // the rank: clusters of (n_split, 1, 1)
  const int kvh = blockIdx.y / a.row_tiles, row0 = (blockIdx.y % a.row_tiles) * R;
  const int b = blockIdx.z;
  const int rows = min(R, a.G - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);
  float* p_s = reinterpret_cast<float*>(smem + L::kP) + warp * L::kPWarp;

  // this split's range of table keys (slab rows), cut at the live end
  const int len = a.lens != nullptr ? a.lens[b] : 0;
  const int start = split * a.split_keys;
  const int end = a.lens != nullptr ? min(a.keys, len - a.kv_offset) : a.keys;
  const int stop = min(start + a.split_keys, end);

  const T* q = static_cast<const T*>(a.q);
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int g = i / D;
    q_s[i] = g < rows
        ? repro::to_f32(q[(static_cast<int64_t>(b) * a.H + kvh * a.G + row0 + g) * D + i % D])
        : 0.f;
  }

  int n_walk;   // live keys of the split, in walk order
  typename std::conditional<kPool, PoolKeys, SlabKeys>::type src;
  if constexpr (kPool) {
    int4* list = reinterpret_cast<int4*>(smem + L::list(a.n_slots));
    int* count = reinterpret_cast<int*>(smem + L::kCount);
    if (warp == 0) list_pages<kInt8>(a, list, count, b, kvh, start, stop, lane);
    __syncthreads();   // the list and q
    const int n_pages = *count;
    n_walk = n_pages > 0 ? (n_pages - 1) * a.BS + min(a.BS, stop - list[n_pages - 1].y) : 0;
    src.list = list;
    src.base = static_cast<int64_t>(kvh) * a.head_stride;
    src.bs = a.BS;
    src.d = D;
    src.n = n_walk;
  } else {
    __syncthreads();   // q
    n_walk = max(0, stop - start);
    src.base = static_cast<int64_t>(b) * a.batch_stride + kvh * a.head_stride +
               static_cast<int64_t>(start) * a.key_stride;
    src.stride = a.key_stride;
    src.n = n_walk;
  }

  // this warp's stages: walk keys (warp + i * kWarps) * kKeys + lane
  const int n_stages = (n_walk + kKeys - 1) / kKeys;
  const int mine = n_stages > warp ? (n_stages - warp + kWarps - 1) / kWarps : 0;
  unsigned char* ring = smem + L::kRing + warp * a.n_slots * L::kSlot;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v);

  auto issue = [&](int i) {
    unsigned char* k_s = ring + (i % a.n_slots) * L::kSlot;
    unsigned char* v_s = k_s + kKeys * L::kRowK;
    int64_t off;
    float ks, vs;
    const bool ok = src.key((warp + i * kWarps) * kKeys + lane, off, ks, vs);
#pragma unroll
    for (int t = 0; t < kChunks; ++t) {
      const int c = lane + 32 * t, j = c / kChunks, cc = c % kChunks;
      const int64_t oj = __shfl_sync(0xffffffffu, off, j);
      const bool okj = __shfl_sync(0xffffffffu, ok, j);
      const int64_t byte = okj ? oj * static_cast<int64_t>(sizeof(P)) + cc * 16 : 0;
      repro::cp_async16(k_s + j * L::kRowK + cc * 16, kg + byte, okj);
      repro::cp_async16(v_s + j * L::kRowV + cc * 16, vg + byte, okj);
    }
    repro::cp_async_commit();
  };

  // m is warp-uniform; l is summed per lane and over the warp at the end
  float m[R], l[R], acc[R][kDpl];
#pragma unroll
  for (int g = 0; g < R; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDpl; ++dd) acc[g][dd] = 0.f;
  }

  for (int i = 0; i < min(mine, a.n_slots); ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    // stages i .. min(i + n_slots, mine) - 1 are in flight: let all but
    // stage i stay so
    switch (min(a.n_slots, mine - i) - 1) {
      case 3: repro::cp_async_wait<3>(); break;
      case 2: repro::cp_async_wait<2>(); break;
      case 1: repro::cp_async_wait<1>(); break;
      default: repro::cp_async_wait<0>();
    }
    __syncwarp();   // every lane's copies of stage i have landed
    const unsigned char* k_s = ring + (i % a.n_slots) * L::kSlot;
    const unsigned char* v_s = k_s + kKeys * L::kRowK;
    int64_t off;
    float ks, vs;
    const bool valid = src.key((warp + i * kWarps) * kKeys + lane, off, ks, vs);

    // lane j scores key j against the block's rows, a sum per 16-byte chunk
    float s[R];
#pragma unroll
    for (int g = 0; g < R; ++g) s[g] = 0.f;
    const unsigned char* krow = k_s + lane * L::kRowK;
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      float kf[kE];
      chunk_f32<P>(*reinterpret_cast<const uint4*>(krow + cc * 16), kf, ks);
#pragma unroll
      for (int g = 0; g < R; ++g) {
        if (g < rows) {
          const float* qr = q_s + g * D + cc * kE;
          float c = 0.f;
#pragma unroll
          for (int e = 0; e < kE; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + e);
            c = fmaf(qv.x, kf[e], c);
            c = fmaf(qv.y, kf[e + 1], c);
            c = fmaf(qv.z, kf[e + 2], c);
            c = fmaf(qv.w, kf[e + 3], c);
          }
          s[g] += c;
        }
      }
    }
    // the online-softmax update; p goes to shared memory for the PV
    // product (0 on masked keys and on rows past G: every stage holds a
    // live key, so m is finite after it)
#pragma unroll
    for (int g = 0; g < R; ++g) {
      float p = 0.f;
      if (g < rows) {
        const float sv = valid ? s[g] * a.scale : kNegInf;
        const float m_new = fmaxf(m[g], repro::warp_max(sv));
        p = expf(sv - m_new);
        const float corr = expf(m[g] - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int dd = 0; dd < kDpl; ++dd) acc[g][dd] *= corr;
        m[g] = m_new;
      }
      p_s[g * kKeys + lane] = p;
    }
    if constexpr (kInt8) p_s[R * kKeys + lane] = vs;
    __syncwarp();
    if (lane * kDpl < D) {   // at D = 16 half the lanes hold no dim, at 112 four
      const unsigned char* vcol = v_s + lane * kDpl * static_cast<int>(sizeof(P));
#pragma unroll
      for (int j0 = 0; j0 < kKeys; j0 += 4) {
        float4 pj[R];
#pragma unroll
        for (int g = 0; g < R; ++g) pj[g] = *reinterpret_cast<const float4*>(p_s + g * kKeys + j0);
        float4 vsc = make_float4(1.f, 1.f, 1.f, 1.f);
        if constexpr (kInt8) vsc = *reinterpret_cast<const float4*>(p_s + R * kKeys + j0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const P* vr = reinterpret_cast<const P*>(vcol + (j0 + u) * L::kRowV);
          const float sc = u == 0 ? vsc.x : u == 1 ? vsc.y : u == 2 ? vsc.z : vsc.w;
#pragma unroll
          for (int dd = 0; dd < kDpl; ++dd) {
            float vv = repro::to_f32(vr[dd]);
            if constexpr (kInt8) vv *= sc;
#pragma unroll
            for (int g = 0; g < R; ++g) {
              const float pv = u == 0 ? pj[g].x : u == 1 ? pj[g].y : u == 2 ? pj[g].z : pj[g].w;
              acc[g][dd] = fmaf(pv, vv, acc[g][dd]);
            }
          }
        }
      }
    }
    __syncwarp();   // every lane's reads of the slot and of p are done
    if (i + a.n_slots < mine) issue(i + a.n_slots);
  }

  // this warp's partial [R][D + 2] into its first K slot (its copies have
  // all landed and been read)
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int g = 0; g < R; ++g) {
    const float lw = repro::warp_sum(l[g]);
#pragma unroll
    for (int dd = 0; dd < kDpl; ++dd) {
      const int d = lane * kDpl + dd;
      if (d < D) part[g * (D + 2) + d] = acc[g][dd];
    }
    if (lane == 0) {
      part[g * (D + 2) + D] = m[g];
      part[g * (D + 2) + D + 1] = lw;
    }
  }
  __syncthreads();

  // the block's partial, its warps' merged in warp order, pushed into slot
  // `split` of rank 0's shared memory once every block has started
  repro::cluster_wait();
  cg::cluster_group cluster = cg::this_cluster();
  float* merged = reinterpret_cast<float*>(smem + L::merge(a.n_slots, a.pages));
  merge_warps<D>(smem + L::kRing, a.n_slots * L::kSlot, rows,
                 cluster.map_shared_rank(merged, 0) + split * L::kPart);
  // phase 1: this block's partial is in rank 0; a peer is done (nothing
  // reads its shared memory), rank 0 waits for every block's
  repro::cluster_arrive_release();
  if (split != 0) return;
  repro::cluster_wait();
  merge_cluster<T, D>(a, merged, L::kPart, rows, static_cast<int64_t>(b) * a.H + kvh * a.G + row0);
}

// either form's kernel over the grid (n_split, KvH * row_tiles, B) in
// clusters of (n_split, 1, 1) with `smem` bytes of dynamic shared memory
cudaError_t launch_cluster(void (*kern)(const Args), const Args& a, size_t smem, int n_split,
                           int B, cudaStream_t s) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    if (cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)))
      return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, a.KvH * a.row_tiles, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a)) return e;
  return cudaGetLastError();
}

template <typename T, typename P, int D, int R, bool kPool>
cudaError_t launch(Args a, int n_split, int B, int n_sm, cudaStream_t s) {
  using L = Layout<P, D, R>;
  auto kern = flash_decode_kernel<T, P, D, R, kPool>;
  a.pages = kPool ? a.split_keys / a.BS : 0;
  // Ring slots: the grid's blocks resident at once come first (a wave of
  // blocks costs a chain of memory latencies), so a warp keeps one slot,
  // and more (up to kMaxSlots, and no more than its stages) only where the
  // whole grid still fits on the card in one wave with them
  const int per_warp = ((a.split_keys + kKeys - 1) / kKeys + kWarps - 1) / kWarps;
  const int64_t blocks = static_cast<int64_t>(n_split) * a.KvH * a.row_tiles * B;
  const int64_t per_sm = (blocks + n_sm - 1) / n_sm;
  a.n_slots = 1;
  for (int k = 2; k <= min(kMaxSlots, per_warp); ++k) {
    const size_t bk = L::bytes(k, a.pages, n_split);
    if (bk > kMaxSmem || per_sm * (bk + 1024) > kSmSmem) break;
    a.n_slots = k;
  }
  return launch_cluster(kern, a, L::bytes(a.n_slots, a.pages, n_split), n_split, B, s);
}

// bf16 queries past head dim 64, and at 64 with grouped KV, take the
// tensor-core form (_paged.decode_form): the CUDA-core form builds no
// instantiation for them and refuses them as an invalid value
template <typename T, typename P, int D, int R, bool kPool>
cudaError_t launch_cuda_form(const Args& a, int n_split, int B, int n_sm, cudaStream_t s) {
  if constexpr (std::is_same<T, bf16>::value && (D > 64 || (D == 64 && R > 1)))
    return cudaErrorInvalidValue;
  else
    return launch<T, P, D, R, kPool>(a, n_split, B, n_sm, s);
}

// the head dims of _paged.HEAD_DIMS / DENSE_HEAD_DIMS; another is an
// invalid-value error
template <typename T, typename P, bool kPool>
cudaError_t by_dim(const Args& a, int D, int n_split, int B, int n_sm, cudaStream_t s) {
  const bool one = a.G == 1;
#define REPRO_DECODE_CASE(DIM)                                                  \
  case DIM:                                                                     \
    return one ? launch_cuda_form<T, P, DIM, 1, kPool>(a, n_split, B, n_sm, s)  \
               : launch_cuda_form<T, P, DIM, kMaxRows, kPool>(a, n_split, B, n_sm, s);
  switch (D) {
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(112)
    REPRO_DECODE_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CASE
}

// both forms' checks; fills the row tiling of G = H / KvH (one tile at G =
// 1, else tiles of kMaxRows)
cudaError_t check_plan(Args& a, int B, int n_split, int grain) {
  if (a.KvH <= 0 || a.H % a.KvH) return cudaErrorInvalidValue;
  if (n_split < 1 || n_split > kMaxSplit || a.split_keys <= 0 || a.split_keys % grain)
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(n_split) * a.split_keys < a.keys) return cudaErrorInvalidValue;
  a.G = a.H / a.KvH;
  const int R = a.G == 1 ? 1 : kMaxRows;
  a.row_tiles = (a.G + R - 1) / R;
  if (static_cast<int64_t>(a.KvH) * a.row_tiles > 65535 || B > 65535) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The tensor-core form: bf16 queries at head dims 112 and 128, and at 64
// with grouped KV (G > 1), over a bf16 or int8 pool or a bf16 slab
// (kernels/_paged.py:decode_form).  The grid, the cluster, the page list,
// the walk order and the merge are the CUDA-core form's (list_pages,
// merge_warps and merge_cluster serve both); what changes is a warp's work
// on a stage, the stage
// itself, and the merge area's rows.
//
// Why.  The CUDA-core form scores with one lane per key (G x D dependent
// FMAs a lane) and carries acc[8][D / 32], s[8] and p[8] for any G > 1;
// its rings of 32-key stages plus an [n_split][8][D + 2] merge area held 2
// blocks an SM at minitron-4b's D 128, G 3 (110 KB) and 3 at D 112 / 128,
// G 1 (60-70 KB), so the one-wave grids of _paged.decode_plan ran in two
// waves.
//
// A stage here is 16 keys (one k16 step of P V) and a warp's ring holds
// kTcSlots = 2 of them (the copy of the next stage is in flight while this
// one is computed), each K and V tile kept as bf16 rows padded
// to D + 8 elements so that ldmatrix reads them free of bank conflicts.
// The stage's keys are the m16 dimension and the block's (up to 8) query
// rows of its kv head the n8 one: S^T = K Q^T on mma.sync m16n8k16 with K's
// A fragments through ldmatrix and Q^T's B fragments loaded once from
// device memory into registers (two accumulators over the even and odd k16
// steps, to halve the chain); the online softmax stays in f32 on the
// fragments (a lane holds two keys of two rows; a row's max over the 8
// lanes of its column pair); and O^T = V^T P^T with V^T through
// ldmatrix.trans and P^T entering as a bf16 hi + lo pair, so the output
// keeps f32 p's precision.  P^T's B fragments come from the score
// fragments of other lanes, 8 shuffles and 4 byte permutes a stage.  Every
// ldmatrix of a step is issued before its MMAs (the asm statements keep
// their order), and a stage whose row maxima did not move leaves acc as it
// is.  Against the other choice, the rows as rows 0-7 of an m16 tile whose
// rows 8-15 are zero (twice the MMAs, no shuffles), this layout read 2-9%
// faster at every row (tools/decode_readings.py, H100 at 700 W).
//
// On the int8 pool the stage arrives as int8 rows by cp.async with each
// key's (kv head, page) scales and is widened to the warp's bf16 tiles
// (integers up to 127 are exact); K's scale multiplies each score, V's is
// folded into P's column before the hi + lo split, and l sums the unscaled
// p, as the bf16 paged prefill does.  The merge area holds min(G, 8) rows
// a split, not 8.  The split (_paged.tc_decode_plan) is ~256 keys a range,
// at most 8: a sweep of splits put it within 3% of the best at each row,
// and within 6% at one sequence of 1 k or 32 k keys and at 8 of up to 32 k
// (tools/decode_readings.py --sweep, H100 at 700 W).
// ---------------------------------------------------------------------------

constexpr int kTcKeys = 16;                     // keys of a stage (_paged.TC_STAGE_KEYS)
constexpr int kTcSlots = 2;                     // ring slots a warp: the next stage in flight

// Dynamic shared memory, in bytes: the live-page count; the warps' rings,
// each slot K then V [kTcKeys] rows (bf16 rows of D + 8, or int8 rows of D
// followed by the keys' K and V scales [kTcKeys] f32 each); on the int8
// pool each warp's widened K and V tiles [kTcKeys][D + 8] bf16; then, at
// offsets the launch fixes, the pool's live-page list (an int4 a page) and
// the cluster's block partials [n_split][rows][D + 2] f32.
template <typename P, int D>
struct TcLayout {
  static constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  static constexpr int LDS = repro::lds<D>();
  static constexpr int kTile = kTcKeys * LDS * 2;
  static constexpr int kRaw = kTcKeys * D;
  static constexpr int kSlot = kInt8 ? 2 * kRaw + 2 * kTcKeys * 4 : 2 * kTile;
  static constexpr int kWide = kInt8 ? 2 * kTile : 0;
  static constexpr int kCount = 0;
  static constexpr int kRing = 16;
  // a warp's partial [rows][D + 2] reuses its first ring slot
  static_assert(kMaxRows * (D + 2) * 4 <= kSlot, "a partial fits a slot");
  static_assert(kSlot % 16 == 0 && kWide % 16 == 0 && kRaw % 16 == 0, "16-byte aligned copies");
  static constexpr size_t kWideAt = kRing + static_cast<size_t>(kWarps) * kTcSlots * kSlot;
  static constexpr size_t kList = kWideAt + static_cast<size_t>(kWarps) * kWide;
  static __host__ __device__ constexpr size_t merge(int pages) {
    return kList + static_cast<size_t>(pages) * 16;
  }
  static __host__ __device__ constexpr size_t bytes(int pages, int n_split, int rows) {
    return merge(pages) + static_cast<size_t>(n_split) * rows * (D + 2) * 4;
  }
};

// Blocks an SM each instantiation keeps room for in registers: 4 at D 64;
// 3 past it, where a block's shared memory allows no more than 3 anyway
// and a cap of 128 registers spilled ~100 bytes a thread in a first version
// of this kernel (ptxas for sm_90a, CUDA 12.8, D 112 and 128; this one
// takes 125-144 there, none spilled).
template <int D>
constexpr int tc_min_blocks() { return D > 64 ? 3 : 4; }

// P: K/V type (bf16, or int8_t with scales on the pool); queries and the
// output are bf16
template <typename P, int D, bool kPool>
__global__ void __launch_bounds__(kThreads, tc_min_blocks<D>())
flash_decode_tc_kernel(const Args a) {
  using L = TcLayout<P, D>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int LDS = L::LDS, KS = D / 16, MT = D / 16;
  constexpr int kRowBytes = kInt8 ? D : LDS * 2;                    // a stored row
  constexpr int kChunks = D * static_cast<int>(sizeof(P)) / 16;     // its 16-byte copies
  extern __shared__ __align__(16) unsigned char smem[];
  // phase 0 of the cluster barrier: this block has started
  repro::cluster_arrive_relaxed();

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / a.row_tiles, row0 = (blockIdx.y % a.row_tiles) * kMaxRows;
  const int b = blockIdx.z;
  const int rows = min(kMaxRows, a.G - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;      // fragment row and column pair

  const int len = a.lens != nullptr ? a.lens[b] : 0;
  const int start = split * a.split_keys;
  const int end = a.lens != nullptr ? min(a.keys, len - a.kv_offset) : a.keys;
  const int stop = min(start + a.split_keys, end);

  // Q^T's B fragments of the k16 steps: query row gr, dims 2 tq and + 1 (and
  // + 8); rows past the group are zero
  uint32_t qb[KS][2];
  {
    const bf16* qr = static_cast<const bf16*>(a.q) +
                     (static_cast<int64_t>(b) * a.H + kvh * a.G + row0 + gr) * D + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qb[kk][0] = gr < rows ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk) : 0u;
      qb[kk][1] = gr < rows ? *reinterpret_cast<const uint32_t*>(qr + 16 * kk + 8) : 0u;
    }
  }

  int n_walk;   // live keys of the split, in walk order
  typename std::conditional<kPool, PoolKeys, SlabKeys>::type src;
  if constexpr (kPool) {
    int4* list = reinterpret_cast<int4*>(smem + L::kList);
    int* count = reinterpret_cast<int*>(smem + L::kCount);
    if (warp == 0) list_pages<kInt8>(a, list, count, b, kvh, start, stop, lane);
    __syncthreads();   // the list
    const int n_pages = *count;
    n_walk = n_pages > 0 ? (n_pages - 1) * a.BS + min(a.BS, stop - list[n_pages - 1].y) : 0;
    src.list = list;
    src.base = static_cast<int64_t>(kvh) * a.head_stride;
    src.bs = a.BS;
    src.d = D;
    src.n = n_walk;
  } else {
    n_walk = max(0, stop - start);
    src.base = static_cast<int64_t>(b) * a.batch_stride + kvh * a.head_stride +
               static_cast<int64_t>(start) * a.key_stride;
    src.stride = a.key_stride;
    src.n = n_walk;
  }

  // this warp's stages: walk keys (warp + i * kWarps) * kTcKeys + j
  const int n_stages = (n_walk + kTcKeys - 1) / kTcKeys;
  const int mine = n_stages > warp ? (n_stages - warp + kWarps - 1) / kWarps : 0;
  unsigned char* ring = smem + L::kRing + warp * kTcSlots * L::kSlot;
  const unsigned char* kg = static_cast<const unsigned char*>(a.k);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v);

  // stage i into slot i % kTcSlots: lanes j and j + 16 find key j's row,
  // and the warp moves K and V in 16-byte cp.async copies, consecutive lanes
  // on consecutive chunks of a row (whole lines an instruction: giving each
  // lane the chunks of one key instead, no shuffles, read 1.2-1.4x slower at
  // the rows' shapes, tools/decode_readings.py on the H100 at 700 W), and,
  // int8, lanes 0-15 store the keys' scales (this warp reads them after its
  // own wait)
  auto issue = [&](int i) {
    unsigned char* k_s = ring + (i % kTcSlots) * L::kSlot;
    unsigned char* v_s = k_s + (kInt8 ? L::kRaw : L::kTile);
    int64_t off;
    float ks, vs;
    const bool ok = src.key((warp + i * kWarps) * kTcKeys + (lane & (kTcKeys - 1)), off, ks, vs);
#pragma unroll
    for (int t = 0; t < (kTcKeys * kChunks + 31) / 32; ++t) {
      const int c = lane + 32 * t;
      const int j = min(c / kChunks, kTcKeys - 1), cc = c % kChunks;
      const int64_t oj = __shfl_sync(0xffffffffu, off, j);
      const bool okj = __shfl_sync(0xffffffffu, ok, j);
      if (c < kTcKeys * kChunks) {
        const int64_t byte = okj ? oj * static_cast<int64_t>(sizeof(P)) + cc * 16 : 0;
        repro::cp_async16(k_s + j * kRowBytes + cc * 16, kg + byte, okj);
        repro::cp_async16(v_s + j * kRowBytes + cc * 16, vg + byte, okj);
      }
    }
    if constexpr (kInt8) {
      float* sc = reinterpret_cast<float*>(k_s + 2 * L::kRaw);
      if (lane < kTcKeys) {
        sc[lane] = ks;
        sc[kTcKeys + lane] = vs;
      }
    }
    repro::cp_async_commit();
  };

  // S^T = K Q^T with the stage's 16 keys as the m16 dimension and the rows
  // as n8: lane (gr, tq) scores rows 2 tq and + 1 against keys gr and gr +
  // 8; m and l per row (l this lane's partial sum, over the 8 lanes of its
  // tq at the end).  O^T = V^T P^T: acc[t] holds dims 16 t + gr and + 8 of
  // both rows.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  static_assert(kTcSlots == 2, "the waits below keep one stage in flight");
  for (int i = 0; i < min(mine, kTcSlots); ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    // stage i + 1, if this warp has it, stays in flight
    if (i + 1 < mine) repro::cp_async_wait<1>();
    else repro::cp_async_wait<0>();
    __syncwarp();   // every lane's copies (and scales) of stage i have landed
    const unsigned char* k_s = ring + (i % kTcSlots) * L::kSlot;
    const bf16* kt;
    if constexpr (kInt8) {
      // widen the stage's int8 K and V rows to the warp's bf16 tiles (exact)
      bf16* wk = reinterpret_cast<bf16*>(smem + L::kWideAt + warp * L::kWide);
      constexpr int CPR = D / 16;                 // 16-byte chunks of an int8 row
#pragma unroll
      for (int u = 0; u < 2 * kTcKeys * CPR / 32; ++u) {
        const int c = lane + 32 * u;
        const int t = c / (kTcKeys * CPR), r = (c / CPR) % kTcKeys, cc = c % CPR;
        const int4 raw = *reinterpret_cast<const int4*>(k_s + t * L::kRaw + r * D + cc * 16);
        const int8_t* e8 = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e] = repro::pack_f32_bf16(static_cast<float>(e8[2 * e]),
                                      static_cast<float>(e8[2 * e + 1]));
        uint4* dst = reinterpret_cast<uint4*>(wk + (t * kTcKeys + r) * LDS + cc * 16);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncwarp();
      kt = wk;
    } else {
      kt = reinterpret_cast<const bf16*>(k_s);
    }
    const bf16* vt = kt + kTcKeys * LDS;
    const int live = n_walk - (warp + i * kWarps) * kTcKeys;   // live keys of the stage
    const float* kscale = reinterpret_cast<const float*>(k_s + 2 * L::kRaw);

    // every K fragment of the stage first (the asm statements keep their
    // order, so a load issued beside its MMA would stall it), then the MMAs
    // in two chains, the even and the odd k16 steps
    uint32_t kf[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) repro::frag_a<LDS>(kf[kk], kt, 0, kk * 16, lane);
    float se[4] = {0.f, 0.f, 0.f, 0.f}, so[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      repro::mma_bf16((kk & 1) ? so : se, kf[kk], qb[kk][0], qb[kk][1]);
    // V^T's A fragments, loaded while the softmax runs
    uint32_t vf[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t) repro::frag_at<LDS>(vf[t], vt, 0, t * 16, lane);
    // score e: key gr + 8 (e / 2), row 2 tq + e % 2; scale, K's int8 scale,
    // the stage's dead keys masked; the online-softmax update (the stage's
    // first key is live, so m is finite after it)
    float p[4], corr[2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = gr + (e >> 1) * 8;
      float sv = se[e] + so[e];
      if constexpr (kInt8) sv *= kscale[j];
      p[e] = j < live ? sv * a.scale : kNegInf;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(p[r], p[2 + r]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __expf(p[e] - m[e & 1]);
    l[0] = l[0] * corr[0] + (p[0] + p[2]);
    l[1] = l[1] * corr[1] + (p[1] + p[3]);
    // a row whose max did not move keeps acc as it is (corr is exactly 1)
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        acc[t][0] *= corr[0];
        acc[t][1] *= corr[1];
        acc[t][2] *= corr[0];
        acc[t][3] *= corr[1];
      }
    }
    // P V: p (times V's scale on the int8 pool) as a bf16 hi + lo pair.
    // P^T's B fragments are (keys 2 tq, 2 tq + 1; row gr) and keys + 8; key
    // k's pair of rows (gr & ~1, gr | 1) sits on lane 4 k + gr / 2 (k < 8;
    // k - 8 in the second register): a shuffle a register and key, and a
    // byte permute keeps row gr's half of each
    if constexpr (kInt8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] *= kscale[kTcKeys + gr + (e >> 1) * 8];
    }
    // hi[0] / lo[0] pack key gr's two rows, hi[2] / lo[2] key gr + 8's
    const float x[8] = {p[0], p[1], 0.f, 0.f, p[2], p[3], 0.f, 0.f};
    uint32_t hi[4], lo[4];
    repro::split_bf16(hi, lo, x);
    const int s0 = 8 * tq + (gr >> 1), s1 = s0 + 4;
    const uint32_t sel = (gr & 1) ? 0x7632u : 0x5410u;
    const uint32_t bh0 = __byte_perm(__shfl_sync(0xffffffffu, hi[0], s0),
                                     __shfl_sync(0xffffffffu, hi[0], s1), sel);
    const uint32_t bh1 = __byte_perm(__shfl_sync(0xffffffffu, hi[2], s0),
                                     __shfl_sync(0xffffffffu, hi[2], s1), sel);
    const uint32_t bl0 = __byte_perm(__shfl_sync(0xffffffffu, lo[0], s0),
                                     __shfl_sync(0xffffffffu, lo[0], s1), sel);
    const uint32_t bl1 = __byte_perm(__shfl_sync(0xffffffffu, lo[2], s0),
                                     __shfl_sync(0xffffffffu, lo[2], s1), sel);
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      repro::mma_bf16(acc[t], vf[t], bh0, bh1);
      repro::mma_bf16(acc[t], vf[t], bl0, bl1);
    }
    __syncwarp();   // every lane's reads of the slot are done
    if (i + kTcSlots < mine) issue(i + kTcSlots);
  }

  // this warp's partial [rows][D + 2] into its first ring slot (its copies
  // have all landed and been read)
  {
    float* part = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lw = l[r];
      lw += __shfl_xor_sync(0xffffffffu, lw, 4);
      lw += __shfl_xor_sync(0xffffffffu, lw, 8);
      lw += __shfl_xor_sync(0xffffffffu, lw, 16);
      const int row = 2 * tq + r;
      if (row < rows) {
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          part[row * (D + 2) + 16 * t + gr] = acc[t][r];
          part[row * (D + 2) + 16 * t + gr + 8] = acc[t][2 + r];
        }
        if (gr == 0) {
          part[row * (D + 2) + D] = m[r];
          part[row * (D + 2) + D + 1] = lw;
        }
      }
    }
  }
  __syncthreads();

  // the block's partial, its warps' merged in warp order, pushed into slot
  // `split` of rank 0's shared memory once every block has started
  repro::cluster_wait();
  cg::cluster_group cluster = cg::this_cluster();
  const int part_floats = rows * (D + 2);
  float* merged = reinterpret_cast<float*>(smem + L::merge(a.pages));
  merge_warps<D>(smem + L::kRing, kTcSlots * L::kSlot, rows,
                 cluster.map_shared_rank(merged, 0) + split * part_floats);
  // phase 1: this block's partial is in rank 0; rank 0 waits for every
  // block's
  repro::cluster_arrive_release();
  if (split != 0) return;
  repro::cluster_wait();
  merge_cluster<bf16, D>(a, merged, part_floats, rows,
                         static_cast<int64_t>(b) * a.H + kvh * a.G + row0);
}

template <typename P, int D, bool kPool>
cudaError_t launch_tc(Args a, int n_split, int B, cudaStream_t s) {
  using L = TcLayout<P, D>;
  auto kern = flash_decode_tc_kernel<P, D, kPool>;
  a.pages = kPool ? a.split_keys / a.BS : 0;
  return launch_cluster(kern, a, L::bytes(a.pages, n_split, min(a.G, kMaxRows)), n_split, B, s);
}

// the head dims of _paged.TC_DECODE_DIMS; another is an invalid-value error
template <typename P, bool kPool>
cudaError_t by_dim_tc(const Args& a, int D, int n_split, int B, cudaStream_t s) {
  switch (D) {
    case 64: return launch_tc<P, 64, kPool>(a, n_split, B, s);
    case 112: return launch_tc<P, 112, kPool>(a, n_split, B, s);
    case 128: return launch_tc<P, 128, kPool>(a, n_split, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The paged pool.  q [B, H, D] of type `dtype`; k_pages, v_pages [KvH, NB,
// BS, D] of the same type, or int8 when k_scales / v_scales [KvH, NB] f32
// are given (both NULL for a float pool), each dense but for its kv-head
// stride (page_stride, scale_stride elements: a shard's view of the pool)
// and 16-byte aligned; tables [B, MB] int32; lens [B] int32.  Key j of a
// table sits at global position kv_offset + j; skip_null nonzero skips the
// pages of zero table entries.  The keys [0, MB * BS) are cut into n_split
// (<= 8) ranges of split_keys (a multiple of BS), one block of a cluster
// each; n_sm is the card's SM count.  Either out [B, H, D] (normalised,
// element type) or the f32 partials acc [B, H, D], m and l [B, H] are
// written; the other is NULL.  tc nonzero takes the tensor-core form
// (bf16 q, D in 64 / 112 / 128; kernels/_paged.py:decode_form and
// tc_decode_plan), else the CUDA-core form.
extern "C" int repro_paged_decode(int dtype, int tc, const void* q,
                                  const void* k_pages, const void* v_pages,
                                  const float* k_scales,
                                  const float* v_scales, const int* tables, const int* lens,
                                  int kv_offset, int skip_null, void* out, float* acc,
                                  float* m, float* l, int B, int H, int KvH,
                                  int64_t page_stride, int64_t scale_stride, int BS, int D,
                                  int MB, int n_split, int split_keys, int n_sm,
                                  void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (n_sm <= 0) return cudaErrorInvalidValue;
  if ((k_scales == nullptr) != (v_scales == nullptr) || BS <= 0 || MB <= 0 || lens == nullptr)
    return cudaErrorInvalidValue;
  Args a = {};
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.k_scales = k_scales;
  a.v_scales = v_scales;
  a.tables = tables;
  a.lens = lens;
  a.out = out;
  a.acc = acc;
  a.m = m;
  a.l = l;
  a.head_stride = page_stride;
  a.scale_stride = scale_stride;
  a.kv_offset = kv_offset;
  a.skip_null = skip_null;
  a.H = H;
  a.KvH = KvH;
  a.BS = BS;
  a.MB = MB;
  a.keys = MB * BS;
  a.split_keys = split_keys;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  if (cudaError_t e = check_plan(a, B, n_split, BS)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    if (dtype != repro::kBF16) return cudaErrorInvalidValue;
    return k_scales != nullptr ? by_dim_tc<int8_t, true>(a, D, n_split, B, s)
                               : by_dim_tc<bf16, true>(a, D, n_split, B, s);
  }
  REPRO_DISPATCH_DTYPE(dtype, T, {
    return k_scales != nullptr ? by_dim<T, int8_t, true>(a, D, n_split, B, n_sm, s)
                               : by_dim<T, T, true>(a, D, n_split, B, n_sm, s);
  });
  return cudaSuccess;
}

// The dense slab.  q [B, H, D]; k, v [B, Sk, KvH, D] (16-byte aligned), the
// model's slab of one layer read in place; lens [B] int32 (NULL: the whole
// slab); kv_offset is the global position of slab row 0.  The rows [0, Sk)
// are cut into n_split (<= 8) ranges of split_keys (a multiple of 32; 16
// on the tensor-core form), one block of a cluster each; n_sm is the
// card's SM count.  Either out [B, H, D] (normalised, element type) or the
// f32 partials acc [B, H, D], m and l [B, H] are written; the other is
// NULL.  tc as repro_paged_decode's.
extern "C" int repro_decode_attention(int dtype, int tc, const void* q, const void* k,
                                      const void* v, const int* lens, int kv_offset, void* out,
                                      float* acc, float* m, float* l, int B, int Sk, int H,
                                      int KvH, int D, int n_split, int split_keys, int n_sm,
                                      void* stream) {
  if (B <= 0 || H <= 0) return cudaSuccess;
  if (Sk <= 0 || n_sm <= 0) return cudaErrorInvalidValue;
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lens = lens;
  a.out = out;
  a.acc = acc;
  a.m = m;
  a.l = l;
  a.head_stride = D;
  a.key_stride = static_cast<int64_t>(KvH) * D;
  a.batch_stride = static_cast<int64_t>(Sk) * KvH * D;
  a.kv_offset = kv_offset;
  a.H = H;
  a.KvH = KvH;
  a.keys = Sk;
  a.split_keys = split_keys;
  a.scale = 1.0f / sqrtf(static_cast<float>(D));
  if (cudaError_t e = check_plan(a, B, n_split, tc ? kTcKeys : kKeys)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) return dtype == repro::kBF16 ? by_dim_tc<bf16, false>(a, D, n_split, B, s)
                                       : cudaErrorInvalidValue;
  REPRO_DISPATCH_DTYPE(dtype, T, { return by_dim<T, T, false>(a, D, n_split, B, n_sm, s); });
  return cudaSuccess;
}
