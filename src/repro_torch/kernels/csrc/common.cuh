// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes a plain C entry point (loaded with ctypes by
// repro_torch/kernels/_build.py).  An entry point launches on the stream it
// is given and returns cudaGetLastError(), so a launch the driver refuses is
// reported to the Python wrapper, which raises.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (_build.DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// round-to-nearest-even, as torch's .to(dtype) rounds
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the four lanes of a quad (the lanes that hold one row of an
// MMA accumulator)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the max over the four lanes of a quad
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// Tensor-core and asynchronous-copy helpers (sm_80+ instructions, used on
// sm_90a by matmul.cu, flash_attention.cu and mamba2.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two f32 rounded to nearest-even bf16, lo in the low half (the element of
// the lower column in an MMA fragment)
__device__ __forceinline__ uint32_t pack_f32_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// ---------------------------------------------------------------------------
// 16-byte vectors of an element type (rmsnorm.cu, rope.cu, swiglu.cu): one
// access a thread moves 4 f32 or 8 bf16, widened to f32 and rounded back in
// order
// ---------------------------------------------------------------------------

template <typename T> struct Vec16 { static constexpr int kN = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ uint4 load16(const T* __restrict__ p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void store16(T* __restrict__ p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// the kN elements of v as f32, in memory order
template <typename T>
__device__ __forceinline__ void unpack16(uint4 v, float (&f)[Vec16<T>::kN]) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  } else {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// kN f32 rounded to T (nearest-even, as from_f32) into one vector
template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&f)[Vec16<T>::kN]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  } else {
    return make_uint4(pack_f32_bf16(f[0], f[1]), pack_f32_bf16(f[2], f[3]),
                      pack_f32_bf16(f[4], f[5]), pack_f32_bf16(f[6], f[7]));
  }
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a (16 x 16, row) * b (16 x 8, col) with a zero accumulator (no
// registers spent on zeroing it)
__device__ __forceinline__ void mma_bf16_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.  Without .trans lane l receives, of matrix j,
// elements (l / 4, 2 (l % 4)) and (l / 4, 2 (l % 4) + 1) in r[j]; with
// .trans elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// m16n8k16 fragments from bf16 tiles in shared memory, row-major with a row
// stride of LDS elements.  Lane l holds, of an A fragment, (row l / 4, cols
// 2 (l % 4) and + 1) in a[0], row + 8 in a[1], cols + 8 in a[2], both in
// a[3]; of a B fragment (k, n) = (2 (l % 4) and + 1, l / 4) in b0, k + 8 in
// b1; of the f32 accumulator, (row l / 4, cols 2 (l % 4), + 1) in d[0..1]
// and row + 8 in d[2..3].  So the accumulator tiles of columns 8 j.. and
// 8 j + 8.. are, element for element, the A fragment of a 16-deep k step.

// A[16 x 16] = rows r0.., cols c0.. of the tile: lanes 0-15 address rows
// 0-15 at column c0, lanes 16-31 the same rows at c0 + 8.
template <int LDS>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int r0,
                                       int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * LDS + c0 + (lane >> 4) * 8);
}

// A[m][k] = tile[k][m] (a row-major tile used transposed): m rows m0..,
// depth k0.., through ldmatrix.trans.
template <int LDS>
__device__ __forceinline__ void frag_at(uint32_t (&a)[4], const __nv_bfloat16* tile, int k0,
                                        int m0, int lane) {
  ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + (lane >> 4) * 8) * LDS + m0 +
                           ((lane >> 3) & 1) * 8);
}

// The B fragments of two adjacent 8-wide n tiles when B[k][n] = tile[n][k]
// (K in Q K^T): rows n0.. and n0 + 8.., depth c0..c0 + 15.  b[0], b[1] for
// n tile n0; b[2], b[3] for n0 + 8.
template <int LDS>
__device__ __forceinline__ void frag_bt(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0,
                                        int c0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LDS + c0 + ((lane >> 3) & 1) * 8);
}

// The B fragments of two adjacent n tiles when B[k][n] = tile[k][n] (V in
// P V): rows k0..k0 + 15, columns n0.. and n0 + 8.., through ldmatrix.trans.
template <int LDS>
__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0,
                                       int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 15)) * LDS + n0 + (lane >> 4) * 8);
}

// An f32 operand carried as a bf16 pair, hi = bf16(v) and lo = bf16(v -
// hi), for two MMAs: v to ~2^-17 relative where hi alone carries 2^-9.
// v[2 i], v[2 i + 1] go into register i (the lower column in the low half).
__device__ __forceinline__ void split_bf16(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(v[2 * i] - __low2float(h),
                                                   v[2 * i + 1] - __high2float(h));
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// bf16 tiles sit in shared memory as rows of W + 8 elements (W a multiple of
// 8): an odd count of 16-byte pieces, so the eight row addresses of an
// ldmatrix 8 x 8 matrix fall in eight different bank groups.
template <int W> __host__ __device__ constexpr int lds() { return W + 8; }

// MMA accumulator tiles [NT][4]: cleared, and a piece's sum added on the
// CUDA cores (the tensor cores' own accumulation truncates)
template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

template <int NT>
__device__ __forceinline__ void add(float (&acc)[NT][4], const float (&part)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// the two bf16 of a packed register as f32 (exact): the lower column first
__device__ __forceinline__ float bf16_lo(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

// 16 bytes global -> shared without passing through registers (L2 only);
// with valid false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// one 4-byte word, zero-filled when not valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The thread-block cluster barrier (sm_90), split into arrive and wait so
// that a block can work between the two.  Every thread of every block of the
// cluster arrives once per phase; a wait returns when the phase is complete.
// A release arrive orders this thread's earlier stores (to its own or a
// peer's shared memory) before an acquire wait that sees the phase complete.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Hopper (sm_90a) helpers: mbarriers, TMA tile loads and wgmma, used by
// matmul.cu's bf16 GEMM.  The layout rules they encode:
//
// * A TMA box loaded with CU_TENSOR_MAP_SWIZZLE_{32,64,128}B lands in shared
//   memory as rows of R = 32 / 64 / 128 bytes (the box's inner extent), row
//   r at r * R, with address bits [4, 4 + b) XORed with bits [7, 7 + b), b =
//   log2(R / 16): the 16-byte chunks of a row are permuted, and the pattern
//   repeats every 8 rows (8 R bytes).  wgmma applies the same address-based
//   swizzle when its descriptor names it, so a tile whose base is
//   1024-byte aligned reads back as TMA wrote it.
// * wgmma reads A and B from shared memory through 64-bit descriptors
//   (wgmma_desc).  A K-major operand (K contiguous, rows of 64 bf16 under
//   the 128-byte swizzle) has its 8-row groups SBO = 1024 bytes apart; a
//   k16 step inside the 64-wide row moves the start address by 32 bytes.
//   An MN-major operand (MN contiguous, e.g. w [K, N]) stored as rows of
//   one swizzle atom (16 / 32 / 64 bf16 under the 32 / 64 / 128-byte
//   swizzle) has its 8-row K groups SBO = 8 R bytes apart and its atoms
//   along MN LBO bytes apart; a k16 step moves the start address by 16 R
//   bytes.
// * The f32 accumulator of wgmma m64nNk16 over a warpgroup: thread t
//   (warp w = t / 32, lane l) holds rows 16 w + l / 4 and 16 w + l / 4 + 8
//   and, for each n8 chunk j, columns 8 j + 2 (l % 4) and + 1:
//   d[4 j + 0, 1] on the first row, d[4 j + 2, 3] on the second (the
//   mma.sync m16n8 C fragment, repeated over N / 8 chunks).
// ---------------------------------------------------------------------------

// mbarrier: a 64-bit word in shared memory counting arrivals and, for TMA,
// transaction bytes; a phase completes when both reach zero, and its
// parity (0, 1, 0, ...) is what a wait names.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA) and to the
// other threads; the caller then synchronises the block
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also tells the barrier to expect `bytes` more from TMA
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first, parity 1, as complete)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (TMA writes, wgmma reads) of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: the box of `map` at coordinates (c0 innermost, c1) into shared memory
// at dst (aligned to the swizzle's repeat, 1024 bytes covers all), counted
// on `bar` as transaction bytes; elements outside the tensor arrive as zero
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units, 14 bits each), swizzle of `swizzle_bytes` rows
// (128 -> layout 1, 64 -> 2, 32 -> 3); base offset 0 (1024-aligned tiles)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                               int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2 : 3;
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// wgmma.fence before the first wgmma of a batch (orders earlier register
// and shared-memory accesses); commit closes a batch into a group; wait<N>
// blocks until at most N groups of this warpgroup are in flight
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator registers across an in-flight
// wgmma (between its issue and the wait that retires it)
template <int R>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// register budget of a warpgroup (a multiple of 8 in [24, 256]): a producer
// warpgroup gives registers back, consumer warpgroups take them
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// d[64, N] += A[64, 16] B[16, N], bf16 in, f32 accumulate (scale-d 1: the
// caller zeroes d first), both operands from shared memory: A K-major
// (trans-a 0), B MN-major (trans-b 1).  d is the accumulator fragment above.
// Defined for N = 16, 32, 64 and 128.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b));
}

// Host: a 2-D bf16 tensor map (inner extent `inner` contiguous, `outer`
// rows `row_bytes` apart) with a box of box_inner x box_outer, its rows
// swizzled by `swizzle_bytes` (32, 64 or 128 = box_inner * 2).  The driver's
// encoder is fetched through the runtime, so the library links no libcuda.
// Returns false if the driver refuses the map.
typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

inline bool encode_tma_2d_bf16(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                               uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                               int swizzle_bytes) {
  static TensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return false;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault) != cudaSuccess)
      return false;
#endif
    encode = reinterpret_cast<TensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace repro

// Instantiate BODY with T bound to the element type named by a dtype code;
// an unknown code is an invalid-value error for the caller to raise on.
#define REPRO_DISPATCH_DTYPE(code, T, ...)                   \
  switch (code) {                                            \
    case repro::kF32: { using T = float; __VA_ARGS__; break; }          \
    case repro::kBF16: { using T = __nv_bfloat16; __VA_ARGS__; break; } \
    default: return cudaErrorInvalidValue;                   \
  }
