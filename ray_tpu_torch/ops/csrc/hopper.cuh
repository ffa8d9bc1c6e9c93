// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// mbarriers, TMA tile copies, wgmma products and their shared-memory
// descriptors, and the host-side tensor maps. Raw PTX, no CUTLASS, so each
// kernel library still builds with one nvcc in seconds.
//
// Tile layout. Every tile the kernels keep in shared memory is a run of
// rows of 64 bf16 (128 bytes, the head dim), written by TMA with the
// 128-byte swizzle: the 16-byte chunk c of row r lands at chunk c ^ (r % 8)
// of that row, and each group of 8 rows fills one 1024-byte atom. A tile
// starts on a 1024-byte boundary. wgmma reads such a tile two ways:
//   K-major (the head dim is the product's depth: q k^T, dO v^T): rows are
//     the operand's M or N rows; SBO = 1024 (8 rows), LBO unused; the
//     k-th 16-wide step starts 32 bytes further;
//   MN-major (the tile's rows are the depth: p v, p^T dO, dS^T q, dS k):
//     the head dim is N, one 64-wide atom; SBO = 1024 (8 depth rows),
//     LBO unused for N = 64; the k-th 16-row step starts 2048 bytes further.
// A comes from registers only as fragments made in the same loop iteration
// (P, dS). Q fragments held in registers across a loop came out corrupted
// after the first dQ product on the card (CUDA 12.9's ptxas), so the
// kernels read Qs from shared memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace hopper {

constexpr int kRowBytes = 128;          // one row of 64 bf16
constexpr int kBoxRows = 64;            // rows per TMA box
constexpr int kBoxBytes = kBoxRows * kRowBytes;
// A barrier wait that has not completed after this long traps (the launch
// then fails with an error at the next synchronise instead of hanging).
constexpr unsigned long long kWaitLimitNs = 2000000000ull;
// Returned by a launcher, plus the operand's index, when the driver refuses
// the tensor map of that operand.
constexpr int kTensorMapError = 1000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Raise the barrier's expected transaction bytes without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the completion of the barrier's phase of the given parity (the
// u-th completion has parity u & 1). Traps after kWaitLimitNs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = globaltimer();
  while (!mbar_try_wait(bar, parity)) {
    if (globaltimer() - t0 > kWaitLimitNs) __trap();
  }
}

// ---- fences, named barriers ----

// Make this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma operand reads, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- TMA ----

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One 64-row box of a {64, S, H, B} tensor map into shared memory; rows past
// S arrive as zeros and still count their bytes on the barrier.
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// One 64-row box from shared memory to the tensor; rows past S are dropped.
__device__ __forceinline__ void tma_store_rows(const CUtensorMap* map, uint32_t src, int row, int h,
                                               int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(0), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// Commit this thread's TMA stores and wait until they have read shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- wgmma ----

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (see the top
// of this file): start address, LBO (unused here, 16 bytes), SBO 1024.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma wait or issue (the hardware writes them asynchronously).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; A in registers (each warp's 16
// rows as an m16n8k16 A fragment), B in shared memory: K-major for
// kTransB = 0, MN-major for kTransB = 1.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(kTransB), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---- arithmetic ----

// 2^x on the SFU (ex2.approx, denormal results flushed to zero).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- fragments and the swizzled tile layout ----

// Byte offset of element (row, col) in a 128-byte-swizzled tile of 64-wide rows.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * kRowBytes + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1));
}

// Two floats -> bf16x2 with `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16x2 times s, rounded back to bf16x2.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  return pack_bf16(__uint_as_float(x << 16) * s, __uint_as_float(x & 0xffff0000u) * s);
}

// dst = bf16(src * s) over one 64-row tile, by the 128 threads of a
// warpgroup (tw = thread in the warpgroup). Elementwise, so the swizzled
// layout carries over; dst may be src.
__device__ __forceinline__ void scale_tile(uint8_t* dst, const uint8_t* src, float s, int tw) {
#pragma unroll
  for (int c = tw; c < kBoxBytes / 16; c += 128) {
    uint4 x = *reinterpret_cast<const uint4*>(src + 16 * c);
    x.x = scale_bf16x2(x.x, s);
    x.y = scale_bf16x2(x.y, s);
    x.z = scale_bf16x2(x.z, s);
    x.w = scale_bf16x2(x.w, s);
    *reinterpret_cast<uint4*>(dst + 16 * c) = x;
  }
}

// The A fragment of k-step kk from an f32 accumulator of the same rows
// (columns 16kk..16kk+15 are its n-groups 2kk and 2kk + 1), rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a_frag(uint32_t (&a)[4], const float (&d)[N], int kk) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Write this thread's part of a 64 x 64 f32 accumulator as bf16 into a
// swizzled tile: row r0 (16w + g of the warpgroup's 64) times s_a, row
// r0 + 8 times s_b.
__device__ __forceinline__ void store_acc_tile(uint8_t* tile, const float (&d)[32], float s_a,
                                               float s_b, int r0, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + swz(r0, c)) = pack_bf16(d[4 * n] * s_a, d[4 * n + 1] * s_a);
    *reinterpret_cast<uint32_t*>(tile + swz(r0 + 8, c)) =
        pack_bf16(d[4 * n + 2] * s_b, d[4 * n + 3] * s_b);
  }
}

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 [B, H, S, 64] view with element strides (sb, sh,
// ss) and a unit last stride, as {64, S, H, B} with 64-row boxes and the
// 128-byte swizzle. Dims are bounded at S, so a box past S reads zeros and
// never the next batch's or head's rows. Returns the driver's result.
inline CUresult make_rows_map(CUtensorMap* map, const void* ptr, int B, int H, int S, long long sb,
                              long long sh, long long ss) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2, static_cast<cuuint64_t>(sh) * 2,
                           static_cast<cuuint64_t>(sb) * 2};
  // A dim of extent 1 is never stepped along; give it a stride TMA takes.
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1 && (strides[i] == 0 || strides[i] % 16 != 0)) strides[i] = 16;
  }
  const cuuint32_t box[4] = {64, kBoxRows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The driver's result for the last tensor map a launcher had refused.
inline int& refused_result() {
  static int r = 0;
  return r;
}

// A launcher's return code for the refused tensor map of operand i.
inline int tensor_map_error(int i, CUresult r) {
  refused_result() = static_cast<int>(r);
  return kTensorMapError + i;
}

// The message for a launcher's return code; `operands` names its tensor
// maps in order.
template <int N>
inline const char* error_string(int code, const char* const (&operands)[N]) {
  if (code >= kTensorMapError && code < kTensorMapError + N) {
    static thread_local char msg[128];
    snprintf(msg, sizeof msg, "the driver refused the tensor map of %s (CUresult %d)",
             operands[code - kTensorMapError], refused_result());
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
