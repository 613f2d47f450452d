// Generic Hopper (sm_90a) building blocks shared by the tensor-core kernels:
// the attention kernels (attention_tc.cuh: K8, K9, K10) and the heads
// (head_predict_tc.cu: K4 bf16 and f32, K5, K7; fused_head_ce_bwd.cu: K6);
// the stem's training forward (fused_stem.cu: K2) takes the mbarrier and
// the 1-D bulk copy.
//
// - Shared-memory tiles in the 128-byte swizzle that wgmma's descriptors
//   read (`swz`), filled by 16- or 8-byte `cp.async` copies or by TMA.
// - wgmma's shared-memory descriptors (K-major and MN-major), and the
//   fence / commit / wait of its asynchronous products.
// - mbarriers and the 2-D TMA load that completes on one, for kernels
//   whose operand strides are fixed for the call (a tensor map is encoded
//   on the host per call, `encode_rows`), and the 1-D bulk copy of one
//   contiguous range (`bulk_load`, no tensor map).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace mpt_hopper {

constexpr int kWarpgroup = 128;

// A tile of R rows (R % 8 == 0) lies as "atoms" of R rows × 128 bytes, one
// per 64 columns, atom a at a·R·128 bytes; row r of an atom at r·128 and
// its 16-byte chunk c (c < 8) at ((c ^ r % 8)·16): the 128-byte swizzle.
// Tiles start on 1024 bytes, so the swizzle follows the address bits as
// wgmma expects. Chunk c of the whole row (c < padded/8) is in atom c / 8.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes global → shared, asynchronously (the `.ca` form: `.cg` takes 16
// bytes only); zero-filled when !valid.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of this thread (the copies that landed, the output
// staging) ordered before later wgmma reads, which go through the async
// proxy. Each writer fences, then the block synchronizes.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- wgmma ---
// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), and the 128-byte swizzle (layout
// type 1, bits 62–63).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand, k-step ks (32 bytes: 16 bf16 or 32 int8 columns) of the
// rows at `rows` in an R-row tile: 32 bytes into the swizzled row per
// k-step, the next atom every four; 8-row groups 1024 bytes apart (SBO;
// LBO unused).
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t rows, int ks) {
  return make_desc(rows + (ks >> 2) * (R * 128) + (ks & 3) * 32, 16, 1024);
}

// MN-major operand (v of p·v), k-step kk (16 keys) and columns 64j..64j+63
// of an R-row tile: 64 columns a 128-byte row; 8-key groups 1024 bytes
// apart (SBO), 64-column atoms R·128 bytes apart (LBO).
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk, int j) {
  return make_desc(tile + j * (R * 128) + kk * 2048, R * 128, 1024);
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

// Keep the compiler from moving reads or writes of wgmma's register
// operands across the asynchronous product (issue to wait).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Eight consecutive accumulator registers as inline-asm operands.
#define MPT_WG_F8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define MPT_WG_R8(d, i)                                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// Named barrier `id` (1..15; 0 is __syncthreads') over `threads` threads
// (a multiple of 32): one warpgroup synchronizes without the others.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at named barrier `id` without waiting: the threads that sync on
// it wait for these arrivals (with theirs, `threads` in all).
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------- mbarrier, TMA ---
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// The barriers' initialization made visible to the async proxy (TMA) and
// the other threads; the block synchronizes after it.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive once and expect `bytes` more of transactions (the TMA copies that
// complete on this barrier) before the phase can complete.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. A fresh barrier
// counts its (nonexistent) phase of parity 1 as completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The box at (c0 elements, c1 rows) of the 2-D tensor map at `map` (a
// __grid_constant__ kernel parameter) into shared memory at dst, completing
// its bytes on `bar`. Out-of-bounds elements land as zeros, and count.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, as one bulk copy of the async proxy (no tensor map),
// completing its bytes on `bar`. Nothing outside the range is touched.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------ host: TMA maps ---
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime (the
// library links no libcuda); null when the driver lacks it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] tensor of `bytes`-byte elements read in boxes of
// box_rows × 128 bytes, 128-byte swizzle, out-of-bounds elements zero.
inline bool encode_rows(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rows,
                        int cols, int bytes, int box_rows, CUtensorMapL2promotion promotion) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, promotion,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace mpt_hopper
