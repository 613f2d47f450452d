// The bf16 and int8 tensor-core heads' kernel, head_predict_tc_kernel (K4,
// K5, K7), and its launchers, shared by the two translation units that
// instantiate it: head_predict_tc.cu (the resident-feats route, with the
// f32 route and the C entry points) and head_predict_wide.cu (the streamed
// route), so that nvcc compiles the two sets of instantiations in parallel.
// The design is described at the head of head_predict_tc.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"  // split3, the six pairs
#include "head_common.cuh"
#include "hopper.cuh"

namespace {

using namespace mpt_hopper;

constexpr int kBN = 128;                   // vocab rows of W a tile: the wgmma N
constexpr int kChunk = 128;                // bytes of K a stage: one swizzle atom
constexpr int kStageBytes = kBN * kChunk;  // 16 KB of W a stage
constexpr int kMinStages = 3;              // one being read, one awaited, one loading
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;         // 227 KB: the most a block may take
constexpr int kColBytes = 2 * kBN * 4;     // a warpgroup's tile bias and scale
// Alignment slack, barriers, two column buffers.
constexpr int kSmemFixed = 1024 + 8 * (2 * kMaxStages + 1) + 8 + 2 * kColBytes;
constexpr float kLog2e = 1.4426950408889634f;

// The operand types: the product of a k-step (32 bytes of K) and the logit
// of an accumulator.
struct Bf16 {
  static constexpr int kBytes = 2;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  using Acc = float;
  // d[64 × 128] (+)= A[64 × 16] · B[16 × 128], both K-major in shared memory.
  __device__ __forceinline__ static void mma(float* d, uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : MPT_WG_F8(d, 0), MPT_WG_F8(d, 8), MPT_WG_F8(d, 16), MPT_WG_F8(d, 24),
          MPT_WG_F8(d, 32), MPT_WG_F8(d, 40), MPT_WG_F8(d, 48), MPT_WG_F8(d, 56)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  __device__ __forceinline__ static float logit(float acc, float, float bias) {
    return acc + bias;
  }
};

struct Int8 {
  static constexpr int kBytes = 1;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // the bits
  using Acc = uint32_t;  // s32 sums
  // d[64 × 128] (+)= A[64 × 32] · B[32 × 128], s8 × s8 → s32, both K-major
  // in shared memory (8-bit types have no transpose).
  __device__ __forceinline__ static void mma(uint32_t* d, uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : MPT_WG_R8(d, 0), MPT_WG_R8(d, 8), MPT_WG_R8(d, 16), MPT_WG_R8(d, 24),
          MPT_WG_R8(d, 32), MPT_WG_R8(d, 40), MPT_WG_R8(d, 48), MPT_WG_R8(d, 56)
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // float(acc) rounds the exact sum to nearest as the plain version's
  // acc.float() does (exact while |acc| ≤ D·127² < 2²⁴); then two
  // roundings, never contracted into one FMA.
  __device__ __forceinline__ static float logit(uint32_t acc, float scale, float bias) {
    return __fadd_rn(__fmul_rn(__int2float_rn(static_cast<int>(acc)), scale), bias);
  }
};

// K chunks of 128 bytes a row of D elements.
__host__ __device__ constexpr int chunks(int D, int bytes) { return (D * bytes + kChunk - 1) / kChunk; }

// W stages that fit beside a feats tile of 64·C rows × nk chunks (0 when
// fewer than kMinStages do).
constexpr int ring_stages(int C, int nk) {
  const int left = (kSmemLimit - kSmemFixed - nk * 64 * C * kChunk) / kStageBytes;
  return left < kMinStages ? 0 : (left > kMaxStages ? kMaxStages : left);
}

// The bytes of a ring stage: W's tile, and on the streamed route the
// CTA's feats chunk beside it.
__host__ __device__ constexpr int stage_bytes(int C, bool stream) {
  return kStageBytes + (stream ? 64 * C * kChunk : 0);
}

// Stages of the streamed route's ring (at least kMinStages for C <= 2).
constexpr int stream_stages(int C) {
  const int n = (kSmemLimit - kSmemFixed) / stage_bytes(C, true);
  return n > kMaxStages ? kMaxStages : n;
}

constexpr int smem_bytes(int C, int nk, int stages, bool stream) {
  return 1024 + (stream ? 0 : nk * 64 * C * kChunk) + stages * stage_bytes(C, stream) +
         8 * (2 * stages + 1) + 8 + C * kColBytes;
}

// One row pair's online state of a thread over its own columns.
struct RowState {
  float m[2], l[2], pick[2];
  int arg[2];
};

// (m, l, arg, pick) merged with another state: the larger max wins, equal
// maxima go to the smaller column; l rescaled to the merged max.
__device__ __forceinline__ void merge_state(float& m, float& l, int& arg, float& pick, float om,
                                            float ol, int oa, float op) {
  const float mn = fmaxf(m, om);
  if (mn != -INFINITY) {
    const float mL = mn * kLog2e;
    l = l * exp2f(fmaf(m, kLog2e, -mL)) + ol * exp2f(fmaf(om, kLog2e, -mL));
  }
  if (om > m || (om == m && oa < arg)) arg = oa;
  m = mn;
  pick += op;
}

// Fold one tile's accumulators (this thread's rows 16w+g, 16w+g+8 at
// columns n0 + 8j + 2t + e) into the thread's online state: the max and
// (kArg) its first column, then the sum of exp relative to the new max and
// the label's logit. `cols` holds the tile's bias (and, int8, scale) in
// shared memory. kRagged: V's last tile, its columns past v_end masked to
// −inf before the max. !kArg (the training forward, K5, which keeps no
// argmax): the max alone, no column compared or carried.
template <typename Tr, bool kRagged, bool kArg>
__device__ __forceinline__ void fold_tile(const typename Tr::Acc* acc, RowState& st, int n0,
                                          int v_end, const int (&lab)[2], const float* cols,
                                          int t) {
  const int c0 = n0 + 2 * t;
  auto logit = [&](int j, int i, int e) {
    const float2 bb = *reinterpret_cast<const float2*>(cols + 8 * j + 2 * t);
    float2 sv = make_float2(0.f, 0.f);
    if constexpr (Tr::kBytes == 1) sv = *reinterpret_cast<const float2*>(cols + kBN + 8 * j + 2 * t);
    const float x = Tr::logit(acc[4 * j + 2 * i + e], e ? sv.y : sv.x, e ? bb.y : bb.x);
    return kRagged && c0 + 8 * j + e >= v_end ? -INFINITY : x;
  };
  float mx[2] = {-INFINITY, -INFINITY};
  int ax[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = logit(j, i, e);
        if constexpr (kArg) {
          const bool up = x > mx[i];  // strict: the first column keeps a tie
          mx[i] = up ? x : mx[i];
          ax[i] = up ? c0 + 8 * j + e : ax[i];
        } else {
          mx[i] = fmaxf(mx[i], x);
        }
      }
  float mL[2], sum[2] = {0.f, 0.f}, pick[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if constexpr (kArg) st.arg[i] = mx[i] > st.m[i] ? ax[i] : st.arg[i];  // strict: an earlier tile keeps a tie
    const float mn = fmaxf(st.m[i], mx[i]);
    // mn = −inf: every column of this thread masked so far; l stays 0.
    mL[i] = mn == -INFINITY ? 0.f : mn * kLog2e;
    st.l[i] *= exp2f(fmaf(st.m[i], kLog2e, -mL[i]));
    st.m[i] = mn;
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = logit(j, i, e);
        sum[i] += exp2f(fmaf(x, kLog2e, -mL[i]));
        pick[i] = c0 + 8 * j + e == lab[i] ? x : pick[i];  // the label's lane and column
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.l[i] += sum[i];
    st.pick[i] += pick[i];
  }
}

// The CTA's shared memory: the feats tile (resident route), the W ring
// (streamed route: each stage W's chunk, then the feats chunk), the
// barriers, and each consumer warpgroup's column buffer (a tile's bias,
// then scale).
struct Layout {
  uint32_t feats, ring, full, empty, feats_bar, cols;
};

// A consumer's place in the ring: the next chunk's stage and phase, the
// next stage to release, and the chunks read and released so far.
struct Ring {
  int stage, rel;
  uint32_t phase;
  int issued, released;
};

// What a consumer thread carries from tile to tile: the fold's state and
// the tile's bias (and scale) at column n0 + (its index in the
// warpgroup), loaded while the tile's products run.
struct Consumer {
  RowState st;
  int lab[2];
  float bias_col, scale_col = 0.f;
  float* cols;  // this warpgroup's column buffer
};

// The products of K chunk kc of the current tile into `acc`, once its W
// stage has landed (not committed). `sa`: this warpgroup's rows of the
// resident feats tile, or (kStream) their offset in a stage's feats chunk.
template <typename Tr, int C, bool kStream>
__device__ __forceinline__ void issue_chunk(typename Tr::Acc* acc, const Layout& L, Ring& rg,
                                            int kc, uint32_t sa, int stages) {
  mbar_wait(L.full + 8 * rg.stage, rg.phase);
  const uint32_t sb = L.ring + rg.stage * stage_bytes(C, kStream);
  const uint32_t fa = kStream ? sb + kStageBytes + sa : sa;
  const int k0 = kStream ? 0 : 4 * kc;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    Tr::mma(acc, kmajor_desc<64 * C>(fa, k0 + ks), kmajor_desc<kBN>(sb, ks), (kc | ks) != 0);
  ++rg.issued;
  if (++rg.stage == stages) {
    rg.stage = 0;
    rg.phase ^= 1;
  }
}

// After a commit and wgmma_wait<1>: every chunk but the `pending` of the
// newest group has been read, so their stages go back to the producer
// (one arrival per warp).
__device__ __forceinline__ void release(const Layout& L, Ring& rg, int pending, int stages) {
  const int lane = threadIdx.x & 31;
  while (rg.released < rg.issued - pending) {
    if (lane == 0) mbar_arrive(L.empty + 8 * rg.rel);
    if (++rg.rel == stages) rg.rel = 0;
    ++rg.released;
  }
}

// Load the bias (and scale) of tile n0's column for this thread, 0 past v_end.
template <typename Tr>
__device__ __forceinline__ void load_columns(Consumer& cs, int n0, int v_end,
                                             const float* __restrict__ bias,
                                             const float* __restrict__ scale_v) {
  const int c = n0 + (threadIdx.x & (kWarpgroup - 1));
  cs.bias_col = c < v_end ? __ldg(bias + c) : 0.f;
  if constexpr (Tr::kBytes == 1) cs.scale_col = c < v_end ? __ldg(scale_v + c) : 0.f;
}

// The fold of tile n0 (whose columns this thread loaded as its products
// started): its columns into the warpgroup's buffer (once the previous
// fold has read it), then the fold.
template <typename Tr, bool kArg>
__device__ __forceinline__ void fold(const typename Tr::Acc* acc, Consumer& cs, int n0, int v_end) {
  const int i = threadIdx.x & (kWarpgroup - 1), wg = threadIdx.x / kWarpgroup;
  named_barrier_sync(1 + wg, kWarpgroup);
  cs.cols[i] = cs.bias_col;
  if constexpr (Tr::kBytes == 1) cs.cols[kBN + i] = cs.scale_col;
  named_barrier_sync(1 + wg, kWarpgroup);
  if (n0 + kBN > v_end)  // V's last tile: CTA-uniform
    fold_tile<Tr, true, kArg>(acc, cs.st, n0, v_end, cs.lab, cs.cols, threadIdx.x & 3);
  else
    fold_tile<Tr, false, kArg>(acc, cs.st, n0, v_end, cs.lab, cs.cols, threadIdx.x & 3);
}

// One vocab tile n0: its products into `acc`, K chunk by chunk through the
// ring (one wgmma group in flight while the next chunk's stage is awaited),
// then the fold. The tile's bias and scale are loaded as its products start
// and read by its fold. The fold waits for every product: ptxas serializes
// all wgmma of a kernel whose products run while other instructions read
// an accumulator — a second accumulator set, folded while the next tile's
// products run, measured no faster on an H100 than this order, with 64
// registers more.
template <typename Tr, int C, bool kArg, bool kStream>
__device__ __forceinline__ void tile_step(typename Tr::Acc* acc, int n0, const Layout& L, Ring& rg,
                                          int nk, int stages, uint32_t sa, Consumer& cs, int v_end,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ scale_v) {
  load_columns<Tr>(cs, n0, v_end, bias, scale_v);
  for (int kc = 0; kc < nk; ++kc) {
    wgmma_fence();
    issue_chunk<Tr, C, kStream>(acc, L, rg, kc, sa, stages);
    wgmma_commit();
    wgmma_wait<1>();
    release(L, rg, 1, stages);
  }
  wgmma_wait<0>();
  release(L, rg, 0, stages);
  fence_regs<64>(acc);
  fold<Tr, kArg>(acc, cs, n0, v_end);
}

// Registers a thread after setmaxnreg: the producer warpgroup gives most
// of its own to the consumers (128 · (2 · 232 + 40) ≤ 65 536 beside two;
// beside one, the consumer may take all 256 a thread can address). The
// .sync.aligned instruction also tells ptxas that each consumer warpgroup
// runs converged from here on.
constexpr int kProducerRegs = 40;

// kArg: keep the first column attaining the max (K4, K7); the training
// forward K5 keeps none, and part_arg is then not written. kStream: the
// streamed route (feats chunks through the ring; see the head comment).
template <typename Tr, int C, bool kArg, bool kStream>
__global__ void __launch_bounds__((C + 1) * kWarpgroup, 1)
head_predict_tc_kernel(const __grid_constant__ CUtensorMap feats_map,  // [B, D]
                       const __grid_constant__ CUtensorMap w_map,      // [V, D]
                       const float* __restrict__ bias,                 // [V]
                       const float* __restrict__ scale_v,              // [V] (int8 only)
                       const int* __restrict__ labels,                 // [B]
                       float* __restrict__ part_mlp,  // [3, n_split, B]: m, l, picked
                       int* __restrict__ part_arg,    // [n_split, B] (kArg)
                       int B, int V, int tiles_per_split, int nk, int stages) {
  constexpr int R = 64 * C;                      // feats rows a CTA
  constexpr int kElems = kChunk / Tr::kBytes;    // K elements a chunk
  constexpr int kStage = stage_bytes(C, kStream);
  extern __shared__ __align__(1024) unsigned char smem[];
  Layout L;
  L.feats = (smem_addr(smem) + 1023) & ~1023u;  // nk atoms of R rows (resident)
  L.ring = L.feats + (kStream ? 0 : nk * R * kChunk);  // `stages` stages
  L.full = L.ring + stages * kStage;            // full[stages], empty[stages], feats
  L.empty = L.full + 8 * stages;
  L.feats_bar = L.empty + 8 * stages;
  L.cols = L.feats_bar + 16;                    // C column buffers of kColBytes

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * R, split = blockIdx.y, n_split = gridDim.y;
  const int v_begin = split * tiles_per_split * kBN;
  const int v_end = min(V, v_begin + tiles_per_split * kBN);
  const int n_tiles = (v_end - v_begin + kBN - 1) / kBN;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(L.full + 8 * s, 1);
      mbar_init(L.empty + 8 * s, 4 * C);  // one arrival a consumer warp
    }
    mbar_init(L.feats_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C) {  // the producer warpgroup: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (warp == 4 * C && lane == 0) {
      if constexpr (!kStream) {
        mbar_expect_tx(L.feats_bar, nk * R * kChunk);
        for (int kc = 0; kc < nk; ++kc)
          tma_load_2d(L.feats + kc * R * kChunk, &feats_map, kc * kElems, row0, L.feats_bar);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t)
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(L.empty + 8 * stage, phase ^ 1);  // the first round passes at once
          mbar_expect_tx(L.full + 8 * stage, kStage);
          const uint32_t at = L.ring + stage * kStage;
          tma_load_2d(at, &w_map, kc * kElems, v_begin + t * kBN, L.full + 8 * stage);
          if constexpr (kStream)  // the feats chunk, on the same barrier
            tma_load_2d(at + kStageBytes, &feats_map, kc * kElems, row0, L.full + 8 * stage);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // Consumer warpgroup wg: rows row0 + 64·wg .. +63 of the tile.
  constexpr int kConsumerRegs = C == 2 ? 232 : 256;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int first = row0 + 64 * wg + 16 * (warp & 3);  // this warp's first row
  Consumer cs;
  cs.cols = reinterpret_cast<float*>(smem + (L.cols - smem_addr(smem)) + wg * kColBytes);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = first + g + 8 * i;
    cs.lab[i] = r < B ? labels[r] : -1;
    cs.st.m[i] = -INFINITY;
    cs.st.l[i] = 0.f;
    cs.st.pick[i] = 0.f;
    cs.st.arg[i] = 0;
  }
  // This warpgroup's rows of every atom (resident), or their offset within
  // a stage's feats chunk (streamed).
  const uint32_t sa = (kStream ? 0u : L.feats) + 64 * wg * kChunk;
  typename Tr::Acc acc[64];
  Ring rg{0, 0, 0u, 0, 0};
  if constexpr (!kStream) mbar_wait(L.feats_bar, 0);
  for (int tile = 0; tile < n_tiles; ++tile)
    tile_step<Tr, C, kArg, kStream>(acc, v_begin + tile * kBN, L, rg, nk, stages, sa, cs, v_end,
                                    bias, scale_v);

  // The quad's four states, merged (merge_state; !kArg: no column shuffled).
  RowState& st = cs.st;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      merge_state(st.m[i], st.l[i], st.arg[i], st.pick[i],
                  __shfl_xor_sync(0xffffffffu, st.m[i], off),
                  __shfl_xor_sync(0xffffffffu, st.l[i], off),
                  kArg ? __shfl_xor_sync(0xffffffffu, st.arg[i], off) : 0,
                  __shfl_xor_sync(0xffffffffu, st.pick[i], off));
  if (t == 0) {
    const size_t plane = static_cast<size_t>(n_split) * B;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = first + g + 8 * i;
      if (r >= B) continue;
      const size_t o = static_cast<size_t>(split) * B + r;
      part_mlp[o] = st.m[i];
      part_mlp[plane + o] = st.l[i];
      part_mlp[2 * plane + o] = st.pick[i];
      if constexpr (kArg) part_arg[o] = st.arg[i];
    }
  }
}

// ------------------------------------------------------------ host side ---
template <typename Tr, int C, bool kArg, bool kStream>
cudaError_t launch_c(const CUtensorMap& fm, const CUtensorMap& wm, const float* bias,
                     const float* scale_v, const int* labels, float* part_mlp, int* part_arg,
                     int B, int V, int n_split, int tiles_per_split, int nk, cudaStream_t s) {
  const int stages = kStream ? stream_stages(C) : ring_stages(C, nk);
  const int bytes = smem_bytes(C, nk, stages, kStream);
  cudaError_t err = cudaFuncSetAttribute(head_predict_tc_kernel<Tr, C, kArg, kStream>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + 64 * C - 1) / (64 * C), n_split);
  head_predict_tc_kernel<Tr, C, kArg, kStream><<<grid, (C + 1) * kWarpgroup, bytes, s>>>(
      fm, wm, bias, scale_v, labels, part_mlp, part_arg, B, V, tiles_per_split, nk, stages);
  return cudaGetLastError();
}

template <typename Tr, bool kArg, bool kStream>
cudaError_t launch_route(int C, const CUtensorMap& fm, const CUtensorMap& wm, const float* bias,
                         const float* scale_v, const int* labels, float* part_mlp, int* part_arg,
                         int B, int V, int n_split, int tiles_per_split, int nk, cudaStream_t s) {
  return C == 2 ? launch_c<Tr, 2, kArg, kStream>(fm, wm, bias, scale_v, labels, part_mlp,
                                                 part_arg, B, V, n_split, tiles_per_split, nk, s)
                : launch_c<Tr, 1, kArg, kStream>(fm, wm, bias, scale_v, labels, part_mlp,
                                                 part_arg, B, V, n_split, tiles_per_split, nk, s);
}

}  // namespace

namespace mpt_head {

// The streamed route's launch (defined in head_predict_wide.cu): kind 0
// bf16 with the argmax (K4), 1 bf16 without (K5), 2 int8 (K7); C consumer
// warpgroups; the tensor maps and the rest as for launch_route.
cudaError_t launch_streamed(int kind, int C, const CUtensorMap& fm, const CUtensorMap& wm,
                            const float* bias, const float* scale_v, const int* labels,
                            float* part_mlp, int* part_arg, int B, int V, int n_split,
                            int tiles_per_split, int nk, cudaStream_t s);

}  // namespace mpt_head
