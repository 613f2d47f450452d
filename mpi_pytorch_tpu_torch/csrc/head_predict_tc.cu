// The streaming predict heads on Hopper's tensor cores: per row of feats,
// the softmax cross-entropy and the first-index argmax of
// logits = feats·Wᵀ + b, without ever storing the [B, V] logits.
//
// Replaces three TPU kernels:
//  - K4, mpi_pytorch_tpu/ops/fused_head_ce.py:313 `_predict_kernel` (with
//    its epilogue `online_predict_update`, :259), for bf16 feats and W:
//    `mpt_head_predict_bf16`; for f32 feats and W (an f32 model keeps its
//    head in f32, as the JAX head_predict does): `mpt_head_predict_f32`,
//    each f32 product six exact bf16 products (the f32 route's section
//    below).
//  - K7, mpi_pytorch_tpu/ops/quantize.py:286 `_predict_int8_kernel`:
//    `mpt_head_predict_int8`. feats are first quantized by
//    quantize_activations' rule (quantize_rows_kernel), W is int8; the
//    int8 × int8 sums are exact int32, then float(acc)·scale_v[c] and + b[c]
//    as two separately rounded f32 operations (__fmul_rn, __fadd_rn: an FMA
//    would round once and give other bits than the plain version's).
//  - K5, mpi_pytorch_tpu/ops/fused_head_ce.py:71 `_fwd_kernel`, the forward
//    of the fused_head_ce training op: `mpt_head_ce_fwd`, K4's bf16 kernel
//    with no argmax kept (kArg = false: the fold takes the max alone and
//    the quad shuffles no column), and a merge that also writes the rows'
//    global (m, l), from which the backward (fused_head_ce_bwd.cu)
//    recomputes its softmax.
// Semantics carried over exactly: the argmax is the FIRST column attaining
// the max (a tie keeps the earlier column within a tile, across tiles,
// across the lanes of a quad and across splits), loss = log Σ exp(logit −
// m) + m − logit[label], and loss = 0 where label < 0.
//
// What bounds them on an H100 SXM (D = 512, V = 64 500):
//  - B = 1 (and up to B ≈ 128): the bytes of W, 66 MB bf16 (~20 us at
//    3.35 TB/s) or 33 MB int8 (~10 us). So W must stream at the full rate:
//    every SM needs many bytes of W in flight.
//  - B = 512: the products, 2·512·512·64 500 = 33.8 G operations: ~34 us
//    at 989 TFLOP/s bf16, ~17 us at 1 979 TOP/s int8. So the products must
//    run on wgmma with the tensor cores kept busy through the epilogue.
//  - f32: the bytes of the f32 W, 132 MB (~39 us), up to B ≈ 64; at B = 512
//    the six bf16 products a product, 203 G operations (~205 us).
//
// Design. Two passes, as the old kernels: the grid is (row tile, vocab
// split), the row tile fastest, so the CTAs that share a vocab split run
// together and read that slice of W from L2 after the first brings it
// from DRAM. Each CTA leaves its split's per-row state to the scratch;
// head_merge_kernel (head_common.cuh) finishes the rows, one warp a row.
// Within a CTA:
//  - A producer warpgroup, one lane of it issuing TMA copies
//    (cp.async.bulk.tensor, 128-byte swizzle, completing on mbarriers): the
//    CTA's feats tile once (64 rows a consumer warpgroup, every K chunk;
//    rows past B and columns past D land as zeros), then W in tiles of 128
//    vocab rows × 128 bytes of K (64 bf16 or 128 int8 values) through a
//    ring of 3–8 stages (as many as shared memory holds beside the feats
//    tile). Rows past V land as zeros. TMA rather than a cp.async ring: W's
//    strides are fixed for the call, so one tensor map, encoded on the host
//    per call through cudaGetDriverEntryPoint (no -lcuda), replaces the
//    consumers' address arithmetic and copy instructions. setmaxnreg moves
//    the producer's registers to the consumers.
//  - One consumer warpgroup (B ≤ 64) or two (B > 64, sharing every W stage:
//    W is read from L2 once per 128 rows). Each runs wgmma m64n128 with
//    both operands K-major in shared memory: k16 bf16 → f32, or k32
//    s8 × s8 → s32, one group in flight while the next stage is awaited. A
//    stage is released (one arrival a warp) once the group that read it has
//    completed.
//  - The epilogue folds the tile in registers once its products are done.
//    In wgmma's layout lane (g, t) of warp w holds rows 16w+g and 16w+g+8
//    at columns 8j+2t+e; each thread keeps its own online state a row over
//    its own columns, which it visits in ascending order (m, l with exp2f
//    on log2e-scaled differences, the first column attaining m, the
//    label's logit where it holds that column). The tile's bias (and
//    scale) is loaded as its products start and staged in shared memory,
//    read twice by the fold. The ragged vocab edge is masked to −inf before
//    the max: a zero-filled W row never wins. At the end of the split the
//    four lanes of a quad merge their states with a (value, column) shuffle
//    — equal values: the smaller column wins — and lane 0 writes the row.
// Determinism: fixed-order sums (k-steps ascending; a thread's columns
// ascending; fixed shuffle trees; a lane's splits ascending), no atomics:
// two calls on the same inputs give the same bits.
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

constexpr int smem_bytes(int C, int nk, int stages) {
  return 1024 + nk * 64 * C * kChunk + stages * kStageBytes + 8 * (2 * stages + 1) + 8 +
         C * kColBytes;
}

// Consumer warpgroups for a batch: two above 64 rows where their feats
// tile fits, else one; 0 when not even one fits (D too large).
int consumer_groups(int B, int D, int bytes) {
  const int nk = chunks(D, bytes);
  if (B > 64 && ring_stages(2, nk) > 0) return 2;
  return ring_stages(1, nk) > 0 ? 1 : 0;
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

// The CTA's shared memory: the feats tile, the W ring, the barriers, and
// each consumer warpgroup's column buffer (a tile's bias, then scale).
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
// stage has landed (not committed).
template <typename Tr, int C>
__device__ __forceinline__ void issue_chunk(typename Tr::Acc* acc, const Layout& L, Ring& rg,
                                            int kc, uint32_t sa, int stages) {
  mbar_wait(L.full + 8 * rg.stage, rg.phase);
  const uint32_t sb = L.ring + rg.stage * kStageBytes;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    Tr::mma(acc, kmajor_desc<64 * C>(sa, 4 * kc + ks), kmajor_desc<kBN>(sb, ks), (kc | ks) != 0);
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
template <typename Tr, int C, bool kArg>
__device__ __forceinline__ void tile_step(typename Tr::Acc* acc, int n0, const Layout& L, Ring& rg,
                                          int nk, int stages, uint32_t sa, Consumer& cs, int v_end,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ scale_v) {
  load_columns<Tr>(cs, n0, v_end, bias, scale_v);
  for (int kc = 0; kc < nk; ++kc) {
    wgmma_fence();
    issue_chunk<Tr, C>(acc, L, rg, kc, sa, stages);
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
// forward K5 keeps none, and part_arg is then not written.
template <typename Tr, int C, bool kArg>
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
  extern __shared__ __align__(1024) unsigned char smem[];
  Layout L;
  L.feats = (smem_addr(smem) + 1023) & ~1023u;  // nk atoms of R rows
  L.ring = L.feats + nk * R * kChunk;           // `stages` W tiles
  L.full = L.ring + stages * kStageBytes;       // full[stages], empty[stages], feats
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
      mbar_expect_tx(L.feats_bar, nk * R * kChunk);
      for (int kc = 0; kc < nk; ++kc)
        tma_load_2d(L.feats + kc * R * kChunk, &feats_map, kc * kElems, row0, L.feats_bar);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t)
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(L.empty + 8 * stage, phase ^ 1);  // the first round passes at once
          mbar_expect_tx(L.full + 8 * stage, kStageBytes);
          tma_load_2d(L.ring + stage * kStageBytes, &w_map, kc * kElems, v_begin + t * kBN,
                      L.full + 8 * stage);
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
  const uint32_t sa = L.feats + 64 * wg * kChunk;  // this warpgroup's rows of every atom
  typename Tr::Acc acc[64];
  Ring rg{0, 0, 0u, 0, 0};
  mbar_wait(L.feats_bar, 0);
  for (int tile = 0; tile < n_tiles; ++tile)
    tile_step<Tr, C, kArg>(acc, v_begin + tile * kBN, L, rg, nk, stages, sa, cs, v_end, bias,
                           scale_v);

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

// ------------------------------------------------------ K4's f32 route ---
// f32 feats and W. Each f32 product is six exact bf16 products: feats and W
// split into three bf16 terms each (attention_tc.cuh's split3), the pairs
// (i, j), i + j <= 2, summed smallest first (pair_a, pair_b), as the f32
// attention kernels take theirs. The roles of the operands are swapped
// against the bf16 head: feats' three term tiles would take 3 KB a row at
// D = 512, 192 KB for 64 rows, leaving no room for W's f32 stages beside
// its terms, so feats is the resident shared-memory operand B (its terms
// split once per CTA, N = 8 or 64 batch rows) and W the register operand A
// of `wgmma ... m64nNk16` with A in registers: each consumer thread loads
// its fragment of the raw f32 W stage (TMA, 128-byte swizzle) and splits it
// in registers, so W is never held split in device memory or in shared
// memory, and a stage is released as soon as it is read. The accumulator
// is then [64 vocab rows × N batch rows] a warpgroup: each thread keeps an
// online state (max, its first column, sum of exp, the label's logit) for
// each of its N/4 batch rows over its two vocab rows a tile, ascending; at
// the end of the split the eight lanes that share a batch row, then the
// eight warps, merge (equal maxima going to the smaller column). Two
// consumer warpgroups (64 vocab rows of a 128-row tile each) alternate on
// the tensor cores: one splits its next stage while the other's products
// run.
constexpr int kF32Cols = kChunk / 4;  // K elements of f32 W a stage (two k-steps)

// Bytes of the three feats term tiles of N rows over D (whole 64-column
// atoms, padding zero).
__host__ __device__ constexpr int f32_terms_bytes(int N, int D) { return 3 * chunks(D, 2) * N * kChunk; }

// W stages that fit beside N rows of feats terms and N labels (0 when fewer
// than two do).
constexpr int f32_stages(int N, int D) {
  const int left = (kSmemLimit - 1024 - f32_terms_bytes(N, D) - 4 * N) / (kStageBytes + 16);
  return left < 2 ? 0 : (left > kMaxStages ? kMaxStages : left);
}

constexpr int f32_smem_bytes(int N, int D, int stages) {
  return 1024 + f32_terms_bytes(N, D) + stages * (kStageBytes + 16) + 4 * N;
}

// Batch rows a CTA of the f32 head takes: 64 above B = 8 where they fit
// (D <= 512), else 8; 0 when not even 8 fit.
int f32_rows(int B, int D) {
  if (B > 8 && f32_stages(64, D) > 0) return 64;
  return f32_stages(8, D) > 0 ? 8 : 0;
}

// d[64 × N] (+)= A[64 × 16] · B[16 × N]: A (bf16 pairs) in registers, B
// K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs_kmajor(float* d, const uint32_t* a, uint64_t b,
                                                int accumulate);
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<64>(float* d, const uint32_t* a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : MPT_WG_F8(d, 0), MPT_WG_F8(d, 8), MPT_WG_F8(d, 16), MPT_WG_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<8>(float* d, const uint32_t* a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// A thread's online state for each of its N/4 batch rows (8j + 2t + e at
// index 2j + e).
template <int N>
struct ColState {
  float m[N / 4], l[N / 4], pick[N / 4];
  int arg[N / 4];
};

// Fold one tile's accumulators: this thread's vocab rows r0 and r0 + 8
// (rows at or past v_end masked to −inf), bias b0, b1, into the state of
// each of its batch rows; the labels of the CTA's rows in `lab`.
template <int N>
__device__ __forceinline__ void fold_f32(const float* acc, ColState<N>& st, int r0, int v_end,
                                         float b0, float b1, const int* lab, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 2 * j + e, col = 8 * j + 2 * t + e;
      const float x0 = r0 < v_end ? acc[4 * j + e] + b0 : -INFINITY;
      const float x1 = r0 + 8 < v_end ? acc[4 * j + 2 + e] + b1 : -INFINITY;
      const bool up = x1 > x0;  // strict: the first row keeps a tie
      const float mx = up ? x1 : x0;
      st.arg[q] = mx > st.m[q] ? (up ? r0 + 8 : r0) : st.arg[q];  // strict: an earlier tile keeps a tie
      const float mn = fmaxf(st.m[q], mx);
      const float mL = mn == -INFINITY ? 0.f : mn * kLog2e;
      st.l[q] = st.l[q] * exp2f(fmaf(st.m[q], kLog2e, -mL)) + exp2f(fmaf(x0, kLog2e, -mL)) +
                exp2f(fmaf(x1, kLog2e, -mL));
      st.m[q] = mn;
      const int lb = lab[col];
      st.pick[q] += (lb == r0 ? x0 : 0.f) + (lb == r0 + 8 ? x1 : 0.f);
    }
}

// This thread's A fragments of the two k-steps of one W stage at sb (128
// vocab rows × 32 f32, 128-byte swizzle), its vocab rows `row` and row + 8,
// split into three bf16 terms: t[kk][term][i + 2h] holds (row + 8i, k-step
// kk's columns 8h + 2t, 8h + 2t + 1).
__device__ __forceinline__ void load_split(const unsigned char* stage, int row, int t,
                                           uint32_t (&tm)[2][3][4]) {
  float2 x[2][2][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * i, c = 4 * kk + 2 * h + (t >> 1);
        x[kk][i][h] = *reinterpret_cast<const float2*>(stage + r * kChunk + ((c ^ (r & 7)) << 4) +
                                                       8 * (t & 1));
      }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[3];
        mpt_tc::split3(x[kk][i][h].x, x[kk][i][h].y, w);
#pragma unroll
        for (int n = 0; n < 3; ++n) tm[kk][n][i + 2 * h] = w[n];
      }
}

constexpr int kF32Consumers = 2;  // consumer warpgroups: 64 vocab rows of a tile each

template <int N>
__global__ void __launch_bounds__((kF32Consumers + 1) * kWarpgroup, 1)
head_predict_f32_kernel(const __grid_constant__ CUtensorMap w_map,  // [V, D] f32
                        const float* __restrict__ feats,            // [B, D]
                        const float* __restrict__ bias,             // [V]
                        const int* __restrict__ labels,             // [B]
                        float* __restrict__ part_mlp,  // [3, n_split, B]: m, l, picked
                        int* __restrict__ part_arg,    // [n_split, B]
                        int B, int D, int V, int tiles_per_split, int stages) {
  constexpr int C = kF32Consumers, NC = C * kWarpgroup;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = smem_addr(smem), base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem + (base - raw);
  const int nk = chunks(D, 2);                       // 64-column atoms of the feats terms
  const uint32_t T = nk * N * kChunk;                // bytes of one term tile
  const uint32_t feats_s = base, ring = base + 3 * T;
  const uint32_t full = ring + stages * kStageBytes, empty = full + 8 * stages;
  int* const lab = reinterpret_cast<int*>(sm + (empty + 8 * stages - base));
  const int ns = (D + kF32Cols - 1) / kF32Cols;      // W stages a tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * N, split = blockIdx.y, n_split = gridDim.y;
  const int v_begin = split * tiles_per_split * kBN;
  const int v_end = min(V, v_begin + tiles_per_split * kBN);
  const int n_tiles = (v_end - v_begin + kBN - 1) / kBN;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C) {  // the producer warpgroup: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (warp == 4 * C && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t)
        for (int s = 0; s < ns; ++s) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes at once
          mbar_expect_tx(full + 8 * stage, kStageBytes);
          tma_load_2d(ring + stage * kStageBytes, &w_map, s * kF32Cols, v_begin + t * kBN,
                      full + 8 * stage);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(232) : "memory");
  // The CTA's feats rows split into three term tiles (rows past B and
  // columns past D zero), and their labels (−1 past B).
  const int c4s = nk * 16;  // float4s a padded row
  for (int i = tid; i < N * c4s; i += NC) {
    const int r = i / c4s, c4 = i % c4s;
    const float4 x = row0 + r < B && 4 * c4 < D
                         ? *reinterpret_cast<const float4*>(feats + static_cast<size_t>(row0 + r) * D + 4 * c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t lo[3], hi[3];
    mpt_tc::split3(x.x, x.y, lo);
    mpt_tc::split3(x.z, x.w, hi);
    const uint32_t at = feats_s + swz<N>(r, c4 >> 1) + (c4 & 1) * 8;
#pragma unroll
    for (int n = 0; n < 3; ++n) mpt_tc::st_shared_v2(at + n * T, lo[n], hi[n]);
  }
  for (int i = tid; i < N; i += NC) lab[i] = row0 + i < B ? labels[row0 + i] : -1;
  fence_async_smem();
  named_barrier_sync(1, NC);

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int row = 64 * wg + 16 * (warp & 3) + g;  // this thread's first vocab row of a tile
  ColState<N> st;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    st.m[q] = -INFINITY;
    st.l[q] = 0.f;
    st.pick[q] = 0.f;
    st.arg[q] = 0;
  }
  float acc[N / 2];
  uint32_t tm[2][3][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int r0 = v_begin + tile * kBN + row;
    const float b0 = r0 < v_end ? __ldg(bias + r0) : 0.f;
    const float b1 = r0 + 8 < v_end ? __ldg(bias + r0 + 8) : 0.f;
    for (int s = 0; s < ns; ++s) {
      mbar_wait(full + 8 * stage, phase);
      load_split(sm + (ring - base) + stage * kStageBytes, row, t, tm);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // read: the stage goes back at once
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
      wgmma_fence();
#pragma unroll
      for (int n = 5; n >= 0; --n)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_rs_kmajor<N>(acc, tm[kk][mpt_tc::pair_a(n)],
                             kmajor_desc<N>(feats_s + mpt_tc::pair_b(n) * T, 2 * s + kk),
                             s > 0 || n < 5 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<N / 2>(acc);
      fence_regs<24>(&tm[0][0][0]);
    }
    fold_f32<N>(acc, st, r0, v_end, b0, b1, lab, t);
  }

  // The eight lanes that share a batch row (lane bits 2-4), then the eight
  // warps through shared memory (the ring, spent), in warp order.
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      merge_state(st.m[q], st.l[q], st.arg[q], st.pick[q],
                  __shfl_xor_sync(0xffffffffu, st.m[q], off),
                  __shfl_xor_sync(0xffffffffu, st.l[q], off),
                  __shfl_xor_sync(0xffffffffu, st.arg[q], off),
                  __shfl_xor_sync(0xffffffffu, st.pick[q], off));
  named_barrier_sync(1, NC);  // every stage is read
  float* const sm_m = reinterpret_cast<float*>(sm + (ring - base));
  float* const sm_l = sm_m + 4 * C * N;
  float* const sm_p = sm_l + 4 * C * N;
  int* const sm_a = reinterpret_cast<int*>(sm_p + 4 * C * N);
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * j + e, at = warp * N + 8 * j + 2 * t + e;
        sm_m[at] = st.m[q];
        sm_l[at] = st.l[q];
        sm_p[at] = st.pick[q];
        sm_a[at] = st.arg[q];
      }
  }
  named_barrier_sync(1, NC);
  if (tid < N && row0 + tid < B) {
    float m = sm_m[tid], l = sm_l[tid], pick = sm_p[tid];
    int arg = sm_a[tid];
    for (int w = 1; w < 4 * C; ++w) {
      const int at = w * N + tid;
      merge_state(m, l, arg, pick, sm_m[at], sm_l[at], sm_a[at], sm_p[at]);
    }
    const size_t plane = static_cast<size_t>(n_split) * B, o = static_cast<size_t>(split) * B + row0 + tid;
    part_mlp[o] = m;
    part_mlp[plane + o] = l;
    part_mlp[2 * plane + o] = pick;
    part_arg[o] = arg;
  }
}

// feats -> int8 by quantize_activations' rule: clamp(rint(x / act_scale)),
// the division correctly rounded, rint rounding half to even.
template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ x, signed char* __restrict__ q,
                                     long long n, float act_scale) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v;
  if constexpr (sizeof(T) == 2)
    v = __bfloat162float(x[i]);
  else
    v = x[i];
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, act_scale)), -127.f), 127.f);
  q[i] = static_cast<signed char>(static_cast<int>(r));
}

// ------------------------------------------------------------ host side ---
template <typename Tr, int C, bool kArg>
cudaError_t launch_c(const CUtensorMap& fm, const CUtensorMap& wm, const float* bias,
                     const float* scale_v, const int* labels, float* part_mlp, int* part_arg,
                     int B, int V, int n_split, int tiles_per_split, int nk, cudaStream_t s) {
  const int stages = ring_stages(C, nk), bytes = smem_bytes(C, nk, stages);
  cudaError_t err = cudaFuncSetAttribute(head_predict_tc_kernel<Tr, C, kArg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + 64 * C - 1) / (64 * C), n_split);
  head_predict_tc_kernel<Tr, C, kArg><<<grid, (C + 1) * kWarpgroup, bytes, s>>>(
      fm, wm, bias, scale_v, labels, part_mlp, part_arg, B, V, tiles_per_split, nk, stages);
  return cudaGetLastError();
}

// The partial kernel over feats [B, D] and W [V, D] of Tr's type; kArg as
// for head_predict_tc_kernel.
template <typename Tr, bool kArg = true>
cudaError_t launch_partial(const void* feats, const void* w, const float* bias,
                           const float* scale_v, const int* labels, float* part_mlp,
                           int* part_arg, int B, int D, int V, int n_split, int tiles_per_split,
                           cudaStream_t s) {
  const int C = consumer_groups(B, D, Tr::kBytes);
  if (C == 0) return cudaErrorInvalidValue;
  CUtensorMap fm, wm;
  if (!encode_rows(&fm, Tr::kMap, feats, B, D, Tr::kBytes, 64 * C,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_rows(&wm, Tr::kMap, w, V, D, Tr::kBytes, kBN, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return cudaErrorNotSupported;
  const int nk = chunks(D, Tr::kBytes);
  return C == 2 ? launch_c<Tr, 2, kArg>(fm, wm, bias, scale_v, labels, part_mlp, part_arg, B,
                                        V, n_split, tiles_per_split, nk, s)
                : launch_c<Tr, 1, kArg>(fm, wm, bias, scale_v, labels, part_mlp, part_arg, B,
                                        V, n_split, tiles_per_split, nk, s);
}

// K4's f32 partial kernel over f32 feats [B, D] and W [V, D]: N batch rows
// a CTA (f32_rows), W streamed in stages of 128 vocab rows × 32 columns.
template <int N>
cudaError_t launch_f32(const float* feats, const float* w, const float* bias, const int* labels,
                       float* part_mlp, int* part_arg, int B, int D, int V, int n_split,
                       int tiles_per_split, cudaStream_t s) {
  const int stages = f32_stages(N, D), bytes = f32_smem_bytes(N, D, stages);
  CUtensorMap wm;
  if (!encode_rows(&wm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, V, D, 4, kBN,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(head_predict_f32_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + N - 1) / N, n_split);
  head_predict_f32_kernel<N><<<grid, (kF32Consumers + 1) * kWarpgroup, bytes, s>>>(
      wm, feats, bias, labels, part_mlp, part_arg, B, D, V, tiles_per_split, stages);
  return cudaGetLastError();
}

}  // namespace

// K4's bf16 route: feats bf16 [B, D], w bf16 [V, D] (D % 16 == 0, 16-byte
// aligned), bias f32 [V], labels i32 [B] -> loss f32 [B], pred i32 [B].
// Scratch: part_mlp f32 [3, n_split, B], part_arg i32 [n_split, B]; the
// split geometry (tiles of mpt_head_tc_tile_vocab() rows) must cover V with
// no empty split.
extern "C" int mpt_head_predict_bf16(const void* feats, const void* w, const void* bias,
                                     const void* labels, void* loss, void* pred, void* part_mlp,
                                     void* part_arg, int B, int D, int V, int n_split,
                                     int tiles_per_split, void* stream) {
  cudaError_t err = check_geometry(B, D, V, n_split, tiles_per_split, kBN);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* mlp = static_cast<float*>(part_mlp);
  int* arg = static_cast<int*>(part_arg);
  err = launch_partial<Bf16>(feats, w, static_cast<const float*>(bias), nullptr, lab, mlp, arg, B,
                             D, V, n_split, tiles_per_split, s);
  if (err != cudaSuccess) return err;
  return launch_merge(mlp, arg, lab, static_cast<float*>(loss), static_cast<int*>(pred), nullptr,
                      nullptr, B, n_split, s);
}

// K5, the training cross-entropy forward: feats and w bf16 ([B, D],
// [V, D], D % 16 == 0, 16-byte aligned), bias f32 [V], labels i32 [B] ->
// loss, m, l f32 [B]: K4's bf16 partial kernel without its argmax, then the
// merge, which keeps each row's global max m and sum l for the backward.
// Scratch part_mlp f32 [3, n_split, B]; the split geometry as for
// mpt_head_predict_bf16.
extern "C" int mpt_head_ce_fwd(const void* feats, const void* w, const void* bias,
                               const void* labels, void* loss, void* m, void* l, void* part_mlp,
                               int B, int D, int V, int n_split, int tiles_per_split,
                               void* stream) {
  cudaError_t err = check_geometry(B, D, V, n_split, tiles_per_split, kBN);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* mlp = static_cast<float*>(part_mlp);
  err = launch_partial<Bf16, false>(feats, w, static_cast<const float*>(bias), nullptr, lab, mlp,
                                    nullptr, B, D, V, n_split, tiles_per_split, s);
  if (err != cudaSuccess) return err;
  return launch_merge(mlp, nullptr, lab, static_cast<float*>(loss), nullptr,
                      static_cast<float*>(m), static_cast<float*>(l), B, n_split, s);
}

// K4's f32 route: feats f32 [B, D], w f32 [V, D] (D % 16 == 0, 16-byte
// aligned), bias f32 [V], labels i32 [B] -> loss f32 [B], pred i32 [B].
// Scratch and split geometry as for mpt_head_predict_bf16, the row tile
// mpt_head_tc_tile_rows(B, D, 4).
extern "C" int mpt_head_predict_f32(const void* feats, const void* w, const void* bias,
                                    const void* labels, void* loss, void* pred, void* part_mlp,
                                    void* part_arg, int B, int D, int V, int n_split,
                                    int tiles_per_split, void* stream) {
  cudaError_t err = check_geometry(B, D, V, n_split, tiles_per_split, kBN);
  if (err != cudaSuccess) return err;
  const int N = f32_rows(B, D);
  if (N == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(feats);
  const auto* wf = static_cast<const float*>(w);
  const auto* b = static_cast<const float*>(bias);
  const int* lab = static_cast<const int*>(labels);
  float* mlp = static_cast<float*>(part_mlp);
  int* arg = static_cast<int*>(part_arg);
  err = N == 64 ? launch_f32<64>(f, wf, b, lab, mlp, arg, B, D, V, n_split, tiles_per_split, s)
                : launch_f32<8>(f, wf, b, lab, mlp, arg, B, D, V, n_split, tiles_per_split, s);
  if (err != cudaSuccess) return err;
  return launch_merge(mlp, arg, lab, static_cast<float*>(loss), static_cast<int*>(pred), nullptr,
                      nullptr, B, n_split, s);
}

// K7: feats (dtype 0 = f32, 1 = bf16) [B, D] are quantized into the scratch
// feats_q int8 [B, D], then the int8 partial kernel and the merge run. w
// int8 [V, D]; scale_v, bias f32 [V]; labels i32 [B]; loss f32 [B]; pred
// i32 [B]; part_mlp, part_arg and the geometry as for
// mpt_head_predict_bf16. Every pointer 16-byte aligned.
extern "C" int mpt_head_predict_int8(const void* feats, void* feats_q, const void* w,
                                     const void* scale_v, const void* bias, const void* labels,
                                     void* loss, void* pred, void* part_mlp, void* part_arg,
                                     int B, int D, int V, int n_split, int tiles_per_split,
                                     float act_scale, int dtype, void* stream) {
  cudaError_t err = check_geometry(B, D, V, n_split, tiles_per_split, kBN);
  if (err != cudaSuccess) return err;
  if (!(act_scale > 0.f)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(B) * D;
  const unsigned qblocks = static_cast<unsigned>((n + 255) / 256);
  signed char* q = static_cast<signed char*>(feats_q);
  if (dtype == 1)
    quantize_rows_kernel<<<qblocks, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(feats), q, n,
                                                 act_scale);
  else if (dtype == 0)
    quantize_rows_kernel<<<qblocks, 256, 0, s>>>(static_cast<const float*>(feats), q, n, act_scale);
  else
    return cudaErrorInvalidValue;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int* lab = static_cast<const int*>(labels);
  float* mlp = static_cast<float*>(part_mlp);
  int* arg = static_cast<int*>(part_arg);
  err = launch_partial<Int8>(q, w, static_cast<const float*>(bias),
                             static_cast<const float*>(scale_v), lab, mlp, arg, B, D, V, n_split,
                             tiles_per_split, s);
  if (err != cudaSuccess) return err;
  return launch_merge(mlp, arg, lab, static_cast<float*>(loss), static_cast<int*>(pred), nullptr,
                      nullptr, B, n_split, s);
}

// The tensor-core heads' tile geometry the wrappers plan splits with: rows
// a CTA for (B, D, element bytes) — bf16 and int8 64 or 128, f32 (4) 8 or
// 64; 0 when D is too wide for a resident feats tile — and vocab rows a
// tile.
extern "C" int mpt_head_tc_tile_rows(int B, int D, int elem_bytes) {
  return elem_bytes == 4 ? f32_rows(B, D) : 64 * consumer_groups(B, D, elem_bytes);
}
extern "C" int mpt_head_tc_tile_vocab() { return kBN; }
