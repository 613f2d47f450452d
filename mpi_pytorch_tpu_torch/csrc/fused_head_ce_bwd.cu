// K6, the training cross-entropy head's backward on Hopper's tensor cores:
// given the forward's per-row global max m and sum l, the gradients of
// loss = CE(feats·Wᵀ + b, labels) with respect to feats, W and b, for an
// upstream gradient g per row.
//
// Replaces mpi_pytorch_tpu/ops/fused_head_ce.py:109 `_bwd_kernel` (the
// backward of the fused_head_ce custom VJP). Its roundings carried over:
// logits are bf16 × bf16 products summed in f32 plus the f32 bias; dlog =
// (p − onehot)·g in f32, p = exp(logit − m)/l, with g = 0 on rows whose
// label is below 0; dlog is rounded to bf16 once and that bf16 dlog is the
// operand of both gradient products (f32 sums); db = Σ over rows of the
// f32 dlog; dfeats is summed in f32 and rounded to bf16 at the end. p is
// exp(logit − m) times 1/l, rounded once a row: within an ulp of the
// division, with no division an element. The logits are recomputed in
// another layout than the forward's (K5), so p may exceed 1 by an ulp:
// harmless.
//
// What bounds it on an H100 SXM at B = 128, D = 512, V = 64 500: the bytes
// — the bf16 W read (66 MB) and the f32 dW written (132 MB), ~59 us at
// 3.35 TB/s; its three products (25 GFLOP) take ~26 us on the bf16 tensor
// cores. So dW must stream out at the full rate while the products run on
// wgmma, and nothing else may add many bytes.
//
// Design. dW and db sum over the rows: one CTA can own a vocab tile for
// every row. dfeats sums over the vocab: [B, D] f32 is 256 KB at B = 128,
// more than a CTA's shared memory. So two passes:
//  1. `ce_bwd_dw_tc_kernel`: persistent CTAs (one wave, an even share of
//     the 128-row vocab tiles each). A producer warp brings the feats rows
//     in by TMA once a CTA (a batch chunk of NB = 64 or 128 rows, every
//     64-column atom, 128-byte swizzle: 128 KB at B = 128, D = 512). Two
//     consumer warpgroups take 64 vocab rows of each tile, each fed its W
//     rows by a producer warp of its own through a ring of 8 KB stages (64
//     vocab rows × 64 columns), so the two run apart: the second starts
//     once the first has formed its first tile's dlog, and then one's dW
//     stores overlap the other's products (in step, measured on an H100,
//     the stores of both ran while no product did). Each computes the
//     logits on wgmma with the accumulator laid out vocab × batch (M = 64
//     vocab rows, N = NB batch rows; W K-major as A, feats K-major as B). In that layout a thread's f32 dlog, converted to bf16
//     pairs, is already the register A operand of dW_tile = dlogᵀ·feats
//     (K = the batch), whose B operand is the same resident feats tile read
//     MN-major: no shared-memory round trip (FlashAttention-3's P·V). dW
//     leaves in 128-column products, each element written once with 8-byte
//     stores straight from the accumulator (a warp's store fills eight
//     32-byte sectors). db is the f32 dlog's row sum in a fixed order (a
//     thread's columns ascending, then the quad). The bf16 dlog goes to a
//     [Vp, Bs] scratch (dlogᵀ, 4-byte pairs) for pass 2. Batches of more
//     than NB rows are taken chunk by chunk inside the kernel: a later
//     chunk's dW products accumulate onto the earlier chunks' dW, loaded
//     into the accumulator, and its db is added to theirs, each by the
//     thread that wrote them.
//  2. `ce_bwd_dfeats_tc_kernel`: dfeats = dlog·W as a split-K product on
//     wgmma (M = 64 batch rows a consumer warpgroup, N = 128 columns of D,
//     K = the vocab): dlogᵀ and W tiles of 128 vocab rows come by TMA
//     through a ring, both read MN-major; each vocab split writes an f32
//     partial, and `ce_bwd_dfeats_reduce_kernel` sums the splits in order
//     and rounds to bf16.
// The vocab edge: V's last tile reads zero W rows past V (TMA fills them),
// and their dlog is set to 0, so they add nothing; they write no dW and no
// db. Padding rows (label < 0) and batch rows past B get g = 0 and m = +inf:
// their dlog is 0, so their dfeats is 0.
// Determinism: fixed-order sums (k-steps ascending, a thread's columns
// ascending, fixed shuffle trees, batch chunks ascending, splits in order),
// no atomics: two calls on the same inputs give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"  // wgmma_ss_n64, wgmma_rs_n64, wgmma_ss_n64_mn, bf16x2_bits
#include "hopper.cuh"

namespace {

using namespace mpt_hopper;

constexpr int kTileV = 128;                  // vocab rows a tile (both passes)
constexpr int kAtom = 128;                   // bytes a swizzled row: 64 bf16
constexpr int kHalf = 64;                    // pass 1: vocab rows of a tile a warpgroup takes
constexpr int kStageBytes = kHalf * kAtom;   // pass 1: a warpgroup's W stage, 8 KB
constexpr int kSmemLimit = 232448;           // 227 KB: the most a block may take
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
constexpr int kConsumers = 2;                // consumer warpgroups a CTA
constexpr int kConsumerThreads = kConsumers * kWarpgroup;
constexpr int kProducerRegs = 40;            // 128 · (2 · 232 + 40) ≤ 65 536
constexpr int kConsumerRegs = 232;
constexpr int kTileD = 128;                  // D columns a dW product / a pass-2 tile
constexpr int kTileB = kConsumers * 64;      // batch rows a pass-2 tile
constexpr int kAtom2Bytes = kTileV * kAtom;     // pass 2: an atom of 128 vocab rows
constexpr int kStage2Bytes = 4 * kAtom2Bytes;   // pass 2: two dlogᵀ atoms, two W atoms
constexpr int kStages2 = 3;

// ---------------------------------------------------------- geometry ---
// Pass 1's shared memory: alignment slack, the feats chunk (whole 128-column
// pairs of atoms of NB rows), a ring a consumer warpgroup, their barriers
// and the feats pair, the chunk's per-row constants (m, 1/l, g, label).
__host__ __device__ constexpr int feats_atoms(int nk) { return (nk + 1) & ~1; }
constexpr int pass1_fixed(int NB, int nk) {
  return 1024 + feats_atoms(nk) * NB * kAtom + 8 * (2 * kConsumers * kMaxStages + 2) + 16 * NB;
}
// Stages of each warpgroup's ring.
constexpr int pass1_stages(int NB, int nk) {
  const int left = (kSmemLimit - pass1_fixed(NB, nk)) / (kConsumers * kStageBytes);
  return left < kMinStages ? 0 : (left > kMaxStages ? kMaxStages : left);
}
constexpr int pass1_smem(int NB, int nk, int stages) {
  return pass1_fixed(NB, nk) + kConsumers * stages * kStageBytes;
}
constexpr int pass2_smem() { return 1024 + kStages2 * kStage2Bytes + 8 * 2 * kStages2; }

// Batch rows a chunk of pass 1 for (B, D): 128 above 64 rows where its feats
// tile leaves room for the rings, else 64; 0 when not even 64 rows fit.
int chunk_rows(int B, int D) {
  const int nk = (D + 63) / 64;
  if (B > 64 && pass1_stages(128, nk) > 0) return 128;
  return pass1_stages(64, nk) > 0 ? 64 : 0;
}

// ------------------------------------------------------------- pass 1 ---
// d[64 × NB] (+)= A[64 × 16]·B[16 × NB]: A (W) and B (feats) K-major in
// shared memory.
template <int NB>
__device__ __forceinline__ void logits_mma(float* d, uint64_t a, uint64_t b, int accumulate);
template <>
__device__ __forceinline__ void logits_mma<128>(float* d, uint64_t a, uint64_t b, int accumulate) {
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
template <>
__device__ __forceinline__ void logits_mma<64>(float* d, uint64_t a, uint64_t b, int accumulate) {
  mpt_tc::wgmma_ss_n64(d, a, b, accumulate);
}

// One arrival of this warp on `bar` (a ring stage read, the feats chunk
// done with): the barriers count consumer warps.
__device__ __forceinline__ void arrive_warp(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

template <int NB>
__global__ void __launch_bounds__((kConsumers + 1) * kWarpgroup, 1)
ce_bwd_dw_tc_kernel(const __grid_constant__ CUtensorMap feats_map,  // [B, D] bf16, boxes 64 × NB
                    const __grid_constant__ CUtensorMap w_map,      // [V, D] bf16, boxes 64 × 64
                    const float* __restrict__ bias,                 // [V]
                    const int* __restrict__ labels,                 // [B]
                    const float* __restrict__ m,                    // [B] global max
                    const float* __restrict__ l,                    // [B] Σ exp(logit − m)
                    const float* __restrict__ g,                    // [B] upstream gradient
                    __nv_bfloat16* __restrict__ dlog,               // [Vp, Bs] scratch: dlogᵀ
                    float* __restrict__ dw,                         // [V, D]
                    float* __restrict__ db,                         // [V]
                    int B, int D, int V, int Bs, int n_tiles, int nk, int stages) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = smem_addr(smem), base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem + (base - raw);
  const uint32_t feats_s = base;
  const uint32_t rings = feats_s + feats_atoms(nk) * NB * kAtom;  // kConsumers rings
  const uint32_t fulls = rings + kConsumers * stages * kStageBytes;
  const uint32_t empties = fulls + 8 * kConsumers * stages;
  const uint32_t feats_full = empties + 8 * kConsumers * stages, feats_empty = feats_full + 8;
  float* const c_m = reinterpret_cast<float*>(sm + (feats_empty + 8 - base));
  float* const c_il = c_m + NB;
  float* const c_g = c_il + NB;
  int* const c_lab = reinterpret_cast<int*>(c_g + NB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_chunks = (B + NB - 1) / NB;

  if (tid == 0) {
    for (int s = 0; s < kConsumers * stages; ++s) {
      mbar_init(fulls + 8 * s, 1);
      mbar_init(empties + 8 * s, 4);  // one arrival a warp of the ring's warpgroup
    }
    mbar_init(feats_full, 1);
    mbar_init(feats_empty, 4 * kConsumers);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // The producer warpgroup: lane 0 of its warp w feeds consumer
    // warpgroup w's ring (the W rows 64w.. of each tile); the first also
    // brings the feats chunks.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    const int pw = warp - 4 * kConsumers;
    if (pw < kConsumers && lane == 0) {
      const uint32_t ring = rings + pw * stages * kStageBytes;
      const uint32_t full = fulls + 8 * pw * stages, empty = empties + 8 * pw * stages;
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0; c < n_chunks; ++c) {
        if (pw == 0) {
          if (c > 0) mbar_wait(feats_empty, (c - 1) & 1);  // every product of chunk c − 1 read
          mbar_expect_tx(feats_full, nk * NB * kAtom);
          for (int kc = 0; kc < nk; ++kc)
            tma_load_2d(feats_s + kc * NB * kAtom, &feats_map, kc * 64, c * NB, feats_full);
        }
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
          for (int kc = 0; kc < nk; ++kc) {
            mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes at once
            mbar_expect_tx(full + 8 * stage, kStageBytes);
            tma_load_2d(ring + stage * kStageBytes, &w_map, kc * 64, tile * kTileV + pw * kHalf,
                        full + 8 * stage);
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = warp >> 2, g8 = lane >> 2, t = lane & 3;
  const int n_dw = (nk + 1) >> 1;  // 128-column dW products a tile
  const uint32_t ring = rings + wg * stages * kStageBytes;
  const uint32_t full = fulls + 8 * wg * stages, empty = empties + 8 * wg * stages;
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < n_chunks; ++c) {
    // The chunk's per-row constants; rows past B (and padding rows) get
    // g = 0 and m = +inf, so their dlog is exactly 0.
    named_barrier_sync(1, kConsumerThreads);  // chunk c − 1's constants are read
    for (int i = tid; i < NB; i += kConsumerThreads) {
      const int b = c * NB + i;
      const int lab = b < B ? labels[b] : -1;
      c_m[i] = b < B ? m[b] : INFINITY;
      c_il[i] = b < B ? 1.f / l[b] : 1.f;
      c_g[i] = lab >= 0 ? g[b] : 0.f;
      c_lab[i] = lab;
    }
    named_barrier_sync(1, kConsumerThreads);
    // The second warpgroup starts once the first has formed its first
    // tile's dlog: from then on their products and stores interleave.
    if (c == 0 && wg == 1) named_barrier_sync(2, kConsumerThreads);
    mbar_wait(feats_full, c & 1);

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      // The logits [64 vocab rows × NB batch rows] of this warpgroup, K
      // chunk by K chunk through the ring (one group in flight while the
      // next stage is awaited).
      float acc[NB / 2];
      int prev = 0;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(full + 8 * stage, phase);
        wgmma_fence();
        const uint32_t sa = ring + stage * kStageBytes;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          logits_mma<NB>(acc, kmajor_desc<kHalf>(sa, ks), kmajor_desc<NB>(feats_s, 4 * kc + ks),
                         (kc | ks) != 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (kc > 0) arrive_warp(empty + 8 * prev);
        prev = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      arrive_warp(empty + 8 * prev);
      fence_regs<NB / 2>(acc);

      // dlog in place of the logits: thread (warp, g8, t) holds vocab rows
      // r0 and r0 + 8, batch rows 8j + 2t + e of the chunk. Its bf16 pairs
      // are the A fragments of dW's k-steps (k-step kk: batch rows 16kk..),
      // and go to the dlogᵀ scratch; db sums the f32 values.
      const int r0 = tile * kTileV + 64 * wg + 16 * (warp & 3) + g8;
      const bool ok[2] = {r0 < V, r0 + 8 < V};
      const float bb[2] = {ok[0] ? __ldg(bias + r0) : 0.f, ok[1] ? __ldg(bias + r0 + 8) : 0.f};
      float dsum[2] = {0.f, 0.f};
      uint32_t a[NB / 16][4];
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 cm = *reinterpret_cast<const float2*>(c_m + col);
        const float2 cl = *reinterpret_cast<const float2*>(c_il + col);
        const float2 cg = *reinterpret_cast<const float2*>(c_g + col);
        const int2 cb = *reinterpret_cast<const int2*>(c_lab + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 8 * i;
          const float x0 = acc[4 * j + 2 * i] + bb[i], x1 = acc[4 * j + 2 * i + 1] + bb[i];
          const float p0 = __fmul_rn(expf(x0 - cm.x), cl.x), p1 = __fmul_rn(expf(x1 - cm.y), cl.y);
          const float d0 = ok[i] ? __fmul_rn(p0 - (cb.x == r ? 1.f : 0.f), cg.x) : 0.f;
          const float d1 = ok[i] ? __fmul_rn(p1 - (cb.y == r ? 1.f : 0.f), cg.y) : 0.f;
          dsum[i] += d0;
          dsum[i] += d1;
          const uint32_t pair = mpt_tc::bf16x2_bits(__floats2bfloat162_rn(d0, d1));
          a[j >> 1][2 * (j & 1) + i] = pair;
          if (c * NB + col < Bs)
            *reinterpret_cast<uint32_t*>(dlog + static_cast<size_t>(r) * Bs + c * NB + col) = pair;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 1);
        dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 2);
        if (t == 0 && ok[i]) db[r0 + 8 * i] = (c == 0 ? 0.f : db[r0 + 8 * i]) + dsum[i];
      }
      if (c == 0 && wg == 0 && tile == static_cast<int>(blockIdx.x))
        named_barrier_arrive(2, kConsumerThreads);  // the second warpgroup may start

      // dW[tile rows, :] (+)= dlogᵀ·feats, 128 columns a product: A the
      // bf16 dlog pairs in registers, B the feats chunk read MN-major (K =
      // its rows), two atoms of 64 columns; onto 0, or the earlier chunks'
      // dW of the same elements.
      for (int dc = 0; dc < n_dw; ++dc) {
        float accw[64];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int col = kTileD * dc + 64 * h + 8 * j + 2 * t;
              float2 o = make_float2(0.f, 0.f);
              if (c > 0 && ok[i] && col < D)
                o = *reinterpret_cast<const float2*>(dw + static_cast<size_t>(r0 + 8 * i) * D + col);
              accw[32 * h + 4 * j + 2 * i] = o.x;
              accw[32 * h + 4 * j + 2 * i + 1] = o.y;
            }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NB / 16; ++kk) {
          mpt_tc::wgmma_rs_n64(accw, a[kk], mnmajor_desc<NB>(feats_s, kk, 2 * dc));
          mpt_tc::wgmma_rs_n64(accw + 32, a[kk], mnmajor_desc<NB>(feats_s, kk, 2 * dc + 1));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<64>(accw);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = kTileD * dc + 64 * h + 8 * j + 2 * t;
            if (col >= D) continue;
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (ok[i])
                *reinterpret_cast<float2*>(dw + static_cast<size_t>(r0 + 8 * i) * D + col) =
                    make_float2(accw[32 * h + 4 * j + 2 * i], accw[32 * h + 4 * j + 2 * i + 1]);
          }
      }
    }
    arrive_warp(feats_empty);  // every product of this warp that read the chunk is done
  }
}

// ------------------------------------------------------------- pass 2 ---
// One vocab split's f32 partial of dfeats = dlog·W for a tile of 128 batch
// rows (64 a consumer warpgroup) × 128 columns of D. A stage holds 128
// vocab rows: the dlogᵀ atoms of the tile's two 64-row halves (M-major A)
// and W's two 64-column atoms (N-major B).
__global__ void __launch_bounds__((kConsumers + 1) * kWarpgroup, 1)
ce_bwd_dfeats_tc_kernel(const __grid_constant__ CUtensorMap dlog_map,  // [Vp, Bs] bf16, boxes 64 × 128
                        const __grid_constant__ CUtensorMap w_map,     // [V, D] bf16, boxes 64 × 128
                        float* __restrict__ part,                      // [n_split, Bp, Dp]
                        int Bp, int Dp, int n_tiles, int tiles_per_split) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t ring = base, full = ring + kStages2 * kStage2Bytes, empty = full + 8 * kStages2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * kTileB, d0 = blockIdx.y * kTileD, split = blockIdx.z;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  if (tid == 0) {
    for (int s = 0; s < kStages2; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (warp == 4 * kConsumers && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = t_begin; tile < t_end; ++tile) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t st = ring + stage * kStage2Bytes, bar = full + 8 * stage;
        mbar_expect_tx(bar, kStage2Bytes);
        tma_load_2d(st, &dlog_map, b0, tile * kTileV, bar);
        tma_load_2d(st + kAtom2Bytes, &dlog_map, b0 + 64, tile * kTileV, bar);
        tma_load_2d(st + 2 * kAtom2Bytes, &w_map, d0, tile * kTileV, bar);
        tma_load_2d(st + 3 * kAtom2Bytes, &w_map, d0 + 64, tile * kTileV, bar);
        if (++stage == kStages2) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = warp >> 2, g8 = lane >> 2, t = lane & 3;
  float acc[64];
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    mbar_wait(full + 8 * stage, phase);
    wgmma_fence();
    const uint32_t st = ring + stage * kStage2Bytes;
#pragma unroll
    for (int kk = 0; kk < kTileV / 16; ++kk) {
      const uint64_t da = mnmajor_desc<kTileV>(st + wg * kAtom2Bytes, kk, 0);
      const int accumulate = tile > t_begin || kk > 0;
      mpt_tc::wgmma_ss_n64_mn(acc, da, mnmajor_desc<kTileV>(st + 2 * kAtom2Bytes, kk, 0), accumulate);
      mpt_tc::wgmma_ss_n64_mn(acc + 32, da, mnmajor_desc<kTileV>(st + 2 * kAtom2Bytes, kk, 1),
                              accumulate);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (tile > t_begin) arrive_warp(empty + 8 * prev);
    prev = stage;
    if (++stage == kStages2) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs<64>(acc);
  float* const out = part + (static_cast<size_t>(split) * Bp + b0 + 64 * wg + 16 * (warp & 3) + g8) * Dp + d0;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(8 * i) * Dp + 64 * h + 8 * j + 2 * t) =
            make_float2(acc[32 * h + 4 * j + 2 * i], acc[32 * h + 4 * j + 2 * i + 1]);
}

// dfeats = bf16(Σ of the splits' partials, in split order).
__global__ void ce_bwd_dfeats_reduce_kernel(const float* __restrict__ part,
                                            __nv_bfloat16* __restrict__ dfeats, int B, int D,
                                            int Bp, int Dp, int n_split) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(B) * D) return;
  const int b = static_cast<int>(i / D), d = static_cast<int>(i % D);
  const size_t plane = static_cast<size_t>(Bp) * Dp;
  const float* p = part + static_cast<size_t>(b) * Dp + d;
  float sum = 0.f;
  for (int s = 0; s < n_split; ++s) sum += p[s * plane];
  dfeats[i] = __float2bfloat16_rn(sum);
}

template <int NB>
cudaError_t launch_pass1(const CUtensorMap& fm, const CUtensorMap& wm, const float* bias,
                         const int* labels, const float* m, const float* l, const float* g,
                         __nv_bfloat16* dlog, float* dw, float* db, int B, int D, int V, int Bs,
                         int n_tiles, int n_ctas, cudaStream_t s) {
  const int nk = (D + 63) / 64, stages = pass1_stages(NB, nk), bytes = pass1_smem(NB, nk, stages);
  cudaError_t err = cudaFuncSetAttribute(ce_bwd_dw_tc_kernel<NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ce_bwd_dw_tc_kernel<NB><<<n_ctas, (kConsumers + 1) * kWarpgroup, bytes, s>>>(
      fm, wm, bias, labels, m, l, g, dlog, dw, db, B, D, V, Bs, n_tiles, nk, stages);
  return cudaGetLastError();
}

}  // namespace

// feats bf16 [B, D]; w bf16 [V, D]; bias f32 [V]; labels i32 [B]; m, l, g
// f32 [B] -> dw f32 [V, D], db f32 [V], dfeats bf16 [B, D]. Scratch: dlog
// bf16 [Vp, Bs] (dlogᵀ: Vp = V rounded up to mpt_head_ce_bwd_tile_vocab(),
// Bs = B rounded up to 8) and part f32 [n_split, Bp, Dp] (Bp, Dp: B and D
// rounded up to mpt_head_ce_bwd_tile_rows() and _tile_cols()). Pass 1 runs
// n_ctas CTAs (at most Vp / 128); pass 2's vocab splits of tiles_per_split
// tiles of 128 rows cover Vp, none empty. D % 16 == 0 and
// mpt_head_ce_bwd_rows(B, D) > 0; every pointer 16-byte aligned.
extern "C" int mpt_head_ce_bwd(const void* feats, const void* w, const void* bias,
                               const void* labels, const void* m, const void* l, const void* g,
                               void* dlog, void* dw, void* db, void* part, void* dfeats, int B,
                               int D, int V, int n_ctas, int n_split, int tiles_per_split,
                               void* stream) {
  if (B < 1 || V < 1 || D < 16 || D % 16 != 0 || n_ctas < 1 || n_split < 1 || tiles_per_split < 1)
    return cudaErrorInvalidValue;
  // This entry runs on autograd's device thread and reports its launches
  // with cudaGetLastError: take off a non-sticky error an earlier call on
  // that thread left, so that it is not reported as this launch's (a sticky
  // one stays and fails the launches below).
  (void)cudaGetLastError();
  const int NB = chunk_rows(B, D);
  if (NB == 0) return cudaErrorInvalidValue;
  const int n_tiles = (V + kTileV - 1) / kTileV, Vp = n_tiles * kTileV;
  const int Bs = (B + 7) / 8 * 8, Bp = (B + kTileB - 1) / kTileB * kTileB;
  const int Dp = (D + kTileD - 1) / kTileD * kTileD;
  if (n_ctas > n_tiles) return cudaErrorInvalidValue;
  if (static_cast<long long>(n_split - 1) * tiles_per_split >= n_tiles ||
      static_cast<long long>(n_split) * tiles_per_split < n_tiles)
    return cudaErrorInvalidValue;
  if (n_split > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* dl = static_cast<__nv_bfloat16*>(dlog);
  CUtensorMap fm, wm1, wm, dm;
  if (!encode_rows(&fm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, feats, B, D, 2, NB,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_rows(&wm1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, V, D, 2, kHalf,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !encode_rows(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, V, D, 2, kTileV,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !encode_rows(&dm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dl, Vp, Bs, 2, kTileV,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
    return cudaErrorNotSupported;
  const auto* fb = static_cast<const float*>(bias);
  const auto* lab = static_cast<const int*>(labels);
  const auto *mf = static_cast<const float*>(m), *lf = static_cast<const float*>(l),
             *gf = static_cast<const float*>(g);
  auto* dwf = static_cast<float*>(dw);
  auto* dbf = static_cast<float*>(db);
  cudaError_t err = NB == 128
      ? launch_pass1<128>(fm, wm1, fb, lab, mf, lf, gf, dl, dwf, dbf, B, D, V, Bs, n_tiles, n_ctas, s)
      : launch_pass1<64>(fm, wm1, fb, lab, mf, lf, gf, dl, dwf, dbf, B, D, V, Bs, n_tiles, n_ctas, s);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ce_bwd_dfeats_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pass2_smem());
  if (err != cudaSuccess) return err;
  ce_bwd_dfeats_tc_kernel<<<dim3(Bp / kTileB, Dp / kTileD, n_split),
                            (kConsumers + 1) * kWarpgroup, pass2_smem(), s>>>(
      dm, wm, static_cast<float*>(part), Bp, Dp, n_tiles, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * D;
  ce_bwd_dfeats_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dfeats), B, D, Bp, Dp, n_split);
  return cudaGetLastError();
}

// The backward's geometry, which the wrapper sizes its scratch and plans
// its splits with: the vocab tile (Vp, pass 2's split unit), pass 2's batch
// rows (Bp) and D columns (Dp) a tile, and pass 1's batch rows a chunk for
// (B, D) (0 when D is too wide for a resident feats chunk).
extern "C" int mpt_head_ce_bwd_tile_vocab() { return kTileV; }
extern "C" int mpt_head_ce_bwd_tile_rows() { return kTileB; }
extern "C" int mpt_head_ce_bwd_tile_cols() { return kTileD; }
extern "C" int mpt_head_ce_bwd_rows(int B, int D) { return chunk_rows(B, D); }
