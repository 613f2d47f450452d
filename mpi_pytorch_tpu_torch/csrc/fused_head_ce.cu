// The classifier head's WMMA kernel: K5, the training cross-entropy
// forward. (The predict heads, K4 in bf16 and f32 and the int8 head K7, run
// on wgmma in head_predict_tc.cu.)
//
// K5 replaces mpi_pytorch_tpu/ops/fused_head_ce.py::_fwd_kernel, the
// forward of the fused_head_ce training op: per row of feats, the softmax
// cross-entropy of logits = feats @ W^T + b without ever storing the [B, V]
// logits: the bf16 partial kernel below (bf16 WMMA, mma.sync, f32
// accumulation; its argmax is computed and dropped) and a merge that writes
// the loss and the global (m, l) the backward recomputes its softmax from.
// Semantics carried over exactly: loss = log(sum exp(logit - m)) + m -
// logit[label], and loss = 0 where label < 0 (batch padding rows). Bound at
// batch 128: the 66 MB of bf16 W, ~20 us.
//
// Design. A GPU grid has no sequential accumulator like the TPU grid's
// vocab sweep, so the reduction runs in two passes (head_common.cuh):
//  1. Grid (row tile of BM rows) x (vocab split). Each CTA walks its split in
//     tiles of BN vocab rows: the tile product over K in chunks staged
//     through shared memory, then an epilogue that folds the [BM, BN] tile
//     into a per-row online state (max, first argmax, sum of exp relative to
//     the max, picked label logit). The state of each split goes to a
//     [n_split, B] scratch.
//  2. One warp per row merges the splits (head_merge_kernel, head_common.cuh).
// The row-tile index is the fastest grid dimension, so the CTAs that share
// one vocab split run together and read that slice of W from L2 after the
// first one brings it in from DRAM. Enough splits are chosen (by the
// wrapper) that even batch 1 puts ~2 CTAs on each of the 132 SMs. The
// ragged vocab edge is masked in-kernel: W is never padded or copied.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include "head_common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // rows of feats per CTA
constexpr int BN = 128;       // vocab rows of W per tile
constexpr int BK = 64;        // K chunk staged in shared memory
constexpr int kThreads = 256;  // 8 warps: 2 (M) x 4 (N), 32 x 32 per warp
constexpr int LDS = BK + 8;   // bf16 pitch: a multiple of 8 for WMMA, staggers banks
constexpr int LDC = BN + 4;   // f32 pitch of the epilogue tile
constexpr int kStageBytes = (BM + BN) * LDS * 2;
constexpr int kTileBytes = BM * LDC * 4;
constexpr int kSmemBytes = kStageBytes > kTileBytes ? kStageBytes : kTileBytes;

// Fold one [BM, BN] f32 tile of logits (Cs, before the bias) for vocab rows
// n0.. into the per-row online state (max, first argmax, sum of exp
// relative to the max, picked label logit).
__device__ __forceinline__ void fold_tile(const float* Cs, const float* __restrict__ bias,
                                          const int* __restrict__ labels, float* s_m,
                                          float* s_l, float* s_pick, int* s_arg, int row0,
                                          int n0, int v_end, int B, int warp, int lane) {
  // Warp `warp` owns rows warp*8 .. warp*8+7 of the tile; lane `lane` takes
  // columns lane, lane+32, lane+64, lane+96.
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr;
    const int grow = row0 + r;
    if (grow >= B) break;  // warp-uniform
    float vals[BN / 32];
    float best = -INFINITY;
    int bcol = -1;  // -1: this lane holds no valid column
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int gc = n0 + lane + 32 * j;
      vals[j] = -INFINITY;
      if (gc < v_end) {
        vals[j] = Cs[r * LDC + lane + 32 * j] + bias[gc];
        if (bcol < 0 || vals[j] > best) {  // strict: first column keeps a tie
          best = vals[j];
          bcol = gc;
        }
      }
    }
    // Warp argmax: larger value wins, a tie goes to the smaller column.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bcol, off);
      if (oc >= 0 && (bcol < 0 || ob > best || (ob == best && oc < bcol))) {
        best = ob;
        bcol = oc;
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j)
      if (n0 + lane + 32 * j < v_end) sum += expf(vals[j] - best);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const int lab = labels[grow];
      if (lab >= n0 && lab < n0 + BN && lab < v_end)
        s_pick[r] += Cs[r * LDC + (lab - n0)] + bias[lab];
      const float m = s_m[r];
      if (best > m) s_arg[r] = bcol;  // strict: an earlier tile keeps a tie
      const float mn = fmaxf(m, best);
      s_l[r] = (m == -INFINITY ? 0.f : s_l[r] * expf(m - mn)) + sum * expf(best - mn);
      s_m[r] = mn;
    }
  }
}

// Write one split's per-row state to the [n_split, B] scratch.
__device__ __forceinline__ void store_partials(const float* s_m, const float* s_l,
                                               const float* s_pick, const int* s_arg,
                                               float* __restrict__ part_mlp,
                                               int* __restrict__ part_arg, int row0,
                                               int split, int n_split, int B, int tid) {
  for (int r = tid; r < BM; r += kThreads) {
    const int grow = row0 + r;
    if (grow >= B) continue;
    const size_t o = static_cast<size_t>(split) * B + grow;
    const size_t plane = static_cast<size_t>(n_split) * B;
    part_mlp[o] = s_m[r];
    part_mlp[plane + o] = s_l[r];
    part_mlp[2 * plane + o] = s_pick[r];
    part_arg[o] = s_arg[r];
  }
}

__global__ void __launch_bounds__(kThreads)
head_partial_kernel(const __nv_bfloat16* __restrict__ feats,  // [B, D]
                    const __nv_bfloat16* __restrict__ w,      // [V, D]
                    const float* __restrict__ bias,           // [V]
                    const int* __restrict__ labels,           // [B]
                    float* __restrict__ part_mlp,  // [3, n_split, B]: m, l, picked
                    int* __restrict__ part_arg,    // [n_split, B]
                    int B, int D, int V, int tiles_per_split) {
  // The K-loop staging buffers and the f32 epilogue tile share one buffer:
  // every warp is past the K loop's trailing barrier before the tile is
  // written.
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ float s_m[BM], s_l[BM], s_pick[BM];
  __shared__ int s_arg[BM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int v_begin = split * tiles_per_split * BN;
  const int v_end = min(V, v_begin + tiles_per_split * BN);

  if (tid < BM) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
    s_pick[tid] = 0.f;
    s_arg[tid] = 0;
  }

  for (int n0 = v_begin; n0 < v_end; n0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < D; k0 += BK) {
      // Stage A = feats[row0:row0+BM, k0:k0+BK] and B = w[n0:n0+BN, k0:k0+BK]
      // in 16-byte vectors; rows past B / v_end and columns past D are zero.
      for (int i = tid; i < BM * (BK / 8); i += kThreads) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row0 + r < B && k0 + c < D)
          v = *reinterpret_cast<const uint4*>(feats + static_cast<size_t>(row0 + r) * D + k0 + c);
        *reinterpret_cast<uint4*>(As + r * LDS + c) = v;
      }
      for (int i = tid; i < BN * (BK / 8); i += kThreads) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n0 + r < v_end && k0 + c < D)
          v = *reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * D + k0 + c);
        *reinterpret_cast<uint4*>(Bs + r * LDS + c) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        // W tile is [BN][BK] row-major = the [BK x BN] operand in column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (warp_m * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + (warp_n * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (warp_m * 32 + i * 16) * LDC + warp_n * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();

    fold_tile(Cs, bias, labels, s_m, s_l, s_pick, s_arg, row0, n0, v_end, B, warp, lane);
    __syncthreads();  // the next tile's staging overwrites Cs
  }

  store_partials(s_m, s_l, s_pick, s_arg, part_mlp, part_arg, row0, split, n_split, B, tid);
}

}  // namespace

// The training cross-entropy forward: feats and w bf16 ([B, D], [V, D]),
// bias f32 [V], labels i32 [B] -> loss, m, l f32 [B]. Scratch: part_mlp
// f32 [3, n_split, B], part_arg i32 [n_split, B]; the split geometry (tiles
// of mpt_head_tile_vocab() rows) must cover V with no empty split.
extern "C" int mpt_head_ce_fwd(const void* feats, const void* w, const void* bias,
                               const void* labels, void* loss, void* m, void* l,
                               void* part_mlp, void* part_arg, int B, int D, int V,
                               int n_split, int tiles_per_split, void* stream) {
  const cudaError_t bad = check_geometry(B, D, V, n_split, tiles_per_split, BN);
  if (bad != cudaSuccess) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + BM - 1) / BM, n_split);
  head_partial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(feats), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<float*>(part_mlp), static_cast<int*>(part_arg), B, D, V, tiles_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(static_cast<const float*>(part_mlp), static_cast<const int*>(part_arg),
                      static_cast<const int*>(labels), static_cast<float*>(loss), nullptr,
                      static_cast<float*>(m), static_cast<float*>(l), B, n_split, s);
}

// The tile geometry K5's wrapper plans splits with: rows per CTA, vocab
// rows per tile.
extern "C" int mpt_head_tile_rows() { return BM; }
extern "C" int mpt_head_tile_vocab() { return BN; }
