// Training cross-entropy head, backward: given the forward's per-row global
// max m and sum l, the gradients of loss = CE(feats @ W^T + b, labels) with
// respect to feats, W and b, for an upstream gradient g per row.
//
// Replaces: mpi_pytorch_tpu/ops/fused_head_ce.py::_bwd_kernel (the backward
// of the fused_head_ce custom VJP). Its roundings carried over exactly:
// logits are bf16 x bf16 products summed in f32 plus the f32 bias; dlog =
// (exp(logit - m) / l - onehot) * g in f32, with g = 0 on rows whose label
// is below 0; dlog is rounded to bf16 once and that bf16 dlog is the operand
// of both gradient products (f32 accumulation); db = sum over rows of the
// f32 dlog; dfeats is summed in f32 and rounded to bf16 at the end.
//
// What bounds it on an H100 at batch 128, D 512, V 64500: the bytes -- the
// bf16 W read (66 MB) and the f32 dW written (132 MB), ~59 us at 3.35 TB/s;
// its three products (25 GFLOP on the bf16 tensor cores) take ~26 us.
//
// Design. The TPU kernel sweeps the vocab on a sequential grid and keeps
// dfeats [B, D] resident as an accumulator. On the card each vocab tile is
// its own CTA, and the two sums run over different axes: dW and db sum over
// the rows (one CTA can own a vocab tile for all rows), dfeats over the
// vocab (a CTA would have to hold [B, D] f32, 256 KB at batch 128, more than
// a CTA's 227 KB of shared memory). So:
//  1. One CTA per 64 vocab rows: for each 64-row chunk of the batch it
//     recomputes the [64, 64] logits (bf16 WMMA, f32 accumulate), forms the
//     f32 dlog, adds it into the tile's db in row order, and writes the bf16
//     dlog -- the very operand both products take -- to a [B, Vp] scratch.
//     Then dW_tile [64, D] = dlog^T . feats, in 128-column chunks with the
//     batch as the K loop, each dW element written once.
//  2. dfeats = dlog . W as a split-K product: grid (64-row tile) x (128
//     columns of D) x (vocab split), each CTA writing its f32 partial to
//     [n_split, Bp, Dp]; then one thread per element sums the splits in
//     order and rounds to bf16.
// The bf16 dlog scratch is 16.5 MB at batch 128 (an eighth of dW), and it
// spares a second recomputation of the logits. Every sum runs in a fixed
// order and nothing is atomic: two calls give the same bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int BV = 64;         // vocab rows per CTA of pass 1; vocab per K step of pass 2
constexpr int BR = 64;         // batch rows per chunk / per pass-2 tile
constexpr int BK = 64;         // D chunk of the logits product
constexpr int DC = 128;        // D columns per dW / dfeats output chunk
constexpr int KR = 32;         // batch rows per K step of the dW product
constexpr int LDS = BK + 8;    // bf16 pitch of the logits product's staged tiles
constexpr int LDL = BV + 4;    // f32 pitch of the [BR, BV] logits / dlog tile
constexpr int LDA = BV + 8;    // bf16 pitch of a staged dlog tile
constexpr int LDB = DC + 8;    // bf16 pitch of a staged feats / W tile
constexpr int LDO = DC + 4;    // f32 pitch of the [BV, DC] dW tile

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kSmem1 = cmax(cmax((BR + BV) * LDS * 2, BR * LDL * 4),
                            cmax(KR * (LDA + LDB) * 2, BV * LDO * 4));
constexpr int kSmem2 = BR * LDA * 2 + BV * LDB * 2;

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kThreads)
ce_bwd_dw_kernel(const __nv_bfloat16* __restrict__ feats,  // [B, D]
                 const __nv_bfloat16* __restrict__ w,      // [V, D]
                 const float* __restrict__ bias,           // [V]
                 const int* __restrict__ labels,           // [B]
                 const float* __restrict__ m,              // [B] global max
                 const float* __restrict__ l,              // [B] sum exp(logit - m)
                 const float* __restrict__ g,              // [B] upstream gradient
                 __nv_bfloat16* __restrict__ dlog,         // [B, Vp] scratch
                 float* __restrict__ dw,                   // [V, D]
                 float* __restrict__ db,                   // [V]
                 int B, int D, int V, int Vp) {
  // Each phase's staging buffers and its f32 tile share one buffer; the
  // barriers between phases keep them apart.
  __shared__ __align__(128) unsigned char smem[kSmem1];
  const int tid = threadIdx.x, warp = tid / 32;
  const int n0 = blockIdx.x * BV;

  // Phase 1: dlog and db, 64 batch rows at a time. Warps 4 (rows) x 2
  // (vocab), 16 x 32 each.
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [BR][LDS] feats
  __nv_bfloat16* Bs = As + BR * LDS;                           // [BV][LDS] W
  float* Ls = reinterpret_cast<float*>(smem);                  // [BR][LDL]
  const int wm = warp / 2, wn = warp % 2;
  float db_acc = 0.f;  // thread tid < BV: column n0 + tid, summed in row order
  for (int r0 = 0; r0 < B; r0 += BR) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int i = tid; i < BR * (BK / 8); i += kThreads) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(As + r * LDS + c) =
            load16(feats + static_cast<size_t>(r0 + r) * D + k0 + c, r0 + r < B && k0 + c < D);
      }
      for (int i = tid; i < BV * (BK / 8); i += kThreads) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * LDS + c) =
            load16(w + static_cast<size_t>(n0 + r) * D + k0 + c, n0 + r < V && k0 + c < D);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
        wmma::load_matrix_sync(fa, As + (wm * 16) * LDS + kk, LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * LDS + kk, LDS);
          wmma::mma_sync(acc[j], fa, fb[j], acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Ls + (wm * 16) * LDL + wn * 32 + j * 16, acc[j], LDL,
                              wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < BR * BV; e += kThreads) {
      const int r = e / BV, c = e % BV;
      const int row = r0 + r, col = n0 + c;
      float d = 0.f;
      if (row < B && col < V) {
        const int lab = labels[row];
        if (lab >= 0) {
          const float logit = Ls[r * LDL + c] + bias[col];
          const float p = __fdiv_rn(expf(logit - m[row]), l[row]);
          d = __fmul_rn(p - (lab == col ? 1.f : 0.f), g[row]);
        }
      }
      Ls[r * LDL + c] = d;
      if (row < B) dlog[static_cast<size_t>(row) * Vp + col] = __float2bfloat16_rn(d);
    }
    __syncthreads();
    if (tid < BV)
      for (int r = 0; r < BR && r0 + r < B; ++r) db_acc += Ls[r * LDL + tid];
    __syncthreads();  // the next chunk's staging overwrites Ls
  }
  if (tid < BV && n0 + tid < V) db[n0 + tid] = db_acc;

  // Phase 2: dW[n0:n0+BV, :] = dlog[:, n0:n0+BV]^T . feats, reading back the
  // dlog this block wrote (visible after the barrier above). Warps 2 (vocab)
  // x 4 (D), 32 x 32 each.
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem);  // [KR][LDA] dlog
  __nv_bfloat16* Fs = Ds + KR * LDA;                           // [KR][LDB] feats
  float* Os = reinterpret_cast<float*>(smem);                  // [BV][LDO]
  const int cm = warp / 4, cn = warp % 4;
  for (int d0 = 0; d0 < D; d0 += DC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < B; k0 += KR) {
      for (int i = tid; i < KR * (BV / 8); i += kThreads) {
        const int r = i / (BV / 8), c = (i % (BV / 8)) * 8;
        *reinterpret_cast<uint4*>(Ds + r * LDA + c) =
            load16(dlog + static_cast<size_t>(k0 + r) * Vp + n0 + c, k0 + r < B);
      }
      for (int i = tid; i < KR * (DC / 8); i += kThreads) {
        const int r = i / (DC / 8), c = (i % (DC / 8)) * 8;
        *reinterpret_cast<uint4*>(Fs + r * LDB + c) =
            load16(feats + static_cast<size_t>(k0 + r) * D + d0 + c, k0 + r < B && d0 + c < D);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KR; kk += 16) {
        // dlog^T: the staged [rows][vocab] tile read column-major.
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], Ds + kk * LDA + cm * 32 + i * 16, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Fs + kk * LDB + cn * 32 + j * 16, LDB);
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
        wmma::store_matrix_sync(Os + (cm * 32 + i * 16) * LDO + cn * 32 + j * 16, acc[i][j],
                                LDO, wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < BV * DC; e += kThreads) {
      const int r = e / DC, c = e % DC;
      if (n0 + r < V && d0 + c < D) dw[static_cast<size_t>(n0 + r) * D + d0 + c] = Os[r * LDO + c];
    }
    __syncthreads();  // the next chunk's staging overwrites Os
  }
}

// One split's partial of dfeats = dlog . W for a [BR, DC] output tile.
__global__ void __launch_bounds__(kThreads)
ce_bwd_dfeats_kernel(const __nv_bfloat16* __restrict__ dlog,  // [B, Vp]
                     const __nv_bfloat16* __restrict__ w,     // [V, D]
                     float* __restrict__ part,                // [n_split, Bp, Dp]
                     int B, int D, int V, int Vp, int Bp, int Dp, int chunks_per_split) {
  __shared__ __align__(128) unsigned char smem[kSmem2];
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem);  // [BR][LDA] dlog
  __nv_bfloat16* Ws = Ds + BR * LDA;                           // [BV][LDB] W
  const int tid = threadIdx.x, warp = tid / 32;
  const int cm = warp / 4, cn = warp % 4;  // 2 (rows) x 4 (D) warps, 32 x 32 each
  const int r0 = blockIdx.x * BR, d0 = blockIdx.y * DC, split = blockIdx.z;
  const int v_begin = split * chunks_per_split * BV;
  const int v_end = min(Vp, v_begin + chunks_per_split * BV);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int v0 = v_begin; v0 < v_end; v0 += BV) {
    for (int i = tid; i < BR * (BV / 8); i += kThreads) {
      const int r = i / (BV / 8), c = (i % (BV / 8)) * 8;
      *reinterpret_cast<uint4*>(Ds + r * LDA + c) =
          load16(dlog + static_cast<size_t>(r0 + r) * Vp + v0 + c, r0 + r < B);
    }
    for (int i = tid; i < BV * (DC / 8); i += kThreads) {
      const int r = i / (DC / 8), c = (i % (DC / 8)) * 8;
      *reinterpret_cast<uint4*>(Ws + r * LDB + c) =
          load16(w + static_cast<size_t>(v0 + r) * D + d0 + c, v0 + r < V && d0 + c < D);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Ds + (cm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Ws + kk * LDB + cn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = part + (static_cast<size_t>(split) * Bp + r0) * Dp + d0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(out + static_cast<size_t>(cm * 32 + i * 16) * Dp + cn * 32 + j * 16,
                              acc[i][j], Dp, wmma::mem_row_major);
}

// dfeats = bf16(sum of the splits' partials, in split order).
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

}  // namespace

// feats bf16 [B, D]; w bf16 [V, D]; bias f32 [V]; labels i32 [B]; m, l, g
// f32 [B] -> dw f32 [V, D], db f32 [V], dfeats bf16 [B, D]. Scratch: dlog
// bf16 [B, Vp] and part f32 [n_split, Bp, Dp], with Vp, Bp, Dp rounded up
// to mpt_head_ce_bwd_tile_vocab / _rows / _cols. The vocab splits of the
// dfeats product cover [0, Vp) in chunks of the vocab tile, none empty.
// D % 16 == 0; every pointer 16-byte aligned.
extern "C" int mpt_head_ce_bwd(const void* feats, const void* w, const void* bias,
                               const void* labels, const void* m, const void* l, const void* g,
                               void* dlog, void* dw, void* db, void* part, void* dfeats,
                               int B, int D, int V, int n_split, int chunks_per_split,
                               void* stream) {
  if (B < 1 || V < 1 || D < 16 || D % 16 != 0 || n_split < 1 || chunks_per_split < 1)
    return cudaErrorInvalidValue;
  const int Vp = (V + BV - 1) / BV * BV, Bp = (B + BR - 1) / BR * BR;
  const int Dp = (D + DC - 1) / DC * DC;
  const long long span = static_cast<long long>(chunks_per_split) * BV;
  if (static_cast<long long>(n_split - 1) * span >= Vp || n_split * span < Vp)
    return cudaErrorInvalidValue;
  if (n_split > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* fb = static_cast<const __nv_bfloat16*>(feats);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* dl = static_cast<__nv_bfloat16*>(dlog);
  ce_bwd_dw_kernel<<<Vp / BV, kThreads, 0, s>>>(
      fb, wb, static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(m), static_cast<const float*>(l), static_cast<const float*>(g),
      dl, static_cast<float*>(dw), static_cast<float*>(db), B, D, V, Vp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_bwd_dfeats_kernel<<<dim3(Bp / BR, Dp / DC, n_split), kThreads, 0, s>>>(
      dl, wb, static_cast<float*>(part), B, D, V, Vp, Bp, Dp, chunks_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(B) * D;
  ce_bwd_dfeats_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dfeats), B, D, Bp, Dp, n_split);
  return cudaGetLastError();
}

// The backward's tile geometry the wrapper sizes its scratch with: the
// vocab tile (Vp and the split chunks), batch rows (Bp) and D columns (Dp).
extern "C" int mpt_head_ce_bwd_tile_vocab() { return BV; }
extern "C" int mpt_head_ce_bwd_tile_rows() { return BR; }
extern "C" int mpt_head_ce_bwd_tile_cols() { return DC; }
