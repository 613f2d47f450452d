// Shared pieces of the attention kernels (fused_attention_small.cu,
// flash_attention.cu, and the tensor-core tiles of attention_tc.cuh): the
// mask value, the operands' strides, the shared-memory opt-in, and the
// register tiles of K9's bf16 FFMA forward (`small_fwd`).
//
// That forward's products run as f32 FFMA on the CUDA cores, so it is
// bounded by its operations (67 TFLOP/s f32 on an H100 SXM), not by its
// bytes: q·kᵀ and p·v of a whole row set stay in shared memory and
// registers, and nothing of size S×S reaches device memory. Its sums run in
// a fixed order (the reduction index ascending in each thread, then a fixed
// shuffle tree), so two calls on the same inputs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mpt_attn {

// The finite mask value of the TPU kernels: exp(kNeg − m) is exactly 0 for
// any real row max m, and the online recurrence never sees −inf − −inf.
constexpr float kNeg = -1e30f;

// Element strides of q, k and v, read in place as [B, S, H, D] views that
// share one set of strides, the head dim contiguous.
struct Strides {
  long long sb, ss, sh;
};

// ------------------------------------------------ the tiny-S forward ---
// Register tiles of attn_small_fwd_kernel (fused_attention_small.cu), the
// bf16 FFMA forward. It computes every sum in the order of the one-CTA-a-
// head kernel it replaced (a score one fmaf chain over r ascending; a row's
// max and sum over 32 lanes, lane L taking columns L, L + 32, ..., then the
// xor tree 16, 8, 4, 2, 1; p·v one fmaf chain over the keys ascending), so
// its outputs are that kernel's bits; what differs is how operands reach
// the FMA units. Warp w owns query rows 16w..16w+15; lane (lr = lane / 16,
// lc = lane % 16) holds rows 16w + 8lr + a, a < 8, so eight rows share each
// operand load:
//   - scores: columns (keys) lc + 16b, b < NB, from q·scale transposed in
//     the warp's own tile ([r][16 rows]: two 16-byte loads give the eight
//     rows' q at one r) and k row-major (one 16-byte load gives a key's k at
//     four r); each score one fmaf chain over r ascending from 0;
//   - the softmax in registers: a row lies in the 16 lanes of one lr, and
//     the 32-lane order's lane L (columns L, L + 32, ...) is lane lc's even
//     b (L = lc) or odd b (L = lc + 16), so its partials, and the xor tree
//     from 16 down, are formed from the same terms in the same order;
//   - out: columns 4lc + c + 64h from v row-major (one 16-byte load a key),
//     p transposed in the warp's tile; one fmaf chain over the keys
//     ascending, then ÷ l.
// That is 8 + NB 16-byte loads for 32·NB FFMA every four r, and three (D ≤
// 64) for 32 FFMA a key: the FMA units, not shared memory, set the pace.
namespace small_fwd {

constexpr int kRows = 16;  // query rows a warp

// Dynamic shared memory of a CTA of nw warps over keys padded to sp rows
// (64 or 128), head dim d: byte offsets of the f32 tiles k [sp][kp] and v
// [sp][vp] and of the warps' own tiles [nw][xp][16] (q·scale transposed,
// then p transposed, then the bf16 output rows). At vit_s16's shape 49 KB:
// four CTAs an SM.
struct Smem {
  int kp, vp, xp;
  int k, v, own, bytes;
  __host__ __device__ Smem(int sp, int nw, int d) {
    kp = 4 * ((d / 4) | 1);  // an odd number of float4s: 16 keys' loads hit 8 bank groups twice
    vp = 64 * ((d + 63) / 64);
    xp = d > sp ? d : sp;
    k = 0;
    v = k + sp * kp * 4;
    own = v + sp * vp * 4;
    bytes = own + nw * xp * kRows * 4;
  }
};

// The next (row, piece) of a walk over rows of n pieces that takes items
// i, i + step, ...: (dr, dc) = (step / n, step % n), carried without a
// division an item.
__device__ __forceinline__ void walk(int& r, int& c, int dr, int dc, int n) {
  r += dr;
  c += dc;
  if (c >= n) {
    c -= n;
    ++r;
  }
}

// s[a][b] = Σ_{r<D} q(8lr + a, r) · k(lc + 16b, r), r ascending: qt is the
// warp's transposed q·scale shifted to this lane's rows (row r at 16r),
// kt the f32 k tile shifted to key lc (key 16b at 16b·kp).
template <int NB>
__device__ __forceinline__ void scores(float (&s)[8][NB], const float* qt, const float* kt, int kp,
                                       int D) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) s[a][b] = 0.f;
#pragma unroll 2
  for (int r0 = 0; r0 < D; r0 += 4) {
    float4 kv[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) kv[b] = *reinterpret_cast<const float4*>(kt + 16 * b * kp + r0);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float4 lo = *reinterpret_cast<const float4*>(qt + 16 * (r0 + rr));
      const float4 hi = *reinterpret_cast<const float4*>(qt + 16 * (r0 + rr) + 4);
      const float qv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float kr = rr == 0 ? kv[b].x : rr == 1 ? kv[b].y : rr == 2 ? kv[b].z : kv[b].w;
#pragma unroll
        for (int a = 0; a < 8; ++a) s[a][b] = fmaf(qv[a], kr, s[a][b]);
      }
    }
  }
}

// Row a's softmax in the 32-lane order, for query i0 + a: keys at or
// past S (and, when causal, past the query) at kNeg; m = the max; s ←
// expf(s − m); l = lane L's partial over columns L, L + 32, ... ascending,
// then the xor tree 16, 8, 4, 2, 1. Returns l, the same in all 16 lanes.
template <int NB>
__device__ __forceinline__ void softmax_rows(float (&s)[8][NB], float (&l)[8], int i0, int lc,
                                             int S, int causal) {
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float m = kNeg;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = lc + 16 * b;
      s[a][b] = (j >= S || (causal && j > i0 + a)) ? kNeg : s[a][b];
      m = fmaxf(m, s[a][b]);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float even = 0.f, odd = 0.f;  // lanes lc and lc + 16 of the 32-lane order
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      s[a][b] = expf(s[a][b] - m);
      if (b % 2 == 0)
        even += s[a][b];
      else
        odd += s[a][b];
    }
    float t = even + odd;  // the tree's first level (lanes xor 16)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    l[a] = t;
  }
}

// o[a][4h + c] = Σ_{j<S} p(8lr + a, j) · v(j, 4lc + c + 64h), j ascending:
// pt is the warp's transposed p shifted to this lane's rows (key j at
// 16j), vt the f32 v tile shifted to column 4lc.
template <int DH>
__device__ __forceinline__ void pv(float (&o)[8][4 * DH], const float* pt, const float* vt, int vp,
                                   int S) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 4 * DH; ++c) o[a][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < S; ++j) {
    const float4 lo = *reinterpret_cast<const float4*>(pt + 16 * j);
    const float4 hi = *reinterpret_cast<const float4*>(pt + 16 * j + 4);
    const float pj[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int h = 0; h < DH; ++h) {
      const float4 vv = *reinterpret_cast<const float4*>(vt + j * vp + 64 * h);
      const float vj[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[a][4 * h + c] = fmaf(pj[a], vj[c], o[a][4 * h + c]);
    }
  }
}

}  // namespace small_fwd

// Above 48 KB a kernel takes dynamic shared memory only once allowed to.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace mpt_attn
