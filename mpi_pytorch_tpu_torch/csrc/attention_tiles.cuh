// Shared building blocks of the attention kernels (fused_attention_small.cu,
// flash_attention.cu): f32 shared-memory tiles, a 4×4 register micro-tile
// product and a warp-per-row softmax (K8's FFMA forward, K10's FFMA
// backward), and the register tiles of K9's FFMA forward (`small_fwd`).
//
// Every product here runs as f32 FFMA on the CUDA cores, so the kernels are
// bounded by their operations (67 TFLOP/s f32 on an H100 SXM), not by their
// bytes: q·kᵀ and p·v of a whole row set stay in shared memory, and nothing
// of size S×S reaches device memory. Sums run in a fixed order (the reduction
// index ascending in each thread, then a fixed shuffle tree), so two calls
// on the same inputs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mpt_attn {

constexpr int kThreads = 256;
// The finite mask value of the TPU kernels: exp(kNeg − m) is exactly 0 for
// any real row max m, and the online recurrence never sees −inf − −inf.
constexpr float kNeg = -1e30f;

// Element strides of q, k and v, read in place as [B, S, H, D] views that
// share one set of strides, the head dim contiguous.
struct Strides {
  long long sb, ss, sh;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// An odd leading dimension ≥ n: a warp reading a column of a row-major tile
// then touches 32 different banks.
__host__ __device__ __forceinline__ int odd_ld(int n) { return n | 1; }

// rows × d elements of a [.., S, .., D] operand (row stride `ss`, the head
// dim contiguous) into the f32 tile dst[r · ld + c], each times `mul`.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long long ss,
                                          int rows, int d, float mul) {
  for (int idx = threadIdx.x; idx < rows * d; idx += blockDim.x) {
    const int r = idx / d, c = idx - r * d;
    dst[r * ld + c] = to_f32(src[r * ss + c]) * mul;
  }
}

// The micro-tile geometry of an X × Y product: thread-tile t covers rows
// {tx + a·nx} and columns {ty + b·ny}, a, b < 4, with nx = ⌈X/4⌉, ny = ⌈Y/4⌉.
// Strided, not contiguous: the lanes of a warp take consecutive ty, so they
// read consecutive (or broadcast) words of either operand layout.
struct Tiles {
  int X, Y, nx, ny;
  __device__ Tiles(int X_, int Y_) : X(X_), Y(Y_), nx((X_ + 3) >> 2), ny((Y_ + 3) >> 2) {}
  __device__ int count() const { return nx * ny; }
};

// acc[a][b] = Σ_{r<R} A(x_a, r) · B(y_b, r) for thread-tile t, r ascending.
// Rows and columns past X, Y are clamped for reading; callers skip them.
template <typename FA, typename FB>
__device__ __forceinline__ void micro_mm(const Tiles& g, int t, int R, FA A, FB B,
                                         float (&acc)[4][4]) {
  const int tx = t / g.ny, ty = t - tx * g.ny;
  int xs[4], ys[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    xs[a] = min(tx + a * g.nx, g.X - 1);
    ys[a] = min(ty + a * g.ny, g.Y - 1);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int r = 0; r < R; ++r) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      av[a] = A(xs[a], r);
      bv[a] = B(ys[a], r);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

// C[x][y] = Σ_{r<R} A(x, r) · B(y, r) over X × Y, handed to epi(x, y, c):
// every (x, y) by exactly one thread of the block.
template <typename FA, typename FB, typename Epi>
__device__ __forceinline__ void tile_mm(int X, int Y, int R, FA A, FB B, Epi epi) {
  const Tiles g(X, Y);
  for (int t = threadIdx.x; t < g.count(); t += blockDim.x) {
    float acc[4][4];
    micro_mm(g, t, R, A, B, acc);
    const int tx = t / g.ny, ty = t - tx * g.ny;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int x = tx + a * g.nx, y = ty + b * g.ny;
        if (x < X && y < Y) epi(x, y, acc[a][b]);
      }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Whole-row softmax over cols entries of each of `rows` rows of p (leading
// dim ld), one warp per row: m = max, p ← exp(s − m), l = Σ p; with
// `normalize`, p ← p / l as well. l lands in l_out[row].
__device__ __forceinline__ void row_softmax(float* p, int ld, int rows, int cols, float* l_out,
                                            bool normalize) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < rows; i += nw) {
    float* row = p + i * ld;
    float m = kNeg;  // every entry is ≥ kNeg: the same max as from −inf
    for (int j = lane; j < cols; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < cols; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      l += e;
    }
    l = warp_sum(l);
    if (normalize)
      for (int j = lane; j < cols; j += 32) row[j] = row[j] / l;
    if (lane == 0) l_out[i] = l;
  }
}

// ------------------------------------------------ the tiny-S forward ---
// Register tiles of attn_small_fwd_kernel (fused_attention_small.cu), the
// bf16 FFMA forward. It computes every sum in the order micro_mm,
// row_softmax and tile_mm take above, so its outputs are their bits; what
// differs is how operands reach the FMA units. Warp w owns query rows
// 16w..16w+15; lane (lr = lane / 16, lc = lane % 16) holds rows
// 16w + 8lr + a, a < 8, so eight rows share each operand load:
//   - scores: columns (keys) lc + 16b, b < NB, from q·scale transposed in
//     the warp's own tile ([r][16 rows]: two 16-byte loads give the eight
//     rows' q at one r) and k row-major (one 16-byte load gives a key's k at
//     four r); each score one fmaf chain over r ascending from 0;
//   - the softmax in registers: a row lies in the 16 lanes of one lr, and
//     row_softmax's lane L (columns L, L + 32, ...) is lane lc's even b
//     (L = lc) or odd b (L = lc + 16), so its partials, and the xor tree
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

// Row a's softmax as row_softmax takes it, for query i0 + a: keys at or
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
    float even = 0.f, odd = 0.f;  // lanes lc and lc + 16 of row_softmax
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
