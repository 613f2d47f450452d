// Shared building blocks of the attention kernels (fused_attention_small.cu,
// flash_attention.cu): f32 shared-memory tiles, a 4×4 register micro-tile
// product, and a warp-per-row softmax.
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

// Above 48 KB a kernel takes dynamic shared memory only once allowed to.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace mpt_attn
