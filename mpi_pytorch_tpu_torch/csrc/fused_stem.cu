// Fused resnet stem tail, forward: out = maxpool3x3/s2/p1(relu(y * a + b)).
//
// Replaces: mpi_pytorch_tpu/ops/fused_stem.py::_primal_kernel (the Pallas
// TPU kernel the eval/serve forward runs through _fwd_impl(want_idx=False)).
// a, b are the folded batchnorm affine (a = gamma * rsqrt(var + eps),
// b = beta - mean * a) in f32; the affine, relu and pool run in f32 and the
// result is stored in y's dtype. NaN propagates like the reference's
// jnp.maximum / reduce_window max.
//
// What bounds it on an H100: bytes. Per output element it does ~20 flops
// against 2 input + 0.25 output elements moved, far below the card's ~295
// flop/byte ridge. At the resnet18 serving shape (B=512, y [512,64,64,64]
// bf16) it must read 268 MB and write 67 MB: 0.10 ms at 3.35 TB/s.
//
// Design: y is NHWC memory (a channels_last conv output viewed as
// [B,H,W,C]), so 8 channels of one pixel are 16 contiguous bytes (bf16).
// One thread per (b, oh, ow, 8-channel group): neighbouring threads take
// neighbouring channel groups, so each of the 9 window loads is a
// coalesced 16-byte access, and the one store is 16 bytes too. The 3x3
// windows of neighbouring outputs overlap (stride 2), so the re-reads hit
// L1/L2 and DRAM traffic stays close to one pass over y. The TPU kernel's
// [H,W,C,B] transposes, 128-lane batch blocks and VMEM limits have no
// counterpart here.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// relu that keeps NaN (jnp.maximum(x, 0) propagates it; fmaxf would not).
__device__ __forceinline__ float relu_nan(float x) { return x < 0.f ? 0.f : x; }

// max that propagates NaN from either side, like lax.max.
__device__ __forceinline__ float max_nan(float m, float x) {
  return (x > m || x != x) ? x : m;
}

template <typename T>
__global__ void stem_pool_fwd_kernel(const T* __restrict__ y,
                                     const float* __restrict__ a,
                                     const float* __restrict__ b,
                                     T* __restrict__ out,
                                     int B, int H, int W, int C) {
  const int H2 = H / 2, W2 = W / 2, G = C / 8;
  const long long total = static_cast<long long>(B) * H2 * W2 * G;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int g = static_cast<int>(i % G);
  long long r = i / G;
  const int ow = static_cast<int>(r % W2);
  r /= W2;
  const int oh = static_cast<int>(r % H2);
  const long long n = r / H2;
  const int c0 = g * 8;

  float av[8], bv[8], m[8], v[8];
  load8(a + c0, av);
  load8(b + c0, bv);
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = -INFINITY;

#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    const int ih = 2 * oh - 1 + dh;
    if (ih < 0 || ih >= H) continue;  // out-of-range rows count as -inf
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int iw = 2 * ow - 1 + dw;
      if (iw < 0 || iw >= W) continue;
      load8(y + ((n * H + ih) * W + iw) * C + c0, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) m[k] = max_nan(m[k], relu_nan(fmaf(v[k], av[k], bv[k])));
    }
  }
  store8(out + ((n * H2 + oh) * W2 + ow) * C + c0, m);
}

template <typename T>
cudaError_t launch(const void* y, const void* a, const void* b, void* out,
                   int B, int H, int W, int C, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * (H / 2) * (W / 2) * (C / 8);
  if (total == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  stem_pool_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(out), B, H, W, C);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Training forward: the same pool plus the window index k = dh * 3 + dw.
//
// Replaces: mpi_pytorch_tpu/ops/fused_stem.py::_fwd_kernel (want_idx=True,
// the forward half of the custom VJP _stem_pool_t). k is the FIRST window
// offset attaining the max in row-major (dh, dw) order -- what the TPU
// kernel's column-then-row fold gives -- with padding as -inf. It is stored
// as int8 (the TPU kernel's MPT_STEM_IDX_INT8 storage; the values are the
// same as its default bf16 ones).
//
// Bound: bytes. At [128,64,64,64] bf16 it reads y (67.1 MB) and writes the
// pooled output (16.8 MB) and k (8.4 MB): 0.028 ms at 3.35 TB/s. Design as
// the eval forward above, plus one 8-byte store of k per thread.
//
// The affine rounds the product and the sum separately (no FMA), as the
// plain PyTorch version's y * a + b does: the two then agree bit for bit on
// every activation, so on every window's max and on every index k.
template <typename T>
__global__ void stem_pool_argmax_kernel(const T* __restrict__ y,
                                        const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        T* __restrict__ out,
                                        int8_t* __restrict__ idx,
                                        int B, int H, int W, int C) {
  const int H2 = H / 2, W2 = W / 2, G = C / 8;
  const long long total = static_cast<long long>(B) * H2 * W2 * G;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int g = static_cast<int>(i % G);
  long long r = i / G;
  const int ow = static_cast<int>(r % W2);
  r /= W2;
  const int oh = static_cast<int>(r % H2);
  const long long n = r / H2;
  const int c0 = g * 8;

  float av[8], bv[8], m[8], v[8];
  int kk[8];
  load8(a + c0, av);
  load8(b + c0, bv);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    m[c] = -INFINITY;
    kk[c] = 0;
  }
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    const int ih = 2 * oh - 1 + dh;
    if (ih < 0 || ih >= H) continue;
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int iw = 2 * ow - 1 + dw;
      if (iw < 0 || iw >= W) continue;
      load8(y + ((n * H + ih) * W + iw) * C + c0, v);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float z = relu_nan(__fadd_rn(__fmul_rn(v[c], av[c]), bv[c]));
        if (z > m[c]) kk[c] = dh * 3 + dw;  // strict: the first max keeps the window
        m[c] = max_nan(m[c], z);
      }
    }
  }
  const long long o = ((n * H2 + oh) * W2 + ow) * C + c0;
  store8(out + o, m);
  unsigned long long packed = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) packed |= static_cast<unsigned long long>(kk[c]) << (8 * c);
  *reinterpret_cast<unsigned long long*>(idx + o) = packed;
}

template <typename T>
cudaError_t launch_argmax(const void* y, const void* a, const void* b, void* out,
                          void* idx, int B, int H, int W, int C, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * (H / 2) * (W / 2) * (C / 8);
  if (total == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  stem_pool_argmax_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(out),
      static_cast<int8_t*>(idx), B, H, W, C);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: route the pooled gradient g through k to the inputs, mask it
// with pooled > 0 (the window max is post-relu, so max > 0 iff the winner
// was a live activation), and form dy = du * a, da = sum du * y and
// db = sum du over (batch, rows, columns).
//
// Replaces: mpi_pytorch_tpu/ops/fused_stem.py::_bwd_kernel (the backward
// half of the custom VJP _stem_pool_t).
//
// Bound: bytes. At [128,64,64,64] bf16 it reads g, k and pooled (42 MB), y
// (67.1 MB) and a, and writes dy (67.1 MB): 176.2 MB, 0.053 ms at
// 3.35 TB/s.
//
// Design: a GATHER, one thread per input (b, ih, iw, 8-channel group), so
// dy is written once with a 16-byte store and nothing is atomic. An input
// row ih is covered by the windows of output rows ih/2 and, for odd ih,
// ih/2 + 1 (when in range); the same for columns: at most 4 windows. For
// each, the thread adds g where k equals its offset in that window --
// the TPU kernel's parity-phase gather, per element, summed in the same
// order ((lo,lo), (lo,hi), (hi,lo), (hi,hi)). The re-reads of g/k/pooled
// by neighbouring inputs hit L1/L2.
//
// The channel sums cross every block, and a GPU grid has no order (the TPU
// kernel carries them across its sequential grid in scratch). Each thread
// walks kItems inputs of one fixed channel group, each block folds its
// threads' sums per channel in a fixed order in shared memory and writes
// one row of a [n_part, C] scratch, and a second kernel sums the rows per
// channel with a fixed tree. No float atomics: two calls on the same inputs
// give bitwise-equal da and db.
constexpr int kBwdThreads = 256;
constexpr int kBwdItems = 8;  // inputs per thread

__device__ __forceinline__ void load8_i8(const int8_t* p, int (&k)[8]) {
  const unsigned long long u = *reinterpret_cast<const unsigned long long*>(p);
#pragma unroll
  for (int c = 0; c < 8; ++c) k[c] = static_cast<int8_t>((u >> (8 * c)) & 0xff);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
stem_pool_bwd_kernel(const T* __restrict__ g, const int8_t* __restrict__ idx,
                     const T* __restrict__ pooled, const T* __restrict__ y,
                     const float* __restrict__ a, T* __restrict__ dy,
                     float* __restrict__ part_da, float* __restrict__ part_db,
                     int B, int H, int W, int C) {
  const int H2 = H / 2, W2 = W / 2, G = C / 8;
  const long long total = static_cast<long long>(B) * H * W * G;
  const long long base = static_cast<long long>(blockIdx.x) * (kBwdThreads * kBwdItems);
  const int tid = threadIdx.x;
  // kBwdThreads % G == 0 (checked by the entry point) and base is a
  // multiple of kBwdThreads, so this thread's channel group is fixed.
  const int c0 = (tid % G) * 8;
  float av[8], sa[8], sb[8];
  load8(a + c0, av);
#pragma unroll
  for (int c = 0; c < 8; ++c) sa[c] = sb[c] = 0.f;

  for (int it = 0; it < kBwdItems; ++it) {
    const long long i = base + tid + static_cast<long long>(it) * kBwdThreads;
    if (i >= total) break;
    long long r = i / G;
    const int iw = static_cast<int>(r % W);
    r /= W;
    const int ih = static_cast<int>(r % H);
    const long long n = r / H;
    float du[8], gv[8], pv[8];
    int kv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) du[c] = 0.f;
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int oh = ih / 2 + rh;
      if (rh == 1 && (!(ih & 1) || oh >= H2)) break;
      const int dh = ih - 2 * oh + 1;
#pragma unroll
      for (int rw = 0; rw < 2; ++rw) {
        const int ow = iw / 2 + rw;
        if (rw == 1 && (!(iw & 1) || ow >= W2)) break;
        const int want = dh * 3 + (iw - 2 * ow + 1);
        const long long o = ((n * H2 + oh) * W2 + ow) * C + c0;
        load8_i8(idx + o, kv);
        load8(g + o, gv);
        load8(pooled + o, pv);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (kv[c] == want && pv[c] > 0.f) du[c] += gv[c];
      }
    }
    const long long o = ((n * H + ih) * W + iw) * C + c0;
    float yv[8], dv[8];
    load8(y + o, yv);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      dv[c] = du[c] * av[c];
      sa[c] += du[c] * yv[c];
      sb[c] += du[c];
    }
    store8(dy + o, dv);
  }

  // Per-block fold, fixed order: channel c0 + e sums the threads of its
  // group in increasing thread order.
  __shared__ float s_a[kBwdThreads][9], s_b[kBwdThreads][9];  // 9: staggers banks
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    s_a[tid][c] = sa[c];
    s_b[tid][c] = sb[c];
  }
  __syncthreads();
  if (tid < C) {
    const int grp = tid / 8, e = tid % 8;
    float ta = 0.f, tb = 0.f;
    for (int j = grp; j < kBwdThreads; j += G) {
      ta += s_a[j][e];
      tb += s_b[j][e];
    }
    part_da[static_cast<long long>(blockIdx.x) * C + tid] = ta;
    part_db[static_cast<long long>(blockIdx.x) * C + tid] = tb;
  }
}

// One block per channel: sum the n_part block partials with a fixed tree.
__global__ void __launch_bounds__(kBwdThreads)
stem_pool_bwd_reduce_kernel(const float* __restrict__ part_da,
                            const float* __restrict__ part_db,
                            float* __restrict__ da, float* __restrict__ db,
                            int n_part, int C) {
  __shared__ float s_a[kBwdThreads], s_b[kBwdThreads];
  const int c = blockIdx.x, tid = threadIdx.x;
  float ta = 0.f, tb = 0.f;
  for (int p = tid; p < n_part; p += kBwdThreads) {
    ta += part_da[static_cast<long long>(p) * C + c];
    tb += part_db[static_cast<long long>(p) * C + c];
  }
  s_a[tid] = ta;
  s_b[tid] = tb;
  __syncthreads();
  for (int s = kBwdThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      s_a[tid] += s_a[tid + s];
      s_b[tid] += s_b[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    da[c] = s_a[0];
    db[c] = s_b[0];
  }
}

long long bwd_parts(int B, int H, int W, int C) {
  const long long total = static_cast<long long>(B) * H * W * (C / 8);
  const long long per_block = static_cast<long long>(kBwdThreads) * kBwdItems;
  return (total + per_block - 1) / per_block;
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* idx, const void* pooled, const void* y,
                       const void* a, void* dy, void* dadb, void* part,
                       int B, int H, int W, int C, cudaStream_t stream) {
  const long long n_part = bwd_parts(B, H, W, C);
  if (n_part == 0) return cudaMemsetAsync(dadb, 0, 2 * sizeof(float) * C, stream);
  if (n_part > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  float* part_da = static_cast<float*>(part);
  float* part_db = part_da + n_part * C;
  float* da = static_cast<float*>(dadb);
  stem_pool_bwd_kernel<T><<<static_cast<unsigned>(n_part), kBwdThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int8_t*>(idx),
      static_cast<const T*>(pooled), static_cast<const T*>(y),
      static_cast<const float*>(a), static_cast<T*>(dy), part_da, part_db, B, H, W, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stem_pool_bwd_reduce_kernel<<<C, kBwdThreads, 0, stream>>>(
      part_da, part_db, da, da + C, static_cast<int>(n_part), C);
  return cudaGetLastError();
}

}  // namespace

// y [B,H,W,C] NHWC contiguous (C % 8 == 0, H and W even, 16-byte aligned);
// a, b f32 [C]; out [B,H/2,W/2,C] in y's dtype. dtype: 0 = f32, 1 = bf16.
extern "C" int mpt_stem_pool_fwd(const void* y, const void* a, const void* b,
                                 void* out, int B, int H, int W, int C,
                                 int dtype, void* stream) {
  if (C % 8 != 0 || H % 2 != 0 || W % 2 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(y, a, b, out, B, H, W, C, s);
    case 1: return launch<__nv_bfloat16>(y, a, b, out, B, H, W, C, s);
    default: return cudaErrorInvalidValue;
  }
}

// As mpt_stem_pool_fwd, plus idx: int8 [B,H/2,W/2,C], the window index k.
extern "C" int mpt_stem_pool_argmax(const void* y, const void* a, const void* b,
                                    void* out, void* idx, int B, int H, int W, int C,
                                    int dtype, void* stream) {
  if (C % 8 != 0 || H % 2 != 0 || W % 2 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_argmax<float>(y, a, b, out, idx, B, H, W, C, s);
    case 1: return launch_argmax<__nv_bfloat16>(y, a, b, out, idx, B, H, W, C, s);
    default: return cudaErrorInvalidValue;
  }
}

// Rows of the backward's f32 scratch (part f32 [2, rows, C]); -1 when the
// grid would be too large.
extern "C" int mpt_stem_bwd_parts(int B, int H, int W, int C) {
  const long long n = bwd_parts(B, H, W, C);
  return n > 0x7fffffffLL ? -1 : static_cast<int>(n);
}

// g, pooled [B,H/2,W/2,C] and y [B,H,W,C] in one dtype (0 = f32, 1 = bf16),
// idx int8 [B,H/2,W/2,C], a f32 [C], all NHWC contiguous and 16-byte
// aligned; C % 8 == 0, C <= 256 and 256 % (C / 8) == 0. Writes dy (y's
// shape and dtype) and dadb f32 [2, C] = (da, db).
extern "C" int mpt_stem_pool_bwd(const void* g, const void* idx, const void* pooled,
                                 const void* y, const void* a, void* dy, void* dadb,
                                 void* part, int B, int H, int W, int C, int dtype,
                                 void* stream) {
  if (C % 8 != 0 || C > kBwdThreads || kBwdThreads % (C / 8) != 0 || H % 2 != 0 ||
      W % 2 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(g, idx, pooled, y, a, dy, dadb, part, B, H, W, C, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(g, idx, pooled, y, a, dy, dadb, part, B, H, W, C, s);
    default: return cudaErrorInvalidValue;
  }
}
