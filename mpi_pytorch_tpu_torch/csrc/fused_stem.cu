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
