// Fused tiny-S attention, forward (K9) and recompute backward (K10), for
// sequences of S ≤ 128 keys and head dims D ≤ 128 (D % 4 == 0).
//
// Replaces mpi_pytorch_tpu/ops/fused_attention_small.py:135 `_fwd_kernel`
// and :151 `_bwd_kernel`. What they compute, per (batch, head):
//   forward   s = (q·scale)·kᵀ (keys ≥ S, and above the diagonal when
//             causal, at −1e30); m = max s; p = exp(s − m); l = Σ p;
//             out = (p·v) / l — divided AFTER the product, as the TPU kernel;
//   backward  p recomputed and normalized BEFORE use; o = p·v recomputed;
//             Δ = Σ_d do·o; dp = do·vᵀ; ds = p·(dp − Δ); dq = ds·k·scale;
//             dk = dsᵀ·q·scale (q unscaled); dv = pᵀ·do.
// The residuals are q, k and v only: no logsumexp and no saved output.
//
// Design. One CTA per (batch, head) owns the whole row set in shared memory
// (three f32 tiles: two [S][D] and the [S][S] scores), so the score tensor
// and the softmax chain never touch device memory, and each CTA writes its
// own dq, dk, dv: no atomics, deterministic. The TPU kernel's bh-grouping
// (several heads stacked into one MXU tile with −1e30 cross-head blocks) and
// its sublane padding of S exist for the TPU's 128×128 matrix unit and are
// left behind. q, k and v are read in place as strided [B, S, H, D] views
// of the projections, with no transpose to [B·H, S, D]. Products are f32
// FFMA (attention_tiles.cuh), so the kernels are bounded by operations;
// tensor cores (a bf16 p) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tiles.cuh"

namespace {

using namespace mpt_attn;

// Floats of dynamic shared memory: two [S][D] tiles, the [S][S] scores and
// one [S] vector.
__host__ __device__ inline int small_smem_floats(int S, int D) {
  return 2 * S * odd_ld(D) + S * odd_ld(S) + S;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_small_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ o, Strides st, int H, int S, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ldd = odd_ld(D), lds = odd_ld(S);
  float* qv = smem;             // q·scale, then v   [S][ldd]
  float* ks = qv + S * ldd;     // k                 [S][ldd]
  float* ps = ks + S * ldd;     // scores, then p    [S][lds]
  float* ls = ps + S * lds;     // l                 [S]
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const long long base = b * st.sb + h * st.sh;
  load_rows(qv, ldd, q + base, st.ss, S, D, scale);
  load_rows(ks, ldd, k + base, st.ss, S, D, 1.f);
  __syncthreads();
  tile_mm(
      S, S, D, [&](int i, int r) { return qv[i * ldd + r]; },
      [&](int j, int r) { return ks[j * ldd + r]; },
      [&](int i, int j, float s) { ps[i * lds + j] = (causal && j > i) ? kNeg : s; });
  __syncthreads();
  row_softmax(ps, lds, S, S, ls, false);
  load_rows(qv, ldd, v + base, st.ss, S, D, 1.f);  // q·scale is spent
  __syncthreads();
  T* ob = o + ((long long)b * S * H + h) * D;  // out is contiguous [B, S, H, D]
  const long long os = (long long)H * D;
  tile_mm(
      S, D, S, [&](int i, int j) { return ps[i * lds + j]; },
      [&](int d, int j) { return qv[j * ldd + d]; },
      [&](int i, int d, float acc) { ob[i * os + d] = from_f32<T>(acc / ls[i]); });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_small_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
                      T* __restrict__ dv, Strides st, int H, int S, int D, float scale,
                      int causal) {
  extern __shared__ float smem[];
  const int ldd = odd_ld(D), lds = odd_ld(S);
  float* xs = smem;            // q·scale → v → k      [S][ldd]
  float* ys = xs + S * ldd;    // k → o → do → q       [S][ldd]
  float* ps = ys + S * ldd;    // scores → p → ds      [S][lds]
  float* vec = ps + S * lds;   // l, then Δ            [S]
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const long long base = b * st.sb + h * st.sh;
  const long long gs = (long long)H * D;  // row stride of do, dq, dk, dv
  const long long gbase = ((long long)b * S * H + h) * D;
  const T* dob = dout + gbase;

  load_rows(xs, ldd, q + base, st.ss, S, D, scale);
  load_rows(ys, ldd, k + base, st.ss, S, D, 1.f);
  __syncthreads();
  tile_mm(
      S, S, D, [&](int i, int r) { return xs[i * ldd + r]; },
      [&](int j, int r) { return ys[j * ldd + r]; },
      [&](int i, int j, float s) { ps[i * lds + j] = (causal && j > i) ? kNeg : s; });
  __syncthreads();
  row_softmax(ps, lds, S, S, vec, true);  // p normalized before any use
  load_rows(xs, ldd, v + base, st.ss, S, D, 1.f);
  __syncthreads();
  // o = p·v, recomputed, into ys (k is spent).
  tile_mm(
      S, D, S, [&](int i, int j) { return ps[i * lds + j]; },
      [&](int d, int j) { return xs[j * ldd + d]; },
      [&](int i, int d, float acc) { ys[i * ldd + d] = acc; });
  __syncthreads();
  // Δ_i = Σ_d do·o, one warp per row.
  {
    const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
    for (int i = threadIdx.x >> 5; i < S; i += nw) {
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(dob[i * gs + d]), ys[i * ldd + d], acc);
      acc = warp_sum(acc);
      if (lane == 0) vec[i] = acc;
    }
  }
  __syncthreads();
  load_rows(ys, ldd, dob, gs, S, D, 1.f);
  __syncthreads();
  // dv = pᵀ·do.
  tile_mm(
      S, D, S, [&](int j, int i) { return ps[i * lds + j]; },
      [&](int d, int i) { return ys[i * ldd + d]; },
      [&](int j, int d, float acc) { dv[gbase + j * gs + d] = from_f32<T>(acc); });
  __syncthreads();
  // dp = do·vᵀ, and ds = p·(dp − Δ) in place of p (each entry has one owner).
  tile_mm(
      S, S, D, [&](int i, int r) { return ys[i * ldd + r]; },
      [&](int j, int r) { return xs[j * ldd + r]; },
      [&](int i, int j, float dp) { ps[i * lds + j] = ps[i * lds + j] * (dp - vec[i]); });
  __syncthreads();
  load_rows(xs, ldd, k + base, st.ss, S, D, 1.f);
  load_rows(ys, ldd, q + base, st.ss, S, D, 1.f);
  __syncthreads();
  // dq = ds·k·scale; dk = dsᵀ·q·scale.
  tile_mm(
      S, D, S, [&](int i, int j) { return ps[i * lds + j]; },
      [&](int d, int j) { return xs[j * ldd + d]; },
      [&](int i, int d, float acc) { dq[gbase + i * gs + d] = from_f32<T>(acc * scale); });
  tile_mm(
      S, D, S, [&](int j, int i) { return ps[i * lds + j]; },
      [&](int d, int i) { return ys[i * ldd + d]; },
      [&](int j, int d, float acc) { dk[gbase + j * gs + d] = from_f32<T>(acc * scale); });
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, Strides st, int B, int S,
               int H, int D, float scale, int causal, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * small_smem_floats(S, D);
  cudaError_t err = allow_smem(attn_small_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  attn_small_fwd_kernel<T><<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st, H, S, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
               void* dv, Strides st, int B, int S, int H, int D, float scale, int causal,
               cudaStream_t stream) {
  const size_t bytes = sizeof(float) * small_smem_floats(S, D);
  cudaError_t err = allow_smem(attn_small_bwd_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  attn_small_bwd_kernel<T><<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), st, H, S, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: strided [B, S, H, D] with the strides (sb, ss, sh) in elements
// and the head dim contiguous; out: contiguous [B, S, H, D].
// scale = D^-0.5 as the caller rounds it to f32; dtype 0 = f32, 1 = bf16.
// Returns cudaGetLastError().
extern "C" int mpt_attn_small_fwd(const void* q, const void* k, const void* v, void* out,
                                  long long sb, long long ss, long long sh, int B, int S, int H,
                                  int D, float scale, int causal, int dtype, void* stream) {
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(q, k, v, out, st, B, S, H, D, scale, causal, s);
  return launch_fwd<float>(q, k, v, out, st, B, S, H, D, scale, causal, s);
}

// q, k, v as above; dout, dq, dk, dv: contiguous [B, S, H, D].
extern "C" int mpt_attn_small_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  void* dq, void* dk, void* dv, long long sb, long long ss,
                                  long long sh, int B, int S, int H, int D, float scale, int causal,
                                  int dtype, void* stream) {
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, st, B, S, H, D, scale, causal, s);
  return launch_bwd<float>(q, k, v, dout, dq, dk, dv, st, B, S, H, D, scale, causal, s);
}
