// Flash attention forward (K8): block-tiled online-softmax attention that
// writes the output and the f32 logsumexp of every row, for head dims
// D ≤ 128 (D % 4 == 0) and blocks of at most 128 queries and 128 keys.
//
// Replaces mpi_pytorch_tpu/ops/flash_attention.py:53 `_attn_fwd_kernel`.
// What it computes, per (batch·head, q-block): over the k-blocks in order,
// s = (q·scale)·kᵀ with keys ≥ S (and, when causal, keys past the query) at
// −1e30; m_new = max(m, max s); α = exp(m − m_new); p = exp(s − m_new);
// l = α·l + Σ p; acc = acc·α + p·v. At the end out = acc / safe_l and
// lse = m + log(safe_l), with safe_l = l where l > 0, else 1.
//
// Design. The TPU kernel carries (m, l, acc) in scratch memory across a
// sequential grid axis over the k-blocks; a GPU grid has no order, so one
// CTA per (batch·head, q-block) loops over the k-blocks itself. acc stays in
// registers (4×4 micro-tiles, at most four a thread), m, l and α in shared
// memory beside the q tile, one k/v tile and the block's scores: nothing of
// size S×S reaches device memory. A causal CTA stops at the first k-block
// that lies wholly past its last query — there p = 0 and α = 1, so the
// skipped steps would change nothing. Keys past S are left out of the
// block's sums, where the TPU kernel adds their exact zeros. q, k and v are
// read in place as strided [B, S, H, D] views. Products are f32 FFMA
// (attention_tiles.cuh): bounded by operations; tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tiles.cuh"

namespace {

using namespace mpt_attn;

constexpr int kMaxBlock = 128;
constexpr int kMaxHeadDim = 128;
// Output micro-tiles a thread may own: ⌈128/4⌉·⌈128/4⌉ / kThreads.
constexpr int kMaxTiles = (kMaxBlock / 4) * (kMaxHeadDim / 4) / kThreads;

__host__ __device__ inline int flash_smem_floats(int BQ, int BK, int D) {
  return (BQ + BK) * odd_ld(D) + BQ * odd_ld(BK) + 3 * BQ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Strides st, int H, int S, int D,
                 int BQ, int BK, int n_q, float scale, int causal) {
  extern __shared__ float smem[];
  const int ldd = odd_ld(D), ldk = odd_ld(BK);
  float* qs = smem;            // q·scale           [BQ][ldd]
  float* kv = qs + BQ * ldd;   // k, then v         [BK][ldd]
  float* ps = kv + BK * ldd;   // scores, then p    [BQ][ldk]
  float* m_s = ps + BQ * ldk;  // running max       [BQ]
  float* l_s = m_s + BQ;       // running sum       [BQ]
  float* a_s = l_s + BQ;       // this block's α    [BQ]
  const int bh = blockIdx.x / n_q, qb = blockIdx.x - bh * n_q;
  const int b = bh / H, h = bh - b * H;
  const int q0 = qb * BQ, rows = min(BQ, S - q0);
  const long long base = b * st.sb + h * st.sh;

  load_rows(qs, ldd, q + base + q0 * st.ss, st.ss, rows, D, scale);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    m_s[i] = kNeg;
    l_s[i] = 0.f;
  }
  const Tiles og(rows, D);
  float acc[kMaxTiles][4][4];
#pragma unroll
  for (int u = 0; u < kMaxTiles; ++u)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][a][c] = 0.f;

  const int n_k = (S + BK - 1) / BK;
  for (int kb = 0; kb < n_k; ++kb) {
    const int k0 = kb * BK, cols = min(BK, S - k0);
    if (causal && k0 > q0 + rows - 1) break;  // uniform across the CTA
    __syncthreads();  // the last block's readers of kv and ps are done
    load_rows(kv, ldd, k + base + k0 * st.ss, st.ss, cols, D, 1.f);
    __syncthreads();
    tile_mm(
        rows, cols, D, [&](int i, int r) { return qs[i * ldd + r]; },
        [&](int j, int r) { return kv[j * ldd + r]; },
        [&](int i, int j, float s) {
          ps[i * ldk + j] = (causal && k0 + j > q0 + i) ? kNeg : s;
        });
    __syncthreads();
    // The online update, one warp per row; v lands in kv meanwhile.
    {
      const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
      for (int i = threadIdx.x >> 5; i < rows; i += nw) {
        float* row = ps + i * ldk;
        float m_cur = kNeg;
        for (int j = lane; j < cols; j += 32) m_cur = fmaxf(m_cur, row[j]);
        m_cur = warp_max(m_cur);
        const float m_prev = m_s[i];
        const float m_new = fmaxf(m_prev, m_cur);
        float l = 0.f;
        for (int j = lane; j < cols; j += 32) {
          const float p = expf(row[j] - m_new);
          row[j] = p;
          l += p;
        }
        l = warp_sum(l);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[i] = alpha;
          l_s[i] = alpha * l_s[i] + l;
          m_s[i] = m_new;
        }
      }
    }
    load_rows(kv, ldd, v + base + k0 * st.ss, st.ss, cols, D, 1.f);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMaxTiles; ++u) {
      const int t = threadIdx.x + u * blockDim.x;
      if (t < og.count()) {
        float pv[4][4];
        micro_mm(
            og, t, cols, [&](int i, int j) { return ps[i * ldk + j]; },
            [&](int d, int j) { return kv[j * ldd + d]; }, pv);
        const int tx = t / og.ny;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float alpha = a_s[min(tx + a * og.nx, rows - 1)];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[u][a][c] = acc[u][a][c] * alpha + pv[a][c];
        }
      }
    }
  }
  __syncthreads();  // the last update of m_s and l_s is visible

  T* ob = o + ((long long)b * S * H + h) * D + (long long)q0 * H * D;
  const long long os = (long long)H * D;
#pragma unroll
  for (int u = 0; u < kMaxTiles; ++u) {
    const int t = threadIdx.x + u * blockDim.x;
    if (t < og.count()) {
      const int tx = t / og.ny, ty = t - tx * og.ny;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int x = tx + a * og.nx;
        if (x >= rows) continue;
        const float l = l_s[x];
        const float safe_l = l > 0.f ? l : 1.f;  // a fully masked row
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int y = ty + c * og.ny;
          if (y < D) ob[x * os + y] = from_f32<T>(acc[u][a][c] / safe_l);
        }
      }
    }
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const float l = l_s[i];
    lse[(long long)bh * S + q0 + i] = m_s[i] + logf(l > 0.f ? l : 1.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, Strides st, int B,
           int S, int H, int D, int BQ, int BK, float scale, int causal, cudaStream_t stream) {
  if (BQ < 1 || BK < 1 || BQ > kMaxBlock || BK > kMaxBlock || D > kMaxHeadDim || D % 4)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * flash_smem_floats(BQ, BK, D);
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_q = (S + BQ - 1) / BQ;
  flash_fwd_kernel<T><<<n_q * B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, st, H, S, D, BQ, BK, n_q, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: strided [B, S, H, D] with the strides (sb, ss, sh) in elements
// and the head dim contiguous; out: contiguous [B, S, H, D]; lse: f32
// [B·H, S]. scale = D^-0.5 as the caller rounds it to f32; dtype 0 = f32,
// 1 = bf16. Returns cudaGetLastError() (cudaErrorInvalidValue for a block
// or head dim the kernel does not take).
extern "C" int mpt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             long long sb, long long ss, long long sh, int B, int S, int H, int D,
                             int block_q, int block_k, float scale, int causal, int dtype,
                             void* stream) {
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, l, st, B, S, H, D, block_q, block_k, scale,
                                 causal, s);
  return launch<float>(q, k, v, out, l, st, B, S, H, D, block_q, block_k, scale, causal, s);
}
