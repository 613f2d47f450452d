// What the heads' two passes share (head_predict_tc.cu: K4's bf16 and
// f32 routes, K7 and the training forward K5).
//
// Pass 1 (a partial kernel) leaves each vocab split's per-row state in a
// scratch: part_mlp f32 [3, n_split, B] (the max m, the sum l of exp
// relative to m, the picked label logit) and part_arg i32 [n_split, B]
// (the first column attaining m; not written when no argmax is asked
// for). Pass 2, a merge kernel, finishes the rows (head_merge_kernel,
// below).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// cudaSuccess when (B, D, V) and the split geometry are ones the partial
// kernels take: D % 16 == 0, every split of tiles_per_split tiles of
// `tile_vocab` rows non-empty, V covered.
inline cudaError_t check_geometry(int B, int D, int V, int n_split, int tiles_per_split,
                                  int tile_vocab) {
  if (B < 1 || V < 1 || D < 16 || D % 16 != 0 || n_split < 1 || tiles_per_split < 1)
    return cudaErrorInvalidValue;
  const long long span = static_cast<long long>(tiles_per_split) * tile_vocab;
  if (static_cast<long long>(n_split - 1) * span >= V || n_split * span < V)
    return cudaErrorInvalidValue;
  if (n_split > 65535) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

// Pass 2: one warp a row merges its n_split partial states. Lane s takes
// splits s, s + 32, ... in order: the larger max wins (strict: a lower
// split keeps a tie), l rescaled to it; then a fixed shuffle tree merges
// the lanes, equal maxima going to the smaller column (the lower split's).
// pred may be null (the training forward needs no argmax: part_arg is then
// neither read nor needed, and may be null too); m_out and l_out,
// when given, receive the row's global max and its sum of exp relative to
// it (the training backward's residuals).
constexpr int kMergeRows = 8;  // rows (warps) a block

__global__ void __launch_bounds__(32 * kMergeRows)
head_merge_kernel(const float* __restrict__ part_mlp, const int* __restrict__ part_arg,
                  const int* __restrict__ labels, float* __restrict__ loss,
                  int* __restrict__ pred, float* __restrict__ m_out, float* __restrict__ l_out,
                  int B, int n_split) {
  const int row = blockIdx.x * kMergeRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= B) return;  // warp-uniform
  const size_t plane = static_cast<size_t>(n_split) * B;
  float M = -INFINITY, l = 0.f, pick = 0.f;
  int arg = 0x7fffffff;
  for (int s = lane; s < n_split; s += 32) {
    const size_t o = static_cast<size_t>(s) * B + row;
    const float m = part_mlp[o], ls = part_mlp[plane + o];
    pick += part_mlp[2 * plane + o];
    if (m > M) {
      l = l * expf(M - m) + ls;
      M = m;
      if (pred != nullptr) arg = part_arg[o];
    } else {
      l += ls * expf(m - M);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, M, off);
    const float ol = __shfl_xor_sync(0xffffffffu, l, off);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
    pick += __shfl_xor_sync(0xffffffffu, pick, off);
    const float mn = fmaxf(M, om);
    l = (M == -INFINITY ? 0.f : l * expf(M - mn)) + (om == -INFINITY ? 0.f : ol * expf(om - mn));
    if (om > M || (om == M && oa < arg)) arg = oa;
    M = mn;
  }
  if (lane == 0) {
    loss[row] = labels[row] < 0 ? 0.f : logf(l) + M - pick;
    if (pred != nullptr) pred[row] = arg;
    if (m_out != nullptr) {
      m_out[row] = M;
      l_out[row] = l;
    }
  }
}

// The merge over B rows, on stream s.
inline cudaError_t launch_merge(const float* part_mlp, const int* part_arg, const int* labels,
                                float* loss, int* pred, float* m_out, float* l_out, int B,
                                int n_split, cudaStream_t s) {
  head_merge_kernel<<<(B + kMergeRows - 1) / kMergeRows, 32 * kMergeRows, 0, s>>>(
      part_mlp, part_arg, labels, loss, pred, m_out, l_out, B, n_split);
  return cudaGetLastError();
}

}  // namespace
