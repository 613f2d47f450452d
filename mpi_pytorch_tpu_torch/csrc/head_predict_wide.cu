// The streamed route of the tensor-core heads (K4 bf16, K5, K7): its
// instantiations of head_predict_tc_kernel (head_predict_tc.cuh, kStream),
// in a translation unit of their own so that nvcc compiles them beside the
// resident route's (head_predict_tc.cu), which calls mpt_head::launch_streamed
// for a D too wide for a resident feats tile.
#include "head_predict_tc.cuh"

namespace mpt_head {

cudaError_t launch_streamed(int kind, int C, const CUtensorMap& fm, const CUtensorMap& wm,
                            const float* bias, const float* scale_v, const int* labels,
                            float* part_mlp, int* part_arg, int B, int V, int n_split,
                            int tiles_per_split, int nk, cudaStream_t s) {
  switch (kind) {
    case 0:
      return launch_route<Bf16, true, true>(C, fm, wm, bias, scale_v, labels, part_mlp, part_arg,
                                            B, V, n_split, tiles_per_split, nk, s);
    case 1:
      return launch_route<Bf16, false, true>(C, fm, wm, bias, scale_v, labels, part_mlp,
                                             part_arg, B, V, n_split, tiles_per_split, nk, s);
    case 2:
      return launch_route<Int8, true, true>(C, fm, wm, bias, scale_v, labels, part_mlp, part_arg,
                                            B, V, n_split, tiles_per_split, nk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace mpt_head
