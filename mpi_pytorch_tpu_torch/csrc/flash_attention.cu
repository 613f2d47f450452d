// Flash attention forward (K8): block-tiled online-softmax attention that
// writes the output and the f32 logsumexp of every row. Two kernels, both
// on the tensor cores (attention_tc.cuh), both for any D % 4 == 0 up to 128
// (instantiated per DK = D rounded up to 16, the real D given at run time):
//   - flash_fwd_tc_kernel, bf16: the path vit_s16 trains through;
//   - flash_fwd_tc_f32_kernel, f32: on three-term bf16 splits, the f32
//     step's.
//
// Replaces mpi_pytorch_tpu/ops/flash_attention.py:53 `_attn_fwd_kernel`.
// What it computes, per (batch·head, q-block): over the k-blocks in order,
// s = (q·scale)·kᵀ with keys ≥ S (and, when causal, keys past the query) at
// −1e30; m_new = max(m, max s); α = exp(m − m_new); p = exp(s − m_new);
// l = α·l + Σ p; acc = acc·α + p·v. At the end out = acc / safe_l and
// lse = m + log(safe_l), with safe_l = l where l > 0, else 1.
//
// Both kernels. The TPU kernel carries (m, l, acc) in scratch memory
// across a sequential grid axis over the k-blocks; a GPU grid has no order,
// so one CTA per (batch·head, q-block) loops over the k-blocks itself:
// nothing of size S×S reaches device memory. A causal CTA stops at the
// first k-block that lies wholly past its last query — there p = 0 and
// α = 1, so the skipped steps would change nothing. q, k and v are read in
// place as strided [B, S, H, D] views.
//
// The tensor-core kernel. Bound on an H100 by its bytes: q, k, v and out
// in bf16 and the f32 lse, 77.7 MB at vit_s16's 224 px training shape
// [128, 196, 6, 64], 23.2 µs at 3.35 TB/s; its four bf16 products (q·kᵀ,
// and p·v as three: the split p of attention_tc.cuh keeps it f32-exact)
// take 15.3 µs at 989 TFLOP/s. A CTA is two warpgroups, 128 queries
// (64 each, scores and output in registers, m, l and α per row in
// registers), over k/v blocks of 64 keys staged as bf16 in a two-stage
// cp.async ring: block kb+1 is in flight while block kb computes. 49 KB of
// shared memory at D = 64 (q 16 KB, two stages of k and v 32 KB, 1 KB of
// alignment) and at most 128 registers a thread, so two CTAs share an SM.
// What the card spends its time on is the per-score work on the CUDA cores
// (mask, exponential, sums, the three-term split) and issuing the copies,
// not the bytes or the products, so: a block with no masked key skips the
// mask and folds the scale into the exponent's FMA; a last block of at
// most 16 or 32 real keys takes a narrower product (196 keys leave 4 past
// 192); the exponential is the hardware's base-2 one. The output leaves
// through the q tile as 16-byte stores. A head dim that is not a multiple
// of 16 (D = 40: DK = 48) takes DK/16 k-steps of q·kᵀ over zero-padded
// columns and the same p·v and shared memory as DK's multiple of 64; rows
// that start on 8 bytes only (D = 36) are copied, and the output stored, in
// 8-byte pieces. Such a call runs its own instantiation (kNarrow), so a
// head dim that is a multiple of 16 on 16-byte rows keeps D and the copies
// fixed at compile time.
//
// The f32 tensor-core kernel. The bf16 kernel's tiles, recurrence and fast
// paths (a narrower last block, no mask or scale on a full block), with
// every product f32-exact: q·scale (so the scores are the TPU kernel's
// (q·scale)·kᵀ up to the order of summation), k, v and p split into three
// bf16 terms, each product six exact term-pair products (attention_tc.cuh).
// Bound on an H100 by its operations: at [128, 196, 6, 64] the two f32
// products price as six TF32 products, 0.046 ms at 495 TFLOP/s, the same
// tensor time as its twelve bf16 products; the f32 q, k, v, out and lse
// (154.7 MB) take 0.046 ms at 3.35 TB/s. The q tile's terms are split once;
// each k/v block's at the top of its step, straight from device memory
// (`stage_terms`), while the other CTA on the SM computes: 97 KB of shared
// memory for D <= 64 (two CTAs an SM, 128 registers a thread), 193 KB
// above. The output and lse leave in f32 straight from the fragments.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tc.cuh"

namespace {

using mpt_attn::allow_smem;
using mpt_attn::kNeg;
using mpt_attn::Strides;

// ------------------------------------------------------ tensor cores ---

constexpr int kTcBlockQ = 128;  // two warpgroups of 64 queries
constexpr int kTcBlockK = 64;

// Shared memory: the q tile, then two stages of (k, v) blocks, bf16 rows
// padded to whole 128-byte atoms, plus 1 KB to start the tiles on 1024.
template <int DK>
constexpr int tc_smem_bytes() {
  return mpt_tc::tile_bytes<DK, kTcBlockQ>() + 4 * mpt_tc::tile_bytes<DK, kTcBlockK>() + 1024;
}

// One k-block of N keys from k0 for this warpgroup's 64 queries: the
// scores, the online update of m, l and acc·α, and acc += p·v. F32: q, k
// and v are three-term splits (six term-pair products each), q already
// times the scale, and `scale` is 1.
template <int D, int N, bool F32 = false>
__device__ __forceinline__ void flash_block(float* acc, float (&m)[2], float (&l)[2], uint32_t sq,
                                            uint32_t sk, uint32_t sv, float scale, int row0, int k0,
                                            int S, int causal) {
  using namespace mpt_tc;
  float s[N / 2];
  qk_product<D, N, kTcBlockQ, kTcBlockK, F32 ? 6 : 1>(s, sq, sk);
  const float sc = prepare_scores<N>(s, scale, row0, k0, S, causal);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], row_max<N>(s, i, sc));
    const float alpha = expf(m[i] - m_new);
    l[i] = alpha * l[i] + exp_sum<N>(s, i, sc, m_new);
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < padded<D>() / 8; ++j) {
      acc[4 * j + 2 * i] *= alpha;
      acc[4 * j + 2 * i + 1] *= alpha;
    }
  }
  pv_product<D, N, kTcBlockK, F32>(acc, s, sv);
}

// The bf16 kernel at DK (D rounded up to 16). kNarrow: q, k and v's first
// D columns (d_arg) copied in `pieces_arg` (attention_tc.cuh, `row_pieces`),
// the rest zeros; else D = DK on 16-byte rows, both fixed at compile time
// (every model's head dim: the run-time D and the narrow copies measured
// slower at D = 64 on an H100).
template <int DK, bool kNarrow>
__global__ void __launch_bounds__(2 * mpt_tc::kWarpgroup, DK <= 64 ? 2 : 1)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, Strides st, int H, int S, int d_arg, int pieces_arg,
                    int n_q, float scale, int causal) {
  using namespace mpt_tc;
  const int D = kNarrow ? d_arg : DK, pieces = kNarrow ? pieces_arg : kPieces16;
  constexpr int NT = 2 * kWarpgroup, BQ = kTcBlockQ, BK = kTcBlockK;
  constexpr uint32_t kTileQ = tile_bytes<DK, BQ>(), kTileK = tile_bytes<DK, BK>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t raw = smem_addr(tc_smem), s_q = (raw + 1023) & ~1023u;
  unsigned char* smem = tc_smem + (s_q - raw);
  const uint32_t s_kv = s_q + kTileQ;  // stage i: k, v at 2i·kTileK
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int bh = blockIdx.x / n_q, qb = blockIdx.x - bh * n_q;
  const int b = bh / H, h = bh - b * H;
  const int q0 = qb * BQ, last_q = min(q0 + BQ, S) - 1;
  const long long base = b * st.sb + h * st.sh;
  const __nv_bfloat16 *kh = k + base, *vh = v + base;

  load_tile<DK, BQ>(s_q, q + base + q0 * st.ss, st.ss, S - q0, D, pieces, tid, NT);
  load_tile<DK, BK>(s_kv, kh, st.ss, S, D, pieces, tid, NT);
  load_tile<DK, BK>(s_kv + kTileK, vh, st.ss, S, D, pieces, tid, NT);
  cp_async_commit();

  // k-blocks that hold a key at or before the CTA's last query.
  const int n_k = causal ? last_q / BK + 1 : (S + BK - 1) / BK;
  const int row0 = q0 + wg * 64 + warp * 16;  // this warp's first query
  const uint32_t sq = s_q + wg * 64 * 128;     // this warpgroup's q rows
  float acc[padded<DK>() / 2];
#pragma unroll
  for (int i = 0; i < padded<DK>() / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < n_k; ++kb) {
    if (kb + 1 < n_k) {  // the next block into the other stage
      const int k1 = (kb + 1) * BK;
      const uint32_t nxt = s_kv + ((kb + 1) & 1) * 2 * kTileK;
      load_tile<DK, BK>(nxt, kh + k1 * st.ss, st.ss, S - k1, D, pieces, tid, NT);
      load_tile<DK, BK>(nxt + kTileK, vh + k1 * st.ss, st.ss, S - k1, D, pieces, tid, NT);
    }
    cp_async_commit();
    cp_async_wait<1>();  // q and this block have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t sk = s_kv + (kb & 1) * 2 * kTileK, sv = sk + kTileK;
    // A last block of at most 16 or 32 real keys takes a narrower product
    // (S = 196: 4 keys past 192), so padding costs less of the softmax.
    const int k0 = kb * BK, left = S - k0;
    if (left > 32)
      flash_block<DK, 64>(acc, m, l, sq, sk, sv, scale, row0, k0, S, causal);
    else if (left > 16)
      flash_block<DK, 32>(acc, m, l, sq, sk, sv, scale, row0, k0, S, causal);
    else
      flash_block<DK, 16>(acc, m, l, sq, sk, sv, scale, row0, k0, S, causal);
    __syncthreads();  // every reader of this stage is done before it refills
  }
  cp_async_wait<0>();

  const float safe_l[2] = {l[0] > 0.f ? l[0] : 1.f, l[1] > 0.f ? l[1] : 1.f};  // fully masked rows
  // The q tile is free (the loop ended on a barrier after the last product).
  store_rows<DK, BQ>(smem, 0, wg * 64, acc, safe_l, o + ((long long)b * S * H + h) * D,
                     (long long)H * D, q0 + wg * 64, S, D);
  if ((threadIdx.x & 3) == 0) {
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i;
      if (row < S) lse[(long long)bh * S + row] = m[i] + logf(safe_l[i]);
    }
  }
}

template <int DK>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, Strides st, int B,
              int S, int H, int D, int pieces, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<DK>();
  const auto kernel = D != DK || pieces != mpt_tc::kPieces16 ? flash_fwd_tc_kernel<DK, true>
                                                             : flash_fwd_tc_kernel<DK, false>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_q = (S + kTcBlockQ - 1) / kTcBlockQ;
  kernel<<<n_q * B * H, 2 * mpt_tc::kWarpgroup, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, st, H, S, D,
      pieces, n_q, scale, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- f32 tensor cores ---
// Instantiated per DK = D rounded up to 16 (the k-steps of q·kᵀ); the real
// D masks the columns at run time.

// Shared memory of the f32 kernel: the three term tiles of q (128 rows) and
// of k and v (64 rows each), and 1 KB to start the tiles on 1024: 97 KB
// for D ≤ 64 (two CTAs an SM), 193 KB above.
template <int DK>
__host__ __device__ constexpr int f32_smem_bytes() {
  return 3 * mpt_tc::tile_bytes<DK, kTcBlockQ>() + 6 * mpt_tc::tile_bytes<DK, kTcBlockK>() + 1024;
}

template <int DK>
__global__ void __launch_bounds__(2 * mpt_tc::kWarpgroup,
                                  2 * f32_smem_bytes<DK>() <= mpt_tc::kMaxSmem ? 2 : 1)
flash_fwd_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, Strides st, int H, int S, int D, int n_q,
                        float scale, int causal) {
  using namespace mpt_tc;
  constexpr int NT = 2 * kWarpgroup, BQ = kTcBlockQ, BK = kTcBlockK;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t s_q = (smem_addr(tc_smem) + 1023) & ~1023u;
  const uint32_t s_k = s_q + 3 * tile_bytes<DK, BQ>(), s_v = s_k + 3 * tile_bytes<DK, BK>();
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int bh = blockIdx.x / n_q, qb = blockIdx.x - bh * n_q;
  const int b = bh / H, h = bh - b * H;
  const int q0 = qb * BQ, last_q = min(q0 + BQ, S) - 1;
  const long long base = b * st.sb + h * st.sh;
  const float *kh = k + base, *vh = v + base;

  stage_terms<DK, BQ, NT>(s_q, q + base + q0 * st.ss, st.ss, S - q0, D, scale, tid);

  // k-blocks that hold a key at or before the CTA's last query.
  const int n_k = causal ? last_q / BK + 1 : (S + BK - 1) / BK;
  const int row0 = q0 + wg * 64 + warp * 16;  // this warp's first query
  const uint32_t sq = s_q + wg * 64 * 128;     // this warpgroup's q rows
  float acc[padded<DK>() / 2];
#pragma unroll
  for (int i = 0; i < padded<DK>() / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < n_k; ++kb) {
    const int k0 = kb * BK, left = S - k0;
    __syncthreads();  // the last block's products are done with the terms
    stage_terms<DK, BK, NT>(s_k, kh + k0 * st.ss, st.ss, left, D, 1.f, tid);
    stage_terms<DK, BK, NT>(s_v, vh + k0 * st.ss, st.ss, left, D, 1.f, tid);
    fence_async_smem();
    __syncthreads();
    // As the bf16 kernel: a narrower last block, and no mask or scale on
    // a block that needs none (the scale is already in q's terms).
    if (left > 32)
      flash_block<DK, 64, true>(acc, m, l, sq, s_k, s_v, 1.f, row0, k0, S, causal);
    else if (left > 16)
      flash_block<DK, 32, true>(acc, m, l, sq, s_k, s_v, 1.f, row0, k0, S, causal);
    else
      flash_block<DK, 16, true>(acc, m, l, sq, s_k, s_v, 1.f, row0, k0, S, causal);
  }

  const float safe_l[2] = {l[0] > 0.f ? l[0] : 1.f, l[1] > 0.f ? l[1] : 1.f};  // fully masked rows
  store_rows_f32<DK>(acc, safe_l, o + ((long long)b * S * H + h) * D, (long long)H * D, row0, S, D);
  if ((threadIdx.x & 3) == 0) {
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i;
      if (row < S) lse[(long long)bh * S + row] = m[i] + logf(safe_l[i]);
    }
  }
}

template <int DK>
int launch_tc_f32(const void* q, const void* k, const void* v, void* o, float* lse, Strides st,
                  int B, int S, int H, int D, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = f32_smem_bytes<DK>();
  static_assert(bytes <= mpt_tc::kMaxSmem, "the f32 kernel's tiles exceed a CTA's shared memory");
  cudaError_t err = allow_smem(flash_fwd_tc_f32_kernel<DK>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_q = (S + kTcBlockQ - 1) / kTcBlockQ;
  flash_fwd_tc_f32_kernel<DK><<<n_q * B * H, 2 * mpt_tc::kWarpgroup, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, st, H, S, D, n_q, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// The tensor-core kernel: q, k, v bf16, strided [B, S, H, D] with the
// strides (sb, ss, sh) in elements and the head dim contiguous, D % 4 == 0
// and D <= 128, rows on any boundary (copied in the widest pieces they
// allow); out contiguous [B, S, H, D] bf16; lse f32 [B·H, S]. scale =
// D^-0.5 as the caller rounds it to f32. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a head dim it does not take).
extern "C" int mpt_flash_fwd_tc(const void* q, const void* k, const void* v, void* out, void* lse,
                                long long sb, long long ss, long long sh, int B, int S, int H,
                                int D, float scale, int causal, void* stream) {
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D < 4 || D > 128 || D % 4) return (int)cudaErrorInvalidValue;
  const int pieces = mpt_tc::row_pieces(
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v),
      sb | ss | sh, D);
  switch ((D + 15) / 16 * 16) {
#define MPT_CASE(dk) \
  case dk:           \
    return launch_tc<dk>(q, k, v, out, l, st, B, S, H, D, pieces, scale, causal, s);
    MPT_CASE(16) MPT_CASE(32) MPT_CASE(48) MPT_CASE(64)
    MPT_CASE(80) MPT_CASE(96) MPT_CASE(112) MPT_CASE(128)
#undef MPT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The f32 tensor-core kernel: q, k, v f32, strided [B, S, H, D] as above
// with every row 16-byte aligned, D % 4 == 0 and D <= 128; out contiguous
// [B, S, H, D] f32; lse f32 [B·H, S]. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a head dim it does not take).
extern "C" int mpt_flash_fwd_tc_f32(const void* q, const void* k, const void* v, void* out,
                                    void* lse, long long sb, long long ss, long long sh, int B,
                                    int S, int H, int D, float scale, int causal, void* stream) {
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D < 4 || D > 128 || D % 4) return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16 * 16) {
#define MPT_CASE(dk) \
  case dk:           \
    return launch_tc_f32<dk>(q, k, v, out, l, st, B, S, H, D, scale, causal, s);
    MPT_CASE(16) MPT_CASE(32) MPT_CASE(48) MPT_CASE(64)
    MPT_CASE(80) MPT_CASE(96) MPT_CASE(112) MPT_CASE(128)
#undef MPT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
