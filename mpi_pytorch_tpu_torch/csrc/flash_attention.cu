// Flash attention forward (K8): block-tiled online-softmax attention that
// writes the output and the f32 logsumexp of every row. Three kernels:
//   - flash_fwd_tc_kernel, bf16 with D % 16 == 0 and D <= 128: tensor cores
//     (attention_tc.cuh), the path vit_s16 trains through;
//   - flash_fwd_tc_f32_kernel, f32 with D % 4 == 0 and D <= 128: tensor
//     cores on three-term bf16 splits (attention_tc.cuh), the f32 step's;
//   - flash_fwd_kernel, bf16 with any other D % 4 == 0, D <= 128: f32 FFMA
//     on the CUDA cores (attention_tiles.cuh), blocks of at most 128
//     queries and 128 keys as the caller gives them.
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
// through the q tile as 16-byte stores.
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
//
// The FFMA kernel. acc stays in registers (4×4 micro-tiles, at most four a
// thread), m, l and α in shared memory beside the f32 q tile, one k/v tile
// and the block's scores. Keys past S are left out of the block's sums,
// where the TPU kernel adds their exact zeros. Bounded by its operations
// at the f32 peak, it holds bf16 with a head dim the tensor-core kernel
// does not take.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tc.cuh"
#include "attention_tiles.cuh"

namespace {

using namespace mpt_attn;
using bf16 = __nv_bfloat16;

constexpr int kMaxBlock = 128;
constexpr int kMaxHeadDim = 128;
// Output micro-tiles a thread may own: ⌈128/4⌉·⌈128/4⌉ / kThreads.
constexpr int kMaxTiles = (kMaxBlock / 4) * (kMaxHeadDim / 4) / kThreads;

__host__ __device__ inline int flash_smem_floats(int BQ, int BK, int D) {
  return (BQ + BK) * odd_ld(D) + BQ * odd_ld(BK) + 3 * BQ;
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                 Strides st, int H, int S, int D, int BQ, int BK, int n_q, float scale,
                 int causal) {
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

  bf16* ob = o + ((long long)b * S * H + h) * D + (long long)q0 * H * D;
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
          if (y < D) ob[x * os + y] = from_f32<bf16>(acc[u][a][c] / safe_l);
        }
      }
    }
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const float l = l_s[i];
    lse[(long long)bh * S + q0 + i] = m_s[i] + logf(l > 0.f ? l : 1.f);
  }
}

// ------------------------------------------------------ tensor cores ---

constexpr int kTcBlockQ = 128;  // two warpgroups of 64 queries
constexpr int kTcBlockK = 64;

// Shared memory: the q tile, then two stages of (k, v) blocks, bf16 rows
// padded to whole 128-byte atoms, plus 1 KB to start the tiles on 1024.
template <int D>
constexpr int tc_smem_bytes() {
  return mpt_tc::tile_bytes<D, kTcBlockQ>() + 4 * mpt_tc::tile_bytes<D, kTcBlockK>() + 1024;
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

template <int D>
__global__ void __launch_bounds__(2 * mpt_tc::kWarpgroup, D <= 64 ? 2 : 1)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    float* __restrict__ lse, Strides st, int H, int S, int n_q, float scale,
                    int causal) {
  using namespace mpt_tc;
  constexpr int NT = 2 * kWarpgroup, BQ = kTcBlockQ, BK = kTcBlockK;
  constexpr uint32_t kTileQ = tile_bytes<D, BQ>(), kTileK = tile_bytes<D, BK>();
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

  load_tile<D, BQ>(s_q, q + base + q0 * st.ss, st.ss, S - q0, tid, NT);
  load_tile<D, BK>(s_kv, kh, st.ss, S, tid, NT);
  load_tile<D, BK>(s_kv + kTileK, vh, st.ss, S, tid, NT);
  cp_async_commit();

  // k-blocks that hold a key at or before the CTA's last query.
  const int n_k = causal ? last_q / BK + 1 : (S + BK - 1) / BK;
  const int row0 = q0 + wg * 64 + warp * 16;  // this warp's first query
  const uint32_t sq = s_q + wg * 64 * 128;     // this warpgroup's q rows
  float acc[padded<D>() / 2];
#pragma unroll
  for (int i = 0; i < padded<D>() / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int kb = 0; kb < n_k; ++kb) {
    if (kb + 1 < n_k) {  // the next block into the other stage
      const int k1 = (kb + 1) * BK;
      const uint32_t nxt = s_kv + ((kb + 1) & 1) * 2 * kTileK;
      load_tile<D, BK>(nxt, kh + k1 * st.ss, st.ss, S - k1, tid, NT);
      load_tile<D, BK>(nxt + kTileK, vh + k1 * st.ss, st.ss, S - k1, tid, NT);
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
      flash_block<D, 64>(acc, m, l, sq, sk, sv, scale, row0, k0, S, causal);
    else if (left > 16)
      flash_block<D, 32>(acc, m, l, sq, sk, sv, scale, row0, k0, S, causal);
    else
      flash_block<D, 16>(acc, m, l, sq, sk, sv, scale, row0, k0, S, causal);
    __syncthreads();  // every reader of this stage is done before it refills
  }
  cp_async_wait<0>();

  const float safe_l[2] = {l[0] > 0.f ? l[0] : 1.f, l[1] > 0.f ? l[1] : 1.f};  // fully masked rows
  // The q tile is free (the loop ended on a barrier after the last product).
  store_rows<D, BQ>(smem, 0, wg * 64, acc, safe_l, o + ((long long)b * S * H + h) * D,
                    (long long)H * D, q0 + wg * 64, S);
  if ((threadIdx.x & 3) == 0) {
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i;
      if (row < S) lse[(long long)bh * S + row] = m[i] + logf(safe_l[i]);
    }
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, Strides st, int B,
              int S, int H, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_q = (S + kTcBlockQ - 1) / kTcBlockQ;
  flash_fwd_tc_kernel<D><<<n_q * B * H, 2 * mpt_tc::kWarpgroup, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, st, H, S, n_q,
      scale, causal);
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

// The FFMA kernel: q, k, v bf16, strided [B, S, H, D] with the strides
// (sb, ss, sh) in elements and the head dim contiguous, D % 4 == 0 and
// D <= 128; out contiguous [B, S, H, D] bf16; lse f32 [B·H, S]; blocks of
// block_q queries and block_k keys (1..128). scale = D^-0.5 as the caller
// rounds it to f32. Returns cudaGetLastError() (cudaErrorInvalidValue for
// a block or head dim the kernel does not take).
extern "C" int mpt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             long long sb, long long ss, long long sh, int B, int S, int H, int D,
                             int block_q, int block_k, float scale, int causal, void* stream) {
  if (block_q < 1 || block_k < 1 || block_q > kMaxBlock || block_k > kMaxBlock ||
      D > kMaxHeadDim || D % 4)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * flash_smem_floats(block_q, block_k, D);
  cudaError_t err = allow_smem(flash_fwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_q = (S + block_q - 1) / block_q;
  flash_fwd_kernel<<<n_q * B * H, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), Strides{sb, ss, sh}, H, S, D, block_q,
      block_k, n_q, scale, causal);
  return (int)cudaGetLastError();
}

// The tensor-core kernel: q, k, v bf16, strided [B, S, H, D] as above with
// every row 16-byte aligned and D % 16 == 0, D <= 128; out contiguous
// [B, S, H, D] bf16; lse f32 [B·H, S]. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a head dim it does not take).
extern "C" int mpt_flash_fwd_tc(const void* q, const void* k, const void* v, void* out, void* lse,
                                long long sb, long long ss, long long sh, int B, int S, int H,
                                int D, float scale, int causal, void* stream) {
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
#define MPT_CASE(d) \
  case d:           \
    return launch_tc<d>(q, k, v, out, l, st, B, S, H, scale, causal, s);
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
