// The streaming predict heads on Hopper's tensor cores: per row of feats,
// the softmax cross-entropy and the first-index argmax of
// logits = feats·Wᵀ + b, without ever storing the [B, V] logits.
//
// Replaces three TPU kernels:
//  - K4, mpi_pytorch_tpu/ops/fused_head_ce.py:313 `_predict_kernel` (with
//    its epilogue `online_predict_update`, :259), for bf16 feats and W:
//    `mpt_head_predict_bf16`; for f32 feats and W (an f32 model keeps its
//    head in f32, as the JAX head_predict does): `mpt_head_predict_f32`,
//    each f32 product six exact bf16 products (the f32 route's section
//    below).
//  - K7, mpi_pytorch_tpu/ops/quantize.py:286 `_predict_int8_kernel`:
//    `mpt_head_predict_int8`. feats are first quantized by
//    quantize_activations' rule (quantize_rows_kernel), W is int8; the
//    int8 × int8 sums are exact int32, then float(acc)·scale_v[c] and + b[c]
//    as two separately rounded f32 operations (__fmul_rn, __fadd_rn: an FMA
//    would round once and give other bits than the plain version's).
//  - K5, mpi_pytorch_tpu/ops/fused_head_ce.py:71 `_fwd_kernel`, the forward
//    of the fused_head_ce training op: `mpt_head_ce_fwd`, K4's bf16 kernel
//    with no argmax kept (kArg = false: the fold takes the max alone and
//    the quad shuffles no column), and a merge that also writes the rows'
//    global (m, l), from which the backward (fused_head_ce_bwd.cu)
//    recomputes its softmax.
// Semantics carried over exactly: the argmax is the FIRST column attaining
// the max (a tie keeps the earlier column within a tile, across tiles,
// across the lanes of a quad and across splits), loss = log Σ exp(logit −
// m) + m − logit[label], and loss = 0 where label < 0.
//
// What bounds them on an H100 SXM (D = 512, V = 64 500):
//  - B = 1 (and up to B ≈ 128): the bytes of W, 66 MB bf16 (~20 us at
//    3.35 TB/s) or 33 MB int8 (~10 us). So W must stream at the full rate:
//    every SM needs many bytes of W in flight.
//  - B = 512: the products, 2·512·512·64 500 = 33.8 G operations: ~34 us
//    at 989 TFLOP/s bf16, ~17 us at 1 979 TOP/s int8. So the products must
//    run on wgmma with the tensor cores kept busy through the epilogue.
//  - f32: the bytes of the f32 W, 132 MB (~39 us), up to B ≈ 64; at B = 512
//    the six bf16 products a product, 203 G operations (~205 us).
//
// Design. Two passes, as the old kernels: the grid is (row tile, vocab
// split), the row tile fastest, so the CTAs that share a vocab split run
// together and read that slice of W from L2 after the first brings it
// from DRAM. Each CTA leaves its split's per-row state to the scratch;
// head_merge_kernel (head_common.cuh) finishes the rows, one warp a row.
// Within a CTA:
//  - A producer warpgroup, one lane of it issuing TMA copies
//    (cp.async.bulk.tensor, 128-byte swizzle, completing on mbarriers): the
//    CTA's feats tile once (64 rows a consumer warpgroup, every K chunk;
//    rows past B and columns past D land as zeros), then W in tiles of 128
//    vocab rows × 128 bytes of K (64 bf16 or 128 int8 values) through a
//    ring of 3–8 stages (as many as shared memory holds beside the feats
//    tile). Rows past V land as zeros. TMA rather than a cp.async ring: W's
//    strides are fixed for the call, so one tensor map, encoded on the host
//    per call through cudaGetDriverEntryPoint (no -lcuda), replaces the
//    consumers' address arithmetic and copy instructions. setmaxnreg moves
//    the producer's registers to the consumers.
//  - One consumer warpgroup (B ≤ 64) or two (B > 64, sharing every W stage:
//    W is read from L2 once per 128 rows). Each runs wgmma m64n128 with
//    both operands K-major in shared memory: k16 bf16 → f32, or k32
//    s8 × s8 → s32, one group in flight while the next stage is awaited. A
//    stage is released (one arrival a warp) once the group that read it has
//    completed.
//  - The epilogue folds the tile in registers once its products are done.
//    In wgmma's layout lane (g, t) of warp w holds rows 16w+g and 16w+g+8
//    at columns 8j+2t+e; each thread keeps its own online state a row over
//    its own columns, which it visits in ascending order (m, l with exp2f
//    on log2e-scaled differences, the first column attaining m, the
//    label's logit where it holds that column). The tile's bias (and
//    scale) is loaded as its products start and staged in shared memory,
//    read twice by the fold. The ragged vocab edge is masked to −inf before
//    the max: a zero-filled W row never wins. At the end of the split the
//    four lanes of a quad merge their states with a (value, column) shuffle
//    — equal values: the smaller column wins — and lane 0 writes the row.
//  - The streamed route (kStream), for a D too wide for the resident feats
//    tile to leave kMinStages W stages (bf16 D >= 2048, int8 D >= 4096: the
//    zoo's inception, alexnet and vgg heads; the JAX kernel takes the whole
//    D): each ring stage carries the CTA's feats chunk (64·C rows × the same
//    128 bytes of K) beside the W chunk, loaded by the same producer lane on
//    the same mbarrier, so no feats tile stays resident and the whole D
//    accumulates in registers a W tile at a time. feats is re-read from L2
//    once per W tile (4 MB at B = 512, D = 4096 bf16). The products, their
//    k-step order and the fold are the resident route's: the same bits.
// Determinism: fixed-order sums (k-steps ascending; a thread's columns
// ascending; fixed shuffle trees; a lane's splits ascending), no atomics:
// two calls on the same inputs give the same bits.
//
// The bf16/int8 kernel and its launchers are in head_predict_tc.cuh; the
// streamed route's instantiations compile in head_predict_wide.cu.
#include "head_predict_tc.cuh"

namespace {

using namespace mpt_hopper;

// ------------------------------------------------------ K4's f32 route ---
// f32 feats and W. Each f32 product is six exact bf16 products: feats and W
// split into three bf16 terms each (attention_tc.cuh's split3), the pairs
// (i, j), i + j <= 2, summed smallest first (pair_a, pair_b), as the f32
// attention kernels take theirs. The roles of the operands are swapped
// against the bf16 head: feats' three term tiles would take 3 KB a row at
// D = 512, 192 KB for 64 rows, leaving no room for W's f32 stages beside
// its terms, so feats is the resident shared-memory operand B (its terms
// split once per CTA, N = 8 or 64 batch rows) and W the register operand A
// of `wgmma ... m64nNk16` with A in registers: each consumer thread loads
// its fragment of the raw f32 W stage (TMA, 128-byte swizzle) and splits it
// in registers, so W is never held split in device memory or in shared
// memory, and a stage is released as soon as it is read. The accumulator
// is then [64 vocab rows × N batch rows] a warpgroup: each thread keeps an
// online state (max, its first column, sum of exp, the label's logit) for
// each of its N/4 batch rows over its two vocab rows a tile, ascending; at
// the end of the split the eight lanes that share a batch row, then the
// eight warps, merge (equal maxima going to the smaller column). Two
// consumer warpgroups (64 vocab rows of a 128-row tile each) alternate on
// the tensor cores: one splits its next stage while the other's products
// run.
constexpr int kF32Cols = kChunk / 4;  // K elements of f32 W a stage (two k-steps)

// Bytes of the three feats term tiles of N rows over D (whole 64-column
// atoms, padding zero).
__host__ __device__ constexpr int f32_terms_bytes(int N, int D) { return 3 * chunks(D, 2) * N * kChunk; }

// W stages that fit beside N rows of feats terms and N labels (0 when fewer
// than two do).
constexpr int f32_stages(int N, int D) {
  const int left = (kSmemLimit - 1024 - f32_terms_bytes(N, D) - 4 * N) / (kStageBytes + 16);
  return left < 2 ? 0 : (left > kMaxStages ? kMaxStages : left);
}

constexpr int f32_smem_bytes(int N, int D, int stages) {
  return 1024 + f32_terms_bytes(N, D) + stages * (kStageBytes + 16) + 4 * N;
}

// d[64 × N] (+)= A[64 × 16] · B[16 × N]: A (bf16 pairs) in registers, B
// K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs_kmajor(float* d, const uint32_t* a, uint64_t b,
                                                int accumulate);
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<64>(float* d, const uint32_t* a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : MPT_WG_F8(d, 0), MPT_WG_F8(d, 8), MPT_WG_F8(d, 16), MPT_WG_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<8>(float* d, const uint32_t* a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// A thread's online state for each of its N/4 batch rows (8j + 2t + e at
// index 2j + e).
template <int N>
struct ColState {
  float m[N / 4], l[N / 4], pick[N / 4];
  int arg[N / 4];
};

// Fold one tile's accumulators: this thread's vocab rows r0 and r0 + 8
// (rows at or past v_end masked to −inf), bias b0, b1, into the state of
// each of its batch rows; the labels of the CTA's rows in `lab`.
template <int N>
__device__ __forceinline__ void fold_f32(const float* acc, ColState<N>& st, int r0, int v_end,
                                         float b0, float b1, const int* lab, int t) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = 2 * j + e, col = 8 * j + 2 * t + e;
      const float x0 = r0 < v_end ? acc[4 * j + e] + b0 : -INFINITY;
      const float x1 = r0 + 8 < v_end ? acc[4 * j + 2 + e] + b1 : -INFINITY;
      const bool up = x1 > x0;  // strict: the first row keeps a tie
      const float mx = up ? x1 : x0;
      st.arg[q] = mx > st.m[q] ? (up ? r0 + 8 : r0) : st.arg[q];  // strict: an earlier tile keeps a tie
      const float mn = fmaxf(st.m[q], mx);
      const float mL = mn == -INFINITY ? 0.f : mn * kLog2e;
      st.l[q] = st.l[q] * exp2f(fmaf(st.m[q], kLog2e, -mL)) + exp2f(fmaf(x0, kLog2e, -mL)) +
                exp2f(fmaf(x1, kLog2e, -mL));
      st.m[q] = mn;
      const int lb = lab[col];
      st.pick[q] += (lb == r0 ? x0 : 0.f) + (lb == r0 + 8 ? x1 : 0.f);
    }
}

// This thread's A fragments of the two k-steps of one W stage at sb (128
// vocab rows × 32 f32, 128-byte swizzle), its vocab rows `row` and row + 8,
// split into three bf16 terms: t[kk][term][i + 2h] holds (row + 8i, k-step
// kk's columns 8h + 2t, 8h + 2t + 1).
__device__ __forceinline__ void load_split(const unsigned char* stage, int row, int t,
                                           uint32_t (&tm)[2][3][4]) {
  float2 x[2][2][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * i, c = 4 * kk + 2 * h + (t >> 1);
        x[kk][i][h] = *reinterpret_cast<const float2*>(stage + r * kChunk + ((c ^ (r & 7)) << 4) +
                                                       8 * (t & 1));
      }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t w[3];
        mpt_tc::split3(x[kk][i][h].x, x[kk][i][h].y, w);
#pragma unroll
        for (int n = 0; n < 3; ++n) tm[kk][n][i + 2 * h] = w[n];
      }
}

constexpr int kF32Consumers = 2;  // consumer warpgroups: 64 vocab rows of a tile each

template <int N>
__global__ void __launch_bounds__((kF32Consumers + 1) * kWarpgroup, 1)
head_predict_f32_kernel(const __grid_constant__ CUtensorMap w_map,  // [V, D] f32
                        const float* __restrict__ feats,            // [B, D]
                        const float* __restrict__ bias,             // [V]
                        const int* __restrict__ labels,             // [B]
                        float* __restrict__ part_mlp,  // [3, n_split, B]: m, l, picked
                        int* __restrict__ part_arg,    // [n_split, B]
                        int B, int D, int V, int tiles_per_split, int stages) {
  constexpr int C = kF32Consumers, NC = C * kWarpgroup;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = smem_addr(smem), base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem + (base - raw);
  const int nk = chunks(D, 2);                       // 64-column atoms of the feats terms
  const uint32_t T = nk * N * kChunk;                // bytes of one term tile
  const uint32_t feats_s = base, ring = base + 3 * T;
  const uint32_t full = ring + stages * kStageBytes, empty = full + 8 * stages;
  int* const lab = reinterpret_cast<int*>(sm + (empty + 8 * stages - base));
  const int ns = (D + kF32Cols - 1) / kF32Cols;      // W stages a tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * N, split = blockIdx.y, n_split = gridDim.y;
  const int v_begin = split * tiles_per_split * kBN;
  const int v_end = min(V, v_begin + tiles_per_split * kBN);
  const int n_tiles = (v_end - v_begin + kBN - 1) / kBN;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * C);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C) {  // the producer warpgroup: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (warp == 4 * C && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t)
        for (int s = 0; s < ns; ++s) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes at once
          mbar_expect_tx(full + 8 * stage, kStageBytes);
          tma_load_2d(ring + stage * kStageBytes, &w_map, s * kF32Cols, v_begin + t * kBN,
                      full + 8 * stage);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(232) : "memory");
  // The CTA's feats rows split into three term tiles (rows past B and
  // columns past D zero), and their labels (−1 past B).
  const int c4s = nk * 16;  // float4s a padded row
  for (int i = tid; i < N * c4s; i += NC) {
    const int r = i / c4s, c4 = i % c4s;
    const float4 x = row0 + r < B && 4 * c4 < D
                         ? *reinterpret_cast<const float4*>(feats + static_cast<size_t>(row0 + r) * D + 4 * c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t lo[3], hi[3];
    mpt_tc::split3(x.x, x.y, lo);
    mpt_tc::split3(x.z, x.w, hi);
    const uint32_t at = feats_s + swz<N>(r, c4 >> 1) + (c4 & 1) * 8;
#pragma unroll
    for (int n = 0; n < 3; ++n) mpt_tc::st_shared_v2(at + n * T, lo[n], hi[n]);
  }
  for (int i = tid; i < N; i += NC) lab[i] = row0 + i < B ? labels[row0 + i] : -1;
  fence_async_smem();
  named_barrier_sync(1, NC);

  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int row = 64 * wg + 16 * (warp & 3) + g;  // this thread's first vocab row of a tile
  ColState<N> st;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    st.m[q] = -INFINITY;
    st.l[q] = 0.f;
    st.pick[q] = 0.f;
    st.arg[q] = 0;
  }
  float acc[N / 2];
  uint32_t tm[2][3][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int r0 = v_begin + tile * kBN + row;
    const float b0 = r0 < v_end ? __ldg(bias + r0) : 0.f;
    const float b1 = r0 + 8 < v_end ? __ldg(bias + r0 + 8) : 0.f;
    for (int s = 0; s < ns; ++s) {
      mbar_wait(full + 8 * stage, phase);
      load_split(sm + (ring - base) + stage * kStageBytes, row, t, tm);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);  // read: the stage goes back at once
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
      wgmma_fence();
#pragma unroll
      for (int n = 5; n >= 0; --n)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          wgmma_rs_kmajor<N>(acc, tm[kk][mpt_tc::pair_a(n)],
                             kmajor_desc<N>(feats_s + mpt_tc::pair_b(n) * T, 2 * s + kk),
                             s > 0 || n < 5 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<N / 2>(acc);
      fence_regs<24>(&tm[0][0][0]);
    }
    fold_f32<N>(acc, st, r0, v_end, b0, b1, lab, t);
  }

  // The eight lanes that share a batch row (lane bits 2-4), then the eight
  // warps through shared memory (the ring, spent), in warp order.
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      merge_state(st.m[q], st.l[q], st.arg[q], st.pick[q],
                  __shfl_xor_sync(0xffffffffu, st.m[q], off),
                  __shfl_xor_sync(0xffffffffu, st.l[q], off),
                  __shfl_xor_sync(0xffffffffu, st.arg[q], off),
                  __shfl_xor_sync(0xffffffffu, st.pick[q], off));
  named_barrier_sync(1, NC);  // every stage is read
  float* const sm_m = reinterpret_cast<float*>(sm + (ring - base));
  float* const sm_l = sm_m + 4 * C * N;
  float* const sm_p = sm_l + 4 * C * N;
  int* const sm_a = reinterpret_cast<int*>(sm_p + 4 * C * N);
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = 2 * j + e, at = warp * N + 8 * j + 2 * t + e;
        sm_m[at] = st.m[q];
        sm_l[at] = st.l[q];
        sm_p[at] = st.pick[q];
        sm_a[at] = st.arg[q];
      }
  }
  named_barrier_sync(1, NC);
  if (tid < N && row0 + tid < B) {
    float m = sm_m[tid], l = sm_l[tid], pick = sm_p[tid];
    int arg = sm_a[tid];
    for (int w = 1; w < 4 * C; ++w) {
      const int at = w * N + tid;
      merge_state(m, l, arg, pick, sm_m[at], sm_l[at], sm_a[at], sm_p[at]);
    }
    const size_t plane = static_cast<size_t>(n_split) * B, o = static_cast<size_t>(split) * B + row0 + tid;
    part_mlp[o] = m;
    part_mlp[plane + o] = l;
    part_mlp[2 * plane + o] = pick;
    part_arg[o] = arg;
  }
}

// feats -> int8 by quantize_activations' rule: clamp(rint(x / act_scale)),
// the division correctly rounded, rint rounding half to even.
template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ x, signed char* __restrict__ q,
                                     long long n, float act_scale) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v;
  if constexpr (sizeof(T) == 2)
    v = __bfloat162float(x[i]);
  else
    v = x[i];
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, act_scale)), -127.f), 127.f);
  q[i] = static_cast<signed char>(static_cast<int>(r));
}

// ------------------------------------------------------------ host side ---
// The partial kernel over feats [B, D] and W [V, D] of Tr's type; kArg as
// for head_predict_tc_kernel. The wrapper plans the route (0 the resident
// feats tile, 1 the streamed one) and the rows a CTA (64 or 128: one or two
// consumer warpgroups); the resident route is refused where its feats tile
// leaves fewer than kMinStages W stages.
template <typename Tr, bool kArg = true>
cudaError_t launch_partial(const void* feats, const void* w, const float* bias,
                           const float* scale_v, const int* labels, float* part_mlp,
                           int* part_arg, int B, int D, int V, int n_split, int tiles_per_split,
                           int route, int rows, cudaStream_t s) {
  const int C = rows / 64;
  const int nk = chunks(D, Tr::kBytes);
  if ((rows != 64 && rows != 128) || (route != 0 && route != 1) ||
      (route == 0 && ring_stages(C, nk) == 0))
    return cudaErrorInvalidValue;
  CUtensorMap fm, wm;
  if (!encode_rows(&fm, Tr::kMap, feats, B, D, Tr::kBytes, 64 * C,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_rows(&wm, Tr::kMap, w, V, D, Tr::kBytes, kBN, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return cudaErrorNotSupported;
  if (route == 1)
    return mpt_head::launch_streamed(Tr::kBytes == 1 ? 2 : (kArg ? 0 : 1), C, fm, wm, bias,
                                     scale_v, labels, part_mlp, part_arg, B, V, n_split,
                                     tiles_per_split, nk, s);
  return launch_route<Tr, kArg, false>(C, fm, wm, bias, scale_v, labels, part_mlp, part_arg, B,
                                       V, n_split, tiles_per_split, nk, s);
}

// K4's f32 partial kernel over f32 feats [B, D] and W [V, D]: N batch rows
// a CTA (8 or 64, the wrapper's plan), W streamed in stages of 128 vocab rows × 32 columns.
template <int N>
cudaError_t launch_f32(const float* feats, const float* w, const float* bias, const int* labels,
                       float* part_mlp, int* part_arg, int B, int D, int V, int n_split,
                       int tiles_per_split, cudaStream_t s) {
  const int stages = f32_stages(N, D), bytes = f32_smem_bytes(N, D, stages);
  CUtensorMap wm;
  if (!encode_rows(&wm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, V, D, 4, kBN,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(head_predict_f32_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + N - 1) / N, n_split);
  head_predict_f32_kernel<N><<<grid, (kF32Consumers + 1) * kWarpgroup, bytes, s>>>(
      wm, feats, bias, labels, part_mlp, part_arg, B, D, V, tiles_per_split, stages);
  return cudaGetLastError();
}

}  // namespace

// K4's bf16 route: feats bf16 [B, D], w bf16 [V, D] (D % 16 == 0, 16-byte
// aligned), bias f32 [V], labels i32 [B] -> loss f32 [B], pred i32 [B].
// Scratch: part_mlp f32 [3, n_split, B], part_arg i32 [n_split, B]; the
// split geometry (tiles of mpt_head_tc_tile_vocab() rows) must cover V with
// no empty split; route and rows a CTA as launch_partial takes them.
extern "C" int mpt_head_predict_bf16(const void* feats, const void* w, const void* bias,
                                     const void* labels, void* loss, void* pred, void* part_mlp,
                                     void* part_arg, int B, int D, int V, int n_split,
                                     int tiles_per_split, int route, int rows, void* stream) {
  cudaError_t err = check_geometry(B, D, V, n_split, tiles_per_split, kBN);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* mlp = static_cast<float*>(part_mlp);
  int* arg = static_cast<int*>(part_arg);
  err = launch_partial<Bf16>(feats, w, static_cast<const float*>(bias), nullptr, lab, mlp, arg, B,
                             D, V, n_split, tiles_per_split, route, rows, s);
  if (err != cudaSuccess) return err;
  return launch_merge(mlp, arg, lab, static_cast<float*>(loss), static_cast<int*>(pred), nullptr,
                      nullptr, B, n_split, s);
}

// K5, the training cross-entropy forward: feats and w bf16 ([B, D],
// [V, D], D % 16 == 0, 16-byte aligned), bias f32 [V], labels i32 [B] ->
// loss, m, l f32 [B]: K4's bf16 partial kernel without its argmax, then the
// merge, which keeps each row's global max m and sum l for the backward.
// Scratch part_mlp f32 [3, n_split, B]; the split geometry, route and rows
// as for mpt_head_predict_bf16.
extern "C" int mpt_head_ce_fwd(const void* feats, const void* w, const void* bias,
                               const void* labels, void* loss, void* m, void* l, void* part_mlp,
                               int B, int D, int V, int n_split, int tiles_per_split,
                               int route, int rows, void* stream) {
  cudaError_t err = check_geometry(B, D, V, n_split, tiles_per_split, kBN);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* mlp = static_cast<float*>(part_mlp);
  err = launch_partial<Bf16, false>(feats, w, static_cast<const float*>(bias), nullptr, lab, mlp,
                                    nullptr, B, D, V, n_split, tiles_per_split, route, rows, s);
  if (err != cudaSuccess) return err;
  return launch_merge(mlp, nullptr, lab, static_cast<float*>(loss), nullptr,
                      static_cast<float*>(m), static_cast<float*>(l), B, n_split, s);
}

// K4's f32 route: feats f32 [B, D], w f32 [V, D] (D % 16 == 0, 16-byte
// aligned), bias f32 [V], labels i32 [B] -> loss f32 [B], pred i32 [B].
// Scratch and split geometry as for mpt_head_predict_bf16; N batch rows a
// CTA, 8 or 64, where their feats terms leave two W stages (the wrapper
// plans 64 above B = 8 where they fit, D <= 512, else 8).
extern "C" int mpt_head_predict_f32(const void* feats, const void* w, const void* bias,
                                    const void* labels, void* loss, void* pred, void* part_mlp,
                                    void* part_arg, int B, int D, int V, int n_split,
                                    int tiles_per_split, int N, void* stream) {
  cudaError_t err = check_geometry(B, D, V, n_split, tiles_per_split, kBN);
  if (err != cudaSuccess) return err;
  if ((N != 8 && N != 64) || f32_stages(N, D) == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(feats);
  const auto* wf = static_cast<const float*>(w);
  const auto* b = static_cast<const float*>(bias);
  const int* lab = static_cast<const int*>(labels);
  float* mlp = static_cast<float*>(part_mlp);
  int* arg = static_cast<int*>(part_arg);
  err = N == 64 ? launch_f32<64>(f, wf, b, lab, mlp, arg, B, D, V, n_split, tiles_per_split, s)
                : launch_f32<8>(f, wf, b, lab, mlp, arg, B, D, V, n_split, tiles_per_split, s);
  if (err != cudaSuccess) return err;
  return launch_merge(mlp, arg, lab, static_cast<float*>(loss), static_cast<int*>(pred), nullptr,
                      nullptr, B, n_split, s);
}

// K7: feats (dtype 0 = f32, 1 = bf16) [B, D] are quantized into the scratch
// feats_q int8 [B, D], then the int8 partial kernel and the merge run. w
// int8 [V, D]; scale_v, bias f32 [V]; labels i32 [B]; loss f32 [B]; pred
// i32 [B]; part_mlp, part_arg, the geometry, route and rows as for
// mpt_head_predict_bf16. Every pointer 16-byte aligned.
extern "C" int mpt_head_predict_int8(const void* feats, void* feats_q, const void* w,
                                     const void* scale_v, const void* bias, const void* labels,
                                     void* loss, void* pred, void* part_mlp, void* part_arg,
                                     int B, int D, int V, int n_split, int tiles_per_split,
                                     int route, int rows, float act_scale, int dtype,
                                     void* stream) {
  cudaError_t err = check_geometry(B, D, V, n_split, tiles_per_split, kBN);
  if (err != cudaSuccess) return err;
  if (!(act_scale > 0.f)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(B) * D;
  const unsigned qblocks = static_cast<unsigned>((n + 255) / 256);
  signed char* q = static_cast<signed char*>(feats_q);
  if (dtype == 1)
    quantize_rows_kernel<<<qblocks, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(feats), q, n,
                                                 act_scale);
  else if (dtype == 0)
    quantize_rows_kernel<<<qblocks, 256, 0, s>>>(static_cast<const float*>(feats), q, n, act_scale);
  else
    return cudaErrorInvalidValue;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int* lab = static_cast<const int*>(labels);
  float* mlp = static_cast<float*>(part_mlp);
  int* arg = static_cast<int*>(part_arg);
  err = launch_partial<Int8>(q, w, static_cast<const float*>(bias),
                             static_cast<const float*>(scale_v), lab, mlp, arg, B, D, V, n_split,
                             tiles_per_split, route, rows, s);
  if (err != cudaSuccess) return err;
  return launch_merge(mlp, arg, lab, static_cast<float*>(loss), static_cast<int*>(pred), nullptr,
                      nullptr, B, n_split, s);
}

// Vocab rows a tile of the tensor-core heads, which the wrappers plan their
// splits with.
extern "C" int mpt_head_tc_tile_vocab() { return kBN; }
