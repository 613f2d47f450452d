// Fused tiny-S attention, forward (K9) and recompute backward (K10), for
// sequences of S ≤ 128 keys and head dims D ≤ 128.
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
// Five kernels:
//   - attn_small_fwd_tc_kernel, the training forward for bf16 with
//     D % 16 == 0 and D <= 128: tensor cores (attention_tc.cuh), the path
//     vit_s16 trains through;
//   - attn_small_fwd_tc_f32_kernel, the forward for f32 with D % 4 == 0 and
//     D <= 128, training and inference: tensor cores on three-term bf16
//     splits (attention_tc.cuh);
//   - attn_small_fwd_kernel, the forward for bf16 with any other
//     D % 4 == 0, and every bf16 inference call (ops/fused_attention_small.py
//     `_route`): f32 FFMA on the CUDA cores, every sum in the order of the
//     plain f32 path (attention_tiles.cuh, small_fwd);
//   - attn_small_bwd_tc_kernel, the backward for bf16 with any D % 4 == 0
//     up to 128: tensor cores, the path vit_s16 trains through;
//   - attn_small_bwd_tc_f32_kernel, the backward for f32 with D % 4 == 0
//     and D <= 128: tensor cores on three-term bf16 splits.
//
// The tensor-core forward. Bound on an H100 by its bytes: q, k, v read and
// out written in bf16, 25.2 MB at vit_s16's 128 px training shape
// [128, 64, 6, 64], 7.5 µs at 3.35 TB/s, against 1.6 µs for its four bf16
// products (q·kᵀ, and p·v as three: the split p of attention_tc.cuh keeps
// it f32-exact). So the design keeps copies in flight rather than
// pushing the tensor-core rate: persistent CTAs, as many as fit on the
// card, each walk an even share of the (batch, head) pairs with the next
// head's q, k and v in flight (a two-stage cp.async ring) while the current
// one computes, so 768 heads leave no part-empty second wave. One
// warpgroup owns the 64 query rows of a head for S ≤ 64, two for
// 64 < S ≤ 128; the whole key row (64 or 128 keys, zero-filled past S and
// masked) is in registers, so the softmax is the whole-row one. 49 KB of
// shared memory at D = 64 and at most 128 registers a thread: four CTAs
// an SM. The copies land, and the output leaves through the head's q tile,
// in the swizzled layout of attention_tc.cuh, whole 128-byte rows per
// eight lanes: with a layout that split rows, issuing the copies and the
// stores took most of the kernel's time.
//
// The f32 tensor-core forward. The bf16 forward's warpgroups and
// whole-row softmax, with every product f32-exact: q·scale, k, v and p
// split into three bf16 terms, each product six exact term-pair products
// (attention_tc.cuh). Bound on an H100 by its bytes: f32 q, k, v read and
// out written, 50.3 MB at [128, 64, 6, 64], 15.0 µs at 3.35 TB/s, against
// 4.9 µs for its twelve bf16 products. Per head, the terms of q and k are
// split straight from device memory into two slots of shared memory, then
// v's into q's slot once q·kᵀ is done (49 KB at S ≤ 64, D ≤ 64: four CTAs
// an SM, whose loads and products overlap each other's); the output leaves
// in f32 straight from the fragment. For S ≤ 64 (one warpgroup) persistent
// CTAs, as many as fit on the card, each walk an even share of the heads,
// as the bf16 forward's do; for S > 64 (two warpgroups, two CTAs an SM)
// one CTA takes one head, which measured faster there on an H100. A raw
// f32 copy of the next head kept in flight by cp.async (as the bf16 kernel
// keeps its next head) measured slower: its shared memory halves the CTAs
// an SM.
//
// The tensor-core backward. Bound by its bytes too: q, k, v, do read and
// dq, dk, dv written in bf16, 44.0 MB at [128, 64, 6, 64], 13.1 µs at
// 3.35 TB/s, against 4.5 µs of bf16 tensor-core time for its eleven
// products (q·kᵀ and do·vᵀ exact; pᵀ·do, ds·k and dsᵀ·q three each). The
// same layout as the forward: persistent CTAs with the next head's q, k,
// v and do in flight, one warpgroup per 64 queries, the whole row in
// registers. Per head:
//   1. s = q·kᵀ and dp = do·vᵀ, both operands K-major from shared memory;
//   2. p = exp(s − m) / l in registers (exp2f), its three bf16 terms to
//      shared memory (`store_terms`), Δ = Σ_j p·dp (equal to the TPU
//      kernel's Σ_d do·o without recomputing o), ds = p·(dp − Δ);
//   3. dv = pᵀ·do: M runs over the keys, so A is the p terms read back
//      transposed (MN-major) from shared memory, do an MN-major B;
//   4. dq = ds·k·scale: ds from registers, split into three terms as the
//      forward's p·v splits p, k an MN-major B;
//   5. the ds terms replace the p terms; dk = dsᵀ·q·scale as dv.
// Rather than the FA2/FA3 backward's second pass with keys as rows (sᵀ =
// k·qᵀ recomputed, per-query m, l and Δ exchanged through shared memory),
// the transposed A operand reads the row pass's own terms: one softmax a
// head, no exchange. Rows past S are zero in q, k, v and do, so padded
// queries have dp = 0 and ds = 0 and add nothing to dk and dv; keys past S
// have p = 0. The outputs leave through the head's v tile (spent after
// step 1) as whole 128-byte rows, each warp through its own rows. Shared
// memory at S ≤ 64, D ≤ 64: a ring of two 32 KB stages and 24 KB of terms,
// 89 KB, two CTAs an SM; at S = 128, D = 128 the inputs take 128 KB and
// the terms 96 KB, so that shape runs with one stage. Each head's dk and dv
// belong to one CTA: no atomics, fixed-order sums, the same bits on every
// call. Any D % 4 == 0: instantiated per DK = D rounded up to 16, the real D
// at run time. q, k, v and do land with their columns D..DK−1 (and the rest
// of each 64-element row) zero at every load of a stage, so s = q·kᵀ and
// dp = do·vᵀ over DK/16 k-steps are the products over D, Δ and ds with
// them; dv, dq and dk come out zero in those columns and only their first
// D columns are stored. Rows that start on 8 bytes only (D = 36) are
// copied, and the gradients stored, in 8-byte pieces. Shared memory is
// DK's multiple of 64's (D = 40 takes D = 64's 89 KB). Such a call runs its
// own instantiation (kNarrow), so a head dim that is a multiple of 16 on
// 16-byte rows keeps D fixed at compile time.
//
// The f32 tensor-core backward. The bf16 backward's warpgroups, whole-row
// softmax, Δ = Σ_j p·dp and transposed p and ds terms, with every product
// f32-exact as in the f32 forward: q·scale, k, v and do split into three
// bf16 terms straight from device memory (`stage_terms`), and each of the
// five products six exact term-pair products summed smallest first (s and
// dp by `qk_issue` with six pairs; dq by `pv_product` on k's terms; dv and
// dk as six MN-major × MN-major pairs of the p or ds terms with do's or
// q·scale's, which bf16 wgmma allows and TF32's does not). dk = dsᵀ·(q·scale)
// reuses q's scaled terms. Bound on an H100 by its bytes: f32 q, k, v, do
// read and dq, dk, dv written, 88.1 MB at [128, 64, 6, 64], 26.3 µs at
// 3.35 TB/s, against 12.2 µs for its thirty bf16 products. Shared memory is
// what limits the layout: at S ≤ 64 with D ≤ 64 the terms of all four
// inputs stay for the whole head (do's and v's staged while q·kᵀ runs)
// and the p, then ds, terms take v's slot once do·vᵀ is done (97 KB, two
// CTAs an SM, persistent CTAs walking the heads). Elsewhere one input's
// terms alone take up to 96 KB (S = D = 128), so two slots hold what the
// next product needs and inputs are staged again from device memory
// between phases (q and k twice, mostly from L2): X holds k, then v, then
// the p and ds terms; Y q, then do, then k, then q. S > 64 takes one CTA a
// head, as the f32 forward.
//
// The FFMA forward. It serves vit_s16's bf16 inference (serving and
// validation), whose answers are held to the plain path's, so each of its
// sums runs in one fixed order: a score is one fmaf chain over d ascending
// from 0 on (q·scale rounded to f32, k); m the row's max; p = expf(s − m);
// l summed by a warp of 32 lanes (lane L over columns L, L + 32, ..., then
// the xor tree 16 … 1); p·v one fmaf chain over the keys ascending; ÷ l,
// then rounded to bf16. Its outputs are the bits of the one-CTA-a-head
// kernel it replaced, which took those orders.
// Bound on an H100 by its FFMA: 805 MFLOP at [128, 64, 6, 64], 12.0 us at
// 67 TFLOP/s (its bytes take 7.5 us). So the design feeds the FMA units:
//   - register micro-tiles of 8 rows by 4 (S <= 64) or 8 keys, and 8 rows
//     by 4 (D <= 64) or 8 head columns, whose operands come as 16-byte
//     shared-memory loads that bring one r (or one key) for several
//     outputs, never several r for one sum: q·scale transposed and p
//     transposed in each warp's own tile, k and v row-major in f32 tiles
//     (small_fwd in attention_tiles.cuh): 12 loads for 128 FFMA in the
//     scores and 3 for 32 in p·v, against 8 scalar loads for 16 of a 4×4
//     tile of threads;
//   - a warp owns 16 whole query rows, so the softmax runs in registers
//     with those lane partials and that tree, and p only passes through
//     the warp's own tile (no barrier of the CTA);
//   - persistent CTAs (four or eight warps) walk an even share of the
//     heads, each head's bf16 q, k and v read from device memory in
//     16-byte pieces straight into the f32 tiles (exact for k and v;
//     q·scale one f32 product): 49 KB at vit_s16's shape,
//     four CTAs an SM, whose reads and products overlap each other's. (A
//     cp.async stage of the next head, converted from shared memory,
//     measured slower on an H100: its 24 KB cost a CTA an SM.) Rows that
//     are not 16-byte aligned are read one element at a time;
//   - out rows leave through the warp's tile as 16-byte stores.
//
// The TPU kernel's bh-grouping (several heads stacked into one MXU tile
// with −1e30 cross-head blocks) and its sublane padding of S exist for the
// TPU's 128×128 matrix unit and are left behind. q, k and v are read in
// place as strided [B, S, H, D] views of the projections, with no
// transpose to [B·H, S, D].
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tc.cuh"
#include "attention_tiles.cuh"

namespace {

using namespace mpt_attn;
using mpt_tc::kMaxSmem;
using mpt_tc::padded;
using mpt_tc::kPieces16;
using mpt_tc::tile_bytes;
using bf16 = __nv_bfloat16;

// Eight bf16 (16 bytes) as f32: exact, each the bf16 bits in the high half.
__device__ __forceinline__ void unpack8(uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    f[2 * u] = __uint_as_float(w[u] << 16);
    f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
  }
}

// The bf16 forward on the CUDA cores (attention_tiles.cuh, small_fwd): a
// CTA of SP/16 warps (SP = 64 or 128 keys) walks `per_cta` heads; DH
// 64-column blocks of the head dim. Each head's q, k and v are read from
// device memory straight into the f32 tiles: 16 bytes at a time when `vec`
// (rows 16-byte aligned, D % 8 == 0), else one element at a time.
template <int SP, int DH>
__global__ void __launch_bounds__(2 * SP, SP == 64 ? (DH == 1 ? 4 : 2) : 1)
attn_small_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, Strides st, int H, int S,
                      int D, int BH, int per_cta, float scale, int causal, int vec) {
  using small_fwd::kRows;
  constexpr int NW = SP / 16, NT = 32 * NW, NB = SP / 16;
  extern __shared__ float smem[];
  const small_fwd::Smem L(SP, NW, D);
  unsigned char* const sm = reinterpret_cast<unsigned char*>(smem);
  float* const kf = reinterpret_cast<float*>(sm + L.k);
  float* const vf = reinterpret_cast<float*>(sm + L.v);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, lr = lane >> 4, lc = lane & 15;
  float* const own = reinterpret_cast<float*>(sm + L.own) + w * L.xp * kRows;  // this warp's tile
  const int nc = D / 8;  // 16-byte chunks a row (vec)
  const int first = blockIdx.x * per_cta, end = min(first + per_cta, BH);
  // Out rows leave in pieces of `per` elements: 16 bytes, or 8 where a row
  // is not a whole number of 16 bytes.
  const int per = D % 8 == 0 ? 8 : 4, n_out = D / per;

  for (int bh = first; bh < end; ++bh) {
    const long long hb = (bh / H) * st.sb + (bh % H) * st.sh;
    __syncthreads();  // the last head's tiles are spent
    // k and v into their f32 tiles (every thread: k's rows, then v's),
    // q·scale transposed into each warp's own tile (its 16 rows, zero past
    // S): q·scale rounds to f32, one product of the f32 q and the scale.
    if (vec) {
      for (int r = tid / nc, c = tid % nc; r < 2 * S; small_fwd::walk(r, c, NT / nc, NT % nc, nc)) {
        const bool is_v = r >= S;
        const int j = is_v ? r - S : r;
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>((is_v ? v : k) + hb + j * st.ss + 8 * c), f);
        float* dst = (is_v ? vf + j * L.vp : kf + j * L.kp) + 8 * c;
        *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
      }
      for (int i = lane; i < kRows * nc; i += 32) {
        const int x = i % kRows, c = i / kRows, row = kRows * w + x;
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (row < S) unpack8(*reinterpret_cast<const uint4*>(q + hb + row * st.ss + 8 * c), f);
#pragma unroll
        for (int u = 0; u < 8; ++u) own[(8 * c + u) * kRows + x] = f[u] * scale;
      }
    } else {
      for (int i = tid; i < 2 * S * D; i += NT) {
        const int t = i / (S * D), j = (i / D) % S, d = i % D;
        const float x = __bfloat162float((t ? v : k)[hb + j * st.ss + d]);
        (t ? vf + j * L.vp : kf + j * L.kp)[d] = x;
      }
      for (int i = lane; i < kRows * D; i += 32) {
        const int x = i % kRows, r = i / kRows, row = kRows * w + x;
        own[r * kRows + x] = row < S ? __bfloat162float(q[hb + row * st.ss + r]) * scale : 0.f;
      }
    }
    __syncthreads();  // the tiles are whole

    const int i0 = kRows * w + 8 * lr;  // this lane's first query
    float s[8][NB], l[8];
    small_fwd::scores<NB>(s, own + 8 * lr, kf + lc * L.kp, L.kp, D);
    small_fwd::softmax_rows<NB>(s, l, i0, lc, S, causal);
    __syncwarp();  // the warp's q is read: p takes its tile, transposed
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float* dst = own + kRows * (lc + 16 * b) + 8 * lr;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][b], s[1][b], s[2][b], s[3][b]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4][b], s[5][b], s[6][b], s[7][b]);
    }
    __syncwarp();
    float acc[8][4 * DH];
    small_fwd::pv<DH>(acc, own + 8 * lr, vf + 4 * lc, L.vp, S);
    __syncwarp();  // the warp's p is read: its rows of out take the tile
    bf16* const ob = reinterpret_cast<bf16*>(own);  // [16][D]
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int h = 0; h < DH; ++h) {
        const int col = 64 * h + 4 * lc;
        if (col >= D) continue;
        const float* x = acc[a] + 4 * h;
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(x[0] / l[a], x[1] / l[a]);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(x[2] / l[a], x[3] / l[a]);
        *reinterpret_cast<uint2*>(ob + (8 * lr + a) * D + col) =
            make_uint2(mpt_tc::bf16x2_bits(p0), mpt_tc::bf16x2_bits(p1));
      }
    __syncwarp();
    // The warp's rows to out (contiguous [B, S, H, D]).
    bf16* const ob_g = o + ((long long)(bh / H) * S * H + bh % H) * D;
    const long long os = (long long)H * D;
    for (int x = lane / n_out, c = lane % n_out; x < kRows;
         small_fwd::walk(x, c, 32 / n_out, 32 % n_out, n_out)) {
      const int row = kRows * w + x;
      if (row < S) {
        if (per == 8)
          *reinterpret_cast<uint4*>(ob_g + row * os + 8 * c) =
              *reinterpret_cast<const uint4*>(ob + x * D + 8 * c);
        else
          *reinterpret_cast<uint2*>(ob_g + row * os + 4 * c) =
              *reinterpret_cast<const uint2*>(ob + x * D + 4 * c);
      }
    }
  }
}

// ------------------------------------------------------ tensor cores ---

// Persistent CTAs: the heads each of `kernel`'s CTAs walks (*per_cta), an
// even share of the BH heads for every CTA that fits on the card at once.
template <typename Kernel>
cudaError_t heads_per_cta(Kernel kernel, int threads, int bytes, int BH, int* per_cta) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes)) !=
          cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int slots = sms * per_sm;
  *per_cta = (BH + slots - 1) / slots;
  return cudaSuccess;
}

// Shared memory: two stages of one head's (q, k, v) tiles of 64·NWG rows,
// bf16 rows padded to whole 128-byte atoms, plus 1 KB to start the tiles
// on 1024.
template <int D, int NWG>
constexpr int tc_small_smem_bytes() {
  return 6 * tile_bytes<D, 64 * NWG>() + 1024;
}

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * mpt_tc::kWarpgroup, NWG == 1 ? (D <= 64 ? 4 : 2) : 1)
attn_small_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         Strides st, int H, int S, int BH, int per_cta, float scale, int causal) {
  using namespace mpt_tc;
  constexpr int NK = 64 * NWG, NT = NWG * kWarpgroup;
  constexpr uint32_t kTile = tile_bytes<D, NK>(), kStage = 3 * kTile;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t raw = smem_addr(tc_smem), s0 = (raw + 1023) & ~1023u;
  unsigned char* smem = tc_smem + (s0 - raw);
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int first = blockIdx.x * per_cta, end = min(first + per_cta, BH);
  const int row0 = wg * 64 + warp * 16;  // this warp's first query

  auto load_head = [&](int bh, int stage) {
    const int b = bh / H, h = bh - b * H;
    const long long base = b * st.sb + h * st.sh;
    const uint32_t dst = s0 + stage * kStage;
    load_tile<D, NK>(dst, q + base, st.ss, S, D, kPieces16, tid, NT);
    load_tile<D, NK>(dst + kTile, k + base, st.ss, S, D, kPieces16, tid, NT);
    load_tile<D, NK>(dst + 2 * kTile, v + base, st.ss, S, D, kPieces16, tid, NT);
  };
  load_head(first, 0);
  cp_async_commit();

  for (int bh = first; bh < end; ++bh) {
    const int stage = (bh - first) & 1;
    __syncthreads();  // the last head's output has left the other stage
    if (bh + 1 < end) load_head(bh + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this head has landed
    fence_async_smem();
    __syncthreads();
    const uint32_t sq = s0 + stage * kStage, sk = sq + kTile, sv = sk + kTile;

    float s[NK / 2];
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kh = 0; kh < NWG; ++kh)  // 64 keys a product
      qk_issue<D, 64, NK, NK>(s + 32 * kh, sq + wg * 64 * 128, sk + kh * 64 * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NK / 2>(s);

    const float sc = prepare_scores<NK>(s, scale, row0, 0, S, causal);
    float l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = exp_sum<NK>(s, i, sc, row_max<NK>(s, i, sc));
    float acc[padded<D>() / 2];
#pragma unroll
    for (int i = 0; i < padded<D>() / 2; ++i) acc[i] = 0.f;
    pv_product<D, NK, NK>(acc, s, sv);

    // This warpgroup's q rows are free: each warp's p·v product took all
    // four warps' register operands, so all four are past q·kᵀ.
    const int b = bh / H, h = bh - b * H;
    store_rows<D, NK>(smem, sq - s0, wg * 64, acc, l, o + ((long long)b * S * H + h) * D,
                      (long long)H * D, wg * 64, S, D);
  }
  cp_async_wait<0>();
}

template <int D, int NWG>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, Strides st, int B, int S,
                  int H, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = tc_small_smem_bytes<D, NWG>(), threads = NWG * mpt_tc::kWarpgroup;
  auto kernel = attn_small_fwd_tc_kernel<D, NWG>;
  const int BH = B * H;
  int per_cta = 0;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) err = heads_per_cta(kernel, threads, bytes, BH, &per_cta);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(BH + per_cta - 1) / per_cta, threads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), st, H, S, BH, per_cta,
      scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd_tc_d(const void* q, const void* k, const void* v, void* o, Strides st, int B, int S,
                    int H, float scale, int causal, cudaStream_t stream) {
  if (S <= 64) return launch_fwd_tc<D, 1>(q, k, v, o, st, B, S, H, scale, causal, stream);
  return launch_fwd_tc<D, 2>(q, k, v, o, st, B, S, H, scale, causal, stream);
}

// ---------------------------------------------- f32 tensor-core forward ---
// Instantiated per DK = D rounded up to 16 (the k-steps of q·kᵀ); the real
// D masks the columns at run time.

// Shared memory of the f32 forward: two slots of three term tiles of
// 64·NWG rows (q's terms, then v's; k's) and 1 KB to start the tiles on
// 1024: 49 KB at S ≤ 64, D ≤ 64.
template <int DK, int NWG>
__host__ __device__ constexpr int f32_small_smem_bytes() {
  return 6 * mpt_tc::tile_bytes<DK, 64 * NWG>() + 1024;
}
// CTAs an SM by shared memory, at most 512 threads (128 registers each).
template <int DK, int NWG>
__host__ __device__ constexpr int f32_small_ctas() {
  return mpt_tc::kMaxSmem / f32_small_smem_bytes<DK, NWG>() < 4 / NWG
             ? mpt_tc::kMaxSmem / f32_small_smem_bytes<DK, NWG>()
             : 4 / NWG;
}

// One head (bh) of the f32 forward: q's and k's terms, the scores, v's
// terms into q's slot, the whole-row softmax and p·v, the output.
template <int DK, int NWG>
__device__ __forceinline__ void f32_small_head(const float* __restrict__ q,
                                               const float* __restrict__ k,
                                               const float* __restrict__ v, float* __restrict__ o,
                                               Strides st, int H, int S, int D, float scale,
                                               int causal, uint32_t s_a, int bh) {
  using namespace mpt_tc;
  constexpr int NK = 64 * NWG, NT = NWG * kWarpgroup;
  // With 128 keys a row the score fragment takes 64 registers: p·v splits
  // p one k-step at a time, so the products keep theirs.
  constexpr int KC = NWG == 2 ? 1 : 2;
  const uint32_t s_b = s_a + 3 * tile_bytes<DK, NK>();  // k's terms
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int row0 = wg * 64 + warp * 16;  // this warp's first query
  const int b = bh / H, h = bh - b * H;
  const long long base = b * st.sb + h * st.sh;

  stage_terms<DK, NK, NT>(s_a, q + base, st.ss, S, D, scale, tid);
  stage_terms<DK, NK, NT>(s_b, k + base, st.ss, S, D, 1.f, tid);
  fence_async_smem();
  __syncthreads();

  float s[NK / 2];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;
  wgmma_fence();
  qk_issue<DK, 64, NK, NK, 6, NWG>(s, s_a + wg * 64 * 128, s_b);  // 64 keys a product
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<NK / 2>(s);

  __syncthreads();  // every warpgroup's q·kᵀ is done with q's terms
  stage_terms<DK, NK, NT>(s_a, v + base, st.ss, S, D, 1.f, tid);
  fence_async_smem();
  __syncthreads();

  // The scale is in q's terms: the whole-row softmax takes the scores as
  // they are.
  const float sc = prepare_scores<NK>(s, 1.f, row0, 0, S, causal);
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = exp_sum<NK>(s, i, sc, row_max<NK>(s, i, sc));
  float acc[padded<DK>() / 2];
#pragma unroll
  for (int i = 0; i < padded<DK>() / 2; ++i) acc[i] = 0.f;
  pv_product<DK, NK, NK, true, KC>(acc, s, s_a);
  store_rows_f32<DK>(acc, l, o + ((long long)b * S * H + h) * D, (long long)H * D, row0, S, D);
}

// S ≤ 64 (NWG = 1): the CTA walks its share of the heads, from
// blockIdx.x·per_cta; S > 64: the CTA's one head, blockIdx.x (a loop, even
// of one trip, costs that kernel registers it does not have).
template <int DK, int NWG>
__global__ void __launch_bounds__(NWG * mpt_tc::kWarpgroup, f32_small_ctas<DK, NWG>())
attn_small_fwd_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o, Strides st,
                             int H, int S, int D, int BH, int per_cta, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t s_a = (mpt_tc::smem_addr(tc_smem) + 1023) & ~1023u;  // q's terms, then v's
  if constexpr (NWG == 1) {
    const int first = blockIdx.x * per_cta, end = min(first + per_cta, BH);
    for (int bh = first; bh < end; ++bh) {
      __syncthreads();  // the last head's p·v is done with v's terms
      f32_small_head<DK, NWG>(q, k, v, o, st, H, S, D, scale, causal, s_a, bh);
    }
  } else {
    f32_small_head<DK, NWG>(q, k, v, o, st, H, S, D, scale, causal, s_a, blockIdx.x);
  }
}

template <int DK, int NWG>
int launch_fwd_tc_f32(const void* q, const void* k, const void* v, void* o, Strides st, int B,
                      int S, int H, int D, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = f32_small_smem_bytes<DK, NWG>(), threads = NWG * mpt_tc::kWarpgroup;
  static_assert(bytes <= kMaxSmem, "the f32 forward's tiles exceed a CTA's shared memory");
  auto kernel = attn_small_fwd_tc_f32_kernel<DK, NWG>;
  const int BH = B * H;
  int per_cta = 1;  // S > 64: one CTA a head
  cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess && NWG == 1) err = heads_per_cta(kernel, threads, bytes, BH, &per_cta);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(BH + per_cta - 1) / per_cta, threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st, H, S, D, BH, per_cta, scale, causal);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_fwd_tc_f32_d(const void* q, const void* k, const void* v, void* o, Strides st, int B,
                        int S, int H, int D, float scale, int causal, cudaStream_t stream) {
  if (S <= 64) return launch_fwd_tc_f32<DK, 1>(q, k, v, o, st, B, S, H, D, scale, causal, stream);
  return launch_fwd_tc_f32<DK, 2>(q, k, v, o, st, B, S, H, D, scale, causal, stream);
}

// ------------------------------------------------ tensor-core backward ---

// The backward's shared memory: STAGES ring stages of one head's (q, k, v,
// do) tiles of 64·NWG rows (bf16 rows padded to whole 128-byte atoms), the
// three bf16 terms of p, then of ds, as [64·NWG queries × 64·NWG keys]
// tiles, and 1 KB to start the tiles on 1024. Two stages where they fit in
// a CTA's 227 KB, else one (S > 64 with D > 64: 128 KB of inputs and 96 KB
// of terms).
template <int NWG>
__host__ __device__ constexpr int bwd_tc_term_bytes() {
  return 64 * NWG * 64 * NWG * 2;
}
template <int DK, int NWG>
__host__ __device__ constexpr int bwd_tc_stages() {
  return 8 * tile_bytes<DK, 64 * NWG>() + 3 * bwd_tc_term_bytes<NWG>() + 1024 <= kMaxSmem ? 2 : 1;
}
template <int DK, int NWG>
__host__ __device__ constexpr int bwd_tc_smem_bytes() {
  return 4 * bwd_tc_stages<DK, NWG>() * tile_bytes<DK, 64 * NWG>() + 3 * bwd_tc_term_bytes<NWG>() +
         1024;
}

// The backward at DK (D rounded up to 16). kNarrow: q, k, v and do's first
// D columns (d_arg) copied in `pieces_arg` (attention_tc.cuh, `row_pieces`),
// the rest zeros; else D = DK on 16-byte rows, both fixed at compile time
// (every model's head dim: the run-time D measured slower at D = 64 on an
// H100).
template <int DK, int NWG, bool kNarrow>
__global__ void __launch_bounds__(NWG * mpt_tc::kWarpgroup, NWG == 1 && DK <= 64 ? 2 : 1)
attn_small_bwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         Strides st, int H, int S, int d_arg, int pieces_arg, int BH, int per_cta,
                         float scale, int causal) {
  using namespace mpt_tc;
  const int D = kNarrow ? d_arg : DK, pieces = kNarrow ? pieces_arg : kPieces16;
  constexpr int NK = 64 * NWG, NT = NWG * kWarpgroup, PD = padded<DK>();
  constexpr int ST = bwd_tc_stages<DK, NWG>();
  constexpr uint32_t kTile = tile_bytes<DK, NK>(), kStage = 4 * kTile;
  constexpr uint32_t kTerm = bwd_tc_term_bytes<NWG>();
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t raw = smem_addr(tc_smem), s0 = (raw + 1023) & ~1023u;
  unsigned char* smem = tc_smem + (s0 - raw);
  const uint32_t sp = s0 + ST * kStage;  // the terms of p, then of ds
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int first = blockIdx.x * per_cta, end = min(first + per_cta, BH);
  // This warp's first query (s, dp, ds, dq) and first key (dv, dk).
  const int row0 = wg * 64 + warp * 16;
  const long long gs = (long long)H * D;  // row stride of do, dq, dk, dv
  const float unit[2] = {1.f, 1.f}, scaled[2] = {scale, scale};

  auto load_head = [&](int bh, int stage) {
    const int b = bh / H, h = bh - b * H;
    const long long base = b * st.sb + h * st.sh;
    const uint32_t dst = s0 + stage * kStage;
    load_tile<DK, NK>(dst, q + base, st.ss, S, D, pieces, tid, NT);
    load_tile<DK, NK>(dst + kTile, k + base, st.ss, S, D, pieces, tid, NT);
    load_tile<DK, NK>(dst + 2 * kTile, v + base, st.ss, S, D, pieces, tid, NT);
    load_tile<DK, NK>(dst + 3 * kTile, dout + ((long long)b * S * H + h) * D, gs, S, D, pieces, tid,
                      NT);
  };
  if constexpr (ST == 2) {
    load_head(first, 0);
    cp_async_commit();
  }

  for (int bh = first; bh < end; ++bh) {
    const int stage = ST == 2 ? (bh - first) & 1 : 0;
    __syncthreads();  // the last head is done with its stage and the terms
    if constexpr (ST == 2) {
      if (bh + 1 < end) load_head(bh + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // this head has landed
    } else {
      load_head(bh, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();
    const uint32_t sq = s0 + stage * kStage, sk = sq + kTile, sv = sk + kTile, sdo = sv + kTile;

    // s = q·kᵀ and dp = do·vᵀ: this warpgroup's 64 queries, all NK keys.
    float s[NK / 2], dp[NK / 2];
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kh = 0; kh < NWG; ++kh) {  // 64 keys a product
      qk_issue<DK, 64, NK, NK>(s + 32 * kh, sq + wg * 64 * 128, sk + kh * 64 * 128);
      qk_issue<DK, 64, NK, NK>(dp + 32 * kh, sdo + wg * 64 * 128, sv + kh * 64 * 128);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NK / 2>(s);
    fence_regs<NK / 2>(dp);

    // p = exp(s − m) / l, normalized before any use; its terms to smem.
    const float sc = prepare_scores<NK>(s, scale, row0, 0, S, causal);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = exp_sum<NK>(s, i, sc, row_max<NK>(s, i, sc));
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        s[4 * j + 2 * i] /= l;
        s[4 * j + 2 * i + 1] /= l;
      }
    }
    store_terms<NK, NK>(smem, sp - s0, kTerm, row0, s);
    // Δ = Σ_j p·dp (= Σ_d do·o); ds = p·(dp − Δ) in place of dp.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float delta = 0.f;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) delta = fmaf(s[4 * j + 2 * i + e], dp[4 * j + 2 * i + e], delta);
      delta = quad_sum(delta);
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * j + 2 * i + e;
          dp[x] = s[x] * (dp[x] - delta);
        }
    }
    fence_async_smem();
    __syncthreads();  // every warpgroup's p terms are in; v is read (staging)

    const int b = bh / H, h = bh - b * H;
    const long long gbase = ((long long)b * S * H + h) * D;
    const uint32_t stage_rows = sv - s0;  // output staging: this warp's rows of v
    float acc[PD / 2];

    // dv = pᵀ·do over all NK queries: A the p terms, transposed.
#pragma unroll
    for (int i = 0; i < PD / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < 3; ++n)
#pragma unroll
        for (int j = 0; j < PD / 64; ++j)
          wgmma_ss_n64_mn(acc + 32 * j, mnmajor_desc<NK>(sp + n * kTerm, kk, wg),
                          mnmajor_desc<NK>(sdo, kk, j), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<PD / 2>(acc);
    store_rows<DK, NK, false>(smem, stage_rows, wg * 64, acc, unit, dv + gbase, gs, wg * 64, S, D);

    // dq = ds·k·scale: ds from registers, split as p is for p·v.
#pragma unroll
    for (int i = 0; i < PD / 2; ++i) acc[i] = 0.f;
    pv_product<DK, NK, NK>(acc, dp, sk);
    __syncwarp();
    store_rows<DK, NK, false>(smem, stage_rows, wg * 64, acc, scaled, dq + gbase, gs, wg * 64, S, D);

    __syncthreads();  // every warpgroup's dv has read the p terms
    store_terms<NK, NK>(smem, sp - s0, kTerm, row0, dp);
    fence_async_smem();
    __syncthreads();

    // dk = dsᵀ·q·scale over all NK queries: A the ds terms, transposed.
#pragma unroll
    for (int i = 0; i < PD / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < 3; ++n)
#pragma unroll
        for (int j = 0; j < PD / 64; ++j)
          wgmma_ss_n64_mn(acc + 32 * j, mnmajor_desc<NK>(sp + n * kTerm, kk, wg),
                          mnmajor_desc<NK>(sq, kk, j), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<PD / 2>(acc);
    __syncwarp();
    store_rows<DK, NK, false>(smem, stage_rows, wg * 64, acc, scaled, dk + gbase, gs, wg * 64, S, D);
  }
  cp_async_wait<0>();
}

template <int DK, int NWG>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* dout, void* dq,
                  void* dk, void* dv, Strides st, int B, int S, int H, int D, int pieces,
                  float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = bwd_tc_smem_bytes<DK, NWG>(), threads = NWG * mpt_tc::kWarpgroup;
  static_assert(bytes <= kMaxSmem, "the tensor-core backward's tiles exceed a CTA's shared memory");
  const auto kernel = D != DK || pieces != kPieces16 ? attn_small_bwd_tc_kernel<DK, NWG, true>
                                                     : attn_small_bwd_tc_kernel<DK, NWG, false>;
  const int BH = B * H;
  int per_cta = 0;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) err = heads_per_cta(kernel, threads, bytes, BH, &per_cta);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(BH + per_cta - 1) / per_cta, threads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), st, H, S, D, pieces, BH, per_cta, scale, causal);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_bwd_tc_d(const void* q, const void* k, const void* v, const void* dout, void* dq,
                    void* dk, void* dv, Strides st, int B, int S, int H, int D, int pieces,
                    float scale, int causal, cudaStream_t stream) {
  return S <= 64 ? launch_bwd_tc<DK, 1>(q, k, v, dout, dq, dk, dv, st, B, S, H, D, pieces, scale,
                                        causal, stream)
                 : launch_bwd_tc<DK, 2>(q, k, v, dout, dq, dk, dv, st, B, S, H, D, pieces, scale,
                                        causal, stream);
}

// -------------------------------------------- f32 tensor-core backward ---
// Instantiated per DK = D rounded up to 16, as the f32 forward.

// Bytes of one operand's three term tiles (64·NWG rows).
template <int DK, int NWG>
__host__ __device__ constexpr int f32_bwd_operand_bytes() {
  return 3 * tile_bytes<DK, 64 * NWG>();
}
// Resident: the terms of q, k, do and v all held for the whole head (the
// p and ds terms in v's slot once do·vᵀ is done): 97 KB, two CTAs an SM,
// at S ≤ 64 with D ≤ 64. Elsewhere two slots, X (k, then v, then the p and
// ds terms) and Y (q, then do, then k, then q again): each input is staged
// where it is next needed, q and k twice.
template <int DK, int NWG>
__host__ __device__ constexpr bool f32_bwd_resident() {
  return NWG == 1 && padded<DK>() == 64;
}
// Slot X holds an operand's terms or the three p (ds) term tiles.
template <int DK, int NWG>
__host__ __device__ constexpr int f32_bwd_slot_x() {
  constexpr int in = f32_bwd_operand_bytes<DK, NWG>(), p = 3 * bwd_tc_term_bytes<NWG>();
  return p > in ? p : in;
}
template <int DK, int NWG>
__host__ __device__ constexpr int f32_bwd_smem_bytes() {
  constexpr int in = f32_bwd_operand_bytes<DK, NWG>();
  return (f32_bwd_resident<DK, NWG>() ? 4 * in : f32_bwd_slot_x<DK, NWG>() + in) + 1024;
}

// dst = Σ over the six term pairs, smallest first, of Aᵀ·B: A the three
// term tiles of p or ds at sa (MN-major: this warpgroup's 64 keys, k-steps
// down the NK queries), B the three term tiles of do or q·scale at sb
// (MN-major: NK query rows, padded DK columns). Waited for.
template <int DK, int NK>
__device__ __forceinline__ void f32_bwd_keys_product(float* dst, uint32_t sa, uint32_t sb, int wg) {
  using namespace mpt_tc;
  constexpr int PD = padded<DK>();
  constexpr uint32_t TA = bwd_tc_term_bytes<NK / 64>(), TB = tile_bytes<DK, NK>();
#pragma unroll
  for (int i = 0; i < PD / 2; ++i) dst[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int n = 5; n >= 0; --n)
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < PD / 64; ++j)
        wgmma_ss_n64_mn(dst + 32 * j, mnmajor_desc<NK>(sa + pair_a(n) * TA, kk, wg),
                        mnmajor_desc<NK>(sb + pair_b(n) * TB, kk, j), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<PD / 2>(dst);
}

// One head (bh) of the f32 backward, from the shared memory at s0 (smem
// its generic address): every product six exact term-pair products.
template <int DK, int NWG>
__device__ __forceinline__ void f32_bwd_head(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const float* __restrict__ dout, float* __restrict__ dq,
                                             float* __restrict__ dk, float* __restrict__ dv,
                                             Strides st, int H, int S, int D, float scale,
                                             int causal, unsigned char* smem, uint32_t s0, int bh) {
  using namespace mpt_tc;
  constexpr int NK = 64 * NWG, NT = NWG * kWarpgroup, PD = padded<DK>();
  constexpr int KC = NWG == 2 ? 1 : 2;  // ds·k splits ds KC k-steps at a time
  constexpr bool RES = f32_bwd_resident<DK, NWG>();
  constexpr uint32_t IN = f32_bwd_operand_bytes<DK, NWG>(), kTerm = bwd_tc_term_bytes<NWG>();
  // Resident: q, k, do, v (then the p and ds terms) in four slots; else
  // the slots X (k, v, then the terms) and Y (q, do, k, q).
  const uint32_t s_x = RES ? s0 + IN : s0, s_y = RES ? s0 : s0 + f32_bwd_slot_x<DK, NWG>();
  const uint32_t s_q = s_y, s_k = s_x;
  const uint32_t s_do = RES ? s0 + 2 * IN : s_y, s_v = RES ? s0 + 3 * IN : s_x;
  const uint32_t s_p = s_v;  // the p terms, then the ds terms
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int row0 = wg * 64 + warp * 16;  // this warp's first query (s, ds, dq) and key (dv, dk)
  const int b = bh / H, h = bh - b * H;
  const long long base = b * st.sb + h * st.sh;
  const long long gs = (long long)H * D, gbase = ((long long)b * S * H + h) * D;
  const float unit[2] = {1.f, 1.f}, scaled[2] = {scale, scale};

  // s = (q·scale)·kᵀ, then dp = do·vᵀ; resident, do's and v's terms are
  // staged while q·kᵀ runs.
  stage_terms<DK, NK, NT>(s_q, q + base, st.ss, S, D, scale, tid);
  stage_terms<DK, NK, NT>(s_k, k + base, st.ss, S, D, 1.f, tid);
  fence_async_smem();
  __syncthreads();
  float s[NK / 2], dp[NK / 2];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
  qk_issue<DK, 64, NK, NK, 6, NWG>(s, s_q + wg * 64 * 128, s_k);
  wgmma_commit();
  if constexpr (!RES) {
    wgmma_wait<0>();
    fence_regs<NK / 2>(s);
    __syncthreads();  // every warpgroup's q·kᵀ is done with q's and k's terms
  }
  stage_terms<DK, NK, NT>(s_do, dout + gbase, gs, S, D, 1.f, tid);
  stage_terms<DK, NK, NT>(s_v, v + base, st.ss, S, D, 1.f, tid);
  fence_async_smem();
  __syncthreads();
  wgmma_fence();
  qk_issue<DK, 64, NK, NK, 6, NWG>(dp, s_do + wg * 64 * 128, s_v);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<NK / 2>(s);
  fence_regs<NK / 2>(dp);

  // p = exp(s − m) / l, normalized before any use (the scale is in q's
  // terms); Δ = Σ_j p·dp; ds = p·(dp − Δ) in place of dp.
  const float sc = prepare_scores<NK>(s, 1.f, row0, 0, S, causal);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = exp_sum<NK>(s, i, sc, row_max<NK>(s, i, sc));
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      s[4 * j + 2 * i] /= l;
      s[4 * j + 2 * i + 1] /= l;
    }
  }
  __syncthreads();  // every warpgroup's do·vᵀ is done with v's terms
  store_terms<NK, NK>(smem, s_p - s0, kTerm, row0, s);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float delta = 0.f;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) delta = fmaf(s[4 * j + 2 * i + e], dp[4 * j + 2 * i + e], delta);
    delta = quad_sum(delta);
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        dp[x] = s[x] * (dp[x] - delta);
      }
  }
  fence_async_smem();
  __syncthreads();  // every warpgroup's p terms are in

  // dv = pᵀ·do over all NK queries.
  float acc[PD / 2];
  f32_bwd_keys_product<DK, NK>(acc, s_p, s_do, wg);
  store_rows_f32<DK>(acc, unit, dv + gbase, gs, row0, S, D);

  // dq = ds·k·scale: ds from registers, split as the forward splits p.
  if constexpr (!RES) {
    __syncthreads();  // every warpgroup's dv is done with do's terms
    stage_terms<DK, NK, NT>(s_y, k + base, st.ss, S, D, 1.f, tid);
    fence_async_smem();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PD / 2; ++i) acc[i] = 0.f;
  pv_product<DK, NK, NK, true, KC>(acc, dp, RES ? s_k : s_y);
  store_rows_f32<DK, false>(acc, scaled, dq + gbase, gs, row0, S, D);

  // dk = dsᵀ·(q·scale): the ds terms replace the p terms.
  __syncthreads();  // every warpgroup's dv is done with the p terms, dq with k's
  store_terms<NK, NK>(smem, s_p - s0, kTerm, row0, dp);
  if constexpr (!RES) stage_terms<DK, NK, NT>(s_y, q + base, st.ss, S, D, scale, tid);
  fence_async_smem();
  __syncthreads();
  f32_bwd_keys_product<DK, NK>(acc, s_p, s_q, wg);
  store_rows_f32<DK>(acc, unit, dk + gbase, gs, row0, S, D);
}

// S ≤ 64 (NWG = 1): the CTA walks its share of the heads, from
// blockIdx.x·per_cta; S > 64: the CTA's one head, blockIdx.x, as the f32
// forward.
template <int DK, int NWG>
__global__ void __launch_bounds__(NWG * mpt_tc::kWarpgroup, NWG == 1 ? 2 : 1)
attn_small_bwd_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             float* __restrict__ dq, float* __restrict__ dk,
                             float* __restrict__ dv, Strides st, int H, int S, int D, int BH,
                             int per_cta, float scale, int causal) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t raw = mpt_tc::smem_addr(tc_smem), s0 = (raw + 1023) & ~1023u;
  unsigned char* smem = tc_smem + (s0 - raw);
  if constexpr (NWG == 1) {
    const int first = blockIdx.x * per_cta, end = min(first + per_cta, BH);
    for (int bh = first; bh < end; ++bh) {
      __syncthreads();  // the last head's dsᵀ·q is done with the terms
      f32_bwd_head<DK, NWG>(q, k, v, dout, dq, dk, dv, st, H, S, D, scale, causal, smem, s0, bh);
    }
  } else {
    f32_bwd_head<DK, NWG>(q, k, v, dout, dq, dk, dv, st, H, S, D, scale, causal, smem, s0,
                          blockIdx.x);
  }
}

template <int DK, int NWG>
int launch_bwd_tc_f32(const void* q, const void* k, const void* v, const void* dout, void* dq,
                      void* dk, void* dv, Strides st, int B, int S, int H, int D, float scale,
                      int causal, cudaStream_t stream) {
  constexpr int bytes = f32_bwd_smem_bytes<DK, NWG>(), threads = NWG * mpt_tc::kWarpgroup;
  static_assert(bytes <= kMaxSmem, "the f32 backward's tiles exceed a CTA's shared memory");
  auto kernel = attn_small_bwd_tc_f32_kernel<DK, NWG>;
  const int BH = B * H;
  int per_cta = 1;  // S > 64: one CTA a head
  cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess && NWG == 1) err = heads_per_cta(kernel, threads, bytes, BH, &per_cta);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(BH + per_cta - 1) / per_cta, threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), st, H, S, D, BH, per_cta, scale, causal);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_bwd_tc_f32_d(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        void* dk, void* dv, Strides st, int B, int S, int H, int D, float scale,
                        int causal, cudaStream_t stream) {
  return S <= 64
             ? launch_bwd_tc_f32<DK, 1>(q, k, v, dout, dq, dk, dv, st, B, S, H, D, scale, causal, stream)
             : launch_bwd_tc_f32<DK, 2>(q, k, v, dout, dq, dk, dv, st, B, S, H, D, scale, causal, stream);
}

// The bf16 FFMA forward over BH = B·H heads: persistent CTAs (an even
// share of the heads each, as many CTAs as fit), reading 16 bytes at a
// time when q, k and v rows are 16-byte aligned and D % 8 == 0.
template <int SP, int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, const Strides& st,
                       int B, int S, int H, int D, float scale, int causal, bool aligned,
                       cudaStream_t stream) {
  constexpr int NT = 2 * SP;
  const auto kernel = attn_small_fwd_kernel<SP, DH>;
  const int bytes = small_fwd::Smem(SP, SP / 16, D).bytes, BH = B * H;
  int per_cta = 0;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess || (err = heads_per_cta(kernel, NT, bytes, BH, &per_cta)) != cudaSuccess)
    return err;
  kernel<<<(BH + per_cta - 1) / per_cta, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), st, H, S, D, BH, per_cta, scale, causal, aligned && D % 8 == 0);
  return cudaGetLastError();
}

}  // namespace

// The FFMA forward: q, k, v bf16, strided [B, S, H, D] with the strides
// (sb, ss, sh) in elements and the head dim contiguous, S <= 128,
// D % 4 == 0 and D <= 128; out: contiguous [B, S, H, D] bf16. scale =
// D^-0.5 as the caller rounds it to f32. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int mpt_attn_small_fwd(const void* q, const void* k, const void* v, void* out,
                                  long long sb, long long ss, long long sh, int B, int S, int H,
                                  int D, float scale, int causal, void* stream) {
  if (S < 1 || S > 128 || D < 4 || D > 128 || D % 4) return (int)cudaErrorInvalidValue;
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
                       sb % 8 == 0 && ss % 8 == 0 && sh % 8 == 0;
  if (S <= 64)
    return (int)(D <= 64 ? launch_fwd<64, 1>(q, k, v, out, st, B, S, H, D, scale, causal, aligned, s)
                         : launch_fwd<64, 2>(q, k, v, out, st, B, S, H, D, scale, causal, aligned, s));
  return (int)(D <= 64 ? launch_fwd<128, 1>(q, k, v, out, st, B, S, H, D, scale, causal, aligned, s)
                       : launch_fwd<128, 2>(q, k, v, out, st, B, S, H, D, scale, causal, aligned, s));
}

// The tensor-core forward: q, k, v bf16, strided [B, S, H, D] as above with
// every row 16-byte aligned, S <= 128, D % 16 == 0 and D <= 128; out
// contiguous [B, S, H, D] bf16. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int mpt_attn_small_fwd_tc(const void* q, const void* k, const void* v, void* out,
                                     long long sb, long long ss, long long sh, int B, int S, int H,
                                     int D, float scale, int causal, void* stream) {
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > 128) return (int)cudaErrorInvalidValue;
  switch (D) {
#define MPT_CASE(d) \
  case d:           \
    return launch_fwd_tc_d<d>(q, k, v, out, st, B, S, H, scale, causal, s);
    MPT_CASE(16) MPT_CASE(32) MPT_CASE(48) MPT_CASE(64)
    MPT_CASE(80) MPT_CASE(96) MPT_CASE(112) MPT_CASE(128)
#undef MPT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The f32 tensor-core forward: q, k, v f32, strided [B, S, H, D] as above
// with every row 16-byte aligned, S <= 128, D % 4 == 0 and D <= 128; out
// contiguous [B, S, H, D] f32. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int mpt_attn_small_fwd_tc_f32(const void* q, const void* k, const void* v, void* out,
                                         long long sb, long long ss, long long sh, int B, int S,
                                         int H, int D, float scale, int causal, void* stream) {
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > 128 || D < 4 || D > 128 || D % 4) return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16 * 16) {
#define MPT_CASE(dk) \
  case dk:           \
    return launch_fwd_tc_f32_d<dk>(q, k, v, out, st, B, S, H, D, scale, causal, s);
    MPT_CASE(16) MPT_CASE(32) MPT_CASE(48) MPT_CASE(64)
    MPT_CASE(80) MPT_CASE(96) MPT_CASE(112) MPT_CASE(128)
#undef MPT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core backward: q, k, v bf16, strided as the FFMA forward takes
// them, rows on any boundary (copied in the widest pieces they allow);
// dout, dq, dk, dv contiguous [B, S, H, D] bf16; S <= 128, D % 4 == 0 and
// D <= 128. Returns cudaGetLastError() (cudaErrorInvalidValue for a shape
// it does not take).
extern "C" int mpt_attn_small_bwd_tc(const void* q, const void* k, const void* v,
                                     const void* dout, void* dq, void* dk, void* dv, long long sb,
                                     long long ss, long long sh, int B, int S, int H, int D,
                                     float scale, int causal, void* stream) {
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > 128 || D < 4 || D > 128 || D % 4) return (int)cudaErrorInvalidValue;
  const int pieces = mpt_tc::row_pieces(
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout),
      sb | ss | sh, D);
  switch ((D + 15) / 16 * 16) {
#define MPT_CASE(dk_) \
  case dk_:           \
    return launch_bwd_tc_d<dk_>(q, k, v, dout, dq, dk, dv, st, B, S, H, D, pieces, scale, causal, s);
    MPT_CASE(16) MPT_CASE(32) MPT_CASE(48) MPT_CASE(64)
    MPT_CASE(80) MPT_CASE(96) MPT_CASE(112) MPT_CASE(128)
#undef MPT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The f32 tensor-core backward: q, k, v f32 as the f32 forward takes them,
// dout (16-byte aligned), dq, dk, dv contiguous [B, S, H, D] f32; S <= 128,
// D % 4 == 0 and D <= 128. Returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int mpt_attn_small_bwd_tc_f32(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         long long sb, long long ss, long long sh, int B, int S,
                                         int H, int D, float scale, int causal, void* stream) {
  const Strides st{sb, ss, sh};
  auto s = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > 128 || D < 4 || D > 128 || D % 4) return (int)cudaErrorInvalidValue;
  switch ((D + 15) / 16 * 16) {
#define MPT_CASE(dk_) \
  case dk_:           \
    return launch_bwd_tc_f32_d<dk_>(q, k, v, dout, dq, dk, dv, st, B, S, H, D, scale, causal, s);
    MPT_CASE(16) MPT_CASE(32) MPT_CASE(48) MPT_CASE(64)
    MPT_CASE(80) MPT_CASE(96) MPT_CASE(112) MPT_CASE(128)
#undef MPT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
