// Tensor-core building blocks of the attention kernels on Hopper (sm_90a):
// the forwards K8 (flash_attention.cu) and K9, and the tiny-S backward
// K10, each bf16 and f32 (K9 and K10 in fused_attention_small.cu).
// The generic Hopper primitives they use (the swizzle, cp.async, wgmma's
// descriptors and its fence / commit / wait) are in hopper.cuh.
//
// Products. `wgmma.mma_async` m64nNk16, bf16 operands, f32 sums: one
// warpgroup (four warps, 128 threads) owns a 64-row tile.
//   - Scores s = q·kᵀ (and the backward's dp = do·vᵀ): both operands from
//     shared memory, K-major. q and k stay unscaled bf16, so every product
//     is exact in f32; the scale is applied to each f32 score afterwards.
//     For D = 64 the scale is 2⁻³ and s is bit for bit the TPU kernel's
//     (q·scale)·kᵀ up to the order of summation; for any other D the
//     products stay exact instead of rounding q·scale to bf16.
//   - p·v (and the backward's ds·k): the softmax runs in registers on the
//     score fragment, whose layout is the A-operand layout of the next
//     product. The f32 p splits into bf16 terms, t0 = bf16(p), t1 = bf16(p
//     − t0), t2 = bf16(p − t0 − t1), each residual exact in f32. v is bf16,
//     so every tᵢ·v is an exact product; the wgmma steps (A from registers,
//     v from shared memory, MN-major) sum them into one f32 accumulator.
//     Two terms keep p to 2⁻¹⁷ relative (|p − t0| ≤ 2⁻⁸·p, and t1 rounds
//     that residual to 8 significant bits); at vit_s16's shapes that leaves
//     up to ~3e-6 on an output element, which crosses the kernels' check
//     (one bf16 ulp plus 1e-6 against the f32 plain version) at outputs
//     near zero, about one element in a million on the card. The third term
//     takes p to 2⁻²⁵, below f32's own rounding: p·v is the f32 product the
//     TPU kernel takes. A single bf16 p would be off by up to 2⁻⁸ — a
//     different function.
//   - pᵀ·do and dsᵀ·q (the backward's dv and dk, rows over the keys): the
//     three terms of p or ds go to shared memory in the swizzled layout
//     (`store_terms`), rows over the queries, and are read back as an
//     MN-major (transposed) A operand, which wgmma allows for 16-bit types.
//
// Staging. q, k and v land in shared memory as bf16 by 16-byte `cp.async`
// copies, straight into the layout wgmma's shared-memory descriptors read
// with the 128-byte swizzle: rows of 64 elements (128 bytes; D padded up
// to a multiple of 64 with zeros), the 16-byte chunk c of row r at
// position c ^ (r % 8). Eight threads copy one whole 128-byte row, so a
// warp's copy touches four full lines of device memory and four rows of
// shared memory without a bank conflict; the output leaves the same way.
// K8's and K10's bf16 kernels take any D % 4 == 0 up to 128: each is
// instantiated per DK = D rounded up to 16 (the k-steps of q·kᵀ and do·vᵀ),
// with the real D given at run time (or, for D = DK on 16-byte rows, fixed
// at compile time), and the columns D..DK−1 are zeros written at every
// load, so they add exact zeros to every product. Rows that start on 8
// bytes only (D % 8 == 4, or the first D columns of a wider view) are
// copied in 8-byte pieces, and rows on 2 or 4 bytes element by element
// (`load_tile`); the output's first D columns leave in 16- or 8-byte
// pieces (`store_rows`).
// (With a layout whose copies split rows into half lines, issuing the
// copies and the stores took most of K9's time on an H100.) No TMA
// descriptor is encoded per call for operands whose strides change
// per call (the fused-qkv projection's row stride is 3·H·D). Rows past S
// are zero-filled, so no stale value (a NaN) meets a zero probability. The
// kernels keep the next k/v block (K8) or the next head (K9, K10) in
// flight while the current one computes.
//
// The f32 kernels (the forwards and K10's backward). An f32 value x splits
// into three bf16 terms, each rounded to nearest: t0 = bf16(x), t1 =
// bf16(x − t0), t2 = bf16(x − t0 − t1); each residual is exact in f32 and
// the three keep x to ~2⁻²⁴ relative. A product a·b keeps the six term
// pairs (i, j) with i + j ≤ 2 (a0b0, a0b1, a1b0, a0b2, a1b1, a2b0), each an
// exact bf16 product, summed in the reverse order (smallest first: the
// tensor cores' f32 sums are not rounded to nearest, so the large products
// meet the accumulator last) into one f32 accumulator: the pairs left out
// are below 2⁻²⁴ of the product. So s = (q·scale)·kᵀ is six products of
// the terms of q·scale and k (both K-major in shared memory: `qk_product`
// with P = 6), and p·v six of p's terms (registers, as `split_p`) and v's
// (MN-major: `pv_product` with F32); the backward's dp = do·vᵀ and ds·k the
// same way, and its pᵀ·do and dsᵀ·q six pairs of MN-major term tiles.
// Three pairs (i + j ≤ 1) leave ~1e-5 of the output: a different function
// at the f32 checks' level. Six bf16 products take the tensor cores as long
// as three TF32 ones (989 against 495 TFLOP/s), and TF32's wgmma takes both
// shared-memory operands K-major only, which would need v transposed. The
// f32 inputs become their terms on the way into shared memory
// (`stage_terms`): read as float4 rows from device memory, split, and
// written as three swizzled bf16 tiles (padding columns zero), where each
// is first needed; the CTAs beside it on the SM hide the loads. (A raw f32 copy of the next block kept in
// flight by cp.async, split from shared memory, measured slower on an
// H100: the copy's shared memory costs a CTA an SM.) The output leaves as
// f32 pairs straight from the fragment (`store_rows_f32`).
//
// Determinism: fixed-order sums (the k-steps ascending, then a fixed
// shuffle tree within each quad of lanes), no atomics: two calls on the
// same inputs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace mpt_tc {

using namespace mpt_hopper;  // swizzle, cp.async, descriptors, wgmma sync
using mpt_attn::kNeg;
using mpt_attn::Strides;

// A CTA's shared memory on an H100 (227 KB).
constexpr int kMaxSmem = 232448;

// ---------------------------------------------------------------- tiles ---
// D padded up to whole 64-element (128-byte) rows: the swizzle atom's width.
template <int D>
__host__ __device__ constexpr int padded() {
  return (D + 63) / 64 * 64;
}

// Bytes of an R-row bf16 tile of padded rows (one term of a split operand).
template <int D, int R>
__host__ __device__ constexpr int tile_bytes() {
  return R * padded<D>() * 2;
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint32_t a, uint32_t b) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b) : "memory");
}

// How `load_tile` copies an operand's rows: 16-byte pieces where every row
// starts on 16 bytes (and so D % 8 == 0); 8-byte pieces where the rows
// start on 8 bytes (D % 8 == 4, or the first D columns of a wider view);
// else four elements at a time through registers (a view whose rows start
// on 2 or 4 bytes). The same bf16 values land either way.
enum RowPieces : int { kPieces16 = 0, kPieces8 = 1, kPiecesElem = 2 };

// The pieces for bf16 operands of head dim D (a multiple of 4) given the
// bitwise or of their addresses and of their element strides.
__host__ inline int row_pieces(uintptr_t addresses, long long strides, int D) {
  const unsigned long long bytes = addresses | (unsigned long long)(2 * strides) | (2u * D);
  return bytes % 16 == 0 ? kPieces16 : bytes % 8 == 0 ? kPieces8 : kPiecesElem;
}

// R rows × D elements (D a multiple of 4, at most DK) of a [.., S, .., D]
// operand (row stride ss elements, the head dim contiguous) into the R-row
// tile at dst, laid out for the k-steps of DK = D rounded up to 16: rows
// at or past `valid`, and every column at or past D, are written as zeros
// at every load, so a reused ring stage or a persistent CTA's next head
// never keeps a stale value (an Inf or NaN would turn a product with the
// zero of the other operand into NaN). 16-byte pieces: eight consecutive
// threads copy one row, so a warp reads four whole 128-byte rows and
// writes four swizzled rows of shared memory; 8-byte pieces and elements
// (`pieces`): sixteen threads a row, each piece the half of a swizzled
// 16-byte chunk.
template <int DK, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long long ss,
                                          int valid, int D, int pieces, int t, int nt) {
  if (pieces == kPieces16) {
    constexpr int NC = padded<DK>() / 8;  // 16-byte chunks a row
    for (int i = t; i < R * NC; i += nt) {
      const int r = i / NC, c = i % NC;
      const bool ok = r < valid && c < D / 8;
      cp_async16(dst + swz<R>(r, c), ok ? src + r * ss + c * 8 : src, ok);
    }
    return;
  }
  constexpr int NH = padded<DK>() / 4;  // 8-byte halves a row
  for (int i = t; i < R * NH; i += nt) {
    const int r = i / NH, c = i % NH;
    const bool ok = r < valid && c < D / 4;
    const uint32_t at = dst + swz<R>(r, c >> 1) + (c & 1) * 8;
    const __nv_bfloat16* from = src + r * ss + c * 4;
    if (pieces == kPieces8) {
      cp_async8(at, ok ? from : src, ok);
    } else {
      uint32_t lo = 0, hi = 0;
      if (ok) {
        const unsigned short* e = reinterpret_cast<const unsigned short*>(from);
        lo = e[0] | (uint32_t)e[1] << 16;
        hi = e[2] | (uint32_t)e[3] << 16;
      }
      st_shared_v2(at, lo, hi);
    }
  }
}

// ---------------------------------------------------------------- wgmma ---

// d[64 × 64] (+)= A[64 × 16] · B[16 × 64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : MPT_WG_F8(d, 0), MPT_WG_F8(d, 8), MPT_WG_F8(d, 16), MPT_WG_F8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 × 32] (+)= A[64 × 16] · B[16 × 32]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : MPT_WG_F8(d, 0), MPT_WG_F8(d, 8)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 × 16] (+)= A[64 × 16] · B[16 × 16]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : MPT_WG_F8(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 × 64] += A[64 × 16] · B[16 × 64]: A in registers, B MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MPT_WG_F8(d, 0), MPT_WG_F8(d, 8), MPT_WG_F8(d, 16), MPT_WG_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 × 64] (+)= A[64 × 16] · B[16 × 64]: A and B MN-major in shared
// memory (A transposed: its 64 rows contiguous, its k-step down the rows).
__device__ __forceinline__ void wgmma_ss_n64_mn(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : MPT_WG_F8(d, 0), MPT_WG_F8(d, 8), MPT_WG_F8(d, 16), MPT_WG_F8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The register fragments. A warpgroup's 64 × N f32 accumulator: warp w
// holds rows 16w..16w+15; lane (g = lane/4, t = lane%4) holds, for each
// 8-column block j, d[4j + 2i + e] = (row 16w + g + 8i, column 8j + 2t + e),
// i, e ∈ {0, 1}. The A fragment of k-step kk (columns 16kk..16kk+15) is
// the four bf16 pairs of d[8kk .. 8kk+7] in order, so the scores of one
// product become the left operand of the next without leaving registers.

// Row i's (i ∈ {0, 1}) max and sum over a quad of lanes: fixed shuffle tree.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The score fragment of N keys from column col0, this warp's rows from
// row0: s ← s·scale, or −1e30 where the key lies at or past S or, when
// causal, past the query.
template <int N>
__device__ __forceinline__ void scale_mask(float* s, float scale, int row0, int col0, int S,
                                           int causal) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + 8 * j + 2 * t + (e & 1), row = row0 + g + 8 * (e >> 1);
      s[4 * j + e] = (col >= S || (causal && col > row)) ? kNeg : s[4 * j + e] * scale;
    }
}

// Whether a warp's block of N keys from col0 needs no mask: every key is
// real and, when causal, none lies past the warp's first query (row0).
// The same for the whole warp, so the branch on it does not diverge.
template <int N>
__device__ __forceinline__ bool unmasked(int row0, int col0, int S, int causal) {
  return col0 + N <= S && !(causal && col0 + N - 1 > row0);
}

// The fragment's scores as the softmax takes them: unscaled where the
// block needs no mask (the scale then rides in `exp_sum`'s FMA: for a
// power-of-two scale, as for D = 64, fma(s, scale, −m) is bit for bit
// s·scale − m), else scaled and masked by `scale_mask`. Returns the factor
// still to apply (scale or 1).
template <int N>
__device__ __forceinline__ float prepare_scores(float* s, float scale, int row0, int col0, int S,
                                                int causal) {
  if (unmasked<N>(row0, col0, S, causal)) return scale;
  scale_mask<N>(s, scale, row0, col0, S, causal);
  return 1.f;
}

// Row i's max of the fragment times sc (every entry is ≥ −1e30; sc > 0,
// so this is the max of the scaled scores).
template <int N>
__device__ __forceinline__ float row_max(const float* s, int i, float sc) {
  float m = kNeg;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) m = fmaxf(m, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
  return quad_max(m) * sc;
}

// Row i: s ← exp(s·sc − m) in place; returns the row's sum of them.
// exp(x) is taken as 2^(x·log2 e) (a multiply and the hardware's base-2
// exponential, against ~8 instructions for expf: the softmax's largest
// cost): x·log2 e rounds to f32 and ex2 is good to ~2⁻²², so p carries a
// relative error of ~2e-7 for the p that matter (|x| of a few units),
// against expf's ~1e-7. x itself is formed as before, so a fully masked
// row still gets x = 0 and p = 1, as the TPU kernel's.
template <int N>
__device__ __forceinline__ float exp_sum(float* s, int i, float sc, float m) {
  constexpr float kLog2e = 1.4426950408889634f;
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p = exp2f(fmaf(s[4 * j + 2 * i + e], sc, -m) * kLog2e);
      s[4 * j + 2 * i + e] = p;
      l += p;
    }
  return quad_sum(l);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The three bf16 terms of the pair (x0, x1), round-to-nearest each, as
// bf16x2 words: t[0] = bf16(x), t[1] = bf16(x − t0), t[2] = bf16(x − t0 − t1).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    t[i] = bf16x2_bits(h);
    x0 -= hf.x;  // exact: the residual of a rounding to fewer bits
    x1 -= hf.y;
  }
}

// The three bf16 terms (t0, t1, t2) of the A fragments of K k-steps of
// the f32 p fragment, round-to-nearest each.
template <int K>
__device__ __forceinline__ void split_p(const float* p, uint32_t (*t)[3][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t w[3];
      split3(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1], w);
#pragma unroll
      for (int i = 0; i < 3; ++i) t[kk][i][r] = w[i];
    }
}

// The six term pairs (i, j), i + j ≤ 2, of a product of two three-term
// splits, largest first: a0b0, a0b1, a1b0, a0b2, a1b1, a2b0. The f32
// products sum them smallest first (n = 5 down to 0): a wgmma's f32 sum
// is not rounded to nearest on an H100 but loses up to a few units in the
// last place of the accumulator, so the terms of order 2⁻¹⁶ and 2⁻⁸ go in
// while the accumulator is small, and only the a0b0 products meet it at
// full size.
__host__ __device__ constexpr int pair_a(int n) {
  constexpr int a[6] = {0, 0, 1, 0, 1, 2};
  return a[n];
}
__host__ __device__ constexpr int pair_b(int n) {
  constexpr int b[6] = {0, 1, 0, 2, 1, 0};
  return b[n];
}

// o[64 × padded D] += A[64 × 16] · v[k-step kk's 16 keys × padded D]: one
// n64 product per 64 columns of v's RV-row tile at sv.
template <int D, int RV>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* a, uint32_t sv, int kk) {
#pragma unroll
  for (int j = 0; j < padded<D>() / 64; ++j)
    wgmma_rs_n64(o + 32 * j, a, mnmajor_desc<RV>(sv, kk, j));
}

// o[64 × padded D] += p·v over N keys (N a multiple of 16), p the f32
// score fragment. bf16 v (an RV-row tile at sv) is its own first term, so
// the pairs are p's three terms against it, in the order k-step, then
// term; F32: v is a three-term split (three RV-row tiles from sv) and the
// pairs are all six, in the order pair (smallest first), then k-step. K
// k-steps at a time (by default up to 32 keys): their three terms each (at
// most 24 registers, live until the products complete).
template <int D, int N, int RV, bool F32 = false, int K = (N < 32 ? N / 16 : 2)>
__device__ __forceinline__ void pv_product(float* o, const float* p, uint32_t sv) {
  constexpr uint32_t TV = tile_bytes<D, RV>();
#pragma unroll
  for (int c = 0; c < N / (16 * K); ++c) {
    uint32_t t[K][3][4];
    split_p<K>(p + 8 * K * c, t);
    wgmma_fence();
    if constexpr (F32) {
#pragma unroll
      for (int n = 5; n >= 0; --n)
#pragma unroll
        for (int kk = 0; kk < K; ++kk)
          pv_step<D, RV>(o, t[kk][pair_a(n)], sv + pair_b(n) * TV, K * c + kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int n = 0; n < 3; ++n) pv_step<D, RV>(o, t[kk][n], sv, K * c + kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<padded<D>() / 2>(o);
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int i = 0; i < 3; ++i) fence_regs<4>(t[kk][i]);
  }
}

// s[64 × NH·N] = q[64 rows at sq of an RQ-row tile] · k[NH·N rows at sk
// of an RK-row tile]ᵀ over D (a multiple of 16; N = 16, 32 or 64, and NH
// products of 64 keys, the h-th into s + 32h, when NH > 1): issued, not
// waited for. P = 6: q and k are three-term splits (three tiles each from
// sq and sk) and the six pairs are summed, pair by pair, smallest first,
// each over every k-step; P = 1 takes the first tile of each (bf16).
template <int D, int N, int RQ, int RK, int P = 1, int NH = 1>
__device__ __forceinline__ void qk_issue(float* s, uint32_t sq, uint32_t sk) {
  constexpr uint32_t TQ = tile_bytes<D, RQ>(), TK = tile_bytes<D, RK>();
  static_assert(NH == 1 || N == 64, "several key products are 64 keys each");
#pragma unroll
  for (int n = P - 1; n >= 0; --n)
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint64_t a = kmajor_desc<RQ>(sq + pair_a(n) * TQ, ks);
      const int accumulate = ks > 0 || n < P - 1;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint64_t b = kmajor_desc<RK>(sk + h * 64 * 128 + pair_b(n) * TK, ks);
        if constexpr (N == 64) wgmma_ss_n64(s + 32 * h, a, b, accumulate);
        else if constexpr (N == 32) wgmma_ss_n32(s, a, b, accumulate);
        else wgmma_ss_n16(s, a, b, accumulate);
      }
    }
}

// The scores of one block: s = q·kᵀ (P pairs, as `qk_issue`), waited for.
template <int D, int N, int RQ, int RK, int P = 1>
__device__ __forceinline__ void qk_product(float* s, uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
  wgmma_fence();
  qk_issue<D, N, RQ, RK, P>(s, sq, sk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<N / 2>(s);
}

// The 64-row output fragment o of the warpgroup whose rows start at row
// `first` of the RQ-row tile at byte `tile` of smem, the fragment's row i
// divided by f[i] (kDivide: the forward's ÷ l) or times it (the backward's
// scale), written as bf16 through this warp's 16 rows of that tile (each
// lane's bf16 pairs land in distinct banks), then the first D columns (D a
// multiple of 4, at most DK) read back and stored to rows row_base + r
// (< S) of out, row stride `os`: 16-byte chunks, eight lanes a 128-byte
// row, where D % 8 == 0 (out's rows then start on 16 bytes), else 8-byte
// halves. Only this warp's rows are touched, so a __syncwarp orders the
// two; a warp that stages twice through the same rows syncs its lanes in
// between.
template <int DK, int RQ, bool kDivide = true>
__device__ __forceinline__ void store_rows(unsigned char* smem, uint32_t tile, int first,
                                           const float* o, const float (&f)[2],
                                           __nv_bfloat16* out, long long os, int row_base, int S,
                                           int D) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < padded<DK>() / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float x0 = o[4 * j + 2 * i], x1 = o[4 * j + 2 * i + 1];
      const __nv_bfloat162 v = kDivide ? __floats2bfloat162_rn(x0 / f[i], x1 / f[i])
                                       : __floats2bfloat162_rn(x0 * f[i], x1 * f[i]);
      const uint32_t at = tile + swz<RQ>(first + 16 * warp + g + 8 * i, j) + 4 * t;
      *reinterpret_cast<uint32_t*>(smem + at) = bf16x2_bits(v);
    }
  __syncwarp();
  // The loops run over DK's pieces (a trip count and divisors known at
  // compile time) and skip those at or past D.
  if (D % 8 == 0) {
    constexpr int NC = DK / 8;  // 16-byte chunks a row
#pragma unroll
    for (int i = lane; i < 16 * NC; i += 32) {
      const int r = 16 * warp + i / NC, c = i % NC;
      if (row_base + r < S && c < D / 8)
        *reinterpret_cast<uint4*>(out + (row_base + r) * os + c * 8) =
            *reinterpret_cast<const uint4*>(smem + tile + swz<RQ>(first + r, c));
    }
  } else {
    constexpr int NH = DK / 4;  // 8-byte halves a row
#pragma unroll
    for (int i = lane; i < 16 * NH; i += 32) {
      const int r = 16 * warp + i / NH, c = i % NH;
      if (row_base + r < S && c < D / 4)
        *reinterpret_cast<uint2*>(out + (row_base + r) * os + c * 4) =
            *reinterpret_cast<const uint2*>(smem + tile + swz<RQ>(first + r, c >> 1) + (c & 1) * 8);
    }
  }
}

// The three bf16 terms (as `split_p`) of this warp's rows of an f32
// fragment over N columns, written to three RT-row tiles `term` bytes
// apart from byte `tile` of smem, in the swizzled layout: fragment row i
// at tile row row0 + g + 8i, its 8-column block j at chunk j. Each lane's
// bf16 pairs land in distinct banks.
template <int N, int RT>
__device__ __forceinline__ void store_terms(unsigned char* smem, uint32_t tile, uint32_t term,
                                            int row0, const float* x) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t w[3];
      split3(x[4 * j + 2 * i], x[4 * j + 2 * i + 1], w);
      const uint32_t at = tile + swz<RT>(row0 + g + 8 * i, j) + 4 * t;
#pragma unroll
      for (int n = 0; n < 3; ++n) *reinterpret_cast<uint32_t*>(smem + at + n * term) = w[n];
    }
}

// ------------------------------------------------------- f32 forwards ---

// R rows × `cols` f32 values of an operand in device memory (row stride ss
// floats, rows 16-byte aligned), each times mul, into the three bf16 term
// tiles (R rows each of D ≥ cols columns, swizzled) at dst, dst + T and
// dst + 2T, T = tile_bytes<D, R>(): rows at or past `valid` and the
// columns at or past `cols` are zero. Thread t of NT takes the float4s t, t + NT, … of the
// padded rows (a warp reads 512 contiguous bytes of a row set), eight at a
// time: their loads all in flight, then each split and written as three
// 8-byte halves of swizzled chunks.
template <int D, int R, int NT>
__device__ __forceinline__ void stage_terms(uint32_t dst, const float* src, long long ss, int valid,
                                            int cols, float mul, int t) {
  constexpr int NC4 = padded<D>() / 4, ITEMS = R * NC4 / NT, U = ITEMS < 8 ? ITEMS : 8;
  constexpr uint32_t T = tile_bytes<D, R>();
  static_assert((R * NC4) % NT == 0 && ITEMS % U == 0, "the staging loop covers the tile evenly");
#pragma unroll
  for (int u0 = 0; u0 < ITEMS; u0 += U) {
    float4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = t + (u0 + u) * NT, r = i / NC4, c = i % NC4;
      x[u] = r < valid && 4 * c < cols ? *reinterpret_cast<const float4*>(src + r * ss + 4 * c)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = t + (u0 + u) * NT, r = i / NC4, c = i % NC4;
      uint32_t lo[3], hi[3];
      split3(x[u].x * mul, x[u].y * mul, lo);
      split3(x[u].z * mul, x[u].w * mul, hi);
      const uint32_t at = dst + swz<R>(r, c >> 1) + (c & 1) * 8;
#pragma unroll
      for (int n = 0; n < 3; ++n) st_shared_v2(at + n * T, lo[n], hi[n]);
    }
  }
}

// This warp's 16 rows of the 64-row f32 output fragment o, row i divided
// by f[i] (kDivide: the forward's ÷ l) or times it (the backward's scale),
// stored as f32 pairs to rows row0 + g + 8i (< S) of out (row stride os),
// columns below `cols` (even): each store of a warp fills eight 32-byte
// sectors.
template <int D, bool kDivide = true>
__device__ __forceinline__ void store_rows_f32(const float* o, const float (&f)[2], float* out,
                                               long long os, int row0, int S, int cols) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < padded<D>() / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= cols) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i;
      if (row < S)
        *reinterpret_cast<float2*>(out + row * os + col) =
            kDivide ? make_float2(o[4 * j + 2 * i] / f[i], o[4 * j + 2 * i + 1] / f[i])
                    : make_float2(o[4 * j + 2 * i] * f[i], o[4 * j + 2 * i + 1] * f[i]);
    }
  }
}

}  // namespace mpt_tc
