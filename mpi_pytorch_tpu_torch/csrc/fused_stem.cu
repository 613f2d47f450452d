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

#include <algorithm>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// Training forward: the same pool plus the window index k = dh * 3 + dw.
//
// Replaces: mpi_pytorch_tpu/ops/fused_stem.py::_fwd_kernel (want_idx=True,
// the forward half of the custom VJP _stem_pool_t). k is the FIRST window
// offset attaining the max in row-major (dh, dw) order -- what the TPU
// kernel's column-then-row fold gives -- with padding as -inf. It is stored
// as int8 (the TPU kernel's MPT_STEM_IDX_INT8 storage; the values are the
// same as its default bf16 ones).
//
// Bound: bytes. At [128,64,64,64] bf16 it reads y (67.1 MB) and writes the
// pooled output (16.8 MB) and k (8.4 MB): 0.0275 ms at 3.35 TB/s.
//
// Design: a staged band. A tile is one image n, a band of R output rows
// (oh0 ...), a block of TW output columns (ow0 ...) and a slice of CS
// channels; its inputs are rows 2·oh0 − 1 ... 2·(oh0 + R) − 1 and columns
// 2·ow0 − 1 ... 2·(ow0 + TW) − 1, clipped to the grid. Tiles are numbered
// band fastest, and each persistent CTA (as many as fit on the card) takes
// one contiguous run of them, so its next tile is mostly the band below
// this one. The top input row of a band, 2·oh0 − 1, is the bottom row of
// the band above: the CTA carries that row's column fold in registers from
// tile to tile, and stages and folds it (the halo row) only for the first
// tile of its run. The staged rows come into shared memory by 1-D bulk
// copies (`bulk_load`) that complete on the stage's mbarrier: in NHWC a
// band of whole rows is one contiguous range and one copy; a column block
// takes a copy a row, a channel slice a copy a pixel. A ring of kArgStages
// stages loads the next tiles while this one is folded. y leaves device
// memory once, but for one halo row a CTA. The tile's shape is set on the
// host per call (`arg_tiles`): CS the widest slice of C up to 256 bytes a
// pixel, TW so that a CTA holds at most kArgThreads threads, R so that a
// stage holds at most kArgStageBytes. (Chosen on the card at the training
// shape: 256 threads and 48 KB stages, two CTAs an SM, ran ahead of 128
// threads with 16–40 KB stages, 64 threads, and a third stage.)
//
// Thread (j, g) owns output column ow0 + j and the slice's channels
// 8g ... 8g + 7 and walks down the band. For each input row it takes the
// affine and relu of its own two columns 2·ow and 2·ow + 1; the left one,
// 2·ow − 1, is its left neighbour's right column, taken by a shuffle (the
// first column of each warp takes it itself). So each input element's
// affine runs once, but for those warp edges. Then the column fold over dw
// (value, dw), then the row fold over dh, both in _pool_argmax_t's order:
// strict > for the index, a NaN-propagating max for the value (one
// max.NaN instruction, as relu is). An odd input row's column fold serves
// both output rows it belongs to. On every window whose max is finite this
// gives the row-major first match of the plain version.
//
// Padding is -inf BY COORDINATE: a row or column off the grid is never
// copied nor read, so nothing depends on what a stage held before. (A
// copy's zero fill would not do: relu(0·a + b) = relu(b) can beat every
// real element, and even a zero wins ties against the real relu zeros.)
//
// The affine rounds the product and the sum separately (no FMA), as the
// plain PyTorch version's y * a + b does: the two then agree bit for bit on
// every activation, so on every window's max and on every index k. Index
// math is 32-bit in shared memory; global offsets are 32-bit below 2^31
// elements of y and 64-bit above. A tile's coordinates cost three 32-bit
// divisions, a thread's (j, g) one.
constexpr int kArgThreads = 256;           // the most a CTA holds
constexpr int kArgStageBytes = 48 * 1024;  // the most a stage holds
constexpr int kArgStages = 2;

// The tiles of one call: the grid's sizes, the tile's shape (cs channels,
// g = cs / 8 groups, tw columns, r rows), the tile counts of each axis and
// in all, and a stage's bytes.
struct ArgTiles {
  int H, W, C, H2, W2;
  int cs, g, tw, r;
  int n_sl, n_cb, n_band, tiles, stage_bytes;
};

// One tile: image n, output rows oh0 ... oh0 + rows − 1, output columns
// ow0 ... ow0 + cols − 1, channels c0 ... c0 + cs − 1; the first staged
// input row and column (gr0, gc0) and the staged columns (ncols). `halo`:
// row 2·oh0 − 1 is staged (the first tile of a run, below the grid's top).
struct ArgTile {
  int n, oh0, rows, ow0, cols, c0, gr0, gc0, ncols;
  bool halo;
};

__device__ __forceinline__ ArgTile arg_tile(const ArgTiles& p, int tile, bool first) {
  ArgTile u;
  int t = tile / p.n_band;
  u.oh0 = (tile - t * p.n_band) * p.r;
  const int sl_n = t / p.n_cb;
  u.ow0 = (t - sl_n * p.n_cb) * p.tw;
  u.n = sl_n / p.n_sl;
  u.c0 = (sl_n - u.n * p.n_sl) * p.cs;
  u.rows = min(p.r, p.H2 - u.oh0);
  u.cols = min(p.tw, p.W2 - u.ow0);
  u.halo = first && u.oh0 > 0;
  u.gr0 = u.halo ? 2 * u.oh0 - 1 : 2 * u.oh0;
  u.gc0 = max(2 * u.ow0 - 1, 0);
  u.ncols = 2 * (u.ow0 + u.cols) - u.gc0;
  return u;
}

// Warp 0: the copies of `tile`'s inputs into `stage`, completing on `bar`.
template <typename T, typename I>
__device__ __forceinline__ void arg_issue(const T* y, const ArgTiles& p, int tile, bool first,
                                          uint32_t stage, uint32_t bar, int lane) {
  using namespace mpt_hopper;
  const ArgTile u = arg_tile(p, tile, first);
  const int nrows = 2 * (u.oh0 + u.rows) - u.gr0;
  const uint32_t pix = p.cs * sizeof(T);
  if (lane == 0) mbar_expect_tx(bar, nrows * u.ncols * pix);
  __syncwarp();
  const T* src = y + ((static_cast<I>(u.n) * p.H + u.gr0) * p.W + u.gc0) * p.C + u.c0;
  const I row = static_cast<I>(p.W) * p.C;
  if (p.cs == p.C && u.ncols == p.W) {  // whole rows: one range
    if (lane == 0) bulk_load(stage, src, nrows * u.ncols * pix, bar);
  } else if (p.cs == p.C) {  // a range a row
    for (int r = lane; r < nrows; r += 32)
      bulk_load(stage + r * u.ncols * pix, src + r * row, u.ncols * pix, bar);
  } else {  // a range a pixel
    for (int r = 0; r < nrows; ++r)
      for (int c = lane; c < u.ncols; c += 32)
        bulk_load(stage + (r * u.ncols + c) * pix, src + r * row + static_cast<I>(c) * p.C, pix,
                  bar);
  }
}

// max that propagates NaN from either side (lax.max, torch.maximum), in one
// instruction.
__device__ __forceinline__ float max_nan1(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float affine_relu(float y, float a, float b) {
  return max_nan1(__fadd_rn(__fmul_rn(y, a), b), 0.f);
}

// The column fold of input row gr at this thread's centre: (v, dw) over
// dw = 0, 1, 2 in _pool_argmax_t's order. Every thread of the CTA calls
// it with the same gr (the shuffle needs the whole warp); `live` threads
// read the stage, the others carry -inf.
template <typename T>
__device__ __forceinline__ void arg_column(const T* stage, const ArgTiles& p, const ArgTile& u,
                                           int gr, int lc, int g, bool live, bool own_left,
                                           const float (&av)[8], const float (&bv)[8],
                                           float (&v)[8], int (&dw)[8]) {
  const T* px = stage + ((gr - u.gr0) * u.ncols + lc) * p.cs + 8 * g;
  float zc[8], zr[8], zl[8];
  if (live) {
    load8(px, zc);
    load8(px + p.cs, zr);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      zc[c] = affine_relu(zc[c], av[c], bv[c]);
      zr[c] = affine_relu(zr[c], av[c], bv[c]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) zc[c] = zr[c] = -INFINITY;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) zl[c] = __shfl_up_sync(0xffffffffu, zr[c], p.g);
  if (own_left) {
    // Column 2·ow − 1: off the grid where lc == 0 (ow == 0), else staged.
    if (live && lc > 0) {
      load8(px - p.cs, zl);
#pragma unroll
      for (int c = 0; c < 8; ++c) zl[c] = affine_relu(zl[c], av[c], bv[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) zl[c] = -INFINITY;
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    dw[c] = zc[c] > zl[c] ? 1 : 0;  // strict: the first max keeps the window
    v[c] = max_nan1(zl[c], zc[c]);
    if (zr[c] > v[c]) dw[c] = 2;
    v[c] = max_nan1(v[c], zr[c]);
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kArgThreads)
stem_pool_argmax_band_kernel(const T* __restrict__ y, const float* __restrict__ a,
                             const float* __restrict__ b, T* __restrict__ out,
                             int8_t* __restrict__ idx, ArgTiles p) {
  using namespace mpt_hopper;
  extern __shared__ __align__(128) unsigned char arg_smem[];
  __shared__ __align__(8) uint64_t full[kArgStages];
  const int tid = threadIdx.x, lane = tid & 31;
  const int j = tid / p.g, g = tid - j * p.g;
  // The first of each run of p.g lanes that share a column has no left
  // neighbour in the warp.
  const bool own_left = lane < p.g;
  if (tid == 0) {
    for (int s = 0; s < kArgStages; ++s) mbar_init(smem_addr(&full[s]), 1);
    mbar_init_fence();
  }
  __syncthreads();
  const uint32_t stage0 = smem_addr(arg_smem);
  // This CTA's run of tiles: an even share, in order.
  const int first = static_cast<int>(static_cast<long long>(blockIdx.x) * p.tiles / gridDim.x);
  const int last = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * p.tiles / gridDim.x);
  if (tid < 32)
    for (int s = 0; s < kArgStages && first + s < last; ++s)
      arg_issue<T, I>(y, p, first + s, s == 0, stage0 + s * p.stage_bytes, smem_addr(&full[s]),
                      lane);

  float av[8], bv[8], tv[8];  // tv, tdw: the column fold of the band's top row
  int tdw[8];
  for (int tile = first, it = 0; tile < last; ++tile, ++it) {
    const int s = it % kArgStages;
    const ArgTile u = arg_tile(p, tile, tile == first);
    const T* stage = reinterpret_cast<const T*>(arg_smem + s * p.stage_bytes);
    const bool live = j < u.cols;
    const int ow = u.ow0 + j, lc = 2 * ow - u.gc0;
    const int c0 = u.c0 + 8 * g;
    load8(a + c0, av);
    load8(b + c0, bv);
    mbar_wait(smem_addr(&full[s]), (it / kArgStages) & 1);

    if (u.oh0 == 0) {  // the padding row above the grid
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        tv[c] = -INFINITY;
        tdw[c] = 0;
      }
    } else if (u.halo) {
      arg_column(stage, p, u, 2 * u.oh0 - 1, lc, g, live, own_left, av, bv, tv, tdw);
    }  // else: carried from the band above, the previous tile
    for (int i = 0; i < u.rows; ++i) {
      const int oh = u.oh0 + i;
      float mv[8], bt[8], m[8];
      int mdw[8], bdw[8];
      arg_column(stage, p, u, 2 * oh, lc, g, live, own_left, av, bv, mv, mdw);
      arg_column(stage, p, u, 2 * oh + 1, lc, g, live, own_left, av, bv, bt, bdw);
      unsigned long long packed = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int k = tdw[c];  // dh = 0
        if (mv[c] > tv[c]) k = 3 + mdw[c];
        m[c] = max_nan1(tv[c], mv[c]);
        if (bt[c] > m[c]) k = 6 + bdw[c];
        m[c] = max_nan1(m[c], bt[c]);
        packed |= static_cast<unsigned long long>(k) << (8 * c);
        tv[c] = bt[c];  // the odd row is the next output row's dh = 0
        tdw[c] = bdw[c];
      }
      if (live) {
        const I o = ((static_cast<I>(u.n) * p.H2 + oh) * p.W2 + ow) * p.C + c0;
        store8(out + o, m);
        *reinterpret_cast<unsigned long long*>(idx + o) = packed;
      }
    }
    __syncthreads();  // every thread has read stage s
    if (tid < 32 && tile + kArgStages < last)
      arg_issue<T, I>(y, p, tile + kArgStages, false, stage0 + s * p.stage_bytes,
                      smem_addr(&full[s]), lane);
  }
}

// The tiles of a call (see the design note above): CS the widest multiple
// of 8 dividing C up to 256 bytes a pixel; TW the column blocks' even share
// of W/2 with at most kArgThreads threads (and 127 columns) a CTA; R the
// most rows a stage of kArgStageBytes holds with its halo row, at least 1.
ArgTiles arg_tiles(int B, int H, int W, int C, int elem) {
  ArgTiles p;
  p.H = H, p.W = W, p.C = C, p.H2 = H / 2, p.W2 = W / 2;
  p.cs = 8;
  for (int cs = 16; cs <= C && cs * elem <= 256; cs += 8)
    if (C % cs == 0) p.cs = cs;
  p.g = p.cs / 8;
  const int tw_max = std::min(kArgThreads / p.g, 127);
  p.n_cb = (p.W2 + tw_max - 1) / tw_max;
  p.tw = (p.W2 + p.n_cb - 1) / p.n_cb;
  const int row_bytes = (2 * p.tw + 1) * p.cs * elem;
  p.r = std::max(1, std::min(p.H2, (kArgStageBytes / row_bytes - 1) / 2));
  p.n_band = (p.H2 + p.r - 1) / p.r;
  p.n_sl = C / p.cs;
  p.stage_bytes = ((2 * p.r + 1) * row_bytes + 127) / 128 * 128;
  const long long tiles = static_cast<long long>(B) * p.n_band * p.n_cb * p.n_sl;
  p.tiles = tiles > (1 << 30) ? -1 : static_cast<int>(tiles);
  return p;
}

template <typename T, typename I>
cudaError_t launch_argmax_i(const void* y, const void* a, const void* b, void* out, void* idx,
                            const ArgTiles& p, cudaStream_t stream) {
  auto kernel = stem_pool_argmax_band_kernel<T, I>;
  const int threads = (p.tw * p.g + 31) / 32 * 32;
  const int bytes = kArgStages * p.stage_bytes;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)) !=
          cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes)) !=
          cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = std::min(p.tiles, sms * per_sm);
  kernel<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(out), static_cast<int8_t*>(idx), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_argmax(const void* y, const void* a, const void* b, void* out,
                          void* idx, int B, int H, int W, int C, cudaStream_t stream) {
  if (static_cast<long long>(B) * (H / 2) * (W / 2) * C == 0) return cudaSuccess;
  const ArgTiles p = arg_tiles(B, H, W, C, sizeof(T));
  if (p.tiles < 0) return cudaErrorInvalidConfiguration;
  if (static_cast<long long>(B) * H * W * C < 0x7fffffffLL)
    return launch_argmax_i<T, int>(y, a, b, out, idx, p, stream);
  return launch_argmax_i<T, long long>(y, a, b, out, idx, p, stream);
}

// ---------------------------------------------------------------------------
// Backward: route the pooled gradient g through k to the inputs, mask it
// with pooled > 0 (the window max is post-relu, so max > 0 iff the winner
// was a live activation), and form dy = du * a, da = sum du * y and
// db = sum du over (batch, rows, columns).
//
// Replaces: mpi_pytorch_tpu/ops/fused_stem.py::_bwd_kernel (the backward
// half of the custom VJP _stem_pool_t).
//
// Bound: bytes. At [128,64,64,64] bf16 it reads g, k and pooled (42 MB), y
// (67.1 MB) and a, and writes dy (67.1 MB): 176.2 MB, 0.053 ms at
// 3.35 TB/s.
//
// Design: a QUAD gather. One thread per (b, oh, ow, 8-channel group) writes
// the 2x2 inputs (2oh, 2oh+1) x (2ow, 2ow+1), so dy is written once with
// 16-byte stores and nothing is atomic. The window offsets are fixed per
// input parity, so no thread branches differently from its neighbours
// except at the grid's last row or column:
//   (even, even) window (oh, ow) at k = 4;
//   (even, odd)  (oh, ow) at 5, then (oh, ow+1) at 3;
//   (odd, even)  (oh, ow) at 7, then (oh+1, ow) at 1;
//   (odd, odd)   (oh, ow) at 8, (oh, ow+1) at 6, (oh+1, ow) at 2,
//                (oh+1, ow+1) at 0
// -- each sum in the order of the TPU kernel's parity phases, (lo, lo),
// (lo, hi), (hi, lo), (hi, hi). A thread reads four windows of (g, k,
// pooled), one per input it writes (a gather per input reads 2.25), all
// four loads in flight at once (a window off the grid is its own window
// again, naming no input); the windows it shares with its neighbours come
// from L1/L2. Its position comes from one shift and two 32-bit divisions
// (a 64-bit instantiation serves tensors of 2^31 elements or more).
//
// The channel sums cross every block, and a GPU grid has no order (the TPU
// kernel carries them across its sequential grid in scratch). Each thread
// walks kBwdItems quads of one fixed channel group; the block folds its
// threads' sums per channel by a fixed shuffle tree in each warp, then
// warp by warp in shared memory, and writes one row of a [n_part, 2, C]
// scratch. The last block to finish (a ticket from an integer atomic after
// a fence; the entry zeroes the ticket) sums the rows in row order and
// writes da and db. No float atomics: two calls on the same inputs give
// bitwise-equal da and db, whichever block finishes last.
constexpr int kBwdThreads = 256;
constexpr int kBwdItems = 16;  // quads per thread

__device__ __forceinline__ void load8_i8(const int8_t* p, int (&k)[8]) {
  const unsigned long long u = *reinterpret_cast<const unsigned long long*>(p);
#pragma unroll
  for (int c = 0; c < 8; ++c) k[c] = static_cast<int8_t>((u >> (8 * c)) & 0xff);
}

// One window's masked gradient (g where pooled > 0, else 0) and index k.
template <typename T, typename I>
__device__ __forceinline__ void load_window(const T* g, const int8_t* idx, const T* pooled, I o,
                                            float (&gm)[8], int (&k)[8]) {
  float gv[8], pv[8];
  load8(g + o, gv);
  load8(pooled + o, pv);
  load8_i8(idx + o, k);
#pragma unroll
  for (int c = 0; c < 8; ++c) gm[c] = pv[c] > 0.f ? gv[c] : 0.f;
}

// du += gm where the window's index names the input (offset `want`).
__device__ __forceinline__ void route(float (&du)[8], const float (&gm)[8], const int (&k)[8],
                                      int want) {
#pragma unroll
  for (int c = 0; c < 8; ++c) du[c] += k[c] == want ? gm[c] : 0.f;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kBwdThreads, 2)
stem_pool_bwd_kernel(const T* __restrict__ g, const int8_t* __restrict__ idx,
                     const T* __restrict__ pooled, const T* __restrict__ y,
                     const float* __restrict__ a, T* __restrict__ dy, float* __restrict__ part,
                     unsigned int* __restrict__ ticket, float* __restrict__ dadb,
                     int B, int H, int W, int C) {
  const int H2 = H / 2, W2 = W / 2, G = C / 8, lg = __ffs(G) - 1;  // G is a power of two
  const I quads = static_cast<I>(B) * H2 * W2 * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // kBwdThreads % G == 0 (checked by the entry point) and every block starts
  // on a multiple of kBwdThreads, so this thread's channel group is fixed.
  const int c0 = (tid & (G - 1)) * 8;
  float av[8], sa[8], sb[8];
  load8(a + c0, av);
#pragma unroll
  for (int c = 0; c < 8; ++c) sa[c] = sb[c] = 0.f;

  const I first = static_cast<I>(blockIdx.x) * (kBwdThreads * kBwdItems) + tid;
  for (int it = 0; it < kBwdItems; ++it) {
    const I i = first + static_cast<I>(it) * kBwdThreads;
    if (i >= quads) break;
    I r = i >> lg;
    const int ow = static_cast<int>(r % W2);
    r /= W2;
    const int oh = static_cast<int>(r % H2);
    const I n = r / H2;
    const bool right = ow + 1 < W2, down = oh + 1 < H2;
    // The four windows (oh, ow), (oh, ow+1), (oh+1, ow), (oh+1, ow+1), all
    // loaded before any is used: a window off the grid reloads (oh, ow) and
    // names no input (want −1), so the loads issue together, unbranched.
    const I w00 = ((n * H2 + oh) * W2 + ow) * C + c0;
    const I step[4] = {0, right ? C : 0, down ? static_cast<I>(W2) * C : 0,
                       right && down ? static_cast<I>(W2 + 1) * C : 0};
    float gm[4][8];
    int k[4][8];
#pragma unroll
    for (int w = 0; w < 4; ++w) load_window(g, idx, pooled, w00 + step[w], gm[w], k[w]);
    // du of the inputs (2oh, 2ow), (2oh, 2ow+1), (2oh+1, 2ow), (2oh+1, 2ow+1).
    float du[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 8; ++c) du[q][c] = 0.f;
    route(du[0], gm[0], k[0], 4);
    route(du[1], gm[0], k[0], 5);
    route(du[1], gm[1], k[1], right ? 3 : -1);
    route(du[2], gm[0], k[0], 7);
    route(du[2], gm[2], k[2], down ? 1 : -1);
    route(du[3], gm[0], k[0], 8);
    route(du[3], gm[1], k[1], right ? 6 : -1);
    route(du[3], gm[2], k[2], down ? 2 : -1);
    route(du[3], gm[3], k[3], right && down ? 0 : -1);
    const I in00 = ((n * H + 2 * oh) * W + 2 * ow) * C + c0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const I o = in00 + ((q >> 1) * static_cast<I>(W) + (q & 1)) * C;
      float yv[8], dv[8];
      load8(y + o, yv);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        dv[c] = du[q][c] * av[c];
        sa[c] += du[q][c] * yv[c];
        sb[c] += du[q][c];
      }
      store8(dy + o, dv);
    }
  }

  // The block's sums, fixed order: in each warp a shuffle tree over the
  // lanes of one channel group (lane % G), then the warps in order.
  for (int off = 16; off >= G; off >>= 1)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      sa[c] += __shfl_xor_sync(0xffffffffu, sa[c], off);
      sb[c] += __shfl_xor_sync(0xffffffffu, sb[c], off);
    }
  __shared__ __align__(16) float s_sum[kBwdThreads / 32 * 2 * 256];  // [warp][da | db][C]
  if (lane < G) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s_sum[warp * 2 * C + c0 + c] = sa[c];
      s_sum[warp * 2 * C + C + c0 + c] = sb[c];
    }
  }
  __syncthreads();
  for (int col = tid; col < 2 * C; col += kBwdThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdThreads / 32; ++w) t += s_sum[w * 2 * C + col];
    part[static_cast<long long>(blockIdx.x) * 2 * C + col] = t;
  }

  // The last block to finish sums the rows.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Thread tid sums float4 column c4 of rows r0, r0 + RP, ... (C / 2
  // float4s a row, RP rows side by side), 16 rows' loads in flight at a
  // time (rows past the last add zeros); then each column's RP sums in
  // order. RP·2C = 1024 floats of s_sum.
  const int n4 = C / 2, c4 = tid % n4, r0 = tid / n4, RP = kBwdThreads / n4;
  const int rows = static_cast<int>(gridDim.x);
  const float4* col = reinterpret_cast<const float4*>(part) + c4;  // row r at col[r·n4]
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int row0 = r0; row0 < rows; row0 += 16 * RP) {
    float4 x[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int row = row0 + u * RP;
      x[u] = row < rows ? __ldcg(col + static_cast<long long>(row) * n4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      acc.x += x[u].x;
      acc.y += x[u].y;
      acc.z += x[u].z;
      acc.w += x[u].w;
    }
  }
  // Every warp read the block sums out of s_sum before the ticket.
  reinterpret_cast<float4*>(s_sum)[r0 * n4 + c4] = acc;
  __syncthreads();
  for (int col = tid; col < 2 * C; col += kBwdThreads) {
    float t = 0.f;
    for (int rr = 0; rr < RP; ++rr) t += s_sum[rr * 2 * C + col];
    dadb[col] = t;
  }
}

long long bwd_parts(int B, int H, int W, int C) {
  const long long quads = static_cast<long long>(B) * (H / 2) * (W / 2) * (C / 8);
  const long long per_block = static_cast<long long>(kBwdThreads) * kBwdItems;
  return (quads + per_block - 1) / per_block;
}

template <typename T, typename I>
cudaError_t launch_bwd_i(const void* g, const void* idx, const void* pooled, const void* y,
                         const void* a, void* dy, void* dadb, void* part, int n_part,
                         int B, int H, int W, int C, cudaStream_t stream) {
  float* rows = static_cast<float*>(part);
  auto* ticket = reinterpret_cast<unsigned int*>(rows + static_cast<long long>(n_part) * 2 * C);
  cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return err;
  stem_pool_bwd_kernel<T, I><<<n_part, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int8_t*>(idx),
      static_cast<const T*>(pooled), static_cast<const T*>(y),
      static_cast<const float*>(a), static_cast<T*>(dy), rows, ticket,
      static_cast<float*>(dadb), B, H, W, C);
  return cudaGetLastError();
}

// 32-bit offsets below 2^31 elements of y, 64-bit above.
template <typename T>
cudaError_t launch_bwd(const void* g, const void* idx, const void* pooled, const void* y,
                       const void* a, void* dy, void* dadb, void* part,
                       int B, int H, int W, int C, cudaStream_t stream) {
  const long long n_part = bwd_parts(B, H, W, C);
  if (n_part == 0) return cudaMemsetAsync(dadb, 0, 2 * sizeof(float) * C, stream);
  if (n_part > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int rows = static_cast<int>(n_part);
  if (static_cast<long long>(B) * H * W * C < 0x7fffffffLL)
    return launch_bwd_i<T, int>(g, idx, pooled, y, a, dy, dadb, part, rows, B, H, W, C, stream);
  return launch_bwd_i<T, long long>(g, idx, pooled, y, a, dy, dadb, part, rows, B, H, W, C, stream);
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

// As mpt_stem_pool_fwd, plus idx: int8 [B,H/2,W/2,C], the window index k.
extern "C" int mpt_stem_pool_argmax(const void* y, const void* a, const void* b,
                                    void* out, void* idx, int B, int H, int W, int C,
                                    int dtype, void* stream) {
  if (C % 8 != 0 || H % 2 != 0 || W % 2 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_argmax<float>(y, a, b, out, idx, B, H, W, C, s);
    case 1: return launch_argmax<__nv_bfloat16>(y, a, b, out, idx, B, H, W, C, s);
    default: return cudaErrorInvalidValue;
  }
}

// Rows of the backward's scratch (part: f32 [rows, 2, C], then one u32
// ticket); -1 when the grid would be too large.
extern "C" int mpt_stem_bwd_parts(int B, int H, int W, int C) {
  const long long n = bwd_parts(B, H, W, C);
  return n > 0x7fffffffLL ? -1 : static_cast<int>(n);
}

// g, pooled [B,H/2,W/2,C] and y [B,H,W,C] in one dtype (0 = f32, 1 = bf16),
// idx int8 [B,H/2,W/2,C], a f32 [C], all NHWC contiguous and 16-byte
// aligned; C % 8 == 0, C <= 256 and 256 % (C / 8) == 0. Writes dy (y's
// shape and dtype) and dadb f32 [2, C] = (da, db).
extern "C" int mpt_stem_pool_bwd(const void* g, const void* idx, const void* pooled,
                                 const void* y, const void* a, void* dy, void* dadb,
                                 void* part, int B, int H, int W, int C, int dtype,
                                 void* stream) {
  if (C % 8 != 0 || C > kBwdThreads || kBwdThreads % (C / 8) != 0 || H % 2 != 0 ||
      W % 2 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(g, idx, pooled, y, a, dy, dadb, part, B, H, W, C, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(g, idx, pooled, y, a, dy, dadb, part, B, H, W, C, s);
    default: return cudaErrorInvalidValue;
  }
}
