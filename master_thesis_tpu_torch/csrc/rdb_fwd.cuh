// One residual dense block (RDB) of the CHN trunk per launch, fused.
//
// Replaces: master_thesis_tpu/ops/pallas_rrdb.py:rrdb_pallas (body
// _rrdb_kernel / _rdb_fwd_block), which runs a whole RRDB per frame with
// the frame resident in VMEM. The closer template is the banded kernel
// _rdb_band_kernel: one RDB per (frame, tile) with a 5-pixel halo.
//
// Computes, for x of one frame (64 channels, NCHW bf16):
//   x_k = lrelu(conv_k(cat(x, x1..x_{k-1})) + b_k)   k = 1..4, 32 channels
//   y   = 0.2 * (conv_5(cat(x, x1..x4)) + b_5) + x   rounded to bf16
//   out = res ? 0.2 * y + res : y                    (the RRDB residual)
// Operands bf16, sums / bias / lrelu in f32, x1..x4 rounded to bf16.
//
// Bound on an H100 SXM (main path: 80 frames at 64x64, one RRDB = 3
// launches): 471 GFLOP per RRDB at the reference's dense 3x3 convs, 0.48 ms
// at 989 TFLOP/s bf16; bytes 42 MB in + 42 MB out per RRDB, 0.025 ms. So it
// is bound by operations: the design keeps every conv on tensor cores
// (bf16 mma.sync) and every intermediate x1..x4 in shared memory.
//
// Design: the TPU kernel keeps 192 channels x 4096 pixels of a frame in
// VMEM (1.5 MB); a block here has 227 KB. Each block therefore computes
// one 8x16 output tile from an 18x26 input tile (5-pixel halo, one per
// conv), all 192 channels pixel-major in shared memory (200 KB). Stage k
// computes x_k on the tile shrunk by k pixels per side; positions outside
// the frame are stored as exact zeros at every stage, so a tap outside the
// frame contributes nothing, as the frame-row masks of _band_tap_masks do.
// Each conv is an implicit GEMM on mma.sync (m16n8k16): 16 consecutive
// pixels x 9 taps x the concatenated input channels, A fragments by
// ldmatrix from the tile, each warp 32 pixels x 16 or 32 channels so every
// fragment serves two products; weights are read from global memory in
// fragment order (0.48 MB per RDB, L2-resident), one K-step ahead of their
// use, and the input tile is loaded as 16-byte words. The halo recompute
// costs about 1.8x the ideal operations; one launch per RRDB and wgmma are
// later work.
//
// Row window (K2, replacing pallas_rrdb.py:rrdb_trunk_pallas_banded, body
// _rdb_band_kernel): a launch may cover only the frame rows [r0, r1) of
// every frame. Its grid then holds that band's 8x16 tiles, each reading
// its 5-row halo in place from the frame tensor (zeros outside [0, H), as
// for K1), so no band copies are made. A TPU band existed because a frame
// did not fit in VMEM; here every tile already carries its halo, and a
// band is a set of tile rows: the outputs equal K1's. Compiled with
// -DBAND_PLANT=1, the first tile row of a band with r0 > 0 drops its halo
// row r0 - 1 (a fault the checks on the card must catch).
#pragma once

#include "conv_tile.cuh"

namespace {

using ct::bf16;

constexpr int NF = 64, GC = 32, C_ALL = NF + 4 * GC;  // x, x1..x4: 192 channels
constexpr int CP = C_ALL + 8;                          // padded pixel stride
constexpr int TH = 8, TW = 16, HALO = 5;
constexpr int RS = TH + 2 * HALO, CS = TW + 2 * HALO;  // 18 x 26 tile
constexpr int NPIX = RS * CS;
constexpr int PAD = 16;  // slack pixels before and after the tile
constexpr int BUF_PIX = NPIX + 2 * PAD;
constexpr int NWARP = 16, NTHREAD = 32 * NWARP;
constexpr size_t SMEM_BYTES = (size_t)BUF_PIX * CP * sizeof(bf16);

__host__ __device__ constexpr int cin_of(int k) { return NF + (k - 1) * GC; }
__host__ __device__ constexpr int out_of(int k) { return k < 5 ? GC : NF; }
__host__ __device__ constexpr int w_off(int k) {  // in uint4 (8 bf16)
  int off = 0;
  for (int j = 1; j < k; ++j) off += 9 * cin_of(j) * out_of(j) / 8;
  return off;
}

// Stage K (1..4): x_K on the tile rows [K, RS - K), all columns, as flat
// M-tiles of 16 pixels, two per warp. Outputs that wrap into the next row
// or lie outside columns [K, CS - K) are never read by a later stage's
// kept outputs.
template <int K, bool HIDDEN>
__device__ __forceinline__ void dense_stage(bf16* b0, const uint4* __restrict__ w,
                                            const float* __restrict__ bias, bf16* hidden,
                                            int gy0, int gx0, int H, int W, int warp, int lane) {
  constexpr int CIN = cin_of(K);
  constexpr int START = K * CS;
  constexpr int NPAIR = (((RS - 2 * K) * CS + 15) / 16 + 1) / 2;
  static_assert(NPAIR <= NWARP, "one pair of M-tiles per warp");
  static_assert(START - CS - 1 >= -PAD && START + 32 * NPAIR + CS + 1 <= NPIX + PAD, "slack");
  const int g = lane >> 2, t = lane & 3;
  const float* bk = bias + (K - 1) * GC;
  if (warp >= NPAIR) return;
  const int pix = START + 32 * warp;
  float acc[2][GC / 8][4];
  ct::mma_taps<CIN, 2, GC / 16, 3, 3, CS, CP, GC / 16>(acc, b0, pix - CS - 1, 16, w + w_off(K), 0,
                                                       lane);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pix + 16 * i + g + 8 * h;
      const int r = p / CS, q = p - r * CS;
      const int gy = gy0 + r, gx = gx0 + q;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int jn = 0; jn < GC / 8; ++jn) {
        const int o = 8 * jn + 2 * t;
        const float v0 = ct::lrelu(acc[i][jn][2 * h] + bk[o]);
        const float v1 = ct::lrelu(acc[i][jn][2 * h + 1] + bk[o + 1]);
        ct::store2(b0 + (ptrdiff_t)p * CP + CIN + o, inside ? v0 : 0.0f, inside ? v1 : 0.0f);
        if (HIDDEN && inside && r >= HALO && r < HALO + TH && q >= HALO && q < HALO + TW) {
          // x_K of a kept output pixel; `hidden` is this frame's (128, H, W).
          const size_t plane = (size_t)H * W;
          bf16* hp = hidden + ((K - 1) * GC + o) * plane + (size_t)gy * W + gx;
          hp[0] = __float2bfloat16(v0);
          hp[plane] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// With HIDDEN, also writes x1..x4 of the kept pixels to `hidden`, (n, 128,
// H, W) bf16: the backward's recompute (csrc/rrdb_bwd.cu).
template <bool HIDDEN>
__global__ void __launch_bounds__(NTHREAD, 1)
rdb_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res, const uint4* __restrict__ w,
           const float* __restrict__ bias, bf16* __restrict__ out, bf16* __restrict__ hidden,
           int H, int W, int r0, int r1) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.z, ty0 = r0 + blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int gy0 = ty0 - HALO, gx0 = tx0 - HALO;
  const size_t frame = (size_t)NF * H * W;

  ct::zero_smem(buf, (int)SMEM_BYTES);
  __syncthreads();
  bf16* b0 = buf + PAD * CP;  // tile pixel 0
  bf16* hid = HIDDEN ? hidden + (size_t)n * 4 * GC * H * W : nullptr;
  ct::load_tile<CP>(b0, x + n * frame, NF, H, W, gy0, gx0, RS, CS);
  __syncthreads();
#ifdef BAND_PLANT
  if (r0 > 0 && blockIdx.y == 0) {  // tile row HALO - 1 holds frame row r0 - 1
    uint4* row = reinterpret_cast<uint4*>(b0 + (ptrdiff_t)(HALO - 1) * CS * CP);
    for (int i = threadIdx.x; i < CS * CP / 8; i += NTHREAD) row[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
#endif
  dense_stage<1, HIDDEN>(b0, w, bias, hid, gy0, gx0, H, W, warp, lane);
  __syncthreads();
  dense_stage<2, HIDDEN>(b0, w, bias, hid, gy0, gx0, H, W, warp, lane);
  __syncthreads();
  dense_stage<3, HIDDEN>(b0, w, bias, hid, gy0, gx0, H, W, warp, lane);
  __syncthreads();
  dense_stage<4, HIDDEN>(b0, w, bias, hid, gy0, gx0, H, W, warp, lane);
  __syncthreads();

  // conv5 on the 8x16 output tile: each warp takes two tile rows (16
  // pixels each) and a quarter (16) of the 64 output channels.
  static_assert(NWARP == (TH / 2) * (NF / 16), "one conv5 job per warp");
  const float* b5 = bias + 4 * GC;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 2 * (warp >> 2), nq = warp & 3;
  const int pix = (HALO + m0) * CS + HALO;
  float acc[2][2][4];
  ct::mma_taps<C_ALL, 2, 1, 3, 3, CS, CP, NF / 16>(acc, b0, pix - CS - 1, CS, w + w_off(5), nq,
                                                  lane);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oy = ty0 + m0 + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h, ox = tx0 + row;
      if (oy >= r1 || ox >= W) continue;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = 16 * nq + 8 * jn + 2 * t + e;
          const size_t idx = n * frame + ((size_t)o * H + oy) * W + ox;
          const float xin = __bfloat162float(b0[(ptrdiff_t)(pix + i * CS + row) * CP + o]);
          bf16 y = __float2bfloat16(0.2f * (acc[i][jn][2 * h + e] + b5[o]) + xin);
          if (res != nullptr)
            y = __float2bfloat16(0.2f * __bfloat162float(y) + __bfloat162float(res[idx]));
          out[idx] = y;
        }
      }
    }
  }
}

}  // namespace

namespace rdb {

// Launches rdb_kernel<HIDDEN> on `stream` over the frame rows [r0, r1)
// (r1 < 0: to the last row); returns the CUDA error code.
template <bool HIDDEN>
inline int launch(const void* x, const void* res, const void* w, const void* b, void* out,
                  void* hidden, int n, int h, int w_img, void* stream, int r0 = 0, int r1 = -1) {
  if (r1 < 0) r1 = h;
  if (r0 < 0 || r1 > h || r0 >= r1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(rdb_kernel<HIDDEN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((w_img + TW - 1) / TW, (r1 - r0 + TH - 1) / TH, n);
  rdb_kernel<HIDDEN><<<grid, NTHREAD, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(res), static_cast<const uint4*>(w),
      static_cast<const float*>(b), static_cast<bf16*>(out), static_cast<bf16*>(hidden), h,
      w_img, r0, r1);
  return (int)cudaGetLastError();
}

}  // namespace rdb
