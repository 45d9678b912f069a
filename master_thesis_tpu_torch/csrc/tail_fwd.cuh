// The RRDBNet tail: (N, 64, h, w) -> (N, 3, 4h, 4w) in three launches.
//
// Replaces: master_thesis_tpu/ops/pallas_tail.py:rrdbnet_tail_pallas,
// full-frame branch (body _tail_kernel / _tail_body / _phase_conv), which
// runs the whole tail of a frame in phase space with ~60 * 64 * HW bytes
// resident in VMEM (31 MB at h = w = 64; a block here has 227 KB).
//
//   upconv_kernel (x2): nearest-2x upsample + 3x3 conv + bias + lrelu, as
//     a 4-phase conv at the input resolution: output pixel (2i+a, 2j+b)
//     reads the 2x2 input window at rows i+a-1.., cols j+b-1.. against the
//     taps fused_upsample_conv_kernel sums (models/nn_ext.py:76). The
//     upsampled input is never formed.
//   hr_last_kernel: hr_conv (3x3 + bias + lrelu) and conv_last (3x3 to 3
//     channels + bias) fused over an 8x16 tile with a 2-pixel halo; the
//     hr_conv output stays in shared memory.
// Every conv is an implicit GEMM on bf16 tensor cores (mma.sync m16n8k16,
// conv_tile.cuh). Intermediates are bf16, sums / bias / lrelu f32.
//
// Bound on an H100 SXM (main path: 80 frames, h = w = 64): 619 GFLOP with
// each upsample-conv in its 4-phase form (4 taps per output pixel, 4/9 of
// the nearest-upsample-then-3x3 count), 0.63 ms at 989 TFLOP/s bf16;
// bytes 42 MB in + 31 MB out, 0.022 ms. So it is bound by operations,
// and the phase form is what keeps the upsample-convs at that count.
// Between the launches this version also writes and reads the
// 128x128 and 256x256 intermediates (about 1.7 GB per step), and the halo
// of hr_conv costs 1.75x its operations. Fusing all four stages over halo
// tiles is later work.
//
// Row windows (K5, replacing the banded branch of rrdbnet_tail_pallas,
// body _tail_band_kernel): upconv_kernel computes the input rows [r0, r0 +
// rows) of its input tensor into an output of 2 * rows rows, reading its
// 1-row halo in place; hr_last_kernel computes the rows [q0, q0 + nq) of
// its input and writes them at row o0 of an output of OH rows. The banded
// tail (ops/tail.py:tail_banded) runs the three launches per band of
// low-resolution rows with a 4-row halo clipped to the frame, the 2x and
// 4x intermediates in band-sized scratch, and hr_last writing the band's
// interior rows straight into the full output; rows outside a tensor read
// as zeros, and a band clipped at the frame edge has the frame's border.
// Compiled with -DBAND_PLANT=1, hr_last_kernel drops the input row q0 - 1
// when q0 > 0 (one halo row at a band edge: a fault the checks on the card
// must catch).
#pragma once

#include "conv_tile.cuh"

namespace {

using ct::bf16;

constexpr int NF = 64, CP = NF + 8;  // channels, padded pixel stride
constexpr int NWARP = 8, NTHREAD = 32 * NWARP;
constexpr int PHASE_W = 4 * NF * NF / 8;  // one phase's packed weights, in uint4

// upconv: a 16x16 tile of low-resolution pixels, 1-pixel halo; each warp
// takes two tile rows and all 64 output channels of each phase.
constexpr int UP_TH = 16, UP_TW = 16;
constexpr int UP_RS = UP_TH + 2, UP_CS = UP_TW + 2;
constexpr size_t UP_SMEM = (size_t)UP_RS * UP_CS * CP * sizeof(bf16);
static_assert(NWARP * 2 == UP_TH && UP_TW == 16, "two 16-pixel tile rows per warp");

__global__ void __launch_bounds__(NTHREAD)
upconv_kernel(const bf16* __restrict__ x, const uint4* __restrict__ w,
              const float* __restrict__ bias, bf16* __restrict__ out, int h, int w_img, int r0,
              int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.z, ty0 = r0 + blockIdx.y * UP_TH, tx0 = blockIdx.x * UP_TW;
  ct::load_tile<CP>(buf, x + (size_t)n * NF * h * w_img, NF, h, w_img, ty0 - 1, tx0 - 1, UP_RS,
                    UP_CS);
  __syncthreads();

  const int H2 = 2 * rows, W2 = 2 * w_img;
  const int m0 = 2 * warp;
  const int pix = (1 + m0) * UP_CS + 1;  // low-res pixel (ty0 + m0, tx0)
#pragma unroll 1
  for (int ph = 0; ph < 4; ++ph) {
    const int a = ph >> 1, b = ph & 1;
    float acc[2][NF / 8][4];
    ct::mma_taps<NF, 2, NF / 16, 2, 2, UP_CS, CP, NF / 16>(
        acc, buf, pix + (a - 1) * UP_CS + (b - 1), UP_CS, w + (size_t)ph * PHASE_W, 0, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int iy = ty0 + m0 + i;
      if (iy >= r0 + rows) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ix = tx0 + g + 8 * hh;
        if (ix >= w_img) continue;
        bf16* o_px = out + ((size_t)n * NF * H2 + 2 * (iy - r0) + a) * W2 + 2 * ix + b;
#pragma unroll
        for (int jn = 0; jn < NF / 8; ++jn) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = 8 * jn + 2 * t + e;
            const float v = ct::lrelu(acc[i][jn][2 * hh + e] + bias[o]);
            o_px[(size_t)o * H2 * W2] = __float2bfloat16(v);
          }
        }
      }
    }
  }
}

// hr_conv + conv_last: an 8x16 output tile, 12x20 input tile (2-pixel
// halo), hr_conv computed on the tile rows [1, 11) as flat M-tiles, two
// per warp. Flat M-tiles wrap across tile rows; the wrapped outputs (tile
// columns 0 and 19, rows past 10) are never read by conv_last.
constexpr int HL_TH = 8, HL_TW = 16, HL_HALO = 2;
constexpr int HL_RS = HL_TH + 2 * HL_HALO, HL_CS = HL_TW + 2 * HL_HALO;
constexpr int HL_NPIX = HL_RS * HL_CS;
constexpr int HL_PAD = 32;  // slack pixels before and after the tile
constexpr int HL_BUF_PIX = HL_NPIX + 2 * HL_PAD;
constexpr int HL_NPAIR = (((HL_RS - 2) * HL_CS + 15) / 16 + 1) / 2;
constexpr size_t HL_SMEM = 2 * (size_t)HL_BUF_PIX * CP * sizeof(bf16);
static_assert(HL_NPAIR <= NWARP, "one pair of M-tiles per warp");
static_assert(HL_CS + 32 * HL_NPAIR + HL_CS + 1 <= HL_NPIX + HL_PAD, "slack");
static_assert(HL_TH == NWARP && HL_TW == 16, "one conv_last row per warp");

__global__ void __launch_bounds__(NTHREAD, 2)
hr_last_kernel(const bf16* __restrict__ x, const uint4* __restrict__ w_hr,
               const float* __restrict__ b_hr, const uint4* __restrict__ w_last,
               const float* __restrict__ b_last, bf16* __restrict__ out, int H, int W, int q0,
               int nq, int o0, int OH) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* in_buf = reinterpret_cast<bf16*>(smem);
  bf16* h3_buf = in_buf + (size_t)HL_BUF_PIX * CP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.z, ty0 = q0 + blockIdx.y * HL_TH, tx0 = blockIdx.x * HL_TW;
  const int gy0 = ty0 - HL_HALO, gx0 = tx0 - HL_HALO;

  ct::zero_smem(in_buf, (int)HL_SMEM);
  __syncthreads();
  bf16* in0 = in_buf + HL_PAD * CP;
  bf16* h30 = h3_buf + HL_PAD * CP;
  ct::load_tile<CP>(in0, x + (size_t)n * NF * H * W, NF, H, W, gy0, gx0, HL_RS, HL_CS);
  __syncthreads();
#ifdef BAND_PLANT
  if (q0 > 0 && blockIdx.y == 0) {  // tile row HL_HALO - 1 holds input row q0 - 1
    uint4* row = reinterpret_cast<uint4*>(in0 + (ptrdiff_t)(HL_HALO - 1) * HL_CS * CP);
    for (int i = threadIdx.x; i < HL_CS * CP / 8; i += NTHREAD) row[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
#endif

  // hr_conv + lrelu; zero outside the frame (conv_last's zero padding).
  if (warp < HL_NPAIR) {
    const int pix = HL_CS + 32 * warp;
    float acc[2][NF / 8][4];
    ct::mma_taps<NF, 2, NF / 16, 3, 3, HL_CS, CP, NF / 16>(acc, in0, pix - HL_CS - 1, 16, w_hr, 0,
                                                           lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = pix + 16 * i + g + 8 * hh;
        const int r = p / HL_CS, q = p - r * HL_CS;
        const int gy = gy0 + r, gx = gx0 + q;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int jn = 0; jn < NF / 8; ++jn) {
          const int o = 8 * jn + 2 * t;
          const float v0 = ct::lrelu(acc[i][jn][2 * hh] + b_hr[o]);
          const float v1 = ct::lrelu(acc[i][jn][2 * hh + 1] + b_hr[o + 1]);
          ct::store2(h30 + (ptrdiff_t)p * CP + o, inside ? v0 : 0.0f, inside ? v1 : 0.0f);
        }
      }
    }
  }
  __syncthreads();

  // conv_last on the output tile: one tile row per warp; the 3 outputs are
  // columns 0..2 of one 16-wide B block.
  const int oy = ty0 + warp;
  const int pix = (HL_HALO + warp) * HL_CS + HL_HALO;
  float acc[1][2][4];
  ct::mma_taps<NF, 1, 1, 3, 3, HL_CS, CP, 1>(acc, h30, pix - HL_CS - 1, 0, w_last, 0, lane);
  if (t > 1 || oy >= q0 + nq) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ox = tx0 + g + 8 * hh;
    if (ox >= W) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = 2 * t + e;
      if (o < 3)
        out[(((size_t)n * 3 + o) * OH + o0 + oy - q0) * W + ox] =
            __float2bfloat16(acc[0][0][2 * hh + e] + b_last[o]);
    }
  }
}

}  // namespace

namespace tail {

// x: (n, 64, h, w) bf16 NCHW; w: 4 phases of (4 * 64, 64) bf16 matrices,
// rows (tap, channel), each in fragment order; bias: 64 f32; out: (n, 64,
// 2 * rows, 2w), the input rows [r0, r0 + rows) upsampled (rows < 0: all
// h). Returns the CUDA error code of the launch.
inline int upconv(const void* x, const void* w, const void* bias, void* out, int n, int h,
                  int w_img, void* stream, int r0 = 0, int rows = -1) {
  if (rows < 0) rows = h;
  if (r0 < 0 || rows <= 0 || r0 + rows > h) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(upconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)UP_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((w_img + UP_TW - 1) / UP_TW, (rows + UP_TH - 1) / UP_TH, n);
  upconv_kernel<<<grid, NTHREAD, UP_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const uint4*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), h, w_img, r0, rows);
  return (int)cudaGetLastError();
}

// x: (n, 64, h, w) bf16 NCHW; w_hr: (9 * 64, 64) and w_last: (9 * 64, 16)
// (outputs 3..15 zero), rows (tap, channel), in fragment order; out: (n,
// 3, oh, w) bf16, whose rows [o0, o0 + nq) receive the input rows [q0, q0 +
// nq). Returns the CUDA error code of the launch.
inline int hr_last(const void* x, const void* w_hr, const void* b_hr, const void* w_last,
                   const void* b_last, void* out, int n, int h, int w_img, int q0, int nq, int o0,
                   int oh, void* stream) {
  if (q0 < 0 || nq <= 0 || q0 + nq > h || o0 < 0 || o0 + nq > oh) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(hr_last_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)HL_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((w_img + HL_TW - 1) / HL_TW, (nq + HL_TH - 1) / HL_TH, n);
  hr_last_kernel<<<grid, NTHREAD, HL_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const uint4*>(w_hr),
      static_cast<const float*>(b_hr), static_cast<const uint4*>(w_last),
      static_cast<const float*>(b_last), static_cast<bf16*>(out), h, w_img, q0, nq, o0, oh);
  return (int)cudaGetLastError();
}

}  // namespace tail
