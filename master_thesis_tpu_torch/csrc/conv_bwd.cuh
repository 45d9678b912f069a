// The pieces of the first designs of the port's backward kernels (K3
// csrc/rrdb_bwd.cu, K6 csrc/tail_bwd.cu). A backward of a chain of 3x3
// convs is, per conv and in reverse order:
//
//   prep:   dP = mask(d) rounded to bf16, where d is the f32 cotangent of
//           the conv's output and mask the lrelu slope from the sign of
//           the forward's post-activation (lrelu(v) >= 0 iff v >= 0); the
//           bias grad is the sum of the unrounded mask(d) over pixels;
//   wgrad:  dW[tap, c, o] = sum over pixels p of src[c, p + tap] * dP[o, p]
//           (an implicit GEMM with K = pixels);
//   adjoint conv: dIn = conv3x3(dP, W transposed and flipped), summed in
//           f32 into the cotangent of the conv's input.
//
// These are what the TPU kernels do per conv (pallas_rrdb.py:
// _rdb_bwd_block, pallas_tail.py:_tail_bwd_kernel) with the same rounding
// points: dP in bf16 before every product, f32 sums and cotangents, f32
// weight and bias grads. Products run on bf16 tensor cores (mma.sync
// m16n8k16, f32 accumulation). Borders: the tile loaders store exact zeros
// outside the frame, so a tap outside the frame contributes nothing in the
// adjoint and in the weight grads, as in the forward.
//
// Weight and bias grads are sums over all N * H * W pixels. Blocks here run
// in parallel and in no order, so each block writes its own partial sums
// (one row of a partial buffer per K-split) and reduce_kernel adds the rows
// in a fixed order: no float atomics, so two runs give bit-identical grads.
#pragma once

#include "conv_tile.cuh"

// A fault planted for the checks of chip_smoke.py, which must catch each:
// 1 masks with lrelu slope 0.25, 2 leaves the centre tap out of every
// weight grad, 3 drops every bias grad. 0 (the default) plants none.
#ifndef BWD_PLANT
#define BWD_PLANT 0
#endif

namespace cb {

constexpr float MASK_SLOPE = BWD_PLANT == 1 ? 0.25f : 0.2f;

using ct::bf16;

constexpr int TH = 8, TW = 16;           // output tile: 8 rows of 16 pixels
constexpr int RS = TH + 2, CS = TW + 2;  // the tile with a 1-pixel halo
constexpr int NPIX = RS * CS;

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Copies a rows x cols pixel-major tile (channel stride CP) of channels
// [0, CPAD) of one NCHW frame, with frame origin (gy0, gx0) in a frame of
// H x W pixels. Channels >= C and pixels outside the frame are zero. With
// UP the frame is the nearest-2x upsampling of `src` (H / 2 x W / 2): the
// upsampled image is read, never formed. The general loader behind
// ct::load_tile, for the 3-channel conv_last cotangent and the upsampled
// reads.
template <int CP, int CPAD, bool UP>
__device__ __forceinline__ void load_tile_any(bf16* dst, const bf16* __restrict__ src, int C,
                                              int H, int W, int gy0, int gx0, int rows,
                                              int cols) {
  const int np = rows * cols;
  const int hs = UP ? H / 2 : H, ws = UP ? W / 2 : W;
  const size_t plane = (size_t)hs * ws;
  for (int i = threadIdx.x; i < CPAD * np; i += blockDim.x) {
    const int c = i / np, p = i - c * np;
    const int r = p / cols, q = p - r * cols;
    const int gy = gy0 + r, gx = gx0 + q;
    bf16 v = __float2bfloat16(0.0f);
    if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int sy = UP ? gy >> 1 : gy, sx = UP ? gx >> 1 : gx;
      v = src[c * plane + (size_t)sy * ws + sx];
    }
    dst[(ptrdiff_t)p * CP + c] = v;
  }
}

template <int CP, int CPAD, bool UP>
__device__ __forceinline__ void load_tile_auto(bf16* dst, const bf16* __restrict__ src, int C,
                                               int H, int W, int gy0, int gx0, int rows,
                                               int cols) {
  if (!UP && C == CPAD && C % 8 == 0)
    ct::load_tile<CP>(dst, src, C, H, W, gy0, gx0, rows, cols);
  else
    load_tile_any<CP, CPAD, UP>(dst, src, C, H, W, gy0, gx0, rows, cols);
}

// ---------------------------------------------------------------------------
// prep: v = scale * in (f32 or bf16; with POOL the sum of the 2x2 block of
// an input at twice the resolution, the adjoint of a nearest-2x upsample);
// with `sign`, v = sign >= 0 ? v : 0.2 v; `out` (if set) = bf16(v); and
// partial[ks * pstride + poff + c] = the sum of v over block (ks, c)'s
// contiguous share of the N * H * W pixels. Grid (KS, C), 256 threads.
// Channel c of a tensor with CS channels per frame sits at (n * CS + c0 + c).
constexpr int PREP_THREADS = 256;

template <bool POOL>
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const float* __restrict__ in_f, const bf16* __restrict__ in_b, float scale, int in_cs,
            int ci0, const bf16* __restrict__ sign, int s_cs, int cs0, bf16* __restrict__ out,
            int o_cs, int co0, float* __restrict__ partial, long long pstride, long long poff,
            int N, int H, int W) {
  const int ks = blockIdx.x, KS = gridDim.x, c = blockIdx.y;
  const size_t plane = (size_t)H * W, total = (size_t)N * plane;
  const size_t chunk = (total + KS - 1) / KS;
  const size_t j0 = (size_t)ks * chunk, j1 = j0 + chunk < total ? j0 + chunk : total;
  float sum = 0.0f;
  for (size_t j = j0 + threadIdx.x; j < j1; j += PREP_THREADS) {
    const size_t n = j / plane, p = j - n * plane;
    float v;
    if (POOL) {
      const size_t y = p / W, x = p - y * W, w2 = 2 * (size_t)W;
      const float* q = in_f + (n * in_cs + ci0 + c) * 4 * plane + 2 * y * w2 + 2 * x;
      v = ((q[0] + q[1]) + q[w2]) + q[w2 + 1];
    } else {
      const size_t idx = (n * in_cs + ci0 + c) * plane + p;
      v = in_f != nullptr ? in_f[idx] : __bfloat162float(in_b[idx]);
    }
    v *= scale;
    if (sign != nullptr) {
      const float s = __bfloat162float(sign[(n * s_cs + cs0 + c) * plane + p]);
      v = s >= 0.0f ? v : MASK_SLOPE * v;
    }
    if (out != nullptr) out[(n * o_cs + co0 + c) * plane + p] = __float2bfloat16(v);
    sum += v;
  }
  if (partial == nullptr) return;
  __shared__ float red[PREP_THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < PREP_THREADS / 32; ++i) s += red[i];
    partial[ks * pstride + poff + c] = BWD_PLANT == 3 ? 0.0f : s;
  }
}

// ---------------------------------------------------------------------------
// conv3x3: a same-padded 3x3 conv of CIN input channels (cin_real of them
// loaded, the rest zero) into COUT output channels over an 8x16 output tile
// per block; 8 warps, each job two tile rows x 32 output channels. The
// weights are a (9 * CIN, COUT) matrix, rows (tap, channel), in fragment
// order (ops/fragments.py). For an adjoint conv they are the forward's
// transposed and flipped kernel, rows (tap, forward output channel).
// Epilogues:
//   OUT_F32        acc_f32 = (accumulate ? acc_f32 : 0) + sum
//   OUT_BF16_LRELU out_bf16 = bf16(lrelu(sum + bias))   (forward recompute)
//   OUT_RRDB_DX    the last adjoint of an RDB backward (conv1; COUT = 64,
//                  the RDB input's channels): d = gout + (acc_f32 + sum), the
//                  RDB's input cotangent (_rdb_bwd_block: g_out + dsrc[0]);
//                  out_f32 = d, or with gres (the RRDB's output cotangent)
//                  out_bf16 = bf16(d + gres) (_rrdb_bwd_kernel: dx_ref).
enum { OUT_F32 = 0, OUT_BF16_LRELU = 1, OUT_RRDB_DX = 2 };
constexpr int CONV_THREADS = 256;

template <int CIN, int COUT, int MODE>
__global__ void __launch_bounds__(CONV_THREADS)
conv3x3_kernel(const bf16* __restrict__ in, int in_cs, int cin_real, const uint4* __restrict__ w,
               const float* __restrict__ bias, float* acc_f32, int out_cs, int accumulate,
               float* __restrict__ out_f32, bf16* __restrict__ out_bf16,
               const float* __restrict__ gout, const bf16* __restrict__ gres, int H, int W) {
  constexpr int CP = CIN + 8;
  static_assert(COUT % 32 == 0 && CIN % 16 == 0, "32-channel jobs, 16-deep K steps");
  __shared__ __align__(16) bf16 buf[NPIX * CP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W;
  load_tile_auto<CP, CIN, false>(buf, in + (size_t)n * in_cs * plane, cin_real, H, W, ty0 - 1,
                                 tx0 - 1, RS, CS);
  __syncthreads();

  constexpr int NJOB = (TH / 2) * (COUT / 32);
#pragma unroll 1
  for (int job = warp; job < NJOB; job += CONV_THREADS / 32) {
    const int m0 = 2 * (job % (TH / 2)), ch = job / (TH / 2);
    const int pix = (1 + m0) * CS + 1;  // output pixel (ty0 + m0, tx0)
    float acc[2][4][4];
    ct::mma_taps<CIN, 2, 2, 3, 3, CS, CP, COUT / 16>(acc, buf, pix - CS - 1, CS, w, 2 * ch, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int oy = ty0 + m0 + i;
      if (oy >= H) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ox = tx0 + g + 8 * hh;
        if (ox >= W) continue;
        const size_t px = (size_t)oy * W + ox;
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = 32 * ch + 8 * jn + 2 * t + e;
            const float a = acc[i][jn][2 * hh + e];
            const size_t idx = ((size_t)n * out_cs + o) * plane + px;
            if (MODE == OUT_F32) {
              acc_f32[idx] = accumulate ? acc_f32[idx] + a : a;
            } else if (MODE == OUT_BF16_LRELU) {
              out_bf16[idx] = __float2bfloat16(ct::lrelu(a + bias[o]));
            } else {
              const size_t j = ((size_t)n * COUT + o) * plane + px;
              const float d = gout[j] + (acc_f32[idx] + a);
              if (gres != nullptr)
                out_bf16[j] = __float2bfloat16(d + __bfloat162float(gres[j]));
              else
                out_f32[j] = d;
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wgrad: partial[ks * pstride + poff + (tap * cin + c) * cout_real + o] =
// sum over the tiles ks, ks + KS, ... of sum over the tile's pixels p of
// src[c, p + off(tap)] * dP[o, p]. Block (chunk, ks) owns 32 input channels
// c of `src` (channels [0, ca) from src_a, the rest from src_b); warp k
// (of 9) owns tap k, all COUTP (>= cout_real) outputs. The GEMM's K is the
// pixels: both operands sit pixel-major in shared memory and reach the
// tensor cores through ldmatrix.trans (A: channels x pixels of the tap's
// shifted window; B: pixels x outputs). With UP, src is read as its
// nearest-2x upsampling (the upsample-convs' weight grads at the high
// resolution); H, W are the high resolution.
constexpr int WG_THREADS = 9 * 32;

template <int COUTP, bool UP>
__global__ void __launch_bounds__(WG_THREADS)
wgrad_kernel(const bf16* __restrict__ src_a, int ca, const bf16* __restrict__ src_b, int cb,
             int cin, const bf16* __restrict__ dp, int d_cs, int cout_real,
             float* __restrict__ partial, long long pstride, long long poff, int N, int H, int W) {
  constexpr int SCP = 32 + 8, DCP = COUTP + 8, NT = COUTP / 8;
  static_assert(COUTP % 16 == 0, "16-wide B loads");
  __shared__ __align__(16) bf16 sbuf[NPIX * SCP];
  __shared__ __align__(16) bf16 dbuf[TH * TW * DCP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tap = warp, dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int c0 = 32 * blockIdx.x, ks = blockIdx.y, KS = gridDim.y;
  const bf16* src = c0 < ca ? src_a : src_b;
  const int src_cs = c0 < ca ? ca : cb, sc0 = c0 < ca ? c0 : c0 - ca;
  const size_t src_plane = UP ? (size_t)(H / 2) * (W / 2) : (size_t)H * W;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int per_frame = tiles_x * tiles_y, ntiles = N * per_frame;

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // ldmatrix.x4.trans, lane l gives the row of matrix l / 8: A's four 8x8
  // matrices are (k 0-7 | 8-15) x (m 0-7 | 8-15) in a0..a3 order, B's are
  // k 0-7, k 8-15 of n 0-7, then of n 8-15 (b0, b1 of two n8 tiles).
  const int a_k = (lane >> 4) * 8 + (lane & 7), a_m = ((lane >> 3) & 1) * 8;
  const int b_k = ((lane >> 3) & 1) * 8 + (lane & 7), b_n = (lane >> 4) * 8;

#pragma unroll 1
  for (int tile = ks; tile < ntiles; tile += KS) {
    const int n = tile / per_frame, rem = tile - n * per_frame;
    const int ty0 = (rem / tiles_x) * TH, tx0 = (rem % tiles_x) * TW;
    __syncthreads();
    load_tile_auto<SCP, 32, UP>(sbuf, src + ((size_t)n * src_cs + sc0) * src_plane, 32, H, W,
                                ty0 - 1, tx0 - 1, RS, CS);
    load_tile_auto<DCP, COUTP, false>(dbuf, dp + (size_t)n * d_cs * H * W, cout_real, H, W, ty0,
                                      tx0, TH, TW);
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < TH; ++r) {
      const int apix = (r + 1 + dy) * CS + 1 + dx;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4_trans(a[mt], sbuf + (ptrdiff_t)(apix + a_k) * SCP + 16 * mt + a_m);
#pragma unroll
      for (int nb = 0; nb < COUTP / 16; ++nb) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, dbuf + (ptrdiff_t)(r * TW + b_k) * DCP + 16 * nb + b_n);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ct::mma_bf16(acc[mt][2 * nb], a[mt], b[0], b[1]);
          ct::mma_bf16(acc[mt][2 * nb + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  float* outp = partial + ks * pstride + poff;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = c0 + 16 * mt + g + 8 * (r >> 1), o = 8 * nt + 2 * t + (r & 1);
        const float v = BWD_PLANT == 2 && tap == 4 ? 0.0f : acc[mt][nt][r];
        if (o < cout_real) outp[((size_t)tap * cin + c) * cout_real + o] = v;
      }
}

// out[i] = sum over rows r = 0, 1, ... of partial[r * cols + i], in order.
__global__ void reduce_kernel(const float* __restrict__ partial, int rows, long long cols,
                              float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cols) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += partial[r * cols + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// Host launchers; each returns the CUDA error code of its launch.

inline int prep(const float* in_f, const bf16* in_b, float scale, int in_cs, int ci0,
                const bf16* sign, int s_cs, int cs0, bf16* out, int o_cs, int co0, float* partial,
                long long pstride, long long poff, int c, int n, int h, int w, int pool, int ks,
                cudaStream_t stream) {
  const dim3 grid(ks, c);
  if (pool)
    prep_kernel<true><<<grid, PREP_THREADS, 0, stream>>>(in_f, in_b, scale, in_cs, ci0, sign,
                                                         s_cs, cs0, out, o_cs, co0, partial,
                                                         pstride, poff, n, h, w);
  else
    prep_kernel<false><<<grid, PREP_THREADS, 0, stream>>>(in_f, in_b, scale, in_cs, ci0, sign,
                                                          s_cs, cs0, out, o_cs, co0, partial,
                                                          pstride, poff, n, h, w);
  return (int)cudaGetLastError();
}

template <int CIN, int COUT, int MODE>
inline int conv3x3(const bf16* in, int in_cs, int cin_real, const uint4* w, const float* bias,
                   float* acc_f32, int out_cs, int accumulate, float* out_f32, bf16* out_bf16,
                   const float* gout, const bf16* gres, int n, int h, int w_img,
                   cudaStream_t stream) {
  const dim3 grid((w_img + TW - 1) / TW, (h + TH - 1) / TH, n);
  conv3x3_kernel<CIN, COUT, MODE><<<grid, CONV_THREADS, 0, stream>>>(
      in, in_cs, cin_real, w, bias, acc_f32, out_cs, accumulate, out_f32, out_bf16, gout, gres, h,
      w_img);
  return (int)cudaGetLastError();
}

template <int COUTP, bool UP>
inline int wgrad(const bf16* src_a, int ca, const bf16* src_b, int cb, int cin, const bf16* dp,
                 int d_cs, int cout_real, float* partial, long long pstride, long long poff, int n,
                 int h, int w, int ks, cudaStream_t stream) {
  const dim3 grid(cin / 32, ks);
  wgrad_kernel<COUTP, UP><<<grid, WG_THREADS, 0, stream>>>(
      src_a, ca, src_b, cb, cin, dp, d_cs, cout_real, partial, pstride, poff, n, h, w);
  return (int)cudaGetLastError();
}

inline int reduce(const float* partial, int rows, long long cols, float* out,
                  cudaStream_t stream) {
  const int threads = 256;
  reduce_kernel<<<(unsigned)((cols + threads - 1) / threads), threads, 0, stream>>>(partial, rows,
                                                                                    cols, out);
  return (int)cudaGetLastError();
}

}  // namespace cb
