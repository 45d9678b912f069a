// K6, second design: the backward of the RRDBNet tail, channels-last, as
// wgmma implicit GEMMs in the 4-phase form, on the templates of K4
// (tail_wgmma.cuh: the phase-taps as shifted descriptors of resident
// 128-byte-swizzled tiles, the staged 16-byte stores) and K3
// (conv_bwd_wgmma.cuh: the MN-major weight-grad GEMM with K-split partials
// and a fixed-order reduce).
//
// Replaces: master_thesis_tpu/ops/pallas_tail.py:tail_bwd_pallas (body
// _tail_bwd_kernel), which per frame recomputes the tail in phase space in
// VMEM, runs the adjoints of conv_last, hr_conv, upconv2 and upconv1 with
// the lrelu masks from the post-activation signs (its _adj_pick_fn runs
// the fused 9-tap x 4 nf form, zero taps included), and writes dx and
// per-frame weight grads that XLA sums and folds back through
// fused_upsample_conv_kernel_adjoint.
//
// Computes, from x (N, h, w, 64) and the output cotangent g (N, 4h, 4w, 3),
// NHWC bf16, one ctypes call (tail_bwd.cu:tail_backward), 11 launches:
//   0  recompute h1 (N, 2h, 2w, 64), h2 and h3 (N, 4h, 4w, 64) with K4's
//      own stages (tw::stage 0, 1, 2);
//   1  last_kernel: dh3 = the adjoint of conv_last; dP_C =
//      bf16(mask_h3(dh3)); the bias partials of conv_last (sum g) and
//      hr_conv (sum of the unrounded masked dh3); conv_last's weight grad,
//      sum g x h3-taps. conv_last has 3 cotangent channels: g is written
//      into shared memory as an 8-channel plane beside a plane of zeros,
//      so the adjoint is an m64n64 wgmma at K = 16 a tap (3 used, not the
//      first design's 32) and the weight grad an m64n8 one (N = 8, 3 used);
//   2  adj_kernel<A_HR>: dh2 = conv(dP_C, hr_conv's kernel transposed and
//      flipped), K4's hr_conv template; the epilogue masks by h2, sums
//      upconv2's bias partials and stores dP_B = bf16(mask) phase-major,
//      (N, 2, 2, 2h, 2w, 64): h2 pixel (2i + a, 2j + b) to plane (a, b) at
//      (i, j);
//   3  wgrad_kernel<W_HR>: dW[tap][o][c] = sum_p dP_C[p, o] h2[p + tap, c];
//   4  adj_kernel<A_UP2>: upconv2's adjoint in the 4-phase form at 2h x 2w.
//      The forward has output (2i + a, 2j + b) read input (i + a - 1 + ti,
//      j + b - 1 + tj), ti, tj in {0, 1}, so dh1[r, s] = sum over a, b, ti,
//      tj of Wphi[a, b, ti, tj]^T dP_B[a, b][r - a + 1 - ti, s - b + 1 - tj]:
//      16 phase-taps over four plane tiles, K = 1024 a pixel. Plane (a, b)'s
//      box starts at (r0 - a, s0 - b), so its tap (ti, tj) is the tile
//      pixel (r + 1 - ti, m + 1 - tj) for every plane. The epilogue masks
//      by h1, sums upconv1's bias partials and stores dP_A phase-major;
//   5  wgrad_kernel<W_UP>: dWphi[a, b, ti, tj][o][c] = sum over i, j of
//      dP_B[a, b][i, j, o] h1[i + a - 1 + ti, j + b - 1 + tj, c];
//   6  adj_kernel<A_UP1> and wgrad_kernel<W_UP>: the same for upconv1 at
//      h x w over dP_A and x; dx is stored bf16 NHWC;
//   7  reduce_kernel: every K-split and bias partial summed in a fixed
//      order, and the phase weight grads folded back to 3x3 kernels, the
//      counterpart of fused_upsample_conv_kernel_adjoint in its 2x2-phase
//      form: dW[ky, kx] = sum over a, b of dWphi[a, b, t(a, ky), t(b, kx)],
//      t(0, .) = (0, 1, 1), t(1, .) = (0, 0, 1).
// Rounding as _tail_bwd_kernel and ops/tail_bwd.py:tail_bwd_plain: every dP
// is rounded to bf16 before a product, cotangents and sums are f32, dW and
// db f32, dx bf16. No f32 cotangent plane goes through device memory: each
// stage's epilogue writes the bf16 dP the next one reads. TMA's
// out-of-bounds zero fill is the zero padding at every frame border. No
// float atomics: every partial sum has its own slot, so two runs give
// bit-identical dx, dW and db.
//
// The adjoints (stages 2, 4, 6) are K4's implicit GEMM (M = 64 output
// pixels of a row, N = 64, K = taps x 64): B for every tap resident in
// shared memory, A the dP tile by one 128-byte-swizzled TMA box a plane
// into a ring, a tap a shifted start address (sw_desc, base offset 0).
// The weight grads (stages 3, 5) are K3's GEMM with K = pixels: A = a tile
// of ROWS x 64 pixels of dP, B = the source tile with its halo, both
// MN-major and 128-byte swizzled (a pixel's 64 channels are one 128-byte
// row, so the same one TMA box serves), a tap a one-pixel (128-byte)
// shift of B's start; a CTA is one unit (hr_conv's 9 taps, or one phase's
// 4) and one K-split, warpgroup wg takes the taps of tile row offset wg.
//
// Bound on an H100 SXM at the train shape (x 8 x 64 x 64 -> 8 x 3 x 256 x
// 256): 184 GFLOP (ops/tail_bwd.py:tail_bwd_flops: the recompute 60, the
// adjoints and weight grads 62 each, with the upsample-convs in the phase
// form), 0.186 ms at 989 TFLOP/s bf16; bytes (x, g in, dx out) ~11 MB. So
// it is bound by operations. What the first design (conv_bwd.cuh, 17
// launches) lost and this one does about it: (1) mma.sync everywhere ->
// wgmma for every product but conv_last's; (2) the upsample-convs'
// backward at 9 taps a high-res pixel -> the 4-phase form's 4; (3)
// conv_last's cotangent padded to 32 channels for the adjoint and 16 for
// the weight grad -> 16 (K) and 8 (N); (4) ~263 GFLOP of products -> 199
// (the 184 of the bound, conv_last's 1.8 at 5.3x and 2.7x); (5) an f32 cotangent
// round trip of ~0.8 GB -> bf16 dP written once by an epilogue; (6) NCHW
// with layout copies around the tail -> NHWC in and out.
//
// Planted faults for the checks on the card (-DBWD_PLANT, as in
// conv_bwd.cuh): 1 masks with lrelu slope 0.25, 2 leaves the centre tap
// out of every weight grad, 3 drops every bias grad, 4 has upconv2's
// adjoint read phase plane (0, 1) where (1, 0) belongs.
// Tiling, from a sweep of variants on the card (PERF.md): weight grads 2
// rows a tile x 4 stages, K-splits 128 / 32; conv_last 1 row a
// warpgroup, 128 producer threads, 3 stages.
#pragma once

#include "tail_wgmma.cuh"

#ifndef BWD_PLANT
#define BWD_PLANT 0
#endif

// Internal linkage, as in conv3x3_wgmma.cuh: variant libraries loaded into
// one process keep their own kernels and once-per-kernel state.
namespace tb {
namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64, RUN = 64;
constexpr float SLOPE = BWD_PLANT == 1 ? 0.25f : 0.2f;
// Rows of the partial sums of last_kernel and the adjoints (a CTA writes
// its row and zeroes the rows past the grid); grids are capped at BROWS.
constexpr int BROWS = 512;
// Bias partial columns: conv_last, hr_conv, upconv2, upconv1.
constexpr int B_LAST = 0, B_HR = 3, B_UP2 = B_HR + C, B_UP1 = B_UP2 + C, BSTRIDE = B_UP1 + C;
constexpr int LAST_W = 3 * C * 9;  // conv_last's weight grad, OIHW
constexpr int TAP_W = C * C;       // one tap's weight grad, [o][c]
constexpr int W_SIZE = 9 * TAP_W;  // a 64 -> 64 3x3 kernel
constexpr int KS_HR = 128, KS_UP = 32;  // K-splits of the weight grads
constexpr int HR_ROW = 9 * TAP_W;      // a K-split row of hr_conv's weight grad
constexpr int UP_UNIT = 4 * TAP_W;     // one phase's 4 taps
constexpr int UP_ROW = 4 * UP_UNIT;    // a K-split row of an upsample-conv's
// The grads, f32, in the order of ops/tail_bwd.py:PARAM_NAMES, kernels OIHW.
constexpr int G_UP1W = 0, G_UP1B = G_UP1W + W_SIZE, G_UP2W = G_UP1B + C, G_UP2B = G_UP2W + W_SIZE,
              G_HRW = G_UP2B + C, G_HRB = G_HRW + W_SIZE, G_LASTW = G_HRB + C,
              G_LASTB = G_LASTW + LAST_W, GRADS = G_LASTB + 3;
// Kernel launches of one backward: 3 recompute, last, 2 x 3 (adjoint, wgrad), reduce.
constexpr int LAUNCHES = 3 + 1 + 6 + 1;

__host__ __device__ constexpr int align1024(int b) { return (b + 1023) / 1024 * 1024; }

// D (64 x 64 f32) += A (64 x 16) B (16 x 64), both MN-major in shared
// memory; D's register layout as cw::mma_ss.
__device__ __forceinline__ void mma_tt(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ float masked(float v, float sign) {
  return sign >= 0.0f ? v : SLOPE * v;
}

// D (64 x 8 f32) += A (64 x 16) B (16 x 8), both MN-major in shared memory;
// thread l of warp w holds d[2 i + e] = D[16 w + l / 4 + 8 i][2 (l % 4) + e].
__device__ __forceinline__ void mma_tt(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// Stage 1: conv_last. Per tile of ROWS x 64 pixels, in a ring stage: h3's
// box by TMA (for the weight grad's taps and the mask), and g's box written
// by the producer threads as an 8-channel plane (3 channels and 5 zeros a
// pixel, 16 bytes, no swizzle; g's 6-byte pixels are no TMA stride),
// beside one plane of zeros that is channels 8-15 of every k16
// step. Then
//   adjoint  dh3 (64 pixels x 64) = sum over 9 taps of g's shifted plane (K
//            16, 3 used) x the tap's block of the flipped, transposed kernel;
//   wgrad    dW^T[tap] (64 c x 8 o, 3 used) += h3's tap-shifted box
//            (MN-major, swizzled) x g's centre pixels (MN-major);
// and the epilogue masks by h3's centre pixel, sums the bias partials of
// hr_conv and conv_last and stores dP_C. A stage's full barrier counts the
// TMA bytes and the producer threads that wrote its g plane.

struct LastCfg {
  static constexpr int RPW = 1, WG = 2, S = 3;
  static constexpr int ROWS = RPW * WG, TR = ROWS + 2, TWC = RUN + 2;
  static constexpr int NCONS = 128 * WG, NPROD = 128, NTHREAD = NCONS + NPROD;
  static constexpr uint32_t H_TX = TR * TWC * 128;
  static constexpr int H_BYTES = align1024(H_TX);
  static constexpr int G_BYTES = (TR * TWC * 16 + 127) / 128 * 128;
  static constexpr int B_BYTES = 9 * 16 * C * 2;  // a k16 block a tap
  static constexpr int STG = RPW * RUN * 128;
  static constexpr int H_OFF = B_BYTES, G_OFF = H_OFF + S * H_BYTES;  // S g planes, the zeros
  static constexpr int STG_OFF = G_OFF + (S + 1) * G_BYTES, BAR_OFF = STG_OFF + WG * STG;
  static constexpr int SMEM = BAR_OFF + (2 * S + 1) * 8;
};

struct LastArgs {
  const bf16* w;   // the adjoint's B (ops/tail_bwd.py:pack_tail_bwd, "last_adj")
  const bf16* g;   // (N, H, W, 3)
  bf16* dpc;       // (N, H, W, 64)
  float* wpart;    // row b at wpart + b * LAST_W, OIHW
  float* bpart;    // row b at bpart + b * BSTRIDE
  int H, W, frames;
};

__global__ void __launch_bounds__(LastCfg::NTHREAD)
last_kernel(__grid_constant__ const CUtensorMap hmap, const LastArgs a) {
  using Q = LastCfg;
  constexpr int RPW = Q::RPW, S = Q::S, ROWS = Q::ROWS, NCONS = Q::NCONS, TWC = Q::TWC;
  extern __shared__ __align__(1024) unsigned char tb_smem[];
  unsigned char* smem = tb_smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Q::BAR_OFF);
  const uint32_t full0 = cw::smem_u32(bars), empty0 = cw::smem_u32(bars + S);
  const uint32_t bfull = cw::smem_u32(bars + 2 * S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int runs = (a.W + RUN - 1) / RUN, groups = (a.H + ROWS - 1) / ROWS;
  const int tiles = runs * groups * a.frames;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      cw::mbar_init(full0 + 8 * s, 1 + Q::NPROD);  // the TMA's bytes, the g plane's writers
      cw::mbar_init(empty0 + 8 * s, NCONS);
    }
    cw::mbar_init(bfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < Q::G_BYTES / 16; i += Q::NTHREAD)
    reinterpret_cast<uint4*>(smem + Q::G_OFF + S * Q::G_BYTES)[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (cw::smem_u32(smem) & 1023) __trap();

  if (warp >= NCONS / 32) {  // the producers: thread 0 the loads, every thread g's plane
    const int pt = threadIdx.x - NCONS;
    if (pt == 0) {
      cw::mbar_expect_tx(bfull, Q::B_BYTES);
      cw::bulk_load(cw::smem_u32(smem), a.w, Q::B_BYTES, bfull);
    }
    int q = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++q) {
      const int x0 = (t % runs) * RUN, y0 = (t / runs % groups) * ROWS, n = t / (runs * groups);
      const int s = q % S, u = q / S;
      if (u > 0) cw::mbar_wait(empty0 + 8 * s, (u - 1) & 1);
      if (pt == 0) {
        cw::mbar_expect_tx(full0 + 8 * s, Q::H_TX);
        cw::tma_load_4d(cw::smem_u32(smem + Q::H_OFF + s * Q::H_BYTES), &hmap, 0, x0 - 1, y0 - 1,
                        n, full0 + 8 * s);
      }
      // g's box from (y0 - 1, x0 - 1), zeros outside the frame.
      unsigned char* gpl = smem + Q::G_OFF + s * Q::G_BYTES;
#pragma unroll 4
      for (int v = pt; v < Q::TR * TWC; v += Q::NPROD) {
        const int yy = y0 - 1 + v / TWC, xx = x0 - 1 + v % TWC;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) {
          const unsigned short* gp = reinterpret_cast<const unsigned short*>(
              a.g + (((size_t)n * a.H + yy) * a.W + xx) * 3);
          val.x = (uint32_t)gp[0] | ((uint32_t)gp[1] << 16);
          val.y = gp[2];
        }
        *reinterpret_cast<uint4*>(gpl + v * 16) = val;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cw::mbar_arrive(full0 + 8 * s);
    }
    return;
  }

  const int wgi = warp >> 2, wl = warp & 3, tt = threadIdx.x & 127, tid = threadIdx.x;
  const int g = lane >> 2, q4 = lane & 3;
  unsigned char* stg = smem + Q::STG_OFF + wgi * Q::STG;
  float bsum[8][2], dwl[9][4];
  float bl0 = 0.0f, bl1 = 0.0f, bl2 = 0.0f;  // conv_last's bias: sum g
#pragma unroll
  for (int j = 0; j < 8; ++j) bsum[j][0] = bsum[j][1] = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) dwl[k][0] = dwl[k][1] = dwl[k][2] = dwl[k][3] = 0.0f;
  cw::mbar_wait(bfull, 0);
  const uint32_t b_base = cw::smem_u32(smem);
  const uint32_t zeros = cw::smem_u32(smem + Q::G_OFF + S * Q::G_BYTES);

  int q = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++q) {
    const int x0 = (t % runs) * RUN, y0 = (t / runs % groups) * ROWS, n = t / (runs * groups);
    const int s = q % S;
    unsigned char* hs = smem + Q::H_OFF + s * Q::H_BYTES;
    const unsigned char* gpl = smem + Q::G_OFF + s * Q::G_BYTES;
    const uint32_t h_base = cw::smem_u32(hs), g_base = cw::smem_u32(gpl);
    cw::mbar_wait(full0 + 8 * s, (q / S) & 1);
    float acc[RPW][32];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[r][i] = 0.0f;
      cw::fence_acc(acc[r]);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) cw::fence_acc(dwl[k]);
    cw::wgmma_fence();
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = wgi * RPW + r;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t at = g_base + ((row + tap / 3) * TWC + tap % 3) * 16;
        cw::mma_ss(acc[r], cw::make_desc(at, zeros - g_base, 128),
                   cw::make_desc(b_base + tap * 2048, 1024, 128));
      }
#pragma unroll
      for (int kk = 0; kk < RUN / 16; ++kk) {
        const uint64_t bd = cw::make_desc(g_base + ((row + 1) * TWC + 1 + 16 * kk) * 16, 128, 128);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          mma_tt(dwl[tap],
                 tw::sw_desc(h_base + ((row + tap / 3) * TWC + tap % 3 + 16 * kk) * 128), bd);
      }
    }
    cw::wgmma_commit();
    cw::wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < RPW; ++r) cw::fence_acc(acc[r]);
#pragma unroll
    for (int k = 0; k < 9; ++k) cw::fence_acc(dwl[k]);

    // Epilogue: mask by h3's centre pixel and read g's for conv_last's bias
    // (both in the stage), stage, store dP_C.
    cw::named_sync(1 + wgi, 128);
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = 16 * wl + g + 8 * i, sp = r * RUN + m;
        const int y = y0 + wgi * RPW + r, xc = x0 + m;
        const bool inside = y < a.H && xc < a.W;
        const int hp = (wgi * RPW + r + 1) * TWC + m + 1;
        if (inside && q4 == 0) {
          const bf16* gv = reinterpret_cast<const bf16*>(gpl + hp * 16);
          bl0 += __bfloat162float(gv[0]);
          bl1 += __bfloat162float(gv[1]);
          bl2 += __bfloat162float(gv[2]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v0 = acc[r][4 * j + 2 * i], v1 = acc[r][4 * j + 2 * i + 1];
          if (!inside) {
            v0 = v1 = 0.0f;
          } else {
            const __nv_bfloat162 sv = *reinterpret_cast<const __nv_bfloat162*>(
                hs + hp * 128 + ((j ^ (hp & 7)) << 4) + 4 * q4);
            v0 = masked(v0, __bfloat162float(sv.x));
            v1 = masked(v1, __bfloat162float(sv.y));
            bsum[j][0] += v0;
            bsum[j][1] += v1;
          }
          *reinterpret_cast<__nv_bfloat162*>(stg + sp * 128 + ((j ^ (sp & 7)) << 4) + 4 * q4) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    cw::mbar_arrive(empty0 + 8 * s);  // the stage read by the wgmmas and the epilogue
    cw::named_sync(1 + wgi, 128);
    for (int v = tt; v < RPW * RUN * 8; v += 128) {
      const int sp = v >> 3, c8 = v & 7, m = sp % RUN, r = sp / RUN;
      const int y = y0 + wgi * RPW + r, xc = x0 + m;
      if (y >= a.H || xc >= a.W) continue;
      *reinterpret_cast<uint4*>(a.dpc + (((size_t)n * a.H + y) * a.W + xc) * C + 8 * c8) =
          *reinterpret_cast<const uint4*>(stg + sp * 128 + ((c8 ^ (sp & 7)) << 4));
    }
  }

  // The CTA's sums through the staging areas, in a fixed order: hr_conv's
  // bias (lanes, then warps), conv_last's weight grad (warpgroups), its
  // bias (lanes, then warps).
  cw::named_sync(1 + Q::WG, NCONS);
  float* red = reinterpret_cast<float*>(smem + Q::STG_OFF);
  float* rw = red + (NCONS / 32) * C;
  float* rl = rw + LAST_W;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = cw::col_sum(bsum[j][e]);
      if (g == 0) red[warp * C + 8 * j + 2 * q4 + e] = v;
    }
  float l0 = bl0, l1 = bl1, l2 = bl2;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    l2 += __shfl_xor_sync(0xffffffffu, l2, off);
  }
  if (lane == 0) {
    rl[warp * 3] = l0;
    rl[warp * 3 + 1] = l1;
    rl[warp * 3 + 2] = l2;
  }
  for (int w = 0; w < Q::WG; ++w) {
    if (wgi == w) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = 2 * q4 + e, c = 16 * wl + g + 8 * i;
            if (o < 3) {
              float* r = rw + (o * C + c) * 9 + tap;
              *r = (w == 0 ? 0.0f : *r) + dwl[tap][2 * i + e];
            }
          }
    }
    cw::named_sync(1 + Q::WG, NCONS);
  }
  for (int i = tid; i < LAST_W; i += NCONS) a.wpart[(size_t)blockIdx.x * LAST_W + i] = rw[i];
  if (tid < C + 3) {
    float sum = 0.0f;
    if (tid < C) {
      for (int w = 0; w < NCONS / 32; ++w) sum += red[w * C + tid];
    } else {
      for (int w = 0; w < NCONS / 32; ++w) sum += rl[w * 3 + tid - C];
    }
    const int col = tid < C ? B_HR + tid : B_LAST + tid - C;
    a.bpart[(size_t)blockIdx.x * BSTRIDE + col] = BWD_PLANT == 3 ? 0.0f : sum;
    for (int r = blockIdx.x + gridDim.x; r < BROWS; r += gridDim.x)
      a.bpart[(size_t)r * BSTRIDE + col] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Stages 2, 4, 6: the adjoints.

constexpr int A_HR = 0, A_UP2 = 1, A_UP1 = 2;

template <int MODE> struct AdjMode {  // the upsample-convs: 4 planes of 4 taps
  static constexpr int RPW = 1, WG = 2, S = 3, NP = 4, T = 4, EXT = 1;
};
template <> struct AdjMode<A_HR> {  // hr_conv: one plane of 9 taps
  static constexpr int RPW = 2, WG = 2, S = 2, NP = 1, T = 9, EXT = 2;
};

template <int MODE>
struct AdjCfg : AdjMode<MODE> {
  using M = AdjMode<MODE>;
  static constexpr int ROWS = M::RPW * M::WG, TR = ROWS + M::EXT, TWC = RUN + M::EXT;
  static constexpr int NCONS = 128 * M::WG, NTHREAD = NCONS + 32;
  // A ring stage: one plane's tile, one TMA box of all 64 channels, 128-byte
  // swizzled, 1024-byte aligned.
  static constexpr uint32_t A_TX = TR * TWC * 128;
  static constexpr int A_BYTES = align1024(A_TX);
  static constexpr int PLANE_B = M::T * C * C * 2;  // one plane's B
  static constexpr int B_BYTES = M::NP * PLANE_B;
  static constexpr int STG = M::RPW * RUN * 128;  // a warpgroup's staging area
  static constexpr int A_OFF = B_BYTES, STG_OFF = A_OFF + M::S * A_BYTES;
  static constexpr int BAR_OFF = STG_OFF + M::WG * STG;
  static constexpr int SMEM = BAR_OFF + (2 * M::S + 1) * 8;
};

struct AdjArgs {
  const bf16* w;     // the packed B of every plane and tap (ops/fragments.py)
  const bf16* sign;  // the mask's post-activation on the output grid (h2, h1), NHWC; A_UP1: null
  bf16* out;         // A_HR dP_B, A_UP2 dP_A: (N, 2, 2, H / 2, W / 2, 64); A_UP1 dx (N, H, W, 64)
  float* bpart;      // the bias partials' first column (row b at bpart + b * BSTRIDE); A_UP1: null
  int H, W, frames;  // the output grid, which is the input planes' grid
  int plant_plane;   // BWD_PLANT 4: the plane read in place of plane (1, 0) (-1: none)
};

// One adjoint over the tiles of ROWS x 64 output pixels of every frame; CTA
// b takes the tiles b, b + gridDim.x, ... and writes its bias sums to row
// b of bpart. A_HR reads dP_C through `dmap` ((N, H, W) frames); the
// upsample-convs read the four planes of their dP ((4 N, H, W) frames,
// plane 4 n + 2 a + b).
template <int MODE>
__global__ void __launch_bounds__(AdjCfg<MODE>::NTHREAD)
adj_kernel(__grid_constant__ const CUtensorMap dmap, const AdjArgs a) {
  using Q = AdjCfg<MODE>;
  constexpr int RPW = Q::RPW, S = Q::S, NP = Q::NP, T = Q::T, ROWS = Q::ROWS;
  constexpr int NCONS = Q::NCONS, TWC = Q::TWC;
  extern __shared__ __align__(1024) unsigned char tb_smem[];
  unsigned char* smem = tb_smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Q::BAR_OFF);
  const uint32_t full0 = cw::smem_u32(bars), empty0 = cw::smem_u32(bars + S);
  const uint32_t bfull = cw::smem_u32(bars + 2 * S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int runs = (a.W + RUN - 1) / RUN, groups = (a.H + ROWS - 1) / ROWS;
  const int tiles = runs * groups * a.frames;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      cw::mbar_init(full0 + 8 * s, 1);
      cw::mbar_init(empty0 + 8 * s, NCONS);
    }
    cw::mbar_init(bfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (cw::smem_u32(smem) & 1023) __trap();  // the swizzle pattern needs 1024-byte stages

  if (warp == NCONS / 32) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      constexpr int PIECE = 16384;
      cw::mbar_expect_tx(bfull, Q::B_BYTES);
      for (int off = 0; off < Q::B_BYTES; off += PIECE)
        cw::bulk_load(cw::smem_u32(smem) + off, a.w + off / 2,
                      Q::B_BYTES - off < PIECE ? Q::B_BYTES - off : PIECE, bfull);
      int q = 0;  // planes loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int x0 = (t % runs) * RUN, y0 = (t / runs % groups) * ROWS, n = t / (runs * groups);
        for (int pl = 0; pl < NP; ++pl, ++q) {
          const int s = q % S, u = q / S;
          if (u > 0) cw::mbar_wait(empty0 + 8 * s, (u - 1) & 1);
          const uint32_t full = full0 + 8 * s, dst = cw::smem_u32(smem + Q::A_OFF + s * Q::A_BYTES);
          cw::mbar_expect_tx(full, Q::A_TX);
          if (NP == 1) {
            cw::tma_load_4d(dst, &dmap, 0, x0 - 1, y0 - 1, n, full);
          } else {
            const int src = pl == 2 && a.plant_plane >= 0 ? a.plant_plane : pl;
            cw::tma_load_4d(dst, &dmap, 0, x0 - (pl & 1), y0 - (pl >> 1), 4 * n + src, full);
          }
        }
      }
    }
    return;
  }

  const int wgi = warp >> 2, wl = warp & 3, tt = threadIdx.x & 127;
  const int g = lane >> 2, q4 = lane & 3;
  unsigned char* stg = smem + Q::STG_OFF + wgi * Q::STG;
  float bsum[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) bsum[j][0] = bsum[j][1] = 0.0f;
  cw::mbar_wait(bfull, 0);
  const uint32_t b_base = cw::smem_u32(smem);

  int q = 0;  // planes consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int x0 = (t % runs) * RUN, y0 = (t / runs % groups) * ROWS, n = t / (runs * groups);
    float acc[RPW][32];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[r][i] = 0.0f;
#pragma unroll 1
    for (int pl = 0; pl < NP; ++pl, ++q) {
      const int s = q % S;
      const uint32_t a_base = cw::smem_u32(smem + Q::A_OFF + s * Q::A_BYTES);
      cw::mbar_wait(full0 + 8 * s, (q / S) & 1);
#pragma unroll
      for (int r = 0; r < RPW; ++r) cw::fence_acc(acc[r]);
      cw::wgmma_fence();
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
#pragma unroll
        for (int tap = 0; tap < T; ++tap) {
          // The tile row and column of the tap's first pixel: hr_conv's tap
          // (ky, kx) at (ky, kx); an upsample-conv's (ti, tj) at (1 - ti, 1 - tj).
          const int ky = MODE == A_HR ? tap / 3 : 1 - (tap >> 1);
          const int kx = MODE == A_HR ? tap % 3 : 1 - (tap & 1);
#pragma unroll
          for (int st = 0; st < 2; ++st) {
            const uint64_t bd = cw::make_desc(
                b_base + pl * Q::PLANE_B + ((cc * T + tap) * 2 + st) * 2 * 8 * 128, 8 * 128, 128);
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
              const int pix = (wgi * RPW + r + ky) * TWC + kx;
              cw::mma_ss(acc[r], tw::sw_desc(a_base + pix * 128 + 32 * (2 * cc + st)), bd);
            }
          }
        }
      cw::wgmma_commit();
      cw::wgmma_wait<1>();
#pragma unroll
      for (int r = 0; r < RPW; ++r) cw::fence_acc(acc[r]);
      if (pl > 0) cw::mbar_arrive(empty0 + 8 * ((q - 1) % S));
    }
    // The mask's signs, loaded while the last wgmmas run.
    __nv_bfloat162 sgn[RPW][2][8];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int y = y0 + wgi * RPW + r, xc = x0 + 16 * wl + g + 8 * i;
        const bool load = MODE != A_UP1 && y < a.H && xc < a.W;
        const bf16* sg = load ? a.sign + (((size_t)n * a.H + y) * a.W + xc) * C + 2 * q4 : nullptr;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sgn[r][i][j] = load ? *reinterpret_cast<const __nv_bfloat162*>(sg + 8 * j)
                              : __floats2bfloat162_rn(0.0f, 0.0f);
      }
    cw::wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < RPW; ++r) cw::fence_acc(acc[r]);
    cw::mbar_arrive(empty0 + 8 * ((q - 1) % S));

    // Epilogue through the warpgroup's staging area: pixel sp = r * 64 + m
    // at byte sp * 128, its 16-byte chunk j at (j ^ sp % 8) * 16.
    cw::named_sync(1 + wgi, 128);  // the last tile's stores have read it
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = 16 * wl + g + 8 * i, sp = r * RUN + m;
        const int y = y0 + wgi * RPW + r, xc = x0 + m;
        const bool inside = y < a.H && xc < a.W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v0 = acc[r][4 * j + 2 * i], v1 = acc[r][4 * j + 2 * i + 1];
          if (!inside) {
            v0 = v1 = 0.0f;
          } else if (MODE != A_UP1) {
            const __nv_bfloat162 sv = sgn[r][i][j];
            v0 = masked(v0, __bfloat162float(sv.x));
            v1 = masked(v1, __bfloat162float(sv.y));
            bsum[j][0] += v0;
            bsum[j][1] += v1;
          }
          *reinterpret_cast<__nv_bfloat162*>(stg + sp * 128 + ((j ^ (sp & 7)) << 4) + 4 * q4) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    cw::named_sync(1 + wgi, 128);
    for (int v = tt; v < RPW * RUN * 8; v += 128) {
      const int sp = v >> 3, c8 = v & 7, m = sp % RUN, r = sp / RUN;
      const int y = y0 + wgi * RPW + r, xc = x0 + m;
      if (y >= a.H || xc >= a.W) continue;
      // The phase-major store: pixel (2i + a, 2j + b) to plane (a, b) at (i, j).
      const size_t o =
          MODE == A_UP1
              ? (((size_t)n * a.H + y) * a.W + xc) * C
              : ((((size_t)n * 4 + 2 * (y & 1) + (xc & 1)) * (a.H >> 1) + (y >> 1)) * (a.W >> 1) +
                 (xc >> 1)) * C;
      *reinterpret_cast<uint4*>(a.out + o + 8 * c8) =
          *reinterpret_cast<const uint4*>(stg + sp * 128 + ((c8 ^ (sp & 7)) << 4));
    }
  }

  // The CTA's bias sums: lanes, then warps in order, through the staging
  // areas (every tile's stores have read them after the barrier).
  if (MODE == A_UP1) return;
  cw::named_sync(1 + Q::WG, NCONS);
  float* red = reinterpret_cast<float*>(smem + Q::STG_OFF);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = cw::col_sum(bsum[j][e]);
      if (g == 0) red[warp * C + 8 * j + 2 * q4 + e] = v;
    }
  cw::named_sync(1 + Q::WG, NCONS);
  if (threadIdx.x < C) {
    float sum = 0.0f;
    for (int w = 0; w < NCONS / 32; ++w) sum += red[w * C + threadIdx.x];
    a.bpart[(size_t)blockIdx.x * BSTRIDE + threadIdx.x] = BWD_PLANT == 3 ? 0.0f : sum;
    for (int r = blockIdx.x + gridDim.x; r < BROWS; r += gridDim.x)
      a.bpart[(size_t)r * BSTRIDE + threadIdx.x] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Stages 3, 5, 6: the weight grads.

constexpr int W_HR = 0, W_UP = 1;

template <int MODE> struct WgMode {  // an upsample-conv: a unit a phase, 2 x 2 taps
  static constexpr int TPW = 2, WG = 2, EXT = 1, UNITS = 4, KS = KS_UP, ROW = UP_ROW;
};
template <> struct WgMode<W_HR> {  // hr_conv: one unit of 3 x 3 taps
  static constexpr int TPW = 3, WG = 3, EXT = 2, UNITS = 1, KS = KS_HR, ROW = HR_ROW;
};

template <int MODE>
struct WgCfg : WgMode<MODE> {
  using M = WgMode<MODE>;
  static constexpr int ROWS = 2, S = 4;
  static constexpr int SR = ROWS + M::EXT, TWS = RUN + M::EXT;  // the source tile
  static constexpr int NCONS = 128 * M::WG, NTHREAD = NCONS + 32;
  static constexpr int D_BYTES = ROWS * RUN * 128;
  static constexpr uint32_t S_TX = SR * TWS * 128;
  static constexpr int S_BYTES = align1024(S_TX);
  static constexpr int STAGE = D_BYTES + S_BYTES;
  static constexpr uint32_t TX = D_BYTES + S_TX;
  static constexpr int SMEM = S * STAGE + 2 * S * 8;
};

struct WgArgs {
  float* part;        // K-split row ks at part + ks * ROW, unit u at + u * (ROW / UNITS)
  int H, W, frames;   // dP's grid (which is the source's) and frames
};

// CTA (unit u, K-split ks): the unit's weight grads over the tiles ks, ks +
// KS, ... of ROWS x 64 pixels of dP. hr_conv: D = dP_C, source h2 from (-1,
// -1), warpgroup wg the taps (wg, 0..2). Phase u = 2 a + b: D = plane u of
// dP ((4 N, H, W) frames), the source from (a - 1, b - 1), warpgroup ti the
// taps (ti, 0..1). Tile pixel (r + wg, m + t) is tap (wg, t)'s source.
template <int MODE>
__global__ void __launch_bounds__(WgCfg<MODE>::NTHREAD)
wgrad_kernel(__grid_constant__ const CUtensorMap dmap, __grid_constant__ const CUtensorMap smap,
             const WgArgs a) {
  using Q = WgCfg<MODE>;
  constexpr int ROWS = Q::ROWS, S = Q::S, KS = Q::KS, NCONS = Q::NCONS, TPW = Q::TPW;
  constexpr int TWS = Q::TWS;
  extern __shared__ __align__(1024) unsigned char tb_smem[];
  unsigned char* smem = tb_smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S * Q::STAGE);
  const uint32_t full0 = cw::smem_u32(bars), empty0 = cw::smem_u32(bars + S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x / KS, ks = blockIdx.x % KS;
  const int oy = MODE == W_HR ? -1 : (u >> 1) - 1, ox = MODE == W_HR ? -1 : (u & 1) - 1;
  const int runs = (a.W + RUN - 1) / RUN, groups = (a.H + ROWS - 1) / ROWS;
  const int tiles = runs * groups * a.frames;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      cw::mbar_init(full0 + 8 * s, 1);
      cw::mbar_init(empty0 + 8 * s, NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (cw::smem_u32(smem) & 1023) __trap();

  if (warp == NCONS / 32) {
    if (lane == 0) {
      int q = 0;
      for (int t = ks; t < tiles; t += KS, ++q) {
        const int x0 = (t % runs) * RUN, y0 = (t / runs % groups) * ROWS, n = t / (runs * groups);
        const int s = q % S, v = q / S;
        if (v > 0) cw::mbar_wait(empty0 + 8 * s, (v - 1) & 1);
        const uint32_t full = full0 + 8 * s, dst = cw::smem_u32(smem + s * Q::STAGE);
        cw::mbar_expect_tx(full, Q::TX);
        cw::tma_load_4d(dst, &dmap, 0, x0, y0, MODE == W_HR ? n : 4 * n + u, full);
        cw::tma_load_4d(dst + Q::D_BYTES, &smap, 0, x0 + ox, y0 + oy, n, full);
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, q4 = lane & 3;
  float acc[TPW][32];
#pragma unroll
  for (int t = 0; t < TPW; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.0f;
  int q = 0;
  for (int t = ks; t < tiles; t += KS, ++q) {
    const int s = q % S;
    const uint32_t d_base = cw::smem_u32(smem + s * Q::STAGE), s_base = d_base + Q::D_BYTES;
    cw::mbar_wait(full0 + 8 * s, (q / S) & 1);
#pragma unroll
    for (int k = 0; k < TPW; ++k) cw::fence_acc(acc[k]);
    cw::wgmma_fence();
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int kk = 0; kk < RUN / 16; ++kk) {
        const uint64_t ad = tw::sw_desc(d_base + (r * RUN + 16 * kk) * 128);
#pragma unroll
        for (int k = 0; k < TPW; ++k)
          mma_tt(acc[k], ad, tw::sw_desc(s_base + ((r + wg) * TWS + k + 16 * kk) * 128));
      }
    cw::wgmma_commit();
    cw::wgmma_wait<1>();
#pragma unroll
    for (int k = 0; k < TPW; ++k) cw::fence_acc(acc[k]);
    if (q > 0) cw::mbar_arrive(empty0 + 8 * ((q - 1) % S));
  }
  cw::wgmma_wait<0>();
#pragma unroll
  for (int k = 0; k < TPW; ++k) cw::fence_acc(acc[k]);

  // acc[k][4 j + 2 i + e] = dW[tap (wg, k)][o = 16 wl + g + 8 i][c = 8 j + 2 q4 + e].
  float* out = a.part + (size_t)ks * Q::ROW + (size_t)u * (Q::ROW / Q::UNITS);
#pragma unroll
  for (int k = 0; k < TPW; ++k) {
    const int tap = wg * TPW + k;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = 16 * wl + g + 8 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(out + (tap * C + m) * C + 8 * j + 2 * q4) =
            make_float2(acc[k][4 * j + 2 * i], acc[k][4 * j + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Stage 7: the reduce. Thread i computes grads element i of the partials'
// order (a weight grad's [tap][o][c], written to its OIHW place): the
// K-split rows in order, the phases of a fold in order (a, b).

struct ReduceArgs {
  const float* part_hr;    // KS_HR rows of HR_ROW
  const float* part_up2;   // KS_UP rows of UP_ROW
  const float* part_up1;
  const float* part_last;  // last_rows rows of LAST_W
  const float* bpart;      // BROWS rows of BSTRIDE
  int last_rows;
  float* grads;            // GRADS f32 (the layout of G_*)
};

// t(a, k): the phase tap of a 3x3 kernel row k in phase a.
__device__ __forceinline__ int phase_tap(int a, int k) { return a == 0 ? (k > 0) : (k > 1); }

__global__ void reduce_kernel(const ReduceArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= GRADS) return;
  float sum = 0.0f;
  if (i < G_LASTW && (i < G_UP1B || (i >= G_UP2W && i < G_UP2B) || (i >= G_HRW && i < G_HRB))) {
    const int base = i < G_UP1B ? G_UP1W : (i < G_UP2B ? G_UP2W : G_HRW);
    const int e = i - base, tap = e / TAP_W, o = e / C % C, c = e % C;
    if (base == G_HRW) {
#pragma unroll 8
      for (int r = 0; r < KS_HR; ++r) sum += a.part_hr[(size_t)r * HR_ROW + e];
    } else {
      const float* part = base == G_UP1W ? a.part_up1 : a.part_up2;
      const int ky = tap / 3, kx = tap % 3;
      for (int pa = 0; pa < 2; ++pa)
        for (int pb = 0; pb < 2; ++pb) {
          const int off = (2 * pa + pb) * UP_UNIT +
                          (2 * phase_tap(pa, ky) + phase_tap(pb, kx)) * TAP_W + o * C + c;
#pragma unroll 8
          for (int r = 0; r < KS_UP; ++r) sum += part[(size_t)r * UP_ROW + off];
        }
    }
    if (BWD_PLANT == 2 && tap == 4) sum = 0.0f;
    a.grads[base + (o * C + c) * 9 + tap] = sum;
    return;
  }
  if (i >= G_LASTW && i < G_LASTB) {
    const int e = i - G_LASTW;
    for (int r = 0; r < a.last_rows; ++r) sum += a.part_last[(size_t)r * LAST_W + e];
    a.grads[i] = BWD_PLANT == 2 && e % 9 == 4 ? 0.0f : sum;
    return;
  }
  const int col = i >= G_LASTB ? B_LAST + i - G_LASTB
                : i >= G_HRB   ? B_HR + i - G_HRB
                : i >= G_UP2B  ? B_UP2 + i - G_UP2B
                               : B_UP1 + i - G_UP1B;
  for (int r = 0; r < BROWS; ++r) sum += a.bpart[(size_t)r * BSTRIDE + col];
  a.grads[i] = sum;
}

// ---------------------------------------------------------------------------
// Host side.

inline int grid_of(long long work, int per_sm) {
  long long grid = (long long)per_sm * cw::sm_count();
  if (work < grid) grid = work;
  if (BROWS < grid) grid = BROWS;
  return (int)grid;
}

inline int launch_last(const bf16* h3, const LastArgs& a, cudaStream_t stream, int* grid) {
  constexpr int smem = LastCfg::SMEM;
  static_assert(smem <= 232448, "a CTA's shared memory exceeds 227 KB");
  static const int per_sm = cw::blocks_per_sm(last_kernel, LastCfg::NTHREAD, smem);
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap hm;
  const int e = tw::make_map_sw(&hm, h3, a.W, a.H, a.frames, LastCfg::TWC, LastCfg::TR);
  if (e != 0) return e;
  const long long tiles = (long long)((a.W + RUN - 1) / RUN) *
                          ((a.H + LastCfg::ROWS - 1) / LastCfg::ROWS) * a.frames;
  *grid = grid_of(tiles, per_sm);
  last_kernel<<<*grid, LastCfg::NTHREAD, smem, stream>>>(hm, a);
  return (int)cudaGetLastError();
}

// An adjoint over `src`: A_HR dP_C (frames, H, W, 64), the upsample-convs
// their dP's planes (4 frames, H, W, 64).
template <int MODE>
inline int launch_adj(const bf16* src, const AdjArgs& a, cudaStream_t stream) {
  using Q = AdjCfg<MODE>;
  constexpr int smem = Q::SMEM;
  static_assert(smem <= 232448, "a CTA's shared memory exceeds 227 KB");
  static const int per_sm = cw::blocks_per_sm(adj_kernel<MODE>, Q::NTHREAD, smem);
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  if (MODE != A_UP1 && (a.H % 2 != 0 || a.W % 2 != 0)) return (int)cudaErrorInvalidValue;
  CUtensorMap dm;
  const int planes = MODE == A_HR ? a.frames : 4 * a.frames;
  const int e = tw::make_map_sw(&dm, src, a.W, a.H, planes, Q::TWC, Q::TR);
  if (e != 0) return e;
  const long long tiles =
      (long long)((a.W + RUN - 1) / RUN) * ((a.H + Q::ROWS - 1) / Q::ROWS) * a.frames;
  adj_kernel<MODE><<<grid_of(tiles, per_sm), Q::NTHREAD, smem, stream>>>(dm, a);
  return (int)cudaGetLastError();
}

// A weight grad of dP (hr_conv: (frames, H, W, 64); the upsample-convs: its
// planes, (4 frames, H, W, 64)) against `src` (frames, H, W, 64).
template <int MODE>
inline int launch_wgrad(const bf16* dp, const bf16* src, const WgArgs& a, cudaStream_t stream) {
  using Q = WgCfg<MODE>;
  constexpr int smem = Q::SMEM;
  static_assert(smem <= 232448, "a CTA's shared memory exceeds 227 KB");
  static const int per_sm = cw::blocks_per_sm(wgrad_kernel<MODE>, Q::NTHREAD, smem);
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap dm, sm;
  const int planes = MODE == W_HR ? a.frames : 4 * a.frames;
  int e = tw::make_map_sw(&dm, dp, a.W, a.H, planes, RUN, Q::ROWS);
  if (e == 0) e = tw::make_map_sw(&sm, src, a.W, a.H, a.frames, Q::TWS, Q::SR);
  if (e != 0) return e;
  wgrad_kernel<MODE><<<Q::UNITS * Q::KS, Q::NTHREAD, smem, stream>>>(dm, sm, a);
  return (int)cudaGetLastError();
}

// The scratch of one backward, carved from one buffer: h1, h2, h3 (then
// dP_B), dP_C, dP_A, the weight grads' K-split rows, conv_last's partial
// rows and the bias partials.
struct Scratch {
  bf16 *h1, *h2, *h3, *dpc, *dpa;
  float *part_hr, *part_up2, *part_up1, *part_last, *bpart;
  long long bytes;
};

inline long long align256(long long b) { return (b + 255) / 256 * 256; }

inline Scratch carve(void* base, int n, int h, int w) {
  Scratch sc;
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  long long off = 0;
  auto take = [&](long long bytes) {
    const uintptr_t at = p + off;
    off += align256(bytes);
    return at;
  };
  const long long lo = (long long)n * 4 * h * w * C * 2, hi = 4 * lo;  // bytes at 2h x 2w, 4h x 4w
  sc.h1 = reinterpret_cast<bf16*>(take(lo));
  sc.h2 = reinterpret_cast<bf16*>(take(hi));
  sc.h3 = reinterpret_cast<bf16*>(take(hi));
  sc.dpc = reinterpret_cast<bf16*>(take(hi));
  sc.dpa = reinterpret_cast<bf16*>(take(lo));
  sc.part_hr = reinterpret_cast<float*>(take((long long)KS_HR * HR_ROW * 4));
  sc.part_up2 = reinterpret_cast<float*>(take((long long)KS_UP * UP_ROW * 4));
  sc.part_up1 = reinterpret_cast<float*>(take((long long)KS_UP * UP_ROW * 4));
  sc.part_last = reinterpret_cast<float*>(take((long long)BROWS * LAST_W * 4));
  sc.bpart = reinterpret_cast<float*>(take((long long)BROWS * BSTRIDE * 4));
  sc.bytes = off;
  return sc;
}

// The backward's 11 launches on `stream` (the note at the top). x (n, h, w,
// 64), g (n, 4h, 4w, 3), dx (n, h, w, 64) NHWC bf16; fw / fb the forward's
// packed B operands and biases of upconv1, upconv2, hr_conv (K4's); a_hr,
// a_up2, a_up1, a_last the adjoints' B operands (ops/tail_bwd.py:
// pack_tail_bwd); grads GRADS f32. Returns the first CUDA
// error code.
inline int backward(const bf16* x, const bf16* g, const void* const fw[3], const void* const fb[3],
                    const bf16* a_hr, const bf16* a_up2, const bf16* a_up1, const bf16* a_last,
                    bf16* dx, float* grads, void* scratch, int n, int h, int w,
                    cudaStream_t stream) {
  const long long pixels = 16LL * n * h * w;
  if (n <= 0 || h <= 0 || w <= 0 || pixels >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Scratch sc = carve(scratch, n, h, w);
  const int h2 = 2 * h, w2 = 2 * w, h4 = 4 * h, w4 = 4 * w;
  int e = tw::stage(0, x, fw[0], fb[0], sc.h1, n, h, w, 0, h, h2, 0, stream);
  if (e == 0) e = tw::stage(1, sc.h1, fw[1], fb[1], sc.h2, n, h2, w2, 0, h2, h4, 0, stream);
  if (e == 0) e = tw::stage(2, sc.h2, fw[2], fb[2], sc.h3, n, h4, w4, 0, h4, h4, 0, stream);
  if (e != 0) return e;

  LastArgs la;
  la.w = a_last;
  la.g = g;
  la.dpc = sc.dpc;
  la.wpart = sc.part_last;
  la.bpart = sc.bpart;
  la.H = h4;
  la.W = w4;
  la.frames = n;
  int last_rows = 0;
  e = launch_last(sc.h3, la, stream, &last_rows);
  if (e != 0) return e;

  bf16* dpb = sc.h3;  // h3 is read for the last time by last_kernel
  AdjArgs aa;
  aa.w = a_hr;
  aa.sign = sc.h2;
  aa.out = dpb;
  aa.bpart = sc.bpart + B_UP2;
  aa.H = h4;
  aa.W = w4;
  aa.frames = n;
  aa.plant_plane = -1;
  e = launch_adj<A_HR>(sc.dpc, aa, stream);
  WgArgs wa;
  wa.part = sc.part_hr;
  wa.H = h4;
  wa.W = w4;
  wa.frames = n;
  if (e == 0) e = launch_wgrad<W_HR>(sc.dpc, sc.h2, wa, stream);
  if (e != 0) return e;

  aa.w = a_up2;
  aa.sign = sc.h1;
  aa.out = sc.dpa;
  aa.bpart = sc.bpart + B_UP1;
  aa.H = h2;
  aa.W = w2;
  aa.plant_plane = BWD_PLANT == 4 ? 1 : -1;
  e = launch_adj<A_UP2>(dpb, aa, stream);
  wa.part = sc.part_up2;
  wa.H = h2;
  wa.W = w2;
  if (e == 0) e = launch_wgrad<W_UP>(dpb, sc.h1, wa, stream);
  if (e != 0) return e;

  aa.w = a_up1;
  aa.sign = nullptr;
  aa.out = dx;
  aa.bpart = nullptr;
  aa.H = h;
  aa.W = w;
  aa.plant_plane = -1;
  e = launch_adj<A_UP1>(sc.dpa, aa, stream);
  wa.part = sc.part_up1;
  wa.H = h;
  wa.W = w;
  if (e == 0) e = launch_wgrad<W_UP>(sc.dpa, x, wa, stream);
  if (e != 0) return e;

  ReduceArgs ra;
  ra.part_hr = sc.part_hr;
  ra.part_up2 = sc.part_up2;
  ra.part_up1 = sc.part_up1;
  ra.part_last = sc.part_last;
  ra.bpart = sc.bpart;
  ra.last_rows = last_rows;
  ra.grads = grads;
  reduce_kernel<<<(GRADS + 255) / 256, 256, 0, stream>>>(ra);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tb
