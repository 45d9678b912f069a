// K3: the backward of one RRDB of the CHN trunk as wgmma implicit GEMMs
// with TMA-fed tiles, channels-last, over the activations the forward kept.
//
// Replaces: master_thesis_tpu/ops/pallas_rrdb.py:rrdb_bwd_pallas (body
// _rrdb_bwd_kernel / _rdb_bwd_block), which per frame recomputes the RRDB
// in VMEM, sweeps rdb3, rdb2, rdb1 in reverse and writes dx and per-frame
// dW / db that XLA sums over the frames. The TPU kernel recomputes x1..x4
// because VMEM holds one frame; here the forward (K1) keeps them (and each
// RDB's input), so nothing is recomputed. K1 rounds x1..x4 as the plain
// forward does, so the kept values equal the recomputed ones.
//
// Per RDB, with g_out its f32 output cotangent and sources s = 0..4 (x,
// then x1..x4), the cotangents dP_t of conv t's pre-activation live in one
// NHWC bf16 buffer D of 192 channels in reverse order: dP_1 at [0, 32),
// dP_2 [32, 64), dP_3 [64, 96), dP_4 [96, 128), dP_5 [128, 192). Source s
// feeds convs s+1..5, so its cotangent is ONE 3x3 conv of the suffix
// D[32 s, 192) with the stacked adjoint weights (each conv's kernel
// transposed and flipped, packed by ops/fragments.py:wgmma_pull_matrix):
//   pull s (s = 4 .. 1)  dsrc_s = conv(D[32 s:], A_s)          N = 32
//                        dP_s = bf16(mask(x_s) dsrc_s) -> D[32 (s - 1):]
//                        bias partials of the unrounded mask(x_s) dsrc_s
//   pull 0               d = g_out + conv(D, A_0)               N = 64
//                        rdb2 / rdb3: d -> G (f32, the next RDB's g_out),
//                        bf16(0.2 d) -> the next RDB's D[128:] (its dP_5)
//                        and its bias partials; rdb1: dx = bf16(d + g)
// each pull an implicit GEMM as K1's convs (conv3x3_wgmma.cuh, a suffix
// where K1 reads a prefix): M = pixels, K = 9 taps x (192 - 32 s) in
// 32-channel chunks; the f32 sum over t stays in registers. Then
//   wgrad  dW_s[tap][d][c] = sum_p D[p, d] src_s[p + tap, c], one launch
// for the RDB's five convs: a GEMM with K = pixels, M = 64 channels of D
// (A, read MN-major from no-swizzle 8-channel planes), N = 32 channels of
// the source (B, MN-major; a tap is a 16-byte step of its start address).
// Rounding as _rdb_bwd_block / _rrdb_bwd_kernel: dP in bf16 before every
// product, f32 cotangents within an RRDB, bf16 between RRDBs, f32 dW / db.
// The f32 sums over t run in another order than the plain version's.
//
// The RRDB's chain (rrdb_bwd.cu:rrdb_backward, one ctypes call): prep
// (rdb3's dP_5 = bf16(0.04 g) and its bias partials), then per RDB pulls
// 4..0 and one wgrad, then one reduce of the weight-grad K-splits and the
// bias partials, in a fixed order: 20 launches. No float atomics: two runs
// give bit-identical dx, dW and db.
//
// Work units of the wgrad: (source s, 64-channel block mb of D, source
// channel half) for the blocks D[64 mb, 64 mb + 64) that meet the suffix
// D[32 s:], 14 units of 64 x 32 outputs x 9 taps; the three consumer
// warpgroups of a CTA take tap rows dy = 0, 1, 2 (three taps each). A CTA
// is one unit and one K-split: it walks the tiles ks, ks + KS, ... of
// ROWS x 64 pixels and writes its sums to its row of a partial buffer.
// Units whose block starts below 32 s (s = 1, 3) compute 32 rows no grad
// needs: 10% more products than the five convs' weight grads.
//
// Bound on an H100 SXM at the train step (8 frames at 64x64 an RRDB): the
// adjoints and the weight grads are each one forward's dense 3x3 products,
// 2 x 47 GFLOP, 0.095 ms at 989 TFLOP/s bf16; bytes (x, g, the kept
// activations in, dx out, weights and grads) about 50 MB, 0.015 ms. So it
// is bound by operations, and every product runs on wgmma. What holds it
// (PERF.md): the whole runs at ~23% of that rate, the wgrads (~40% of the
// time) and the N = 32 pulls (~11 us a launch, under the launch and
// pipeline-fill costs of a short kernel) furthest below it.
//
// Planted faults for the checks on the card (-DBWD_PLANT, as in
// conv_bwd.cuh): 1 masks with lrelu slope 0.25, 2 leaves the centre tap
// out of every weight grad, 3 drops every bias grad.
// Tuning (master_thesis_tpu_torch/sweep_rrdb_bwd.py): -DPULL_ROWS (rows a
// warpgroup of a pull; 2 warpgroups, 3 stages), -DWGRAD_ROWS (rows a tile)
// / -DWGRAD_STAGES / -DWGRAD_KS (K-splits) for the wgrad. Defaults from the
// sweep (PERF.md): pulls in 4-row tiles, wgrad 4 rows x 3 stages x 9.
#pragma once

#include "conv3x3_wgmma.cuh"

#ifndef BWD_PLANT
#define BWD_PLANT 0
#endif
#ifndef PULL_ROWS
#define PULL_ROWS 2
#endif
#ifndef WGRAD_ROWS
#define WGRAD_ROWS 4
#endif
#ifndef WGRAD_STAGES
#define WGRAD_STAGES 3
#endif
#ifndef WGRAD_KS
#define WGRAD_KS 9
#endif

namespace kb {
namespace {

using cw::bf16;
using cw::CHUNK;
using cw::GC;
using cw::HC;
using cw::NF;
using cw::RUN;
using cw::TW;

constexpr float MASK_SLOPE = BWD_PLANT == 1 ? 0.25f : 0.2f;
constexpr int DC = NF + 4 * GC;        // D's channels: dP_1..dP_5
constexpr int BROWS = 256;             // rows of the bias partial sums
constexpr int UNITS = 14;              // wgrad work units of an RDB
constexpr int UNIT_FLOATS = 9 * 64 * 32;
constexpr int PART_FLOATS = UNITS * UNIT_FLOATS;  // one K-split row of one RDB
constexpr int RDB_GRADS = 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64) + 192;

__host__ __device__ constexpr int pull_n(int s) { return s == 0 ? NF : GC; }
__host__ __device__ constexpr int pull_chunks(int s) { return (DC - 32 * s) / CHUNK; }
__host__ __device__ constexpr int pull_w_off(int s) {  // source s's B in an RDB's pulls
  int off = 0;
  for (int j = 0; j < s; ++j) off += 9 * (DC - 32 * j) * pull_n(j);
  return off;
}
constexpr int PULL_NUMEL = pull_w_off(5);  // an RDB's five pull matrices
// Kernel launches of one RRDB's backward: prep, 3 x (5 pulls + wgrad), reduce.
constexpr int LAUNCHES = 1 + 3 * 6 + 1;

// The wgrad unit of (source, block of D, source channel half) and back.
__host__ __device__ constexpr int unit_of(int s, int mb, int half) {
  return s == 0 ? 2 * mb + half : s == 1 ? 6 + mb : s == 2 ? 8 + mb : s == 3 ? 10 + mb : 13;
}
struct Unit {
  int s, mb, ch0;  // source, block of D, first source channel (in x or h)
};
__host__ __device__ inline Unit unit_info(int u) {
  if (u < 6) return {0, u / 2, 32 * (u % 2)};
  if (u < 9) return {1, u - 6, 0};
  if (u < 11) return {2, u - 8, 32};
  if (u < 13) return {3, u - 10, 64};
  return {4, 2, 96};
}

// The MN-major no-swizzle descriptor: core matrices of 8 MN-contiguous
// elements (16 bytes) x 8 K rows (128 bytes); LBO steps along K, SBO
// along M / N, as for the K-major layout.
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t k_step, uint32_t mn_step) {
  return cw::make_desc(addr, k_step, mn_step);
}

// D (64 x 32 f32) += A (64 x 16) B (16 x 32), both MN-major (transposed)
// in shared memory; D's register layout as cw::mma_ss.
__device__ __forceinline__ void mma_tt(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// The pulls.

struct PullCfg {
  static constexpr int RPW = PULL_ROWS, WG = 2, S = 3;
  static constexpr int ROWS = RPW * WG, TR = ROWS + 2;
  static constexpr int NCONS = 128 * WG, NTHREAD = NCONS + 32;
  static constexpr int PLANE = (TR * TW * 16 + 127) / 128 * 128;
  static constexpr int A_BYTES = 4 * PLANE;
  static constexpr uint32_t A_TX = 4 * TR * TW * 16;
  __host__ __device__ static constexpr int stage_bytes(int n) { return A_BYTES + cw::b_bytes(n); }
  __host__ __device__ static constexpr int smem_bytes(int n) {
    return S * stage_bytes(n) + ROWS * RUN * (n + 8) * 2 + 2 * S * 8;
  }
};

struct PullArgs {
  const bf16* w;   // source s's packed B (nchunk blocks of 9 x 32 x N)
  const bf16* h;   // s >= 1: the RDB's x1..x4, NHWC 128 (the masks)
  const bf16* g;   // s = 0: the RRDB's output cotangent, NHWC 64
  float* gbuf;     // s = 0: in the RDB's g_out (unless g_first), out its input cotangent
  bf16* dcur;      // s >= 1: dP_s is written at channel 32 (s - 1)
  bf16* dnext;     // s = 0: the next RDB's D (its dP_5 at 128), or null on rdb1
  bf16* dx;        // s = 0 on rdb1: the RRDB's dx, NHWC 64
  float* bpart;    // bias partials: row r, channel c at bpart[r * bstride + c]
  int bstride;
  int g_first;     // s = 0 on rdb3: g_out = 0.2 g
  int H, W, frames, s;
};

// Pull s over the tiles of ROWS x 64 output pixels of every frame; CTA b
// takes the tiles b, b + gridDim.x, ... and writes its bias sums to row b
// of bpart (and zeros to the rows b + gridDim.x, ... < BROWS).
template <int N>
__global__ void __launch_bounds__(PullCfg::NTHREAD)
pull_kernel(__grid_constant__ const CUtensorMap dmap, const PullArgs a) {
  using C = PullCfg;
  constexpr int RPW = C::RPW, S = C::S, ROWS = C::ROWS;
  constexpr int NCONS = C::NCONS, PLANE = C::PLANE, A_BYTES = C::A_BYTES;
  constexpr int STAGE = C::stage_bytes(N), B_BYTES = cw::b_bytes(N);
  constexpr int NB8 = N / 8, P = N + 8;
  extern __shared__ __align__(1024) unsigned char kb_smem[];
  unsigned char* smem = kb_smem;
  bf16* stg = reinterpret_cast<bf16*>(smem + S * STAGE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::smem_bytes(N) - 2 * S * 8);
  const uint32_t full0 = cw::smem_u32(bars), empty0 = cw::smem_u32(bars + S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int runs = (a.W + RUN - 1) / RUN, groups = (a.H + ROWS - 1) / ROWS;
  const int tiles = runs * groups * a.frames, nchunk = pull_chunks(a.s);
  const int cin0 = 32 * a.s;  // the suffix's first channel of D

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      cw::mbar_init(full0 + 8 * s, 1);
      cw::mbar_init(empty0 + 8 * s, NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCONS / 32) {  // the producer warp
    if (lane == 0) {
      int q = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int x0 = (t % runs) * RUN, y0 = (t / runs % groups) * ROWS, n = t / (runs * groups);
        for (int c = 0; c < nchunk; ++c, ++q) {
          const int s = q % S, u = q / S;
          if (u > 0) cw::mbar_wait(empty0 + 8 * s, (u - 1) & 1);
          const uint32_t full = full0 + 8 * s, dst = cw::smem_u32(smem + s * STAGE);
          cw::mbar_expect_tx(full, C::A_TX + B_BYTES);
          for (int g = 0; g < 4; ++g)
            cw::tma_load_4d(dst + g * PLANE, &dmap, cin0 + CHUNK * c + 8 * g, x0 - 1, y0 - 1, n,
                            full);
          cw::bulk_load(dst + A_BYTES, a.w + (size_t)c * (B_BYTES / 2), B_BYTES, full);
        }
      }
    }
    return;
  }

  const int wgi = warp >> 2, wl = warp & 3, tid = threadIdx.x;
  const int g = lane >> 2, q4 = lane & 3;
  float bsum[NB8][2];
#pragma unroll
  for (int j = 0; j < NB8; ++j) bsum[j][0] = bsum[j][1] = 0.0f;
  int q = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int x0 = (t % runs) * RUN, y0 = (t / runs % groups) * ROWS, n = t / (runs * groups);
    float acc[RPW][N / 2];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[r][i] = 0.0f;

    for (int c = 0; c < nchunk; ++c, ++q) {
      const int s = q % S;
      const uint32_t a_base = cw::smem_u32(smem + s * STAGE), b_base = a_base + A_BYTES;
      cw::mbar_wait(full0 + 8 * s, (q / S) & 1);
#pragma unroll
      for (int r = 0; r < RPW; ++r) cw::fence_acc(acc[r]);
      cw::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint64_t bd =
              cw::make_desc(b_base + (tap * 2 + hh) * 2 * NB8 * 128, NB8 * 128, 128);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const int pix = (wgi * RPW + r + tap / 3) * TW + tap % 3;
            cw::mma_ss(acc[r], cw::make_desc(a_base + 2 * hh * PLANE + pix * 16, PLANE, 128), bd);
          }
        }
      }
      cw::wgmma_commit();
      cw::wgmma_wait<1>();
#pragma unroll
      for (int r = 0; r < RPW; ++r) cw::fence_acc(acc[r]);
      if (c > 0) cw::mbar_arrive(empty0 + 8 * ((q - 1) % S));
    }
    cw::wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < RPW; ++r) cw::fence_acc(acc[r]);
    cw::mbar_arrive(empty0 + 8 * ((q - 1) % S));

    // Epilogue through the staging area: s >= 1 dP_s; s = 0 the next
    // RDB's dP_5 or the RRDB's dx.
    cw::named_sync(1 + C::WG, NCONS);
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int pix = (wgi * RPW + r) * RUN + 16 * wl + g + 8 * i;
        const int y = y0 + pix / RUN, xc = x0 + pix % RUN;
        const bool inside = y < a.H && xc < a.W;
        const size_t px = ((size_t)n * a.H + y) * a.W + xc;
#pragma unroll
        for (int j = 0; j < NB8; ++j) {
          const int col = 8 * j + 2 * q4;
          float v0 = acc[r][4 * j + 2 * i], v1 = acc[r][4 * j + 2 * i + 1];
          if (!inside) {
            v0 = v1 = 0.0f;
          } else if (N == GC) {  // mask by the sign of x_s
            const __nv_bfloat162 sv =
                *reinterpret_cast<const __nv_bfloat162*>(a.h + px * HC + 32 * (a.s - 1) + col);
            if (!(__bfloat162float(sv.x) >= 0.0f)) v0 *= MASK_SLOPE;
            if (!(__bfloat162float(sv.y) >= 0.0f)) v1 *= MASK_SLOPE;
            bsum[j][0] += v0;
            bsum[j][1] += v1;
          } else {
            const __nv_bfloat162 gv = *reinterpret_cast<const __nv_bfloat162*>(a.g + px * NF + col);
            const float g0 = __bfloat162float(gv.x), g1 = __bfloat162float(gv.y);
            float2* gp = reinterpret_cast<float2*>(a.gbuf + px * NF + col);
            float2 go;
            if (a.g_first) {
              go.x = 0.2f * g0;
              go.y = 0.2f * g1;
            } else {
              go = *gp;
            }
            const float d0 = go.x + v0, d1 = go.y + v1;
            if (a.dnext == nullptr) {  // rdb1: the RRDB's dx
              v0 = d0 + g0;
              v1 = d1 + g1;
            } else {
              *gp = make_float2(d0, d1);
              v0 = 0.2f * d0;
              v1 = 0.2f * d1;
              bsum[j][0] += v0;
              bsum[j][1] += v1;
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(stg + pix * P + col) = __floats2bfloat162_rn(v0, v1);
        }
      }
    cw::named_sync(1 + C::WG, NCONS);

    bf16* out = N == GC ? a.dcur : (a.dnext == nullptr ? a.dx : a.dnext);
    const int ocs = N == GC ? DC : (a.dnext == nullptr ? NF : DC);
    const int oc0 = N == GC ? 32 * (a.s - 1) : (a.dnext == nullptr ? 0 : NF + 2 * GC);
    for (int v = tid; v < ROWS * RUN * NB8; v += NCONS) {
      const int pix = v / NB8, c8 = v - pix * NB8;
      const int y = y0 + pix / RUN, xc = x0 + pix % RUN;
      if (y >= a.H || xc >= a.W) continue;
      const size_t o = (((size_t)n * a.H + y) * a.W + xc) * ocs + oc0 + 8 * c8;
      *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(stg + pix * P + 8 * c8);
    }
  }

  // The CTA's bias sums: lanes, then warps in order, through the staging
  // area (the last tile's stores have read it after the barrier).
  if (N == NF && a.dnext == nullptr) return;  // rdb1's dx: no bias grad
  cw::named_sync(1 + C::WG, NCONS);
  float* red = reinterpret_cast<float*>(stg);
#pragma unroll
  for (int j = 0; j < NB8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v = cw::col_sum(bsum[j][e]);
      if (g == 0) red[warp * N + 8 * j + 2 * q4 + e] = v;
    }
  cw::named_sync(1 + C::WG, NCONS);
  if (tid < N) {
    float sum = 0.0f;
    for (int w = 0; w < NCONS / 32; ++w) sum += red[w * N + tid];
    a.bpart[(size_t)blockIdx.x * a.bstride + tid] = BWD_PLANT == 3 ? 0.0f : sum;
    for (int r = blockIdx.x + gridDim.x; r < BROWS; r += gridDim.x)
      a.bpart[(size_t)r * a.bstride + tid] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// The weight grads.

struct WgradCfg {
  static constexpr int ROWS = WGRAD_ROWS, S = WGRAD_STAGES, KS = WGRAD_KS;
  static constexpr int NCONS = 3 * 128, NTHREAD = NCONS + 32;
  static constexpr int DPLANE = ROWS * RUN * 16;  // 8 channels of D's tile
  static constexpr int D_BYTES = 8 * DPLANE;
  static constexpr int SPLANE = ((ROWS + 2) * TW * 16 + 127) / 128 * 128;
  static constexpr int S_BYTES = 4 * SPLANE;
  static constexpr uint32_t TX = D_BYTES + 4 * (ROWS + 2) * TW * 16;
  static constexpr int STAGE = D_BYTES + S_BYTES;
  static constexpr int SMEM = S * STAGE + 2 * S * 8;
};

struct WgradArgs {
  float* part;         // this RDB's K-split rows: row ks at part + ks * pstride
  long long pstride;
  int H, W, frames;
};

// CTA (unit u, K-split ks): dW_u over the tiles ks, ks + KS, ... of ROWS x
// 64 pixels. Warpgroup dy holds the taps (dy, 0..2).
__global__ void __launch_bounds__(WgradCfg::NTHREAD)
wgrad_kernel(__grid_constant__ const CUtensorMap dmap, __grid_constant__ const CUtensorMap xmap,
             __grid_constant__ const CUtensorMap hmap, const WgradArgs a) {
  using C = WgradCfg;
  constexpr int ROWS = C::ROWS, S = C::S, KS = C::KS, NCONS = C::NCONS;
  extern __shared__ __align__(1024) unsigned char kb_smem[];
  unsigned char* smem = kb_smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S * C::STAGE);
  const uint32_t full0 = cw::smem_u32(bars), empty0 = cw::smem_u32(bars + S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x / KS, ks = blockIdx.x % KS;
  const Unit un = unit_info(u);
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

  if (warp == NCONS / 32) {
    if (lane == 0) {
      const CUtensorMap* smap = un.s == 0 ? &xmap : &hmap;
      int q = 0;
      for (int t = ks; t < tiles; t += KS, ++q) {
        const int x0 = (t % runs) * RUN, y0 = (t / runs % groups) * ROWS, n = t / (runs * groups);
        const int s = q % S, v = q / S;
        if (v > 0) cw::mbar_wait(empty0 + 8 * s, (v - 1) & 1);
        const uint32_t full = full0 + 8 * s, dst = cw::smem_u32(smem + s * C::STAGE);
        cw::mbar_expect_tx(full, C::TX);
        for (int g = 0; g < 8; ++g)
          cw::tma_load_4d(dst + g * C::DPLANE, &dmap, 64 * un.mb + 8 * g, x0, y0, n, full);
        for (int g = 0; g < 4; ++g)
          cw::tma_load_4d(dst + C::D_BYTES + g * C::SPLANE, smap, un.ch0 + 8 * g, x0 - 1, y0 - 1,
                          n, full);
      }
    }
    return;
  }

  const int dy = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, q4 = lane & 3;
  float acc[3][16];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[dx][i] = 0.0f;
  int q = 0;
  for (int t = ks; t < tiles; t += KS, ++q) {
    const int s = q % S;
    const uint32_t d_base = cw::smem_u32(smem + s * C::STAGE), s_base = d_base + C::D_BYTES;
    cw::mbar_wait(full0 + 8 * s, (q / S) & 1);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) cw::fence_acc(acc[dx]);
    cw::wgmma_fence();
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int kk = 0; kk < RUN / 16; ++kk) {
        const uint64_t ad = mn_desc(d_base + (r * RUN + 16 * kk) * 16, 128, C::DPLANE);
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          mma_tt(acc[dx], ad,
                 mn_desc(s_base + ((r + dy) * TW + dx + 16 * kk) * 16, 128, C::SPLANE));
      }
    cw::wgmma_commit();
    cw::wgmma_wait<1>();
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) cw::fence_acc(acc[dx]);
    if (q > 0) cw::mbar_arrive(empty0 + 8 * ((q - 1) % S));
  }
  cw::wgmma_wait<0>();
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) cw::fence_acc(acc[dx]);

  // acc[dx][4 j + 2 i + e] = dW[tap][m = 16 wl + g + 8 i][n = 8 j + 2 q4 + e].
  float* out = a.part + ks * a.pstride + (size_t)u * UNIT_FLOATS;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int tap = 3 * dy + dx;
    const bool drop = BWD_PLANT == 2 && tap == 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = 16 * wl + g + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v0 = drop ? 0.0f : acc[dx][4 * j + 2 * i];
        const float v1 = drop ? 0.0f : acc[dx][4 * j + 2 * i + 1];
        *reinterpret_cast<float2*>(out + (tap * 64 + m) * 32 + 8 * j + 2 * q4) = make_float2(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// prep: rdb3's dP_5 = bf16(0.2 (0.2 g)) into D[128:] and its bias partials
// (row b of bpart from CTA b of BROWS, a contiguous share of the pixels).
constexpr int PREP_THREADS = 256;

__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const bf16* __restrict__ g, bf16* __restrict__ d, float* __restrict__ bpart,
            int bstride, long long pixels) {
  const long long chunk = (pixels + gridDim.x - 1) / gridDim.x;
  const long long p0 = blockIdx.x * chunk, p1 = p0 + chunk < pixels ? p0 + chunk : pixels;
  float sum = 0.0f;  // channel threadIdx.x % 64
  for (long long i = p0 * NF + threadIdx.x; i < p1 * NF; i += PREP_THREADS) {
    const long long p = i / NF;
    const int c = (int)(i - p * NF);
    const float v = 0.2f * (0.2f * __bfloat162float(g[i]));
    d[p * DC + NF + 2 * GC + c] = __float2bfloat16(v);
    sum += v;
  }
  __shared__ float red[PREP_THREADS];
  red[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x < NF) {
    float s = 0.0f;
    for (int k = 0; k < PREP_THREADS / NF; ++k) s += red[threadIdx.x + NF * k];
    bpart[(size_t)blockIdx.x * bstride + threadIdx.x] = BWD_PLANT == 3 ? 0.0f : s;
  }
}

// ---------------------------------------------------------------------------
// reduce: each RDB's grads in the order of its parameters, conv1..conv5
// each as (dW OIHW, db), f32: the weight grads summed over the K-split
// rows of `part` in order, the bias grads over the BROWS rows of `bpart`.
__host__ __device__ constexpr int conv_cin(int t) { return NF + (t - 1) * GC; }
__host__ __device__ constexpr int conv_out(int t) { return t < 5 ? GC : NF; }

__global__ void reduce_kernel(const float* __restrict__ part, long long pstride, int ks_rows,
                              const float* __restrict__ bpart, float* __restrict__ grads) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3LL * RDB_GRADS) return;
  const int j = (int)(i / RDB_GRADS);
  int e = (int)(i - (long long)j * RDB_GRADS), t = 1;
  while (e >= 9 * conv_cin(t) * conv_out(t) + conv_out(t)) {
    e -= 9 * conv_cin(t) * conv_out(t) + conv_out(t);
    ++t;
  }
  const int cin = conv_cin(t), wsize = 9 * cin * conv_out(t);
  float sum = 0.0f;
  if (e >= wsize) {
    const int ch = 32 * (t - 1) + (e - wsize);
    for (int r = 0; r < BROWS; ++r) sum += bpart[((size_t)r * 3 + j) * DC + ch];
  } else {
    const int o = e / (9 * cin), c = e / 9 % cin, tap = e % 9;
    const int d = 32 * (t - 1) + o;
    const int s = c < NF ? 0 : 1 + (c - NF) / GC;
    const int n = c < NF ? c % 32 : (c - NF) % GC;
    const int u = unit_of(s, d / 64, c < NF ? c / 32 : 0);
    const float* p = part + (size_t)j * PART_FLOATS + (size_t)u * UNIT_FLOATS +
                     (tap * 64 + d % 64) * 32 + n;
    for (int r = 0; r < ks_rows; ++r) sum += p[r * pstride];
  }
  grads[i] = sum;
}

// ---------------------------------------------------------------------------
// Host side.

// An NHWC bf16 tensor (frames, rows, cols, ch) read in boxes of 8 channels x
// box_cols x box_rows of one frame.
inline int make_map(CUtensorMap* m, const void* base, int ch, int cols, int rows, int frames,
                    int box_cols, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = cw::encode_fn();
  if (fn == nullptr) return cw::TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)ch, (cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)frames};
  const cuuint64_t strides[3] = {(cuuint64_t)ch * 2, (cuuint64_t)cols * ch * 2,
                                 (cuuint64_t)rows * cols * ch * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cw::TENSOR_MAP_ERROR + (int)r;
}

template <int N>
inline int launch_pull(const CUtensorMap& dmap, const PullArgs& a, cudaStream_t stream) {
  constexpr int smem = PullCfg::smem_bytes(N);
  static_assert(smem <= 232448, "a CTA's shared memory exceeds 227 KB");
  static const int per_sm = cw::blocks_per_sm(pull_kernel<N>, PullCfg::NTHREAD, smem);
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)((a.W + RUN - 1) / RUN) *
                          ((a.H + PullCfg::ROWS - 1) / PullCfg::ROWS) * a.frames;
  long long grid = (long long)per_sm * cw::sm_count();
  if (tiles < grid) grid = tiles;
  if (BROWS < grid) grid = BROWS;
  pull_kernel<N><<<(int)grid, PullCfg::NTHREAD, smem, stream>>>(dmap, a);
  return (int)cudaGetLastError();
}

inline int launch_wgrad(const CUtensorMap& dmap, const CUtensorMap& xmap, const CUtensorMap& hmap,
                        const WgradArgs& a, cudaStream_t stream) {
  constexpr int smem = WgradCfg::SMEM;
  static_assert(smem <= 232448, "a CTA's shared memory exceeds 227 KB");
  static const int per_sm = cw::blocks_per_sm(wgrad_kernel, WgradCfg::NTHREAD, smem);
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  wgrad_kernel<<<UNITS * WgradCfg::KS, WgradCfg::NTHREAD, smem, stream>>>(dmap, xmap, hmap, a);
  return (int)cudaGetLastError();
}

// The scratch of one RRDB's backward, carved from one buffer: D twice (the
// current RDB's and the next one's), G, the weight-grad K-split rows of the
// three RDBs and their bias partials.
struct Scratch {
  bf16* d[2];
  float* gbuf;
  float* part;
  float* bpart;
  long long bytes;
};

inline long long align256(long long b) { return (b + 255) / 256 * 256; }

inline Scratch carve(void* base, long long pixels) {
  Scratch sc;
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  long long off = 0;
  auto take = [&](long long bytes) {
    const uintptr_t at = p + off;
    off += align256(bytes);
    return at;
  };
  for (int i = 0; i < 2; ++i) sc.d[i] = reinterpret_cast<bf16*>(take(pixels * DC * 2));
  sc.gbuf = reinterpret_cast<float*>(take(pixels * NF * 4));
  sc.part = reinterpret_cast<float*>(take((long long)WgradCfg::KS * 3 * PART_FLOATS * 4));
  sc.bpart = reinterpret_cast<float*>(take((long long)BROWS * 3 * DC * 4));
  sc.bytes = off;
  return sc;
}

// The launches of one RRDB's backward on `stream` (see the note at the top);
// returns the first CUDA error code.
inline int rrdb_backward(const bf16* const ins[3], const bf16* const hid[3], const bf16* g,
                         const bf16* pulls, bf16* dx, float* grads, void* scratch, int n, int h,
                         int w, cudaStream_t stream) {
  const long long pixels = (long long)n * h * w;
  const Scratch sc = carve(scratch, pixels);
  CUtensorMap dpull[2], dwg[2];
  int e = 0;
  for (int i = 0; i < 2 && e == 0; ++i) {
    e = make_map(&dpull[i], sc.d[i], DC, w, h, n, TW, PullCfg::TR);
    if (e == 0) e = make_map(&dwg[i], sc.d[i], DC, w, h, n, RUN, WgradCfg::ROWS);
  }
  if (e != 0) return e;
  const int bstride = 3 * DC;
  prep_kernel<<<BROWS, PREP_THREADS, 0, stream>>>(g, sc.d[0], sc.bpart + 2 * DC + NF + 2 * GC,
                                                   bstride, pixels);
  e = (int)cudaGetLastError();
  for (int j = 2; j >= 0 && e == 0; --j) {
    const int cur = (2 - j) & 1;
    const bf16* wj = pulls + (size_t)j * PULL_NUMEL;
    PullArgs a;
    a.h = hid[j];
    a.g = g;
    a.gbuf = sc.gbuf;
    a.dcur = sc.d[cur];
    a.dnext = j > 0 ? sc.d[cur ^ 1] : nullptr;
    a.dx = dx;
    a.bstride = bstride;
    a.g_first = j == 2;
    a.H = h;
    a.W = w;
    a.frames = n;
    for (int s = 4; s >= 0 && e == 0; --s) {
      a.s = s;
      a.w = wj + pull_w_off(s);
      a.bpart = s > 0 ? sc.bpart + j * DC + 32 * (s - 1)
                      : (j > 0 ? sc.bpart + (j - 1) * DC + NF + 2 * GC : nullptr);
      e = s > 0 ? launch_pull<GC>(dpull[cur], a, stream) : launch_pull<NF>(dpull[cur], a, stream);
    }
    if (e != 0) break;
    CUtensorMap xm, hm;
    e = make_map(&xm, ins[j], NF, w, h, n, TW, WgradCfg::ROWS + 2);
    if (e == 0) e = make_map(&hm, hid[j], HC, w, h, n, TW, WgradCfg::ROWS + 2);
    if (e != 0) break;
    WgradArgs wa;
    wa.part = sc.part + (size_t)j * PART_FLOATS;
    wa.pstride = 3LL * PART_FLOATS;
    wa.H = h;
    wa.W = w;
    wa.frames = n;
    e = launch_wgrad(dwg[cur], xm, hm, wa, stream);
  }
  if (e != 0) return e;
  const long long total = 3LL * RDB_GRADS;
  reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      sc.part, 3LL * PART_FLOATS, WgradCfg::KS, sc.bpart, grads);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace kb
