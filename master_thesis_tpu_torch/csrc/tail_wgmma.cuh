// K4 / K5, second design: the RRDBNet tail, (N, h, w, 64) -> (N, 4h, 4w, 3)
// channels-last, as four implicit-GEMM launches on Hopper's warpgroup MMA
// (wgmma) with TMA-fed tiles, on the template of K1 (conv3x3_wgmma.cuh,
// whose helpers it uses).
//
// Replaces: master_thesis_tpu/ops/pallas_tail.py:rrdbnet_tail_pallas, the
// full-frame branch (K4, body _tail_kernel / _phase_conv) and the banded
// branch (K5, body _tail_band_kernel).
//
//   upconv1, upconv2  nearest-2x upsample + 3x3 conv + bias + lrelu in the
//     4-phase form at the low resolution: output pixel (2i + a, 2j + b)
//     sums taps (ti, tj) in {0, 1}^2 of the input at (i + a - 1 + ti,
//     j + b - 1 + tj), so the upsampled input is never formed. The 16
//     phase-taps are 16 shifted descriptors of one resident input tile.
//   hr_conv           3x3 conv + bias + lrelu, 64 -> 64.
//   conv_last         3x3 conv + bias, 64 -> 3 (an N = 8 GEMM, 3 used).
// All on NHWC bf16, 64 input channels; sums, bias and lrelu in f32; h1, h2,
// h3 and the output rounded to bf16 (the rounding of ops/tail.py:tail_plain).
//
// Bound on an H100 SXM at the serving shape (80 frames at 64x64): 619 GFLOP
// (the upsample-convs in their 4-phase form), 0.626 ms at 989 TFLOP/s bf16.
// Unfused, each launch's max(operations, its input and output once) is
// 0.063 / 0.250 / 0.401 / 0.210 ms (upconv1 / upconv2 / hr_conv /
// conv_last): upconv2 and hr_conv write 671 MB each, conv_last reads it.
//
// Design: one kernel template, one launch per stage. M = 64 output pixels
// of one input row, N = 64 (8 for conv_last), K = taps x 64 channels. A
// tile is ROWS input rows x 64 pixels; a warpgroup owns RPW of its rows (one
// m64 wgmma tile a row), a CTA holds WG consumer warpgroups and one
// producer warp and walks the tiles b, b + grid, ... The producer first
// copies the stage's whole B (all phases and taps, at most 128 KB) into
// shared memory once per CTA, so no tile re-reads weights; then, per tile,
// it loads the input (ROWS + 2) x 66 pixels x 64 channels by one TMA box
// into a ring stage, 128-byte swizzled: each pixel's 128 bytes are one
// K-major row of wgmma's 128-byte swizzle mode. (K1's eight 16-byte-wide
// boxes a tile, one per 8-channel plane, held conv_last to 44% of its
// floor: TMA moves 16-byte rows far below the card's rate.) TMA's
// out-of-bounds zero fill is the convs' zero padding. A tap is a shifted
// descriptor: a one-pixel shift is a 128-byte step of the start address,
// a k16 step a 32-byte one.
// The consumers run PG phases a pass (upconv; 1 for the others) into f32
// registers, then stage the bf16 outputs in a warpgroup-private area
// (16-byte chunks XOR-swizzled by pixel, no bank conflicts) and store whole
// 128-byte pixels with 16-byte vectors: NHWC keeps a pixel's 64 channels
// together (with PG = 2, phases (a, 0) and (a, 1) of one row fill one
// 128-pixel output row). conv_last stages its 3-channel pixels and stores
// 8-byte words. What holds it now (PERF.md): a warpgroup's epilogue runs
// after its wgmmas, not under them, and every tile loads its halo rows
// again; hr_conv and upconv2 reach ~62% of their floors, conv_last ~74%.
//
// Row windows (K5): a launch computes the input rows [ylo, yhi) and writes
// input row y's outputs at row SCALE * (y - ylo) + a + o0 of its output
// (SCALE 2 for the upsample-convs). The banded tail runs the four launches
// per band with the 2x and 4x intermediates in band-sized scratch, upconv1
// reading x in place and conv_last writing the band's rows into the full
// output. Each output pixel sums the same products in the same order as
// in the full-frame launch, so K5 equals K4 bit for bit.
//
// Planted faults for the checks on the card: -DTAIL_PLANT=1 reads every
// tile's right halo column as zeros (every launch); -DBAND_PLANT=1 reads
// conv_last's input row ylo - 1 as zeros when ylo > 0 (a band's halo row).
// Tuning (master_thesis_tpu_torch/sweep_tail.py), per stage kind:
// -DTAIL_UP_ROWS / _WG / _STAGES / _PG (upsample-convs: rows a warpgroup,
// consumer warpgroups, ring stages, phases a pass), -DTAIL_HR_ROWS / _WG /
// _STAGES (hr_conv), -DTAIL_LAST_ROWS / _WG / _STAGES (conv_last).
// Defaults, from the sweep (PERF.md): upsample-convs 1 row x 2 warpgroups
// x 2 stages x 1 phase a pass (210 KB of shared memory), hr_conv 2 x 2 x 2
// (204 KB), conv_last 4 x 2 x 2 (178 KB); one CTA an SM.
#pragma once

#include "conv3x3_wgmma.cuh"

#ifndef TAIL_UP_ROWS
#define TAIL_UP_ROWS 1
#endif
#ifndef TAIL_UP_WG
#define TAIL_UP_WG 2
#endif
#ifndef TAIL_UP_STAGES
#define TAIL_UP_STAGES 2
#endif
#ifndef TAIL_UP_PG
#define TAIL_UP_PG 1
#endif
#ifndef TAIL_HR_ROWS
#define TAIL_HR_ROWS 2
#endif
#ifndef TAIL_HR_WG
#define TAIL_HR_WG 2
#endif
#ifndef TAIL_HR_STAGES
#define TAIL_HR_STAGES 2
#endif
#ifndef TAIL_LAST_ROWS
#define TAIL_LAST_ROWS 4
#endif
#ifndef TAIL_LAST_WG
#define TAIL_LAST_WG 2
#endif
#ifndef TAIL_LAST_STAGES
#define TAIL_LAST_STAGES 2
#endif

// Internal linkage, as in conv3x3_wgmma.cuh: variant libraries loaded into
// one process keep their own kernels and once-per-kernel state.
namespace tw {
namespace {

using bf16 = __nv_bfloat16;

constexpr int C = 64;                // input channels of every stage
constexpr int RUN = 64, TW = RUN + 2;  // output pixels of an M-tile, tile columns
constexpr int UP = 0, HR = 1, LAST = 2;
constexpr int OUT_LAST = 3;          // conv_last's output channels

template <int MODE> struct Mode;
template <> struct Mode<UP> {
  static constexpr int RPW = TAIL_UP_ROWS, WG = TAIL_UP_WG, S = TAIL_UP_STAGES, PG = TAIL_UP_PG;
  static constexpr int N = 64, PHASES = 4, TAPS = 4, SCALE = 2;
};
template <> struct Mode<HR> {
  static constexpr int RPW = TAIL_HR_ROWS, WG = TAIL_HR_WG, S = TAIL_HR_STAGES, PG = 1;
  static constexpr int N = 64, PHASES = 1, TAPS = 9, SCALE = 1;
};
template <> struct Mode<LAST> {
  static constexpr int RPW = TAIL_LAST_ROWS, WG = TAIL_LAST_WG, S = TAIL_LAST_STAGES, PG = 1;
  static constexpr int N = 8, PHASES = 1, TAPS = 9, SCALE = 1;
};

template <int MODE>
struct Cfg : Mode<MODE> {
  using M = Mode<MODE>;
  static_assert(M::PHASES % M::PG == 0, "phases a pass must divide the phases");
  static constexpr int ROWS = M::RPW * M::WG, TR = ROWS + 2;  // input / tile rows a tile
  static constexpr int NCONS = 128 * M::WG, NTHREAD = NCONS + 32;
  // A stage: the tile by one TMA box of all 64 channels, 128-byte swizzled
  // (pixel p's 16-byte chunk j at p * 128 + (j ^ p % 8) * 16), 1024-byte
  // aligned.
  static constexpr int A_BYTES = (TR * TW * 128 + 1023) / 1024 * 1024;
  static constexpr uint32_t A_TX = TR * TW * 128;
  static constexpr int PHASE_B = M::TAPS * C * M::N * 2;  // one phase's B
  static constexpr int B_BYTES = M::PHASES * PHASE_B;
  // A warpgroup's staging area: 64 pixels x 128 bytes per row and phase of a
  // pass, or 64 pixels x 3 bf16 per row for conv_last.
  static constexpr int STG = M::N == 64 ? M::RPW * M::PG * RUN * 128 : M::RPW * RUN * OUT_LAST * 2;
  static constexpr int A_OFF = B_BYTES, STG_OFF = A_OFF + M::S * A_BYTES;
  static constexpr int BAR_OFF = STG_OFF + M::WG * STG;
  static constexpr int SMEM = BAR_OFF + (2 * M::S + 1) * 8;
};

struct Args {
  const bf16* w;      // the stage's packed B (ops/fragments.py)
  const float* bias;  // N (3 for conv_last)
  bf16* out;          // NHWC, (frames, OH, SCALE * W, 64) or (frames, OH, W, 3)
  int H, W;           // input rows and columns
  int ylo, yhi;       // input rows computed
  int frames;
  int OH;             // output rows
  int o0;             // output row of input row ylo's phase-0 outputs
  int plant_row;      // BAND_PLANT: the input row read as zeros (-1: none)
};

// D (64 x 8 f32, 4 registers a thread) += A (64 x 16) B (16 x 8), bf16 from
// shared memory; thread l of warp w holds d[2 i + e] = D[16 w + l / 4 + 8 i]
// [2 (l % 4) + e].
__device__ __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) { cw::mma_ss(d, a, b); }

// Zeroes one tile pixel (its 128 bytes) of a ring stage.
__device__ __forceinline__ void zero_pixel(unsigned char* stage, int pix) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<uint4*>(stage + pix * 128 + j * 16) = make_uint4(0, 0, 0, 0);
}

// The wgmma descriptor of A (64 pixels x 16 channels, K-major) starting at
// `addr` in a 128-byte-swizzled stage: SBO 1024 bytes (8 pixels), LBO
// unused, base offset 0. The swizzle follows the address bits of each row,
// so a start shifted by whole pixels (a tap) or by 32 bytes (a k16 step)
// reads the pixels and channels TMA wrote there.
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// One stage over the tiles of ROWS x 64 input pixels of [ylo, yhi) x W x
// frames, tile t = (frame, row group, column run) from the slowest.
template <int MODE>
__global__ void __launch_bounds__(Cfg<MODE>::NTHREAD)
tail_kernel(__grid_constant__ const CUtensorMap xmap, const Args a) {
  using Q = Cfg<MODE>;
  constexpr int RPW = Q::RPW, S = Q::S, PG = Q::PG, N = Q::N, NB8 = N / 8;
  constexpr int ROWS = Q::ROWS, NCONS = Q::NCONS;
  constexpr int SCALE = Q::SCALE, TAPS = Q::TAPS;
  extern __shared__ __align__(1024) unsigned char tw_smem[];
  unsigned char* smem = tw_smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Q::BAR_OFF);
  const uint32_t full0 = cw::smem_u32(bars), empty0 = cw::smem_u32(bars + S);
  const uint32_t bfull = cw::smem_u32(bars + 2 * S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int runs = (a.W + RUN - 1) / RUN, groups = (a.yhi - a.ylo + ROWS - 1) / ROWS;
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
      int q = 0;  // tiles loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++q) {
        const int x0 = (t % runs) * RUN, y0 = a.ylo + (t / runs % groups) * ROWS;
        const int n = t / (runs * groups);
        const int s = q % S, u = q / S;
        if (u > 0) cw::mbar_wait(empty0 + 8 * s, (u - 1) & 1);
        const uint32_t full = full0 + 8 * s, dst = cw::smem_u32(smem + Q::A_OFF + s * Q::A_BYTES);
        cw::mbar_expect_tx(full, Q::A_TX);
        cw::tma_load_4d(dst, &xmap, 0, x0 - 1, y0 - 1, n, full);
      }
    }
    return;
  }

  const int wgi = warp >> 2, wl = warp & 3, tt = threadIdx.x & 127;
  const int g = lane >> 2, q4 = lane & 3;
  unsigned char* stg = smem + Q::STG_OFF + wgi * Q::STG;
  float bias[NB8][2];
#pragma unroll
  for (int j = 0; j < NB8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * q4 + e;
      bias[j][e] = (N == 64 || col < OUT_LAST) ? a.bias[col] : 0.0f;
    }
  cw::mbar_wait(bfull, 0);
  const uint32_t b_base = cw::smem_u32(smem);

  int q = 0;  // tiles consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++q) {
    const int x0 = (t % runs) * RUN, y0 = a.ylo + (t / runs % groups) * ROWS;
    const int n = t / (runs * groups);
    const int s = q % S;
    unsigned char* stage = smem + Q::A_OFF + s * Q::A_BYTES;
    cw::mbar_wait(full0 + 8 * s, (q / S) & 1);
#if defined(TAIL_PLANT) || defined(BAND_PLANT)
    {
#ifdef TAIL_PLANT
      if (tt < Q::TR) zero_pixel(stage, tt * TW + TW - 1);  // the right halo column
#endif
#ifdef BAND_PLANT
      const int pr = a.plant_row - (y0 - 1);
      if (a.plant_row >= 0 && pr >= 0 && pr < Q::TR)
        for (int p = tt; p < TW; p += 128) zero_pixel(stage, pr * TW + p);
#endif
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cw::named_sync(1 + wgi, 128);
    }
#endif
    const uint32_t a_base = cw::smem_u32(stage);
#pragma unroll 1
    for (int pp = 0; pp < Q::PHASES / PG; ++pp) {
      float acc[RPW][PG][N / 2];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int f = 0; f < PG; ++f)
#pragma unroll
          for (int i = 0; i < N / 2; ++i) acc[r][f][i] = 0.0f;
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int f = 0; f < PG; ++f) cw::fence_acc(acc[r][f]);
      cw::wgmma_fence();
#pragma unroll
      for (int f = 0; f < PG; ++f) {
        const int ph = pp * PG + f;
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int tap = 0; tap < TAPS; ++tap) {
            // Tile row and column of the tap's top-left input pixel.
            const int ky = SCALE == 2 ? (ph >> 1) + (tap >> 1) : tap / 3;
            const int kx = SCALE == 2 ? (ph & 1) + (tap & 1) : tap % 3;
#pragma unroll
            for (int st = 0; st < 2; ++st) {
              const uint64_t bd = cw::make_desc(
                  b_base + ph * Q::PHASE_B + ((c * TAPS + tap) * 2 + st) * 2 * NB8 * 128, NB8 * 128,
                  128);
#pragma unroll
              for (int r = 0; r < RPW; ++r) {
                const int pix = (wgi * RPW + r + ky) * TW + kx;
                mma(acc[r][f], sw_desc(a_base + pix * 128 + 32 * (2 * c + st)), bd);
              }
            }
          }
      }
      cw::wgmma_commit();
      cw::wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int f = 0; f < PG; ++f) cw::fence_acc(acc[r][f]);
      if (pp == Q::PHASES / PG - 1) cw::mbar_arrive(empty0 + 8 * s);  // A read by every wgmma

      // Epilogue through the warpgroup's staging area.
      cw::named_sync(1 + wgi, 128);  // the last pass's stores have read it
      if constexpr (N == 64) {
        // Pixel sp = (r * PG + f) * 64 + m at byte sp * 128, its 16-byte
        // chunk j at (j ^ (m % 8)) * 16.
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int f = 0; f < PG; ++f)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int sp = (r * PG + f) * RUN + 16 * wl + g + 8 * i;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float v0 = cw::lrelu(acc[r][f][4 * j + 2 * i] + bias[j][0]);
                const float v1 = cw::lrelu(acc[r][f][4 * j + 2 * i + 1] + bias[j][1]);
                *reinterpret_cast<__nv_bfloat162*>(stg + sp * 128 + ((j ^ g) << 4) + 4 * q4) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
        cw::named_sync(1 + wgi, 128);
        const int OW = SCALE * a.W;
        for (int v = tt; v < RPW * PG * RUN * 8; v += 128) {
          const int sp = v >> 3, c8 = v & 7, m = sp % RUN;
          const int f = sp / RUN % PG, r = sp / RUN / PG;
          const int y = y0 + wgi * RPW + r, xc = x0 + m;
          if (y >= a.yhi || xc >= a.W) continue;
          const int ph = pp * PG + f;
          const int oy = SCALE * (y - a.ylo) + (SCALE == 2 ? ph >> 1 : 0) + a.o0;
          const int ox = SCALE * xc + (SCALE == 2 ? ph & 1 : 0);
          *reinterpret_cast<uint4*>(a.out + (((size_t)n * a.OH + oy) * OW + ox) * C + 8 * c8) =
              *reinterpret_cast<const uint4*>(stg + sp * 128 + ((c8 ^ (sp & 7)) << 4));
        }
      } else {
        // conv_last: pixel m of row r at bf16 (r * 64 + m) * 3; the row's
        // valid pixels are a multiple of 4 (W = 4w), so whole 8-byte words.
        bf16* st16 = reinterpret_cast<bf16*>(stg);
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int m = 16 * wl + g + 8 * i;
            bf16* px = st16 + (r * RUN + m) * OUT_LAST;
            if (q4 == 0) {
              px[0] = __float2bfloat16(acc[r][0][2 * i] + bias[0][0]);
              px[1] = __float2bfloat16(acc[r][0][2 * i + 1] + bias[0][1]);
            } else if (q4 == 1) {
              px[2] = __float2bfloat16(acc[r][0][2 * i] + bias[0][0]);
            }
          }
        cw::named_sync(1 + wgi, 128);
        const int cols = a.W - x0 < RUN ? a.W - x0 : RUN;
        constexpr int WORDS = RUN * OUT_LAST / 4;
        for (int v = tt; v < RPW * WORDS; v += 128) {
          const int r = v / WORDS, wd = v % WORDS;
          const int y = y0 + wgi * RPW + r;
          if (y >= a.yhi || 4 * wd >= cols * OUT_LAST) continue;
          const int oy = y - a.ylo + a.o0;
          *reinterpret_cast<uint2*>(a.out + (((size_t)n * a.OH + oy) * a.W + x0) * OUT_LAST + 4 * wd) =
              *reinterpret_cast<const uint2*>(st16 + r * RUN * OUT_LAST + 4 * wd);
        }
      }
    }
  }
}

// An NHWC bf16 tensor of 64 channels (frames, rows, cols, 64) read in boxes
// of all 64 channels x box_cols columns x box_rows rows of one frame,
// 128-byte swizzled.
inline int make_map_sw(CUtensorMap* m, const void* base, int cols, int rows, int frames,
                       int box_cols, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = cw::encode_fn();
  if (fn == nullptr) return cw::TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)frames};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)cols * C * 2,
                                 (cuuint64_t)rows * cols * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cw::TENSOR_MAP_ERROR + (int)r;
}

// One stage over the input rows [a.ylo, a.yhi) of x, (a.frames, a.H, a.W,
// 64) NHWC. Returns the CUDA error code (or cw::TENSOR_MAP_ERROR + a
// CUresult).
template <int MODE>
int launch(const bf16* x, const Args& a, cudaStream_t stream) {
  using Q = Cfg<MODE>;
  constexpr int smem = Q::SMEM;
  static_assert(smem <= 232448, "a CTA's shared memory exceeds 227 KB");
  if (a.ylo < 0 || a.yhi > a.H || a.ylo >= a.yhi || a.o0 < 0 ||
      a.o0 + Q::SCALE * (a.yhi - a.ylo) > a.OH || (MODE == LAST && a.W % 4 != 0))
    return (int)cudaErrorInvalidValue;
  static const int per_sm = [] {
    if (cudaFuncSetAttribute(tail_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return 0;
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, tail_kernel<MODE>, Q::NTHREAD, smem);
    return blocks;
  }();
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap xm;
  const int e = make_map_sw(&xm, x, a.W, a.H, a.frames, TW, Q::TR);
  if (e != 0) return e;
  const long long tiles = (long long)((a.W + RUN - 1) / RUN) *
                          ((a.yhi - a.ylo + Q::ROWS - 1) / Q::ROWS) * a.frames;
  const long long cap = (long long)per_sm * cw::sm_count();
  tail_kernel<MODE><<<(int)(tiles < cap ? tiles : cap), Q::NTHREAD, smem, stream>>>(xm, a);
  return (int)cudaGetLastError();
}

// Stage k of the tail (0 upconv1, 1 upconv2, 2 hr_conv, 3 conv_last) over
// the input rows [ylo, yhi) of x, (n, h_in, w_in, 64), into out (see Args).
// Returns the CUDA error code.
inline int stage(int k, const void* x, const void* w, const void* b, void* out, int n, int h_in,
                 int w_in, int ylo, int yhi, int oh, int o0, cudaStream_t stream) {
  Args a;
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(b);
  a.out = static_cast<bf16*>(out);
  a.H = h_in;
  a.W = w_in;
  a.ylo = ylo;
  a.yhi = yhi;
  a.frames = n;
  a.OH = oh;
  a.o0 = o0;
  a.plant_row = -1;
#ifdef BAND_PLANT
  if (k == 3 && ylo > 0) a.plant_row = ylo - 1;
#endif
  const bf16* xb = static_cast<const bf16*>(x);
  if (k < 2) return launch<UP>(xb, a, stream);
  if (k == 2) return launch<HR>(xb, a, stream);
  if (k == 3) return launch<LAST>(xb, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tw
