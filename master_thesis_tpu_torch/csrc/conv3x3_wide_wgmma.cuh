// K7, second design, for the wide convs: one 3x3 conv (same padding, f32
// bias, then ReLU where asked) over NT independent 16x16 images, NHWC bf16
// in and out, Cin and Cout multiples of 64, as an implicit GEMM on Hopper's
// warpgroup MMA (wgmma) with TMA-fed tiles. The thin convs of a stack
// (Cin or Cout under 64, 5x5 taps) stay on conv_stack.cu's fused kernel.
//
// Replaces, for those convs: master_thesis_tpu/ops/pallas_sep4d.py:
// conv_stack_tiles (body _conv_stack_kernel / _accum_taps_tile): each
// 16x16 tile is its own image, zero-padded at its own border; operands
// bf16, sums f32, the f32 bias added, then ReLU, the output rounded to bf16
// (the rounding of ops/conv_stack.py:conv_stack_plain).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at sep4d's shapes in
// the CHN+DFPN step (B=4, F=5: 5 120 tiles a stage): 128->256 and 256->128
// 0.773 TFLOP each (0.78 ms), 256->256 1.546 TFLOP (1.56 ms), 4.69 ms for
// the four; their inputs and outputs once are 1.0-1.3 GB a conv (0.3-0.4
// ms), so all four are bound by operations.
//
// Design: the GEMM is swapped, D = W^T X: M = output channels (one m64
// tile a consumer warpgroup), N = pixels, K = 9 taps x Cin. A tile's input
// is one 18x18-pixel box of 64 channels per K-chunk, brought by one TMA
// load from a 4-D tensor map (C, 16, 16, NT) started at (-1, -1): TMA's
// out-of-bounds zero fill is the tile's own zero border. The box lands
// 128-byte swizzled, pixel p's 16-byte chunk j at p * 128 + (j ^ p % 8) *
// 16, which is wgmma's K-major 128-byte layout with one pixel a row. N runs
// over the box's flat pixel range at its row stride of 18 ("wrapped"):
// output pixel (y, x) is column 18 y + x, and tap (dy, dx) reads the box
// from column + 18 dy + dx, so a tap is the descriptor's start moved by
// whole pixels (128 bytes) and a k16 step by 32 bytes, base offset 0.
// Columns 0..287 cover every output (0..285) as two n144 halves; columns
// with x >= 16 are computed and dropped, so the tensor cores do 288 / 256
// of the useful work (and the halves read 2 pixels past the box: the
// stage's zeroed slack). The weights are the A operand, K-major and
// 128-byte swizzled too: ops/fragments.py:wgmma_wide_matrix packs them as
// (Cin / 64, 9, Cout padded to 128, 64) with each output's 16-byte chunks
// XOR-ed by its row phase, so a (tap, chunk) block of COUT_T outputs is one
// contiguous bulk copy.
//
// A CTA owns (image, COUT_T output channels) tiles, image-major so that the
// CTAs of one image run side by side and share its boxes in L2, and walks
// them b, b + grid, ... A producer keeps two rings full: the boxes (one
// stage a 64-channel chunk, 41 KB) and the weights (one stage a (tap,
// chunk) block, COUT_T x 128 bytes), each guarded by mbarriers. It is a
// warpgroup of its own, one lane issuing every load, since Hopper hands out
// registers by warpgroup, and gives its registers to the consumers
// (setmaxnreg: 40 for it, 232 for them). Two consumer warpgroups
// accumulate in f32 registers: with COUT_T = 128 warpgroup w owns outputs
// [64 w, 64 w + 64) over both halves (144 registers a thread), with COUT_T
// = 64 half w of the 64 outputs. Each (chunk, tap) is one wgmma group (4
// k16 steps x the warpgroup's halves); a stage is released once the group
// after its last reader has been issued and the reader retired.
// The epilogue adds the bias, applies ReLU, rounds to bf16, stages a half
// in a warpgroup-private area (pixel-major, 144-byte pixel stride: no bank
// conflicts) and stores whole 128-byte pixel pieces with 16-byte vectors,
// while the producer is already loading the next tile.
//
// What bounds it: the weights. At one image a CTA every tile reads its
// conv's whole weight matrix from L2 (1.18 MB at 256->256, 6 GB a conv at
// 5 120 tiles); the box is read once per COUT_T outputs. More images a CTA
// would cut that, but the accumulators of 288 pixels x 128 outputs already
// take 144 registers a thread and two images' boxes do not fit beside the
// rings (ROADMAP: a 2-CTA cluster multicasting the weights is the lever).
//
// Output addressing, for the p <-> q swap of sep4d: tile t's pixel q, the
// channel o, lands at (t / tg) * sg + (t % tg) * st + q * sp + o elements.
//
// Planted faults for the checks on the card, -DWIDE_PLANT=n: 1 leaves out
// tap (0, 0); 2 drops the bias; 3 reads tap (1, 1) through descriptors
// whose base offset holds the start address's swizzle phase (the 128-byte
// mode's phase applied twice). Tuning (master_thesis_tpu_torch/
// sweep_conv_stack.py): -DWIDE_COUT (64 or 128 outputs a CTA), -DWIDE_SA
// (box stages), -DWIDE_SW (weight stages).
#pragma once

#include "conv3x3_wgmma.cuh"

#ifndef WIDE_COUT
#define WIDE_COUT 128
#endif
#ifndef WIDE_SA
#define WIDE_SA 2
#endif
#ifndef WIDE_SW
#define WIDE_SW 4
#endif
#ifndef WIDE_PLANT
#define WIDE_PLANT 0
#endif

// Internal linkage, as in conv3x3_wgmma.cuh: variant libraries loaded into
// one process keep their own kernels and once-per-kernel state.
namespace ww {
namespace {

using bf16 = __nv_bfloat16;

constexpr int SIDE = 16, BOX = SIDE + 2;  // image side, box side
constexpr int HALF = 144;                 // pixel columns a wgmma (two halves cover 0..287)
constexpr int CHUNK = 64;                 // input channels a K-chunk (one 128-byte pixel row)
constexpr int COUT_PAD = 128;             // the packed weights' output padding

struct Cfg {
  static constexpr int COUT_T = WIDE_COUT, SA = WIDE_SA, SW = WIDE_SW;
  static_assert(COUT_T == 64 || COUT_T == 128, "64 or 128 outputs a CTA");
  static constexpr int UNITS = COUT_T / 64;  // (output tile, half) pairs a warpgroup
  // Two consumer warpgroups and a producer warpgroup (one lane of it
  // issues the loads): registers are handed out by warpgroup, so the
  // producer gives its share to the consumers (setmaxnreg).
  static constexpr int NCONS = 256, NTHREAD = NCONS + 128;
  static constexpr int PROD_REGS = 40, CONS_REGS = 232;
  static_assert(PROD_REGS * 128 + CONS_REGS * NCONS <= 65536, "register file");
  static constexpr uint32_t A_TX = BOX * BOX * 128;        // one box: 41 472 bytes
  static constexpr int A_BYTES = (A_TX + 1535) / 1024 * 1024;  // + slack, 1024-aligned
  static constexpr uint32_t W_BYTES = COUT_T * 128;       // one (tap, chunk) block
  static constexpr int STG_PITCH = 144;                   // bytes a staged pixel (64 ch + 8)
  static constexpr int STG = HALF * STG_PITCH;            // a warpgroup's staging area
  static constexpr int W_OFF = SA * A_BYTES, STG_OFF = W_OFF + SW * W_BYTES;
  static constexpr int BAR_OFF = STG_OFF + 2 * STG;
  static constexpr int SMEM = BAR_OFF + 2 * (SA + SW) * 8;
};

struct Args {
  const bf16* w;       // packed (cin / 64, 9, cout_pad, 64), swizzled rows
  const float* bias;   // cout
  bf16* out;
  int nt, cin, cout, cout_pad, relu;
  long long tg, sg, st, sp;  // output addressing (see the note)
};

// D (64 x 144 f32, 72 registers a thread) += A (64 x 16) B (16 x 144), bf16
// from shared memory. Thread l of warp w of the warpgroup holds, for each n8
// block j, d[4 j + 2 i + e] = D[16 w + l / 4 + 8 i][8 j + 2 (l % 4) + e].
__device__ __forceinline__ void mma144(float (&d)[72], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(1));
}

// The K-major 128-byte-swizzled descriptor at `addr` (SBO 1024 bytes: 8
// rows of 128), base offset 0; the fault of -DWIDE_PLANT=3 puts the start
// address's phase in the base offset.
__device__ __forceinline__ uint64_t desc(uint32_t addr, bool phase = false) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
               ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
  if (phase) d |= (uint64_t)((addr >> 7) & 7) << 49;
  return d;
}

__global__ void __launch_bounds__(Cfg::NTHREAD, 1)
wide_kernel(__grid_constant__ const CUtensorMap xmap, const Args a) {
  using C = Cfg;
  constexpr int SA = C::SA, SW = C::SW, UNITS = C::UNITS, COUT_T = C::COUT_T;
  extern __shared__ __align__(1024) unsigned char ww_smem[];
  unsigned char* smem = ww_smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  const uint32_t afull0 = cw::smem_u32(bars), aempty0 = afull0 + 8 * SA;
  const uint32_t wfull0 = aempty0 + 8 * SA, wempty0 = wfull0 + 8 * SW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nct = a.cout_pad / COUT_T, nch = a.cin / CHUNK;
  const int tiles = a.nt * nct;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      cw::mbar_init(afull0 + 8 * s, 1);
      cw::mbar_init(aempty0 + 8 * s, C::NCONS);
    }
    for (int s = 0; s < SW; ++s) {
      cw::mbar_init(wfull0 + 8 * s, 1);
      cw::mbar_init(wempty0 + 8 * s, C::NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Zero each box stage's slack (read only by dropped columns).
  constexpr int SLACK16 = (C::A_BYTES - (int)C::A_TX) / 16;
  for (int i = threadIdx.x; i < SA * SLACK16; i += blockDim.x)
    *reinterpret_cast<uint4*>(smem + (i / SLACK16) * C::A_BYTES + C::A_TX + (i % SLACK16) * 16) =
        make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (cw::smem_u32(smem) & 1023) __trap();  // the swizzle pattern needs 1024-byte stages

  if (warp >= C::NCONS / 32) {  // the producer warpgroup: one lane issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PROD_REGS));
    if (warp == C::NCONS / 32 && lane == 0) {
      int qa = 0, qw = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int img = t / nct, n0 = (t - img * nct) * COUT_T;
        for (int c = 0; c < nch; ++c, ++qa) {
          const int sa = qa % SA;
          if (qa >= SA) cw::mbar_wait(aempty0 + 8 * sa, (qa / SA - 1) & 1);
          cw::mbar_expect_tx(afull0 + 8 * sa, C::A_TX);
          cw::tma_load_4d(cw::smem_u32(smem + sa * C::A_BYTES), &xmap, CHUNK * c, -1, -1, img,
                          afull0 + 8 * sa);
          for (int tap = 0; tap < 9; ++tap, ++qw) {
            const int sw = qw % SW;
            if (qw >= SW) cw::mbar_wait(wempty0 + 8 * sw, (qw / SW - 1) & 1);
            cw::mbar_expect_tx(wfull0 + 8 * sw, C::W_BYTES);
            cw::bulk_load(cw::smem_u32(smem + C::W_OFF + sw * C::W_BYTES),
                          a.w + ((size_t)(c * 9 + tap) * a.cout_pad + n0) * CHUNK, C::W_BYTES,
                          wfull0 + 8 * sw);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONS_REGS));
  const int wgi = warp >> 2, wl = warp & 3, tt = threadIdx.x & 127;
  const int g = lane >> 2, q4 = lane & 3;
  // Warpgroup wgi's output tile (64 of the CTA's COUT_T) and its halves.
  const int mt = UNITS == 2 ? wgi : 0;
  unsigned char* stg = smem + C::STG_OFF + wgi * C::STG;
  int qa = 0, qw = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int img = t / nct, n0 = (t - img * nct) * COUT_T;
    float acc[UNITS][72];
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
#pragma unroll
      for (int i = 0; i < 72; ++i) acc[u][i] = 0.0f;
    int prev_w = -1, prev_a = -1;  // stages to release once the next group is issued
    for (int c = 0; c < nch; ++c, ++qa) {
      const int sa = qa % SA;
      cw::mbar_wait(afull0 + 8 * sa, (qa / SA) & 1);
      const uint32_t box = cw::smem_u32(smem + sa * C::A_BYTES);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++qw) {
        const int sw = qw % SW;
        cw::mbar_wait(wfull0 + 8 * sw, (qw / SW) & 1);
        const uint32_t wst = cw::smem_u32(smem + C::W_OFF + sw * C::W_BYTES) + mt * 64 * 128;
#pragma unroll
        for (int u = 0; u < UNITS; ++u) cw::fence_acc(acc[u]);
        cw::wgmma_fence();
        if (!(WIDE_PLANT == 1 && tap == 0)) {
          const int shift = (tap / 3) * BOX + tap % 3;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t ad = desc(wst + 32 * kk);
#pragma unroll
            for (int u = 0; u < UNITS; ++u) {
              const int h = UNITS == 2 ? u : wgi;
              mma144(acc[u], ad, desc(box + (HALF * h + shift) * 128 + 32 * kk,
                                      WIDE_PLANT == 3 && tap == 4));
            }
          }
        }
        cw::wgmma_commit();
        cw::wgmma_wait<1>();
#pragma unroll
        for (int u = 0; u < UNITS; ++u) cw::fence_acc(acc[u]);
        if (prev_w >= 0) cw::mbar_arrive(wempty0 + 8 * prev_w);
        if (prev_a >= 0) {
          cw::mbar_arrive(aempty0 + 8 * prev_a);
          prev_a = -1;
        }
        prev_w = sw;
      }
      prev_a = sa;
    }
    cw::wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < UNITS; ++u) cw::fence_acc(acc[u]);
    cw::mbar_arrive(wempty0 + 8 * prev_w);
    cw::mbar_arrive(aempty0 + 8 * prev_a);

    // Epilogue, a half at a time through the staging area: pixel column n
    // (0..143 of the half) at n * 144 bytes, output o (0..63) at 2 o.
    const int obase = n0 + mt * 64;
    float bias[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = obase + 16 * wl + g + 8 * i;
      bias[i] = (WIDE_PLANT != 2 && o < a.cout) ? a.bias[o] : 0.0f;
    }
    bf16* out = a.out + (img / a.tg) * a.sg + (img % a.tg) * a.st;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int h = UNITS == 2 ? u : wgi;
      cw::named_sync(1 + wgi, 128);  // the last half's stores have read stg
#pragma unroll
      for (int j = 0; j < 18; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = acc[u][4 * j + 2 * i + e] + bias[i];
            if (a.relu) v = fmaxf(v, 0.0f);
            *reinterpret_cast<bf16*>(stg + (8 * j + 2 * q4 + e) * C::STG_PITCH +
                                     2 * (16 * wl + g + 8 * i)) = __float2bfloat16(v);
          }
      cw::named_sync(1 + wgi, 128);
      for (int v = tt; v < HALF * 8; v += 128) {
        const int n = HALF * h + (v >> 3), c8 = v & 7;
        const int y = n / BOX, x = n - y * BOX;
        if (y >= SIDE || x >= SIDE || obase >= a.cout) continue;
        *reinterpret_cast<uint4*>(out + (y * SIDE + x) * a.sp + obase + 8 * c8) =
            *reinterpret_cast<const uint4*>(stg + (v >> 3) * C::STG_PITCH + 16 * c8);
      }
    }
  }
}

// NHWC bf16 tiles (nt, 16, 16, c) read in boxes of 64 channels x 18 x 18
// pixels of one tile, 128-byte swizzled.
inline int make_map(CUtensorMap* m, const void* base, int c, int nt) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = cw::encode_fn();
  if (fn == nullptr) return cw::TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)c, SIDE, SIDE, (cuuint64_t)nt};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)SIDE * c * 2,
                                 (cuuint64_t)SIDE * SIDE * c * 2};
  const cuuint32_t box[4] = {CHUNK, BOX, BOX, 1}, estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cw::TENSOR_MAP_ERROR + (int)r;
}

// One conv over x (a.nt, 16, 16, a.cin) NHWC into a.out. Returns the CUDA
// error code (or cw::TENSOR_MAP_ERROR + a CUresult).
inline int launch(const bf16* x, const Args& a, cudaStream_t stream) {
  constexpr int smem = Cfg::SMEM;
  static_assert(smem <= 232448, "a CTA's shared memory exceeds 227 KB");
  if (a.nt < 1 || a.cin < CHUNK || a.cin % CHUNK || a.cout < 64 || a.cout % 64 ||
      a.cout_pad % COUT_PAD || a.cout_pad < a.cout || a.tg < 1)
    return (int)cudaErrorInvalidValue;
  static const int per_sm = [] {
    if (cudaFuncSetAttribute(wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
        cudaSuccess)
      return 0;
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wide_kernel, Cfg::NTHREAD, smem);
    return blocks;
  }();
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap xm;
  const int e = make_map(&xm, x, a.cin, a.nt);
  if (e != 0) return e;
  const long long tiles = (long long)a.nt * (a.cout_pad / Cfg::COUT_T);
  const long long cap = (long long)per_sm * cw::sm_count();
  wide_kernel<<<(int)(tiles < cap ? tiles : cap), Cfg::NTHREAD, smem, stream>>>(xm, a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ww
