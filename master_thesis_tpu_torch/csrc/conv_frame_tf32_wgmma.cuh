// K7 / K8 in f32: one k x k conv (k = 3 or 5; same padding, zeros only at
// the frame's border; f32 bias, then ReLU where asked) over N whole NHWC
// f32 frames, Cin a multiple of 32 and Cout of 64, on Hopper's tensor
// cores in 3xTF32: each product a * b is a_hi b_hi + a_hi b_lo + a_lo b_hi,
// a = a_hi + a_lo with a_hi = tf32(a) and a_lo = tf32(a - a_hi) (round to
// nearest, ties away), three wgmma products summed in f32.
// K7's tiles are frames of 16x16. The thin convs of a stack (sep4d's 1 ->
// 128 and 128 -> 1, the mixer's tail, the flow estimators' c0 and c17,
// VGG's 3 -> 64) stay on conv_f32.cu's SIMT kernel.
//
// Replaces, in f32, for those convs: master_thesis_tpu/ops/pallas_sep4d.py:
// conv_stack_tiles (K7, body _conv_stack_kernel: sep4d's two stages and the
// mixer) and conv_stack_banded (K8, body _conv_stack_band_kernel: flow_256's
// and flow_64's segments, VGG's pool-4 tower), which run their dots in f32
// under Precision.HIGHEST: a multi-pass split product on the TPU's
// low-precision matrix unit, as here. One TF32 product alone reads ~3e-4
// relative L2 against f64 on the card.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, 67 TFLOP/s f32 outside the
// tensor cores, 3.35 TB/s): three products make the tensor-core bound 3 x
// FLOPs / 495 TFLOP/s, 0.41x the f32 one (FLOPs / 67 TFLOP/s). At the CHN+DFPN
// step's shapes sep4d's four wide convs (4.63 TFLOP) have a 28.1 ms
// tensor-core bound (69.1 ms at 67 TFLOP/s). Every routed conv does at
// least ~450 TF32 operations (3 x FLOPs) a byte of its input, hi and lo
// weights and output (the least: flow_64's 3x3 at 8x8), past the card's
// ~148, so all are bound by operations (chip_smoke.py:phase_tf32_convs
// computes each floor).
//
// Design: conv_frame_wgmma.cuh's swapped implicit GEMM, D = W^T X: M = output
// channels (one m64 tile a consumer warpgroup), N = the box's wrapped pixel
// columns, K = k² taps x Cin. tf32 wgmma reads both operands K-major from
// shared memory, as the swapped GEMM has them: the weights K-major, the
// pixels with their channels contiguous. A K-chunk is 32 input channels,
// one 128-byte row a pixel (32 tf32); a tap moves the B descriptor by whole
// pixels (128 bytes) and a k8 step by 32 bytes, base offset 0, 128-byte
// swizzle. A tile is fr frames x rows x tw output pixels (ops/conv_stack.py:
// frame_tile_tf32), covered by NH n144 halves: columns with x >= tw, y >=
// rows or past the tile's frames are computed and dropped. Its input is one
// 4-D TMA box a chunk, (tw + k - 1) x (rows + k - 1) x fr pixels from (x0 -
// r, y0 - r, f0): the zero fill is the frame's zero padding, and a tile's
// halo rows are its neighbours' rows in device memory.
//
// The split. The weights are split once when packed (ops/fragments.py:
// wgmma_tf32_matrix: the hi and the lo matrix, each (Cin / 32, k², Cout padded
// to 128, 32), each output's 16-byte chunks in the 128-byte swizzle), so a
// (tap, chunk) stage is two bulk copies. The activations are split in
// shared memory: three producer warps that issue no load wait for each box,
// round it in place to its hi half and write its lo half right behind it
// (the box's bytes further on, swizzled by their own address bits), fence
// the async proxy and arrive on the box's split barrier, on which the
// consumers wait. So the split overlaps the consumers' products on the
// previous chunk and costs no device memory. The hi half is rounded in shared
// memory rather than left for the tensor core to truncate: the kernel's
// arithmetic is then the same whatever the tensor core does with the low 13
// bits, and the CPU tests emulate the split bit for bit.
//
// Roles, from conv_frame_wgmma.cuh: lane 0 of the producer warpgroup issues
// every load (setmaxnreg hands the warpgroup's registers to the consumers),
// keeping the box ring (2 stages of hi + lo) and the weight ring ((tap,
// chunk) blocks, hi + lo: 2 stages of 128 outputs or 4 of 64) full; the next
// box is issued early in the current chunk's taps. Two consumer warpgroups,
// each one m64 x n144 product: on one half (NH = 1) warpgroup w owns outputs
// [64 w, 64 w + 64) of the CTA's 128, on two halves (NH = 2) half w of its
// 64. Each (chunk, tap) is one wgmma group of 4 k8 steps x 3 products, the
// two correction products first. A CTA walks its work units (tile, 128 / NH
// outputs), outputs fastest.
//
// The sums. The tensor cores add each product group into the accumulator
// with the sum truncated (round toward zero), so the error grows with the
// number of groups added into one accumulator: a model of those adds
// (tests/test_torch_tf32x3.py:_truncated_sums) reads 5.9e-5 relative L2
// against f64 for one accumulator over 25 x 256 inputs, past chip_smoke.py's
// f32 limit of 1e-5, and a version of this kernel with one accumulator a
// unit failed that limit on the card at the 256-channel and 5x5 shapes. So
// the groups of each row of taps (12 or 20 wgmmas) go into a partial
// accumulator started afresh (scale-d 0), which is then added to the unit's
// sum in f32 with round to nearest (the model: 1.5e-6): 72 more registers a
// thread, which is why a warpgroup holds one m64 x n144 product and not
// two, and a wait for the row's last group before the add.
//
// The epilogue adds the bias, applies ReLU and stores f32 straight from the
// accumulators (8 consecutive outputs of 4 pixels a warp store: whole
// 32-byte sectors), masked at the frame's edges, to tile t's pixel q,
// channel o at (f / tg) sg + (f % tg) st + q sp + o: NHWC, or sep4d's p <-> q
// swap (stage 1's last conv), so the swap costs no permute.
//
// Shared memory: a stage of the box ring is its hi and lo copies, 2 x fr x bh
// x bw x 128 bytes rounded up to 1024; the weight ring 64 KB. A box has at
// most 324 pixels (K7's 18 x 18, and K8's 3x3 tiles of 16 x 16; its 5x5
// tiles of 4 rows x 32 on one n144 half, a 36 x 8 box): 231 552 bytes at
// K7's tile, of the 232 448. Columns past the box read the next bytes of
// shared memory (the lo copy, the next stage, the weight ring) and are
// dropped: a column's sums depend on its own pixels only. The launcher
// refuses a tile whose reads would pass the end.
//
// Planted faults for the checks on the card, -DTF32_PLANT=n: 1 drops the two
// correction products (plain 1xTF32); 2 leaves out the corner tap (-r, -r);
// 3 reads the top halo row of every tile below a frame's first row tile as
// zeros (that row is the tile above's, across the tile boundary).
#pragma once

#include "conv3x3_wgmma.cuh"

#ifndef TF32_PLANT
#define TF32_PLANT 0
#endif

namespace ft {
namespace {

constexpr int HALF = 144;                // pixel columns a wgmma
constexpr int CHUNK = 32;                // f32 input channels a K-chunk (one 128-byte pixel row)
constexpr int COUT_PAD = 128;            // the packed weights' output padding
constexpr int SA = 2;                    // box stages
constexpr int W_RING = 2 * 128 * 128;    // weight-ring bytes of one of hi / lo: 2 stages of 128
                                         // outputs, or 4 of 64
constexpr int NCONS = 256, NTHREAD = NCONS + 128, CONS_WARPS = NCONS / 32;
constexpr int SPLIT_WARPS = 3;           // producer warps 1-3 split the boxes
constexpr int PROD_REGS = 40, CONS_REGS = 232;
static_assert(PROD_REGS * 128 + CONS_REGS * NCONS <= 65536, "register file");
constexpr int SMEM_MAX = 232448;
constexpr int BARS = 128;  // (afull, asplit, aempty) x SA + (wfull, wempty) x (2 or 4)

struct Args {
  const float* wt;    // packed hi matrix, the lo matrix lo_off floats further
  const float* bias;  // cout
  float* out;
  long long lo_off;
  long long tg, sg, st, sp;  // output addressing (see the note)
  int n, h, w, cin, cout, cout_pad, relu;
  int fr, rows, tw;              // a tile: fr frames x rows x tw output pixels
  int tiles_x, tiles_y, groups;  // column tiles, row tiles, frame groups
  int a_tx, a_stage;             // one box copy's bytes, and a stage's (hi + lo, 1024-aligned)
};

// The kernel's shared memory for a box copy of a_tx bytes: the rings, the
// barriers, and slack where the last half's dropped columns (up to the
// largest tap shift past column NH * 144) would read past them.
inline int smem_bytes(int a_tx, int nh, int k, int bw) {
  const int a_stage = (2 * a_tx + 1023) / 1024 * 1024;
  const int rings = SA * a_stage + 2 * W_RING;
  const int reach = (SA - 1) * a_stage + a_tx + (nh * HALF + (k - 1) * (bw + 1)) * 128;
  return (reach > rings ? reach : rings) + BARS;
}

struct Tile {
  int f0, y0, x0;
};
__device__ __forceinline__ Tile tile_of(const Args& a, int s) {
  const int tx = s % a.tiles_x, rest = s / a.tiles_x;
  return {rest / a.tiles_y * a.fr, rest % a.tiles_y * a.rows, tx * a.tw};
}

// D (64 x 144 f32, 72 registers a thread) = A (64 x 8) B (8 x 144) + (acc ?
// D : 0), tf32, both K-major from shared memory. Thread l of warp w of the
// warpgroup holds, for each n8 block j, d[4 j + 2 i + e] = D[16 w + l / 4 +
// 8 i][8 j + 2 (l % 4) + e].
__device__ __forceinline__ void mma144(float (&d)[72], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(acc));
}

// The K-major 128-byte-swizzled descriptor at `addr` (SBO 1024 bytes: 8
// rows of 128), base offset 0: each address is swizzled by its own bits.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// tf32(v), round to nearest, ties away from zero, low 13 bits zero (the
// rounding of ops/fragments.py:tf32_round).
__device__ __forceinline__ float tf32_rna(float v) {
  return __int_as_float((__float_as_int(v) + 0x1000) & (int)0xFFFFE000);
}

template <int K, int NH>
__global__ void __launch_bounds__(NTHREAD, 1)
tf32_kernel(__grid_constant__ const CUtensorMap xmap, const Args a) {
  constexpr int R = K / 2, KK = K * K;
  constexpr int COUT_T = 128 / NH;                // outputs a CTA: a warpgroup's m64 x n144 each
  constexpr int SW = W_RING / (COUT_T * 128);     // weight stages: 2 of 128 outputs, 4 of 64
  constexpr uint32_t W_BYTES = COUT_T * 128;      // one (tap, chunk) block, hi or lo
  constexpr int JB = SW + 1 < KK - 1 ? SW + 1 : KK - 1;  // the tap before which the next box goes
  static_assert(NH == 1 || NH == 2, "one or two n144 halves");
  extern __shared__ __align__(1024) unsigned char ft_smem[];
  unsigned char* smem = ft_smem;
  const int w_off = SA * a.a_stage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + w_off + 2 * W_RING);
  const uint32_t afull0 = cw::smem_u32(bars), asplit0 = afull0 + 8 * SA, aempty0 = asplit0 + 8 * SA;
  const uint32_t wfull0 = aempty0 + 8 * SA, wempty0 = wfull0 + 8 * SW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bw = a.tw + K - 1, bh = a.rows + K - 1;
  const int nct = a.cout / COUT_T, nch = a.cin / CHUNK;
  const int units = a.groups * a.tiles_y * a.tiles_x * nct;  // (tile, COUT_T outputs), outputs fastest

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      cw::mbar_init(afull0 + 8 * s, 1);
      cw::mbar_init(asplit0 + 8 * s, SPLIT_WARPS);
      cw::mbar_init(aempty0 + 8 * s, CONS_WARPS);
    }
    for (int s = 0; s < SW; ++s) {
      cw::mbar_init(wfull0 + 8 * s, 1);
      cw::mbar_init(wempty0 + 8 * s, CONS_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (cw::smem_u32(smem) & 1023) __trap();  // the swizzle pattern needs 1024-byte stages
  __syncthreads();

  if (warp >= CONS_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS));
    if (warp == CONS_WARPS) {  // lane 0 issues every load
      if (lane != 0) return;
      int qa = 0, qw = 0;
      int bu = blockIdx.x, bc = 0;  // the next box: unit, chunk
      auto next_box = [&]() {
        if (bu >= units) return;
        const Tile t = tile_of(a, bu / nct);
        const int sa = qa % SA;
        if (qa >= SA) cw::mbar_wait(aempty0 + 8 * sa, (qa / SA - 1) & 1);
        cw::mbar_expect_tx(afull0 + 8 * sa, (uint32_t)a.a_tx);
        cw::tma_load_4d(cw::smem_u32(smem + sa * a.a_stage), &xmap, CHUNK * bc, t.x0 - R, t.y0 - R,
                        t.f0, afull0 + 8 * sa);
        ++qa;
        if (++bc == nch) {
          bc = 0;
          bu += gridDim.x;
        }
      };
      next_box();
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int n0 = (u % nct) * COUT_T;
        for (int c = 0; c < nch; ++c) {
          for (int tap = 0; tap < KK; ++tap, ++qw) {
            if (tap == JB) next_box();
            const int sw = qw % SW;
            if (qw >= SW) cw::mbar_wait(wempty0 + 8 * sw, (qw / SW - 1) & 1);
            cw::mbar_expect_tx(wfull0 + 8 * sw, 2 * W_BYTES);
            const uint32_t dst = cw::smem_u32(smem + w_off + sw * 2 * W_BYTES);
            const float* src = a.wt + ((size_t)(c * KK + tap) * a.cout_pad + n0) * CHUNK;
            cw::bulk_load(dst, src, W_BYTES, wfull0 + 8 * sw);
            cw::bulk_load(dst + W_BYTES, src + a.lo_off, W_BYTES, wfull0 + 8 * sw);
          }
        }
      }
      return;
    }
    // Warps 1-3: each box, once landed, rounded in place to its hi half,
    // its lo half written a_tx bytes further on.
    const int st = threadIdx.x - (CONS_WARPS + 1) * 32;
    int qa = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Tile t = tile_of(a, u / nct);
      for (int c = 0; c < nch; ++c, ++qa) {
        const int sa = qa % SA;
        cw::mbar_wait(afull0 + 8 * sa, (qa / SA) & 1);
        unsigned char* box = smem + sa * a.a_stage;
        const uint32_t lo_row0 = (uint32_t)a.a_tx >> 7;  // the lo copy's first row
        for (int i = st; i < a.a_tx / 16; i += SPLIT_WARPS * 32) {
          const int p = i >> 3, j = (i & 7) ^ (p & 7);  // pixel, logical 16-byte chunk
          const float4 v = *reinterpret_cast<const float4*>(box + 16 * i);
          float4 hi = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
          float4 lo = make_float4(tf32_rna(v.x - hi.x), tf32_rna(v.y - hi.y), tf32_rna(v.z - hi.z),
                                  tf32_rna(v.w - hi.w));
          if (TF32_PLANT == 3 && t.y0 > 0 && p < bw) hi = lo = make_float4(0.f, 0.f, 0.f, 0.f);
          *reinterpret_cast<float4*>(box + 16 * i) = hi;
          const uint32_t row = lo_row0 + p;
          *reinterpret_cast<float4*>(box + 128 * row + 16 * (j ^ (row & 7))) = lo;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) cw::mbar_arrive(asplit0 + 8 * sa);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS));
  const int wgi = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, q4 = lane & 3;
  const int mt = NH == 1 ? wgi : 0, h = NH == 2 ? wgi : 0;  // warpgroup wgi's outputs and half
  // A stage is released by one lane a consumer warp, after its wgmmas that
  // read it retired.
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) cw::mbar_arrive(bar);
  };
  int qa = 0, qw = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Tile t = tile_of(a, u / nct);
    const int n0 = (u % nct) * COUT_T;
    // The tensor cores add each product group into part with its sum
    // truncated; part is summed into acc (round to nearest) after each row
    // of taps, before the truncation drifts.
    float acc[72], part[72];
#pragma unroll
    for (int i = 0; i < 72; ++i) acc[i] = part[i] = 0.0f;
    int fresh = 1;                 // the next product starts part afresh
    int prev_w = -1, prev_a = -1;  // stages to release once the next group is issued
    for (int c = 0; c < nch; ++c, ++qa) {
      const int sa = qa % SA;
      cw::mbar_wait(asplit0 + 8 * sa, (qa / SA) & 1);
      const uint32_t hi = cw::smem_u32(smem + sa * a.a_stage), lo = hi + a.a_tx;
#pragma unroll 1
      for (int tap = 0; tap < KK; ++tap, ++qw) {
        const int sw = qw % SW;
        cw::mbar_wait(wfull0 + 8 * sw, (qw / SW) & 1);
        const uint32_t wh = cw::smem_u32(smem + w_off + sw * 2 * W_BYTES) + mt * 64 * 128;
        const uint32_t wlo = wh + W_BYTES;
        cw::fence_acc(part);
        cw::wgmma_fence();
        if (!(TF32_PLANT == 2 && tap == 0)) {
          const uint32_t col = (HALF * h + (tap / K) * bw + tap % K) * 128;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t ah = desc(wh + 32 * kk), bh_ = desc(hi + col + 32 * kk);
            if (TF32_PLANT != 1) {
              mma144(part, desc(wlo + 32 * kk), bh_, !fresh);
              mma144(part, ah, desc(lo + col + 32 * kk), 1);
              fresh = 0;
            }
            mma144(part, ah, bh_, !fresh);
            fresh = 0;
          }
        }
        cw::wgmma_commit();
        if (tap % K == K - 1) {  // the row's last tap: part into acc
          cw::wgmma_wait<0>();
          cw::fence_acc(part);
#pragma unroll
          for (int i = 0; i < 72; ++i) acc[i] += part[i];
          fresh = 1;
        } else {
          cw::wgmma_wait<1>();
          cw::fence_acc(part);
        }
        if (prev_w >= 0) release(wempty0 + 8 * prev_w);
        if (prev_a >= 0) {
          release(aempty0 + 8 * prev_a);
          prev_a = -1;
        }
        prev_w = sw;
      }
      prev_a = sa;
    }
    cw::wgmma_wait<0>();
    cw::fence_acc(part);
    release(wempty0 + 8 * prev_w);
    release(aempty0 + 8 * prev_a);

    // Epilogue: output o = obase + 8 i of column 8 j + 2 q4 + e.
    const int obase = n0 + mt * 64 + 16 * wl + g;
    const float b0 = a.bias[obase], b1 = a.bias[obase + 8];
#pragma unroll
    for (int j = 0; j < 18; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = HALF * h + 8 * j + 2 * q4 + e;
        const int q = n / bw, x = n - q * bw, fl = q / bh, y = q - fl * bh;
        const int f = t.f0 + fl, yy = t.y0 + y, xx = t.x0 + x;
        if (x >= a.tw || y >= a.rows || fl >= a.fr || f >= a.n || yy >= a.h || xx >= a.w) continue;
        float* o = a.out + (f / a.tg) * a.sg + (f % a.tg) * a.st + ((long long)yy * a.w + xx) * a.sp +
                   obase;
        float v0 = acc[4 * j + e] + b0, v1 = acc[4 * j + 2 + e] + b1;
        if (a.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        o[0] = v0;
        o[8] = v1;
      }
  }
}

// NHWC f32 frames (n, h, w, c) read in boxes of 32 channels x bw x bh x fr
// pixels, 128-byte swizzled.
inline int make_map(CUtensorMap* m, const void* base, int c, int w, int h, int n, int bw, int bh,
                    int fr) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = cw::encode_fn();
  if (fn == nullptr) return cw::TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 4, (cuuint64_t)w * c * 4,
                                 (cuuint64_t)h * w * c * 4};
  const cuuint32_t box[4] = {CHUNK, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)fr};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cw::TENSOR_MAP_ERROR + (int)r;
}

// CTAs that can run at once: one an SM.
template <int K, int NH>
int resident_ctas() {
  static const int n = [] {
    return cudaFuncSetAttribute(tf32_kernel<K, NH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_MAX) == cudaSuccess
               ? cw::sm_count()
               : 0;
  }();
  return n;
}

template <int K, int NH>
int launch_t(const CUtensorMap& xm, const Args& a, int smem, cudaStream_t stream) {
  const int cap = resident_ctas<K, NH>();
  if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long units = (long long)a.groups * a.tiles_y * a.tiles_x * (a.cout / (128 / NH));
  const long long grid = units < cap ? units : cap;
  tf32_kernel<K, NH><<<(int)grid, NTHREAD, smem, stream>>>(xm, a);
  return (int)cudaGetLastError();
}

// One conv over x (a.n, a.h, a.w, a.cin) NHWC f32 into a.out, k = 3 or 5,
// with a tile of a.fr x a.rows x a.tw on nh n144 halves (128 / nh outputs a
// CTA). Returns the CUDA error code (or cw::TENSOR_MAP_ERROR + a CUresult).
inline int launch(const float* x, Args a, int k, int nh, cudaStream_t stream) {
  if ((k != 3 && k != 5) || (nh != 1 && nh != 2) || a.n < 1 || a.h < 1 || a.w < 1 ||
      a.cin < CHUNK || a.cin % CHUNK || a.cout < 64 || a.cout % (128 / nh) ||
      a.cout_pad % COUT_PAD || a.cout_pad < a.cout || a.fr < 1 || a.rows < 1 || a.tw < 1 ||
      a.tw > a.w || a.rows > a.h || (a.fr > 1 && a.rows != a.h) || a.tg < 1)
    return (int)cudaErrorInvalidValue;
  const int bw = a.tw + k - 1, bh = a.rows + k - 1;
  if (((a.fr - 1) * bh + a.rows - 1) * bw + a.tw > nh * HALF || bw > 256 || bh > 256 || a.fr > 256)
    return (int)cudaErrorInvalidValue;  // an output column past the halves
  a.a_tx = a.fr * bh * bw * 128;
  a.a_stage = (2 * a.a_tx + 1023) / 1024 * 1024;
  const int smem = smem_bytes(a.a_tx, nh, k, bw);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidConfiguration;
  a.tiles_x = (a.w + a.tw - 1) / a.tw;
  a.tiles_y = (a.h + a.rows - 1) / a.rows;
  a.groups = (a.n + a.fr - 1) / a.fr;
  CUtensorMap xm;
  const int e = make_map(&xm, x, a.cin, a.w, a.h, a.n, bw, bh, a.fr);
  if (e != 0) return e;
  if (k == 3) return nh == 2 ? launch_t<3, 2>(xm, a, smem, stream) : launch_t<3, 1>(xm, a, smem, stream);
  return nh == 2 ? launch_t<5, 2>(xm, a, smem, stream) : launch_t<5, 1>(xm, a, smem, stream);
}

}  // namespace
}  // namespace ft
