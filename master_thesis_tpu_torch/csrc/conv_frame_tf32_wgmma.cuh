// K7 / K8 in f32, K4 / K5 (the RRDBNet tail) in f32 and K1 / K2 (the RRDB
// trunk) in f32: one conv over N whole NHWC f32 frames (or a window of their
// rows) on Hopper's tensor cores in 3xTF32: each product a * b is a_hi b_hi +
// a_hi b_lo + a_lo b_hi, a = a_hi + a_lo with a_hi = tf32(a) and a_lo = tf32(a
// - a_hi) (round to nearest, ties away), three wgmma products summed in f32.
// Four modes:
//
// - conv: a k x k conv (k = 3 or 5; same padding, zeros only at the frame's
//   border; f32 bias, then ReLU or leaky ReLU (0.2) where asked, or the
//   residual epilogue below), Cin a multiple of 32 and Cout of 64. K7's tiles
//   are frames of 16x16. The thin convs of a stack (sep4d's 1 -> 128 and
//   128 -> 1, the mixer's tail, the flow estimators' c0 and c17, VGG's 3 ->
//   64) stay on conv_f32.cu's SIMT kernel. The tail's hr_conv (3x3, 64 -> 64,
//   leaky) is one launch of it, and so is an RDB's conv5 (3x3, 192 -> 64,
//   the residual epilogue).
// - phase: a nearest-2x upsample then 3x3 conv (the tail's upconv1 and
//   upconv2, leaky) in its 4-phase form at the low resolution: output phase
//   (a, b) of low-resolution pixel (y, x) is high-resolution pixel (2y + a,
//   2x + b), and reads the four taps (ti, tj) at input offsets (a - 1 + ti,
//   b - 1 + tj) (models/nn_ext.py:fused_upsample_conv_kernel): 4/9 of the
//   products of the 3x3 at the high resolution that the SIMT route runs.
// - last: the tail's conv_last (3x3, 64 -> 3, no activation) as the
//   unswapped product (below), so that its 3 outputs cost an n8 a tap, not
//   an m64.
// - gc: an RDB's dense-concat convs conv1..conv4 (3x3, Cin 64, 96, 128, 160
//   -> gc = 32, leaky) as the unswapped product with 32 outputs a tap (an
//   n96 a row of taps), so that gc = 32 costs no padding to an m64.
//
// The residual epilogue ("resid", conv mode): an RDB's conv5, 0.2 (0.2
// (acc + b) + r) + r2, each step one f32 fma in conv_f32.cu's order (the r2
// step only where r2 is given), r the RDB's input x and r2 the RRDB residual
// on an RRDB's third RDB. r and r2 are whole frames read at the output
// pixel's frame, row and column through their own strides, so a band's
// launch reads them in place.
//
// Replaces, in f32: master_thesis_tpu/ops/pallas_sep4d.py: conv_stack_tiles
// (K7, body _conv_stack_kernel: sep4d's two stages and the mixer) and
// conv_stack_banded (K8, body _conv_stack_band_kernel: flow_256's and
// flow_64's segments, VGG's pool-4 tower), for their 64-multiple convs; and
// master_thesis_tpu/ops/pallas_tail.py: rrdbnet_tail_pallas (K4, body
// _tail_kernel, and K5, its banded branch, body _tail_band_kernel: each
// upsample-conv as _phase_conv), all four stages; and
// master_thesis_tpu/ops/pallas_rrdb.py: rrdb_pallas (K1, body _rrdb_kernel)
// and rrdb_trunk_pallas_banded (K2, body _rdb_band_kernel), all five convs
// of each RDB (15 launches an RRDB). Those run their dots in
// f32 under Precision.HIGHEST: a multi-pass split product on the TPU's
// low-precision matrix unit, as here. One TF32 product alone reads ~3e-4
// relative L2 against f64 on the card.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, 67 TFLOP/s f32 outside the
// tensor cores, 3.35 TB/s): three products make the tensor-core bound 3 x FLOPs
// / 495 TFLOP/s, 0.41x the f32 one (FLOPs / 67 TFLOP/s). At the CHN+DFPN step's
// shapes sep4d's four wide convs (4.63 TFLOP) have a 28.1 ms tensor-core bound
// (69.1 ms at 67 TFLOP/s). Every routed conv of K7 / K8 does at least ~450 TF32
// operations (3 x FLOPs) a byte of its input, hi and lo weights and output (the
// least: flow_64's 3x3 at 8x8), past the card's ~148, so all are bound by
// operations (chip_smoke.py:phase_tf32_convs computes each floor). The tail at
// 80 x 64^2 (its four launches, 619.3 GFLOP with the upsample-convs in the
// 4-phase form): upconv1 0.260 ms and upconv2 1.041 ms (phase mode,
// operations), hr_conv 2.342 ms (conv mode, operations), conv_last 0.419 ms
// (last mode, bytes: its 1.34 GB input; its products, 8 outputs a tap, 0.293
// ms); the whole tail 3.754 ms by operations, its input and output 0.044 ms
// (chip_smoke.py:phase_tail_stages_tf32 prints each). An RDB at 80 x 64^2
// (157.0 GFLOP): conv1..conv4 84.6 GFLOP, 0.513 ms, conv5 72.5 GFLOP, 0.439
// ms, all bound by operations; an RRDB 2.855 ms (chip_smoke.py:
// phase_rdb_convs_tf32 prints each conv's floor).
//
// Design: conv_frame_wgmma.cuh's swapped implicit GEMM, D = W^T X: M = output
// channels (one m64 tile a consumer warpgroup), N = the box's wrapped pixel
// columns, K = taps x Cin. tf32 wgmma reads both operands K-major from
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
// Phase mode is conv mode over a 3x3 halo box at the low resolution with
// the 4 phases x Cout as its outputs (ops/fragments.py:
// wgmma_tf32_phase_matrix: M = 4 x 64, phase-major), 4 taps: the warpgroup
// that holds phase (a, b) shifts its B descriptor by (a + ti) bw + b + tj
// pixels for tap (ti, tj), and its epilogue stores low-resolution pixel (y,
// x) at (2y + a, 2x + b) of the 2h x 2w output, which needs the tile's (y,
// x) and not the linear q sp address of conv mode.
//
// Last mode is the unswapped product D = X W: M = 64 wrapped pixel rows of
// the same boxes (a warpgroup takes every other m64 block of the tile's
// 2 LAST_MB = 4), N = 24: a row of taps' 3 taps dx x 8 outputs (3 stored),
// K = 32-channel chunks, one wgmma group a (chunk, row of taps dy). Column
// 8 dx + o of row m then sums tap (dy, dx) over pixel m + dy bw, and the
// epilogue adds rows n, n + 1, n + 2's dx columns for output column n
// through shared memory (so a tile's columns end 2 short of its 256). Both
// operands are K-major as tf32 wgmma wants them: the box has a pixel's 32
// channels in one 128-byte row, so a row of taps moves the A descriptor by
// whole pixels; the weights (fragments.wgmma_tf32_last_matrix) have each
// (dx, output)'s channels contiguous, one 3 KB block a (chunk, dy), 18 KB hi
// + 18 KB lo at Cin 64, loaded once a CTA. An n8 product a tap, tried
// first, was bound by issuing its three times as many small wgmmas; padding
// Cout to an m64 of the swapped form instead would cost 21x its products (a
// 2.3 ms floor at K4's shape against this form's 0.42 ms).
//
// Gc mode is last mode with 32 outputs: N = 96, a row of taps' 3 taps dx x
// 32 outputs (fragments.wgmma_tf32_gc_matrix: one 12 KB block a (chunk, dy),
// hi and lo), the same tiles, m64 blocks and one wgmma group a (chunk, dy)
// into a fresh partial sum. Its weights do not fit once a CTA (cin 160: 5
// chunks x 3 rows x 24 KB), so the (chunk, dy) blocks stream through the
// weight ring, two stages of hi + lo; the rest of the 64 KB region is the
// epilogue's exchange. The epilogue adds rows n + 1's dx 1 and n + 2's dx 2
// columns to row n's dx 0 in four passes of 8 outputs (each thread writes
// its rows' dx 1 and dx 2 columns of the pass to the exchange, 16 KB, then
// reads the next rows' for its own): ((dx 0 + dx 1) + dx 2) + b, as last
// mode adds them. Each pixel's 8 outputs of a pass are one 32-byte sector
// of its store, at channel offset cin of the dense-concat buffer. Padding
// gc = 32 to an m64 of the swapped form instead would double conv1..conv4's
// products (54% of an RDB's).
//
// The input's pixel stride is a launch argument (xc floats, a multiple of 4;
// its frame stride xn): an RDB's convs read the first cin channels of the
// NHWC dense-concat buffer of nf + 4 gc = 192 channels (a pixel 768 bytes
// apart) in place, and conv1..conv4 store their 32 outputs into it.
//
// Row windows (K5's bands, as conv_f32.cu's): the input buffer holds the
// frame's rows from x_row0 (its TMA map has the frame's rows that it holds,
// so the zero fill is the frame's border and never a band's edge), the
// launch computes the rows [cy0, cy1) of its resolution and stores the
// output rows [r0, r1) at buffer row r - out_row0 (phase mode: cy0 = r0 / 2,
// cy1 = (r1 + 1) / 2, each phase's row masked to the window). An output
// sums the same products in the same order whatever the tile, the window or
// the halves, so a banded tail equals the full-frame one bit for bit, and a
// banded RDB (K2's 15 launches a band) the full-frame one (K1's).
//
// The split. The weights are split once when packed (ops/fragments.py:
// wgmma_tf32_matrix: the hi and the lo matrix, each (Cin / 32, taps, Cout
// padded to 128 (last mode: rows of taps, 24 rows; gc mode 96), 32), each output's 16-byte
// chunks in the 128-byte swizzle), so a (tap, chunk) stage is two bulk copies.
// The activations are split in shared memory: three producer warps that issue
// no load wait for each box, round it in place to its hi half and write its lo
// half right behind it (the box's bytes further on, swizzled by their own
// address bits), fence the async proxy and arrive on the box's split barrier,
// on which the consumers wait. So the split overlaps the consumers' products on
// the previous chunk and costs no device memory. The hi half is rounded in
// shared memory rather than left for the tensor core to truncate: the kernel's
// arithmetic is then the same whatever the tensor core does with the low 13
// bits, and the CPU tests emulate the split bit for bit.
//
// Roles, from conv_frame_wgmma.cuh: lane 0 of the producer warpgroup issues
// every load (setmaxnreg hands the warpgroup's registers to the consumers),
// keeping the box ring (2 stages of hi + lo) and the weight ring ((tap,
// chunk) blocks, hi + lo: 2 stages of 128 outputs or 4 of 64; in last mode
// the whole weights once; in gc mode 2 stages of a (chunk, dy) block) full;
// the next box is issued early in the current
// chunk's taps. Two consumer warpgroups, each one m64 x n144 product: on one
// half (NH = 1) warpgroup w owns outputs [64 w, 64 w + 64) of the CTA's 128,
// on two halves (NH = 2) half w of its 64. Each (chunk, tap) is one wgmma
// group of 4 k8 steps x 3 products, the two correction products first. A
// CTA walks its work units (tile, 128 / NH outputs; a tile in last mode),
// outputs fastest.
//
// The sums. The tensor cores add each product group into the accumulator with
// the sum truncated (round toward zero), so the error grows with the number of
// groups added into one accumulator: a model of those adds
// (tests/test_torch_tf32x3.py:_truncated_sums) reads 5.9e-5 relative L2 against
// f64 for one accumulator over 25 x 256 inputs, past chip_smoke.py's f32 limit
// of 1e-5, and a version of this kernel with one accumulator a unit failed that
// limit on the card at the 256-channel and 5x5 shapes. So the groups of each
// row of taps (k taps; 2 in phase mode; one group in last mode) go into a
// partial accumulator started afresh (scale-d 0), which is then added to the
// unit's sum in f32 with round to nearest (the model: 1.5e-6; 1.1e-6 at the
// phase mode's 4 x 64 inputs): 72 more registers a thread, which is why a
// warpgroup holds one m64 x n144 product and not two, and a wait for the row's
// last group before the add.
//
// The epilogue adds the bias, applies the activation (branch-free) and
// stores f32 straight from the accumulators (8 consecutive outputs of 4
// pixels a warp store: whole 32-byte sectors), masked at the frame's edges
// and the window, to frame f's row y, column x, channel o at (f / tg) sg +
// (f % tg) st + (y - out_row0) sr + x sp + o: NHWC, or sep4d's p <-> q swap
// (stage 1's last conv), so the swap costs no permute. It is the kernel's
// cost a unit that no product hides (both warpgroups work on one unit), so
// each column's pixel comes from multiply-high divisions by host-computed
// magic numbers, each column on its own, and its address is a 32-bit
// offset from a base computed once a unit: a division per column, or
// columns stepped from one another into one dependency chain, cost more
// than a phase-mode unit's products. Last mode's 3 outputs of a pixel are
// stored by one thread, consecutive pixels by consecutive threads.
//
// Shared memory: a stage of the box ring is its hi and lo copies, 2 x fr x bh x
// bw x 128 bytes rounded up to 1024; the weight region 64 KB in every mode (the
// ring; last mode's 36 KB of weights and its 2 x 9.3 KB exchange; gc mode's
// 2 x 24 KB ring and its 16 KB exchange). A box has at
// most 324 pixels (K7's 18 x 18, and K8's 3x3 tiles of 16 x 16; its 5x5 tiles
// of 4 rows x 32 on one n144 half, a 36 x 8 box): 231 552 bytes at K7's tile,
// of the 232 448. The tail's stages take the same budget: phase mode at 64^2
// and 128^2 tiles of 16 x 16 on two halves (an 18 x 18 box, 231 552 bytes),
// hr_conv 16 x 16 tiles on two halves (64 outputs a CTA), last mode tiles of 7
// rows x 32 (a 34 x 9 box, 4 m64 blocks: 222 336 bytes), and so do gc mode's;
// an RDB's conv5 tiles of 7 rows x 32 on two halves (ops/conv_stack.py:
// tf32_smem, last_tile_tf32). Columns past the box read the next bytes of
// shared memory (the lo copy, the next stage, the weights) and are dropped: a
// column's sums depend on its own pixels only. The launcher refuses a tile
// whose reads would pass the end.
//
// Planted faults for the checks on the card, -DTF32_PLANT=n: 1 drops the two
// correction products (plain 1xTF32); 2 leaves out the corner tap (-r, -r),
// in phase mode tap (0, 0) of each phase, in last and gc modes by zeroing its
// weights in shared memory; 3 reads the top halo row of every
// tile below a frame's first row tile as zeros (that row is the tile above's,
// across the tile boundary); 4 reads a window's first input row (frame row
// x_row0) as zeros where x_row0 > 0: a band's halo row, which only K2's and
// K5's bands read (as tail.cu's BAND_PLANT in bf16); 5, in gc mode, loads
// the last 32-channel chunk of the input from one chunk early (a dense-concat
// conv reading x_{k-2}'s channels where x_{k-1}'s belong; conv1 its first
// chunk twice); 8 sets the backward's mask slope (the mask epilogue's and
// conv_bwd_tf32_wgmma.cuh's) to 0.25. (6, 7 and 9 are the backward's:
// conv_bwd_tf32_wgmma.cuh.)
//
// The backward's epilogues (K3 and K6 in f32, conv_bwd_tf32_wgmma.cuh drives
// them), each its own kernel instance (EK) so that the forward's carry none:
// - mask (conv mode at 64 outputs, gc mode): v = acc (no bias) where the
//   kept activation m >= 0, else 0.2 acc, m read at the output pixel through
//   r's strides; K3's pulls 4..1 (gc mode, reading a channel suffix of the
//   cotangent buffer D in place) and K6's hr_conv / upconv2 adjoints;
// - dx (conv mode at 64 outputs): v = rs r + acc (one fma), then + r2 where
//   given; K3's pull 0. Where out2 is given it also stores 0.2 v there (the
//   next RDB's dP_5), through its own pixel strides.
// Both write each unit's sums of what the bias grads sum (the masked
// values, or 0.2 v) to `part` (64 floats a row), where part is given: each
// warp's (gc mode: 32 outputs, row 8 u + warp) or each warpgroup's (conv
// mode: its half of the columns, row 2 u + warpgroup) after shuffles in a
// fixed order, without atomics. Gc mode reads the mask at the output's
// pixel offsets (its strides are the output's).
// s2d (conv mode): the input is the phase-major view of an NHWC 64-channel
// tensor at twice the resolution (the 4 phases (a, b) x 64 channels of each
// low-resolution pixel, 256 channels, chunk c at phase a = c / 4, channels
// 32 (c % 4) of the (b, o) pair): a 5-D TMA map reads it in place. K6's
// upsample-conv adjoints run so, over the 3x3 adjoint of the 4-phase kernel
// (2.25x the 16 phase-taps' products).
#pragma once

#include "conv3x3_wgmma.cuh"

#ifndef TF32_PLANT
#define TF32_PLANT 0
#endif

namespace ft {
namespace {

constexpr int HALF = 144;                // pixel columns a wgmma
constexpr int CHUNK = 32;                // f32 input channels a K-chunk (one 128-byte pixel row)
constexpr int COUT_PAD = 128;            // the packed weights' output padding (conv, phase)
constexpr int SA = 2;                    // box stages
constexpr int W_RING = 2 * 128 * 128;    // weight-ring bytes of one of hi / lo: 2 stages of 128
                                         // outputs, or 4 of 64
constexpr int NCONS = 256, NTHREAD = NCONS + 128, CONS_WARPS = NCONS / 32;
constexpr int SPLIT_WARPS = 3;           // producer warps 1-3 split the boxes
constexpr int PROD_REGS = 40, CONS_REGS = 232;
static_assert(PROD_REGS * 128 + CONS_REGS * NCONS <= 65536, "register file");
constexpr int SMEM_MAX = 232448;
constexpr int BARS = 128;  // (afull, asplit, aempty) x SA + (wfull, wempty) x (2 or 4)
constexpr int CONV = 0, PHASE = 1, LAST = 2, GC = 3;                    // modes
constexpr int EPI_NONE = 0, EPI_RELU = 1, EPI_LEAKY = 2, EPI_RESID = 3;  // epilogues
constexpr int EPI_MASK = 4, EPI_DX = 5;                                  // the backward's
constexpr int EK_ACT = 0, EK_RESID = 1, EK_MASK = 2, EK_DX = 3;          // epilogue instances
constexpr float RES_SCALE = 0.2f;  // the residual epilogue's scale, the RDB's
constexpr float MASK_SLOPE = TF32_PLANT == 8 ? 0.25f : 0.2f;  // the leaky masks' slope
constexpr int PART_ROW = 64;       // floats a row of the bias partial sums
// Last mode: a row of taps' 3 taps x outputs padded to 8 (an n24 product;
// one (chunk, row) block of LAST_W floats, hi or lo), 2 m64 pixel blocks a
// warpgroup (256 wrapped columns a tile, the last 2 read by their left
// neighbours), the epilogue's exchange rows.
constexpr int LAST_N = 8, LAST_W = 3 * LAST_N * CHUNK, LAST_MB = 2, EX_ROWS = 2 * LAST_MB * 64 + 8;
// Gc mode: 32 outputs (an n96 product a row of taps), last mode's m64
// blocks, the epilogue's exchange of 2 x (its 256 pixel rows x 8 outputs).
constexpr int GC_N = 32, GC_ROWS = 2 * LAST_MB * 64;

struct Args {
  const float* wt;    // packed hi matrix, the lo matrix lo_off floats further
  const float* bias;  // cout (phase mode: cout / 4)
  float* out;
  long long lo_off;
  long long tg, sg, st, sr, sp;  // output addressing (see the note)
  int n, h, w, cin, cout, cout_pad, epi;
  int fr, rows, tw;              // a tile: fr frames x rows x tw pixels of the input's resolution
  int x_row0;                    // frame row of the input buffer's row 0
  int cy0, cy1;                  // rows computed (the input's resolution)
  int r0, r1, out_row0;          // output rows stored, and the output buffer's row 0
  int tiles_x, tiles_y, groups;  // column tiles, row tiles, frame groups
  int a_tx, a_stage;             // one box copy's bytes, and a stage's (hi + lo, 1024-aligned)
  unsigned mbw, mbh, mtg;        // the epilogue's divisors bw, bh and tg as magic numbers (div_by)
  // The residual epilogue: r, r2 (r2 null for none) read at frame f, row y,
  // column x, channel o at f r_sn + y r_sy + x r_sx + o.
  const float* r;
  const float* r2;
  long long r_sn, r_sy, r_sx, r2_sn, r2_sy, r2_sx;
  // The backward's epilogues (mask: r is the mask; dx: rs r + acc (+ r2),
  // 0.2 of it to out2 at frame f, row y, column x, channel o at f o2_sn + y
  // o2_sy + x o2_sx + o where out2 is given), their bias partial sums (rows
  // of part by unit, null for none), and s2d, the phase-major input.
  float* out2;
  long long o2_sn, o2_sy, o2_sx;
  float* part;
  float rs;
  int s2d;
};

// ceil(2^32 / d): with it n / d is umulhi(n, m) for every n, d < 2^16
// (d > 1), one instruction where the epilogue divides a column index.
inline unsigned magic(int d) {
  return d > 1 ? (unsigned)((((unsigned long long)1 << 32) + d - 1) / d) : 0u;
}

// The kernel's shared memory for a box copy of a_tx bytes: the rings, the
// barriers, and slack where the last columns read (cols: NH x 144, or last
// mode's blocks x 64, plus the largest tap shift) would pass them.
inline int smem_bytes(int a_tx, int cols, int k, int bw) {
  const int a_stage = (2 * a_tx + 1023) / 1024 * 1024;
  const int rings = SA * a_stage + 2 * W_RING;
  const int reach = (SA - 1) * a_stage + a_tx + (cols + (k - 1) * (bw + 1)) * 128;
  return (reach > rings ? reach : rings) + BARS;
}

struct Tile {
  int f0, y0, x0;
};
__device__ __forceinline__ Tile tile_of(const Args& a, int s) {
  const int tx = s % a.tiles_x, rest = s / a.tiles_x;
  return {rest / a.tiles_y * a.fr, a.cy0 + rest % a.tiles_y * a.rows, tx * a.tw};
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

// D (64 x 24 f32, 12 registers a thread) = A (64 x 8) B (8 x 24) + (acc ?
// D : 0), tf32, both K-major from shared memory: for each n8 block j, d[4 j
// + 2 i + e] = D[16 w + l / 4 + 8 i][8 j + 2 (l % 4) + e].
__device__ __forceinline__ void mma24(float (&d)[12], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 96 f32, 48 registers a thread) = A (64 x 8) B (8 x 96) + (acc ?
// D : 0), tf32, both K-major from shared memory: for each n8 block j, d[4 j
// + 2 i + e] = D[16 w + l / 4 + 8 i][8 j + 2 (l % 4) + e].
__device__ __forceinline__ void mma96(float (&d)[48], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
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

// n / d for n, d < 2^16, m = magic(d).
__device__ __forceinline__ int div_by(int n, int d, unsigned m) {
  return d == 1 ? n : (int)__umulhi((unsigned)n, m);
}

// Frame f's offset in the output: (f / tg) sg + (f % tg) st.
__device__ __forceinline__ long long frame_base(const Args& a, int f) {
  const int tg = (int)a.tg, fg = div_by(f, tg, a.mtg);
  return (long long)fg * a.sg + (long long)(f - fg * tg) * a.st;
}

// The epilogue's activation without a branch: max(max(v, slope v), floor)
// with (slope, floor) (1, -inf) for none, (1, 0) for ReLU, (0.2, -inf) for
// leaky ReLU (max(v, 0.2 v) is v >= 0 ? v : 0.2 v).
struct Act {
  float slope, floor;
};
__device__ __forceinline__ Act act_of(int epi) {
  return {epi == EPI_LEAKY ? 0.2f : 1.0f, epi == EPI_RELU ? 0.0f : -INFINITY};
}
__device__ __forceinline__ float activate(float v, Act f) {
  return fmaxf(fmaxf(v, f.slope * v), f.floor);
}

// A 5-D box (the s2d input's) into shared memory.
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            int c3, int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// EK: the epilogue's instance (EK_ACT: bias and activation; EK_RESID: conv
// mode's residual; EK_MASK, EK_DX: the backward's), so that each conv's
// epilogue carries no other's.
template <int K, int NH, int MODE, int EK = EK_ACT>
__global__ void __launch_bounds__(NTHREAD, 1)
tf32_kernel(__grid_constant__ const CUtensorMap xmap, const Args a) {
  constexpr bool RES = EK == EK_RESID;
  constexpr int R = K / 2;
  constexpr bool ROWS_N = MODE == LAST || MODE == GC;  // the unswapped product: taps by rows
  constexpr int KK = MODE == PHASE ? 4 : ROWS_N ? K : K * K;  // taps (last and gc modes: rows of taps)
  constexpr int TPR = MODE == PHASE ? 2 : K;      // taps a row: one partial sum
  // Outputs a work unit (gc mode: a (chunk, dy) block's 3 dx x 32 rows).
  constexpr int COUT_T = MODE == LAST ? LAST_N : MODE == GC ? 3 * GC_N : 128 / NH;
  // Weight stages: 2 of 128, 4 of 64, 2 of gc mode's 96 (in 48 KB of the 64).
  constexpr int SW = MODE == LAST ? 1 : W_RING / (COUT_T * 128);
  constexpr uint32_t W_BYTES = COUT_T * 128;      // one (tap, chunk) block, hi or lo
  constexpr int JB = SW + 1 < KK - 1 ? SW + 1 : KK - 1;  // the tap before which the next box goes
  static_assert(NH == 1 || NH == 2, "one or two n144 halves");
  static_assert(MODE == CONV || K == 3, "phase, last and gc modes are 3x3");
  static_assert(MODE == CONV || !RES, "the residual epilogue is conv mode's");
  static_assert(EK != EK_DX || (MODE == CONV && NH == 2), "the dx epilogue is conv mode's at 64 outputs");
  static_assert(EK != EK_MASK || MODE == GC || (MODE == CONV && NH == 2), "the mask epilogue: gc or conv at 64");
  static_assert(MODE != GC || (SW == 2 && 2 * SW * W_BYTES + 2 * GC_ROWS * 8 * 4 == 2 * W_RING),
                "gc mode's ring and exchange fill the weight region");
  extern __shared__ __align__(1024) unsigned char ft_smem[];
  unsigned char* smem = ft_smem;
  const int w_off = SA * a.a_stage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + w_off + 2 * W_RING);
  const uint32_t afull0 = cw::smem_u32(bars), asplit0 = afull0 + 8 * SA, aempty0 = asplit0 + 8 * SA;
  const uint32_t wfull0 = aempty0 + 8 * SA, wempty0 = wfull0 + 8 * SW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bw = a.tw + K - 1, bh = a.rows + K - 1;
  const int nct = ROWS_N ? 1 : a.cout / COUT_T, nch = a.cin / CHUNK;
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
        const int ch = TF32_PLANT == 5 && MODE == GC && bc == nch - 1 && bc > 0 ? bc - 1 : bc;
        if (qa >= SA) cw::mbar_wait(aempty0 + 8 * sa, (qa / SA - 1) & 1);
        cw::mbar_expect_tx(afull0 + 8 * sa, (uint32_t)a.a_tx);
        if (MODE == CONV && a.s2d)  // chunk ch: phase row ch / 4, channels 32 (ch % 4) of (b, o)
          tma_load_5d(cw::smem_u32(smem + sa * a.a_stage), &xmap, CHUNK * (ch & 3), t.x0 - R, ch >> 2,
                      t.y0 - R, t.f0, afull0 + 8 * sa);
        else
          cw::tma_load_4d(cw::smem_u32(smem + sa * a.a_stage), &xmap, CHUNK * ch, t.x0 - R,
                          t.y0 - R - a.x_row0, t.f0, afull0 + 8 * sa);
        ++qa;
        if (++bc == nch) {
          bc = 0;
          bu += gridDim.x;
        }
      };
      if (MODE == LAST) {  // the whole weights once, then the boxes as the ring frees
        const uint32_t wb = (uint32_t)a.lo_off * 4;
        cw::mbar_expect_tx(wfull0, 2 * wb);
        cw::bulk_load(cw::smem_u32(smem + w_off), a.wt, wb, wfull0);
        cw::bulk_load(cw::smem_u32(smem + w_off) + wb, a.wt + a.lo_off, wb, wfull0);
        while (bu < units) next_box();
        return;
      }
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
          if (TF32_PLANT == 4 && a.x_row0 > 0 && t.y0 - R + (p / bw) % bh == a.x_row0)
            hi = lo = make_float4(0.f, 0.f, 0.f, 0.f);
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
  // A stage is released by one lane a consumer warp, after its wgmmas that
  // read it retired.
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) cw::mbar_arrive(bar);
  };

  if constexpr (MODE == LAST) {
    // Warpgroup wgi: m64 pixel blocks wgi, wgi + 2 of the tile's 2 LAST_MB
    // (columns past the tile's are computed and dropped). A (chunk, row of
    // taps dy) is one wgmma group of m64 n24 products: column 8 dx + o of
    // pixel row m sums tap (dy, dx) for output o over its row m + dy bw.
    cw::mbar_wait(wfull0, 0);
    const uint32_t wbase = cw::smem_u32(smem + w_off), wlo = (uint32_t)a.lo_off * 4;
    if (TF32_PLANT == 2) {  // the corner tap's weights (dy, dx) = (0, 0) zeroed in shared memory
      for (int i = threadIdx.x; i < 2 * nch * LAST_N * 32; i += NCONS) {
        const int half = i / (nch * LAST_N * 32), c = i / (LAST_N * 32) % nch;
        float* w = reinterpret_cast<float*>(smem + w_off) + half * a.lo_off + c * KK * LAST_W;
        w[i % (LAST_N * 32)] = 0.0f;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cw::named_sync(1, NCONS);
    }
    const uint64_t dwh = desc(wbase), dwl = desc(wbase + wlo);
    float* const ex = reinterpret_cast<float*>(smem + w_off + 2 * wlo);  // 2 x EX_ROWS x 9 floats
    float bl[3];  // the biases
#pragma unroll
    for (int o = 0; o < 3; ++o) bl[o] = o < a.cout ? a.bias[o] : 0.0f;
    const Act act = act_of(a.epi);
    int qa = 0, par = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Tile t = tile_of(a, u);
      float acc[LAST_MB][12], part[LAST_MB][12];
#pragma unroll
      for (int j = 0; j < LAST_MB; ++j)
#pragma unroll
        for (int i = 0; i < 12; ++i) acc[j][i] = part[j][i] = 0.0f;
      int prev_a = -1;
      for (int c = 0; c < nch; ++c, ++qa) {
        const int sa = qa % SA;
        cw::mbar_wait(asplit0 + 8 * sa, (qa / SA) & 1);
        const uint64_t dah = desc(cw::smem_u32(smem + sa * a.a_stage)), dal = dah + (a.a_tx >> 4);
#pragma unroll 1
        for (int dy = 0; dy < KK; ++dy) {
#pragma unroll
          for (int j = 0; j < LAST_MB; ++j) cw::fence_acc(part[j]);
          cw::wgmma_fence();
          // Descriptor units (16 bytes): a (chunk, dy) weight block, dy rows of pixels.
          const uint32_t wrow = (c * KK + dy) * (LAST_W * 4 / 16), arow = dy * bw * 8;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t b_hi = dwh + wrow + 2 * kk, b_lo = dwl + wrow + 2 * kk;
#pragma unroll
            for (int j = 0; j < LAST_MB; ++j) {
              const uint32_t col = (wgi + 2 * j) * 64 * 8 + arow + 2 * kk;
              if (TF32_PLANT != 1) {
                mma24(part[j], dal + col, b_hi, kk > 0);
                mma24(part[j], dah + col, b_lo, 1);
              }
              mma24(part[j], dah + col, b_hi, TF32_PLANT != 1 || kk > 0);
            }
          }
          cw::wgmma_commit();
          cw::wgmma_wait<0>();  // each row of taps a partial sum, added in f32
#pragma unroll
          for (int j = 0; j < LAST_MB; ++j) {
            cw::fence_acc(part[j]);
#pragma unroll
            for (int i = 0; i < 12; ++i) acc[j][i] += part[j][i];
          }
          if (prev_a >= 0) {
            release(aempty0 + 8 * prev_a);
            prev_a = -1;
          }
        }
        prev_a = sa;
      }
      release(aempty0 + 8 * prev_a);

      // Epilogue: the sums of the three dx columns of each pixel row to
      // shared memory (row m, dx, o at 9 m + 3 dx + o), then consumer
      // thread n adds pixel column n's taps: rows n, n + 1, n + 2 (two
      // exchange buffers, so one barrier a unit suffices).
      float* const e = ex + par * (EX_ROWS * 9);
      par ^= 1;
#pragma unroll
      for (int j = 0; j < LAST_MB; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = (wgi + 2 * j) * 64 + 16 * wl + g + 8 * i;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              if (2 * q4 + q < 3) e[9 * m + 3 * dx + 2 * q4 + q] = acc[j][4 * dx + 2 * i + q];
        }
      cw::named_sync(1, NCONS);
      const int n = threadIdx.x, y = div_by(n, bw, a.mbw), x = n - y * bw;
      if (x < min(a.tw, a.w - t.x0) && y < min(a.rows, a.cy1 - t.y0) && t.f0 < a.n) {
        float* o = a.out + frame_base(a, t.f0) + (long long)(t.y0 + y - a.out_row0) * a.sr +
                   (long long)(t.x0 + x) * a.sp;
#pragma unroll
        for (int oc = 0; oc < 3; ++oc)
          if (oc < a.cout)
            o[oc] = activate(e[9 * n + oc] + e[9 * n + 12 + oc] + e[9 * n + 24 + oc] + bl[oc], act);
      }
    }
    return;
  } else if constexpr (MODE == GC) {
    // Warpgroup wgi: m64 pixel blocks wgi, wgi + 2 of the tile's 2 LAST_MB,
    // as in last mode. A (chunk, row of taps dy) is one wgmma group of m64
    // n96 products into a fresh partial sum: column 32 dx + o of pixel row m
    // sums tap (dy, dx) for output o over its row m + dy bw. The weight block
    // of each (chunk, dy) arrives through the ring.
    float* const ex = reinterpret_cast<float*>(smem + w_off + SW * 2 * W_BYTES);  // [dx - 1][row][8]
    const Act act = act_of(a.epi);
    int qa = 0, qw = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Tile t = tile_of(a, u);
      float acc[LAST_MB][48], part[LAST_MB][48];
#pragma unroll
      for (int j = 0; j < LAST_MB; ++j)
#pragma unroll
        for (int i = 0; i < 48; ++i) acc[j][i] = part[j][i] = 0.0f;
      for (int c = 0; c < nch; ++c, ++qa) {
        const int sa = qa % SA;
        cw::mbar_wait(asplit0 + 8 * sa, (qa / SA) & 1);
        const uint64_t dah = desc(cw::smem_u32(smem + sa * a.a_stage)), dal = dah + (a.a_tx >> 4);
#pragma unroll 1
        for (int dy = 0; dy < KK; ++dy, ++qw) {
          const int sw = qw % SW;
          cw::mbar_wait(wfull0 + 8 * sw, (qw / SW) & 1);
          const uint32_t wh = cw::smem_u32(smem + w_off + sw * 2 * W_BYTES);
          if (TF32_PLANT == 2 && dy == 0) {  // the corner tap's rows (dx 0) zeroed in shared memory
            for (int i = threadIdx.x; i < 2 * GC_N * 32; i += NCONS) {
              float* w = reinterpret_cast<float*>(smem + w_off + sw * 2 * W_BYTES);
              w[i / (GC_N * 32) * (W_BYTES / 4) + i % (GC_N * 32)] = 0.0f;
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            cw::named_sync(1, NCONS);
          }
          const uint64_t dwh = desc(wh), dwl = desc(wh + W_BYTES);
#pragma unroll
          for (int j = 0; j < LAST_MB; ++j) cw::fence_acc(part[j]);
          cw::wgmma_fence();
          const uint32_t arow = dy * bw * 8;  // descriptor units (16 bytes): dy rows of pixels
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t b_hi = dwh + 2 * kk, b_lo = dwl + 2 * kk;
#pragma unroll
            for (int j = 0; j < LAST_MB; ++j) {
              const uint32_t col = (wgi + 2 * j) * 64 * 8 + arow + 2 * kk;
              if (TF32_PLANT != 1) {
                mma96(part[j], dal + col, b_hi, kk > 0);
                mma96(part[j], dah + col, b_lo, 1);
              }
              mma96(part[j], dah + col, b_hi, TF32_PLANT != 1 || kk > 0);
            }
          }
          cw::wgmma_commit();
          cw::wgmma_wait<0>();  // each (chunk, dy) a partial sum, added in f32
#pragma unroll
          for (int j = 0; j < LAST_MB; ++j) {
            cw::fence_acc(part[j]);
#pragma unroll
            for (int i = 0; i < 48; ++i) acc[j][i] += part[j][i];
          }
          release(wempty0 + 8 * sw);
        }
        release(aempty0 + 8 * sa);
      }

      // Epilogue: output column n's output o is row n's dx 0 column plus row
      // n + 1's dx 1 and row n + 2's dx 2 (rows past the tile's 256 are
      // dropped columns; they read row 255). Per pass p (outputs 8 p ..
      // 8 p + 7) each thread writes its rows' dx 1 and dx 2 columns to the
      // exchange, then adds the next rows' to its own dx 0 and stores.
      const int xlim = min(a.tw, a.w - t.x0), ylim = min(a.rows, a.cy1 - t.y0);
      float* const o0 = a.out + frame_base(a, t.f0) + (long long)(t.y0 - a.out_row0) * a.sr +
                        (long long)t.x0 * a.sp + 2 * q4;
      int off[LAST_MB][2];  // each of the thread's rows: its pixel's offset, or -1 (not stored)
#pragma unroll
      for (int j = 0; j < LAST_MB; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = (wgi + 2 * j) * 64 + 16 * wl + g + 8 * i, y = div_by(m, bw, a.mbw), x = m - y * bw;
          off[j][i] = x < xlim && y < ylim && t.f0 < a.n ? y * (int)a.sr + x * (int)a.sp : -1;
        }
      // The mask epilogue's mask at the tile's first pixel (read at off).
      const float* const m0 = EK == EK_MASK ? a.r + t.f0 * a.r_sn + (long long)t.y0 * a.r_sy +
                                                  (long long)t.x0 * a.r_sx + 2 * q4
                                            : nullptr;
#pragma unroll
      for (int pass = 0; pass < 4; ++pass) {
#pragma unroll
        for (int j = 0; j < LAST_MB; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int m = (wgi + 2 * j) * 64 + 16 * wl + g + 8 * i;
            const int c1 = 4 * (4 + pass) + 2 * i, c2 = 4 * (8 + pass) + 2 * i;  // dx 1's, dx 2's registers
            *reinterpret_cast<float2*>(ex + 8 * m + 2 * q4) = make_float2(acc[j][c1], acc[j][c1 + 1]);
            *reinterpret_cast<float2*>(ex + 8 * (GC_ROWS + m) + 2 * q4) = make_float2(acc[j][c2], acc[j][c2 + 1]);
          }
        cw::named_sync(1, NCONS);
        const float b0 = EK == EK_MASK ? 0.0f : a.bias[8 * pass + 2 * q4];
        const float b1 = EK == EK_MASK ? 0.0f : a.bias[8 * pass + 2 * q4 + 1];
        float p0 = 0.0f, p1 = 0.0f;  // the mask epilogue's sums of this pass's outputs
#pragma unroll
        for (int j = 0; j < LAST_MB; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int m = (wgi + 2 * j) * 64 + 16 * wl + g + 8 * i;
            const float2 d1 = *reinterpret_cast<const float2*>(ex + 8 * min(m + 1, GC_ROWS - 1) + 2 * q4);
            const float2 d2 = *reinterpret_cast<const float2*>(ex + 8 * (GC_ROWS + min(m + 2, GC_ROWS - 1)) + 2 * q4);
            const int c0 = 4 * pass + 2 * i;  // dx 0's registers
            if (off[j][i] < 0) continue;
            if constexpr (EK == EK_MASK) {  // no bias: the sums masked by the kept activation's sign
              const float2 mk = *reinterpret_cast<const float2*>(m0 + off[j][i] + 8 * pass);
              float v0 = acc[j][c0] + d1.x + d2.x, v1 = acc[j][c0 + 1] + d1.y + d2.y;
              v0 = mk.x >= 0.0f ? v0 : MASK_SLOPE * v0;
              v1 = mk.y >= 0.0f ? v1 : MASK_SLOPE * v1;
              p0 += v0;
              p1 += v1;
              *reinterpret_cast<float2*>(o0 + off[j][i] + 8 * pass) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<float2*>(o0 + off[j][i] + 8 * pass) =
                  make_float2(activate(acc[j][c0] + d1.x + d2.x + b0, act),
                              activate(acc[j][c0 + 1] + d1.y + d2.y + b1, act));
            }
          }
        if (EK == EK_MASK && a.part != nullptr) {  // the warp's sums, row 8 u + warp
#pragma unroll
          for (int sh = 4; sh < 32; sh *= 2) {
            p0 += __shfl_xor_sync(0xffffffffu, p0, sh);
            p1 += __shfl_xor_sync(0xffffffffu, p1, sh);
          }
          if (lane < 4)
            *reinterpret_cast<float2*>(a.part + ((size_t)u * CONS_WARPS + warp) * PART_ROW + 8 * pass + 2 * lane) =
                make_float2(p0, p1);
        }
        cw::named_sync(1, NCONS);
      }
    }
    return;
  } else {
    const int mt = NH == 1 ? wgi : 0, h = NH == 2 ? wgi : 0;  // warpgroup wgi's outputs and half
    constexpr bool BWD = EK == EK_MASK || EK == EK_DX;
    int qa = 0, qw = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Tile t = tile_of(a, u / nct);
      const int n0 = (u % nct) * COUT_T;
      const int ph = (n0 + mt * 64) >> 6, pa = ph >> 1 & 1, pb = ph & 1;  // phase mode: (a, b)
      // This thread's outputs oc and oc + 8 (phase mode: channels of phase
      // ph); their biases are loaded now, their latency under the products.
      const int oc = (MODE == PHASE ? 0 : n0 + mt * 64) + 16 * wl + g;
      const float b0 = !BWD && a.bias != nullptr ? a.bias[oc] : 0.0f;
      const float b1 = !BWD && a.bias != nullptr ? a.bias[oc + 8] : 0.0f;
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
            const int dy = MODE == PHASE ? pa + tap / 2 : tap / K;
            const int dx = MODE == PHASE ? pb + tap % 2 : tap % K;
            const uint32_t col = (HALF * h + dy * bw + dx) * 128;
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
          if (tap % TPR == TPR - 1) {  // the row's last tap: part into acc
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

      // Epilogue: outputs oc and oc + 8 of column n = 144 h + 8 j + 2 q4 + e,
      // its tile pixel (fl, y, x) by multiply-high divisions, each column on
      // its own; the tile's bounds and its base address once a unit, a
      // column's offset from the base in 32 bits (phase mode: pixel (y, x)
      // at (2y + a, 2x + b), its rows within [r0, r1)).
      const int xlim = min(a.tw, a.w - t.x0), flim = min(a.fr, a.n - t.f0);
      int ylo = 0, ylim = min(a.rows, a.cy1 - t.y0);
      if (MODE == PHASE) {
        ylo = max(0, (a.r0 - pa + 1) / 2 - t.y0);
        ylim = min(ylim, (a.r1 - pa + 1) / 2 - t.y0);
      }
      const int sy = (MODE == PHASE ? 2 : 1) * (int)a.sr, sx = (MODE == PHASE ? 2 : 1) * (int)a.sp;
      const long long fb0 = frame_base(a, t.f0);
      float* const o0 = a.out + fb0 +
                        (long long)((MODE == PHASE ? 2 * t.y0 + pa : t.y0) - a.out_row0) * a.sr +
                        (long long)(MODE == PHASE ? 2 * t.x0 + pb : t.x0) * a.sp + oc;
      const Act act = act_of(a.epi);
      float bs0 = 0.0f, bs1 = 0.0f;  // the backward's bias sums of outputs oc, oc + 8
      // The residual epilogue's r and r2 (the mask epilogue's mask, the dx
      // epilogue's r, r2 and out2) at the tile's first pixel, output oc.
      const float* const rp0 =
          EK != EK_ACT ? a.r + t.f0 * a.r_sn + (long long)t.y0 * a.r_sy + (long long)t.x0 * a.r_sx + oc
                       : nullptr;
      const float* const r2p0 =
          (RES || EK == EK_DX) && a.r2 != nullptr
              ? a.r2 + t.f0 * a.r2_sn + (long long)t.y0 * a.r2_sy + (long long)t.x0 * a.r2_sx + oc
              : nullptr;
      float* const o2p0 = EK == EK_DX && a.out2 != nullptr
                              ? a.out2 + t.f0 * a.o2_sn + (long long)t.y0 * a.o2_sy + (long long)t.x0 * a.o2_sx + oc
                              : nullptr;
#pragma unroll
      for (int j = 0; j < 18; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = HALF * h + 8 * j + 2 * q4 + e;
          const int q = div_by(n, bw, a.mbw), x = n - q * bw;
          int fl = 0, y = q;
          if (a.fr > 1) {
            fl = div_by(q, bh, a.mbh);
            y = q - fl * bh;
          }
          if (x >= xlim || y < ylo || y >= ylim || fl >= flim) continue;
          float* o = o0 + (y * sy + x * sx);
          if (a.fr > 1) o += frame_base(a, t.f0 + fl) - fb0;
          float v0 = acc[4 * j + e] + b0, v1 = acc[4 * j + 2 + e] + b1;
          if constexpr (EK == EK_MASK) {  // the sums masked by the kept activation's sign
            const float* rp = rp0 + (y * (int)a.r_sy + x * (int)a.r_sx) + fl * a.r_sn;
            v0 = rp[0] >= 0.0f ? v0 : MASK_SLOPE * v0;
            v1 = rp[8] >= 0.0f ? v1 : MASK_SLOPE * v1;
            bs0 += v0;
            bs1 += v1;
            o[0] = v0;
            o[8] = v1;
            continue;
          }
          if constexpr (EK == EK_DX) {  // rs r + acc (+ r2); 0.2 of it to out2
            const float* rp = rp0 + (y * (int)a.r_sy + x * (int)a.r_sx) + fl * a.r_sn;
            v0 = fmaf(a.rs, rp[0], v0);
            v1 = fmaf(a.rs, rp[8], v1);
            if (r2p0 != nullptr) {
              const float* r2p = r2p0 + (y * (int)a.r2_sy + x * (int)a.r2_sx) + fl * a.r2_sn;
              v0 += r2p[0];
              v1 += r2p[8];
            }
            o[0] = v0;
            o[8] = v1;
            if (o2p0 != nullptr) {
              float* o2 = o2p0 + (y * (int)a.o2_sy + x * (int)a.o2_sx) + fl * a.o2_sn;
              o2[0] = RES_SCALE * v0;
              o2[8] = RES_SCALE * v1;
              bs0 += RES_SCALE * v0;
              bs1 += RES_SCALE * v1;
            }
            continue;
          }
          if constexpr (RES) {  // 0.2 (0.2 v + r) + r2, conv_f32.cu's order
            const float* rp = rp0 + (y * (int)a.r_sy + x * (int)a.r_sx) + fl * a.r_sn;
            v0 = fmaf(RES_SCALE, v0, rp[0]);
            v1 = fmaf(RES_SCALE, v1, rp[8]);
            if (r2p0 != nullptr) {
              const float* r2p = r2p0 + (y * (int)a.r2_sy + x * (int)a.r2_sx) + fl * a.r2_sn;
              v0 = fmaf(RES_SCALE, v0, r2p[0]);
              v1 = fmaf(RES_SCALE, v1, r2p[8]);
            }
          }
          o[0] = activate(v0, act);
          o[8] = activate(v1, act);
        }
      if (BWD && a.part != nullptr) {  // the warpgroup's sums (its half), row 2 u + wgi
        bs0 += __shfl_xor_sync(0xffffffffu, bs0, 1);
        bs0 += __shfl_xor_sync(0xffffffffu, bs0, 2);
        bs1 += __shfl_xor_sync(0xffffffffu, bs1, 1);
        bs1 += __shfl_xor_sync(0xffffffffu, bs1, 2);
        if (q4 == 0) {
          float* row = a.part + ((size_t)u * 2 + wgi) * PART_ROW + oc;
          row[0] = bs0;
          row[8] = bs1;
        }
      }
    }
  }
}

// NHWC f32 frames (n, rows, w, c): the first c channels of pixels xc floats
// apart, frames xn floats apart, read in boxes of 32 channels x bw x bh x fr
// pixels, 128-byte swizzled.
inline int make_map(CUtensorMap* m, const void* base, int c, int w, int rows, long long xc, long long xn,
                    int n, int bw, int bh, int fr) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = cw::encode_fn();
  if (fn == nullptr) return cw::TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)xc * 4, (cuuint64_t)w * xc * 4, (cuuint64_t)xn * 4};
  const cuuint32_t box[4] = {CHUNK, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)fr};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cw::TENSOR_MAP_ERROR + (int)r;
}

// The phase-major (s2d) view of an NHWC f32 tensor (n, 2h, 2w, 64): dims
// (c: the 128 floats of a (b, o) pair, x: w, a: 2, y: h, n), boxes of bc
// channels x bw x 1 x bh x fr.
inline int make_map5(CUtensorMap* m, const void* base, int w, int h, int n, int bc, int bw, int bh, int fr) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = cw::encode_fn();
  if (fn == nullptr) return cw::TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t row = 2ull * w * 64 * 4;  // bytes of a high-resolution row
  const cuuint64_t dims[5] = {128, (cuuint64_t)w, 2, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[4] = {128 * 4, row, 2 * row, 2 * row * h};
  const cuuint32_t box[5] = {(cuuint32_t)bc, (cuuint32_t)bw, 1, (cuuint32_t)bh, (cuuint32_t)fr};
  const cuuint32_t estride[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(base), dims, strides, box,
                        estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        bc == CHUNK ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cw::TENSOR_MAP_ERROR + (int)r;
}

// CTAs that can run at once: one an SM.
template <int K, int NH, int MODE, int EK>
int resident_ctas() {
  static const int n = [] {
    return cudaFuncSetAttribute(tf32_kernel<K, NH, MODE, EK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_MAX) == cudaSuccess
               ? cw::sm_count()
               : 0;
  }();
  return n;
}

// The grid of a launch: its work units, at most one CTA an SM.
inline int grid_of(const Args& a, int nh, int mode) {
  const long long units =
      (long long)a.groups * a.tiles_y * a.tiles_x * (mode == LAST || mode == GC ? 1 : a.cout / (128 / nh));
  return (int)(units < cw::sm_count() ? units : cw::sm_count());
}

template <int K, int NH, int MODE, int EK = EK_ACT>
int launch_t(const CUtensorMap& xm, const Args& a, int smem, cudaStream_t stream) {
  if (resident_ctas<K, NH, MODE, EK>() <= 0) return (int)cudaErrorInvalidConfiguration;
  tf32_kernel<K, NH, MODE, EK><<<grid_of(a, NH, MODE), NTHREAD, smem, stream>>>(xm, a);
  return (int)cudaGetLastError();
}

// One launch over x (a.n frames of x_rows rows from frame row a.x_row0, a.w,
// a.cin; pixels xc floats apart, frames xn) NHWC f32 into a.out, in mode
// `mode` with a k x k kernel (3 or 5 in conv mode, 3 otherwise) on a tile of
// a.fr x a.rows x a.tw, on nh n144 halves (conv, phase) or 2 LAST_MB m64
// blocks (last, gc); the output rows [a.r0, a.r1) stored. Returns the CUDA
// error code (or cw::TENSOR_MAP_ERROR + a CUresult).
// The backward's epilogues (mask, dx) take a.r (and a.r2, a.out2, a.part)
// as the note says; with a.s2d the input is the phase-major view of an
// NHWC (n, 2h, 2w, 64) tensor (cin 256, whole frames; xc and xn unread).
// *rows, where given, receives the rows of a.part the launch writes.
inline int launch(const float* x, Args a, int k, int nh, int mode, int x_rows, long long xc, long long xn,
                  cudaStream_t stream, int* rows = nullptr) {
  const int ho = mode == PHASE ? 2 * a.h : a.h;  // the output frame's rows
  const bool rows_n = mode == LAST || mode == GC;  // the unswapped product
  if ((mode != CONV && mode != PHASE && mode != LAST && mode != GC) || (k != 3 && (k != 5 || mode != CONV)) ||
      (nh != 1 && nh != 2) || a.n < 1 || a.h < 1 || a.w < 1 || a.cin < CHUNK || a.cin % CHUNK ||
      a.fr < 1 || a.rows < 1 || a.tw < 1 || a.tw > a.w || a.tg < 1 || a.x_row0 < 0 || x_rows < 1 ||
      a.x_row0 >= a.h || a.r0 < 0 || a.r1 > ho || a.r0 >= a.r1 || a.out_row0 > a.r0 ||
      (a.epi < EPI_NONE || a.epi > EPI_DX) ||
      (a.epi == EPI_RESID && (mode != CONV || a.r == nullptr)) ||
      ((a.epi == EPI_MASK || a.epi == EPI_DX) &&
       (a.r == nullptr || !(mode == GC || (mode == CONV && a.cout == 64 && nh == 2)) ||
        (a.epi == EPI_DX && mode != CONV) ||
        (mode == GC && (a.r_sy != a.sr || a.r_sx != a.sp)))) ||
      (a.s2d && (mode != CONV || k != 3 || a.cin != 4 * 64 || a.x_row0 != 0 || x_rows != a.h)))
    return (int)cudaErrorInvalidValue;
  // The input: the first cin channels of pixels xc floats apart (16-byte
  // strides and base for the TMA map), frames xn floats apart.
  if (!a.s2d && (xc < a.cin || xc % 4 || xn % 4 || xn < (long long)x_rows * a.w * xc))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16) return (int)cudaErrorInvalidValue;
  if (mode == LAST) {  // the weights and the exchange fill the 64 KB weight region at Cin 64
    if (a.cout < 1 || a.cout > 3 || a.cout_pad != 3 * LAST_N || a.cin > 2 * CHUNK || a.fr != 1 ||
        2 * (a.cin / CHUNK) * 3 * LAST_W * 4 + 2 * EX_ROWS * 9 * 4 > 2 * W_RING)
      return (int)cudaErrorInvalidValue;
  } else if (mode == GC) {  // 32 outputs, the (chunk, dy) blocks streamed
    if (a.cout != GC_N || a.cout_pad != 3 * GC_N || a.fr != 1) return (int)cudaErrorInvalidValue;
  } else if (a.cout < 64 || a.cout % (128 / nh) || a.cout_pad % COUT_PAD || a.cout_pad < a.cout ||
             (mode == PHASE && (a.cout != 256 || a.cout_pad != 256))) {
    return (int)cudaErrorInvalidValue;
  }
  a.cy0 = mode == PHASE ? a.r0 / 2 : a.r0;
  a.cy1 = mode == PHASE ? (a.r1 + 1) / 2 : a.r1;
  if (a.rows > a.cy1 - a.cy0 || (a.fr > 1 && (a.rows != a.h || a.cy0 != 0 || a.x_row0 != 0)))
    return (int)cudaErrorInvalidValue;
  const int bw = a.tw + k - 1, bh = a.rows + k - 1;
  const int cols = ((a.fr - 1) * bh + a.rows - 1) * bw + a.tw;  // the tile's last output column + 1
  const int read = rows_n ? 2 * LAST_MB * 64 : nh * HALF;  // the columns the products read
  if (cols + (rows_n ? 2 : 0) > read || bw > 256 || bh > 256 || a.fr > 256)
    return (int)cudaErrorInvalidValue;  // an output column past the halves or blocks
  a.a_tx = a.fr * bh * bw * 128;
  a.a_stage = (2 * a.a_tx + 1023) / 1024 * 1024;
  const int smem = smem_bytes(a.a_tx, read, k, bw);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidConfiguration;
  if (a.n >= 65536 || a.tg >= 65536 || 2 * (a.rows * a.sr + a.tw * a.sp) >= (1LL << 31) ||
      (a.epi >= EPI_RESID && (2 * (a.rows * a.r_sy + a.tw * a.r_sx) >= (1LL << 31) ||
                              2 * (a.rows * a.r2_sy + a.tw * a.r2_sx) >= (1LL << 31) ||
                              2 * (a.rows * a.o2_sy + a.tw * a.o2_sx) >= (1LL << 31))))
    return (int)cudaErrorInvalidValue;  // div_by's range, and a column's 32-bit offset in a tile
  a.mbw = magic(bw);
  a.mbh = magic(bh);
  a.mtg = magic((int)a.tg);
  a.tiles_x = (a.w + a.tw - 1) / a.tw;
  a.tiles_y = (a.cy1 - a.cy0 + a.rows - 1) / a.rows;
  a.groups = (a.n + a.fr - 1) / a.fr;
  const int valid = x_rows < a.h - a.x_row0 ? x_rows : a.h - a.x_row0;  // frame rows x holds
  // The input rows the stored outputs read (phase mode: (r0 - 1) / 2 to r1 / 2).
  int need0 = mode == PHASE ? (a.r0 - 1) >> 1 : a.r0 - k / 2;
  int need1 = mode == PHASE ? (a.r1 >> 1) + 1 : a.r1 + k / 2;
  need0 = need0 > 0 ? need0 : 0;
  need1 = need1 < a.h ? need1 : a.h;
  if (a.x_row0 > need0 || a.x_row0 + valid < need1) return (int)cudaErrorInvalidValue;  // rows x lacks
  CUtensorMap xm;
  const int e = a.s2d ? make_map5(&xm, x, a.w, a.h, a.n, CHUNK, bw, bh, a.fr)
                      : make_map(&xm, x, a.cin, a.w, valid, xc, xn, a.n, bw, bh, a.fr);
  if (e != 0) return e;
  if (rows != nullptr)  // a row a warp (gc mode) or a warpgroup (conv mode) of each unit
    *rows = (int)((long long)a.groups * a.tiles_y * a.tiles_x * (mode == GC ? CONS_WARPS : 2 * a.cout / 64));
  if (a.epi == EPI_MASK)
    return mode == GC ? launch_t<3, 1, GC, EK_MASK>(xm, a, smem, stream)
                      : launch_t<3, 2, CONV, EK_MASK>(xm, a, smem, stream);
  if (a.epi == EPI_DX) return launch_t<3, 2, CONV, EK_DX>(xm, a, smem, stream);
  if (mode == GC) return launch_t<3, 1, GC>(xm, a, smem, stream);
  if (mode == PHASE)
    return nh == 2 ? launch_t<3, 2, PHASE>(xm, a, smem, stream)
                   : launch_t<3, 1, PHASE>(xm, a, smem, stream);
  if (mode == LAST) return launch_t<3, 1, LAST>(xm, a, smem, stream);
  if (a.epi == EPI_RESID) {
    if (k != 3) return (int)cudaErrorInvalidValue;  // an RDB's conv5 is 3x3
    return nh == 2 ? launch_t<3, 2, CONV, EK_RESID>(xm, a, smem, stream)
                   : launch_t<3, 1, CONV, EK_RESID>(xm, a, smem, stream);
  }
  if (k == 3)
    return nh == 2 ? launch_t<3, 2, CONV>(xm, a, smem, stream) : launch_t<3, 1, CONV>(xm, a, smem, stream);
  return nh == 2 ? launch_t<5, 2, CONV>(xm, a, smem, stream) : launch_t<5, 1, CONV>(xm, a, smem, stream);
}

}  // namespace
}  // namespace ft
