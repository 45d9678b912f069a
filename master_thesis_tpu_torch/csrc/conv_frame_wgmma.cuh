// K8, second design: one k x k conv (k = 3 or 5; same padding, zeros only
// at the frame's border; f32 bias, then ReLU where asked) over N whole
// NHWC bf16 frames, Cin and Cout multiples of 64, as an implicit GEMM on
// Hopper's warpgroup MMA (wgmma) with TMA-fed tiles. The thin convs of a
// stack (the flow estimators' c0 with Cin 10 and c17 with Cout 2, VGG's
// 3 -> 64) stay on conv_stack.cu's fused kernel.
//
// Replaces, for those convs: master_thesis_tpu/ops/pallas_sep4d.py:
// conv_stack_banded (body _conv_stack_band_kernel / _band_tap_masks_r):
// full frames in row bands, zero padding at the frame's border only;
// operands bf16, sums f32, the f32 bias added, then ReLU, the output
// rounded to bf16 (the rounding of ops/conv_stack.py:conv_stack_plain).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the CHN+DFPN
// step's shapes (B=4, F=5: 20 frames through the flow estimators, 4 + 20
// through VGG): flow_256's 128 -> 128 convs 0.271 ms (5x5 at 128²) to 1.086
// ms (5x5 at 256²) each, 2.9 ms for its 7 segments; VGG's pool-4 tower 0.9
// ms. Every routed conv does >= 295 operations a byte of its input and
// output: all are bound by operations (chip_smoke.py computes each floor).
//
// Design: the GEMM is swapped, D = W^T X, as in conv3x3_wide_wgmma.cuh: M =
// output channels (one m64 tile a consumer warpgroup), N = pixels, K = k²
// taps x Cin. A tile is fr frames x rows x tw output pixels (ops/
// conv_stack.py:frame_tile: tw = min(W, 64); rows of a frame, or whole
// small frames stacked). Its input is one TMA box a 64-channel chunk,
// (tw + k - 1) x (rows + k - 1) x fr pixels started at (x0 - r, y0 - r, f0)
// on a 4-D tensor map over the NHWC frames (C, W, H, N): TMA's
// out-of-bounds zero fill is the frame's zero padding and the ragged last
// tile, and a tile's halo rows are its neighbours' rows in device memory,
// so no conv recomputes a halo. The box lands 128-byte swizzled, one pixel
// a 128-byte row: pixel p = (f bh + y) bw + x, bw = tw + k - 1, bh = rows + k
// - 1. N runs over the box's flat pixel range ("wrapped" columns): output
// (f, y, x) is column (f bh + y) bw + x, and tap (dy, dx) reads the box at
// column + dy bw + dx, so a tap is the descriptor's start moved by whole
// pixels (128 bytes) and a k16 step by 32 bytes, base offset 0. Two n144
// halves cover columns 0..287 (the tile is sized so every output column is
// below 288); columns with x >= tw, y >= rows or past the tile's frames
// are computed and dropped.
// Dropped columns past the box read the next stage or the weight ring:
// a column's sums depend on its own pixels only, and those are dropped.
// The weights are the A operand, K-major and 128-byte swizzled
// (ops/fragments.py:wgmma_wide_matrix: (Cin / 64, k², Cout padded to 128,
// 64), each output's 16-byte chunks XOR-ed by its row phase), so a (tap,
// chunk) block of COUT_T outputs is one contiguous bulk copy.
//
// Roles, from conv3x3_wide_wgmma.cuh: a producer warpgroup (one lane
// issues every load; setmaxnreg hands its registers to the consumers) keeps
// the box ring (2 stages) and the weight ring (4 stages of (tap, chunk)
// blocks) full; the next box is issued early in the current chunk's taps,
// so it is in flight for most of them. Two consumer warpgroups accumulate
// in f32 registers: with COUT_T = 128 warpgroup w owns outputs [64 w, 64 w
// + 64) over both halves (144 registers a thread), with COUT_T = 64 (Cout
// not a multiple of 128) half w of the 64 outputs. A CTA walks its work
// units (tile, COUT_T outputs), outputs fastest, so that the CTAs of one
// tile run side by side and share its box in L2. The epilogue adds the
// bias, applies ReLU, rounds to bf16 and stages 72 columns at a time in a
// warpgroup-private area (144-byte pixel stride) from which it stores
// whole 128-byte pixel pieces, masked at the frame's right and bottom
// edges and past the last frame.
//
// Shared memory at the largest tile (5x5, tw = 64, rows 4: a box of 8 x 68
// pixels, 69 632 bytes): two box stages, four 16 KB weight stages and two
// 10 KB staging areas, 225 632 bytes of the 232 448.
//
// The weights: every tile reads its conv's whole weight matrix (for COUT_T
// outputs) from L2, 819 KB at flow_256's c15 over 256 useful pixels. A
// 2-CTA cluster that multicast each weight block to two tiles, and 2 or 3
// weight stages, were built and timed, and lost at every shape (PERF.md
// §6); more than 4 stages do not fit at 5x5.
//
// Planted faults for the checks on the card, -DFRAME_PLANT=n: 1 leaves out
// the corner tap (-r, -r); 2 drops the bias; 3 reads the top halo row of
// every tile below a frame's first row tile as zeros (that row is the
// tile above's, across the tile boundary).
#pragma once

#include "conv3x3_wide_wgmma.cuh"

#ifndef FRAME_PLANT
#define FRAME_PLANT 0
#endif

namespace fw {
namespace {

using bf16 = __nv_bfloat16;

constexpr int HALF = 144, COLS = 2 * HALF;  // pixel columns a wgmma, and a tile's
constexpr int CHUNK = 64;                   // input channels a K-chunk
constexpr int COUT_PAD = 128;               // the packed weights' output padding
constexpr int SA = 2, SW = 4;                // box and weight stages
constexpr int NCONS = 256, NTHREAD = NCONS + 128, CONS_WARPS = NCONS / 32;
constexpr int PROD_REGS = 40, CONS_REGS = 232;
static_assert(PROD_REGS * 128 + CONS_REGS * NCONS <= 65536, "register file");
constexpr int STG_COLS = 72, STG_PITCH = 144;  // columns a staging pass, bytes a staged pixel
constexpr int STG = STG_COLS * STG_PITCH;      // a warpgroup's staging area
constexpr int SMEM_MAX = 232448;

struct Args {
  const bf16* wt;     // packed (cin / 64, k * k, cout_pad, 64), swizzled rows
  const float* bias;  // cout
  bf16* out;          // (n, h, w, cout) NHWC
  int n, h, w, cin, cout, cout_pad, relu;
  int fr, rows, tw;              // a tile: fr frames x rows x tw output pixels
  int tiles_x, tiles_y, groups;  // column tiles, row tiles, frame groups
  int a_tx, a_bytes;             // one box's bytes, and its stage (1024-aligned)
};

inline int smem_bytes(int a_bytes, int cout_t) {
  return SA * a_bytes + SW * cout_t * 128 + 2 * STG + 2 * (SA + SW) * 8;
}

// A work unit's tile: its first frame, row and column.
struct Tile {
  int f0, y0, x0;
};
__device__ __forceinline__ Tile tile_of(const Args& a, int s) {
  const int tx = s % a.tiles_x, rest = s / a.tiles_x;
  return {rest / a.tiles_y * a.fr, rest % a.tiles_y * a.rows, tx * a.tw};
}

template <int K, int COUT_T>
__global__ void __launch_bounds__(NTHREAD, 1)
frame_kernel(__grid_constant__ const CUtensorMap xmap, const Args a) {
  constexpr int R = K / 2, KK = K * K, UNITS = COUT_T / 64;
  constexpr uint32_t W_BYTES = COUT_T * 128;  // one (tap, chunk) block
  constexpr int JB = SW + 1 < KK - 1 ? SW + 1 : KK - 1;  // the tap before which the next box goes
  static_assert(COUT_T == 64 || COUT_T == 128, "64 or 128 outputs a CTA");
  extern __shared__ __align__(1024) unsigned char fw_smem[];
  unsigned char* smem = fw_smem;
  const int w_off = SA * a.a_bytes, stg_off = w_off + SW * (int)W_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + stg_off + 2 * STG);
  const uint32_t afull0 = cw::smem_u32(bars), aempty0 = afull0 + 8 * SA;
  const uint32_t wfull0 = aempty0 + 8 * SA, wempty0 = wfull0 + 8 * SW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bw = a.tw + K - 1, bh = a.rows + K - 1;
  const int nct = a.cout / COUT_T, nch = a.cin / CHUNK;
  const int spatial = a.groups * a.tiles_y * a.tiles_x;
  const int units = spatial * nct;  // work units (tile, COUT_T outputs), outputs fastest

  if (threadIdx.x == 0) {
    for (int s = 0; s < SA; ++s) {
      cw::mbar_init(afull0 + 8 * s, 1);
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

  if (warp >= CONS_WARPS) {  // the producer warpgroup: one lane issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PROD_REGS));
    if (warp == CONS_WARPS && lane == 0) {
      int qa = 0, qw = 0;
      int bu = blockIdx.x, bc = 0;  // the next box: unit, chunk
      auto next_box = [&]() {
        if (bu >= units) return;
        const Tile t = tile_of(a, bu / nct);
        const int sa = qa % SA;
        if (qa >= SA) cw::mbar_wait(aempty0 + 8 * sa, (qa / SA - 1) & 1);
        cw::mbar_expect_tx(afull0 + 8 * sa, (uint32_t)a.a_tx);
        cw::tma_load_4d(cw::smem_u32(smem + sa * a.a_bytes), &xmap, CHUNK * bc, t.x0 - R, t.y0 - R,
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
            cw::mbar_expect_tx(wfull0 + 8 * sw, W_BYTES);
            const bf16* src = a.wt + ((size_t)(c * KK + tap) * a.cout_pad + n0) * CHUNK;
            cw::bulk_load(cw::smem_u32(smem + w_off + sw * W_BYTES), src, W_BYTES, wfull0 + 8 * sw);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONS_REGS));
    const int wgi = warp >> 2, wl = warp & 3, tt = threadIdx.x & 127;
    const int g = lane >> 2, q4 = lane & 3;
    const int mt = UNITS == 2 ? wgi : 0;  // warpgroup wgi's 64 of the CTA's COUT_T outputs
    unsigned char* stg = smem + stg_off + wgi * STG;
    // A stage is released by one lane a consumer warp, after its wgmmas
    // that read it retired.
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) cw::mbar_arrive(bar);
    };
    int qa = 0, qw = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Tile t = tile_of(a, u / nct);
      const int n0 = (u % nct) * COUT_T;
      float acc[UNITS][72];
#pragma unroll
      for (int v = 0; v < UNITS; ++v)
#pragma unroll
        for (int i = 0; i < 72; ++i) acc[v][i] = 0.0f;
      int prev_w = -1, prev_a = -1;  // stages to release once the next group is issued
      for (int c = 0; c < nch; ++c, ++qa) {
        const int sa = qa % SA;
        cw::mbar_wait(afull0 + 8 * sa, (qa / SA) & 1);
        const uint32_t box = cw::smem_u32(smem + sa * a.a_bytes);
        if (FRAME_PLANT == 3 && t.y0 > 0) {  // the fault: the box's top row read as zeros
          for (int i = threadIdx.x; i < bw * 8; i += NCONS)
            *reinterpret_cast<uint4*>(smem + sa * a.a_bytes + 16 * i) = make_uint4(0, 0, 0, 0);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          cw::named_sync(3, NCONS);
        }
#pragma unroll
        for (int tap = 0; tap < KK; ++tap, ++qw) {
          const int sw = qw % SW;
          cw::mbar_wait(wfull0 + 8 * sw, (qw / SW) & 1);
          const uint32_t wst = cw::smem_u32(smem + w_off + sw * W_BYTES) + mt * 64 * 128;
#pragma unroll
          for (int v = 0; v < UNITS; ++v) cw::fence_acc(acc[v]);
          cw::wgmma_fence();
          if (!(FRAME_PLANT == 1 && tap == 0)) {
            const int shift = (tap / K) * bw + tap % K;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t ad = ww::desc(wst + 32 * kk);
#pragma unroll
              for (int v = 0; v < UNITS; ++v) {
                const int h = UNITS == 2 ? v : wgi;
                ww::mma144(acc[v], ad, ww::desc(box + (HALF * h + shift) * 128 + 32 * kk));
              }
            }
          }
          cw::wgmma_commit();
          cw::wgmma_wait<1>();
#pragma unroll
          for (int v = 0; v < UNITS; ++v) cw::fence_acc(acc[v]);
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
#pragma unroll
      for (int v = 0; v < UNITS; ++v) cw::fence_acc(acc[v]);
      release(wempty0 + 8 * prev_w);
      release(aempty0 + 8 * prev_a);

      // Epilogue, 72 columns at a time through the staging area: column n
      // (of the pass) at n * 144 bytes, output o (0..63) at 2 o.
      const int obase = n0 + mt * 64;
      float bias[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        bias[i] = FRAME_PLANT != 2 ? a.bias[obase + 16 * wl + g + 8 * i] : 0.0f;
#pragma unroll
      for (int v = 0; v < UNITS; ++v) {
        const int h = UNITS == 2 ? v : wgi;
#pragma unroll
        for (int pass = 0; pass < HALF / STG_COLS; ++pass) {
          cw::named_sync(1 + wgi, 128);  // the last pass's stores have read stg
#pragma unroll
          for (int j = 0; j < STG_COLS / 8; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float val = acc[v][4 * (STG_COLS / 8 * pass + j) + 2 * i + e] + bias[i];
                if (a.relu) val = fmaxf(val, 0.0f);
                *reinterpret_cast<bf16*>(stg + (8 * j + 2 * q4 + e) * STG_PITCH +
                                         2 * (16 * wl + g + 8 * i)) = __float2bfloat16(val);
              }
          cw::named_sync(1 + wgi, 128);
          for (int idx = tt; idx < STG_COLS * 8; idx += 128) {
            const int n = HALF * h + STG_COLS * pass + (idx >> 3), c8 = idx & 7;
            const int q = n / bw, x = n - q * bw, fl = q / bh, y = q - fl * bh;
            const int f = t.f0 + fl, yy = t.y0 + y, xx = t.x0 + x;
            if (x >= a.tw || y >= a.rows || fl >= a.fr || f >= a.n || yy >= a.h || xx >= a.w) continue;
            *reinterpret_cast<uint4*>(a.out + (((size_t)f * a.h + yy) * a.w + xx) * a.cout + obase +
                                      8 * c8) =
                *reinterpret_cast<const uint4*>(stg + (idx >> 3) * STG_PITCH + 16 * c8);
          }
        }
      }
    }
  }
}

// NHWC bf16 frames (n, h, w, c) read in boxes of 64 channels x bw x bh x fr
// pixels, 128-byte swizzled.
inline int make_map(CUtensorMap* m, const void* base, int c, int w, int h, int n, int bw, int bh,
                    int fr) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = cw::encode_fn();
  if (fn == nullptr) return cw::TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {CHUNK, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)fr};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cw::TENSOR_MAP_ERROR + (int)r;
}

// CTAs that can run at once: one an SM.
template <int K, int COUT_T>
int resident_ctas() {
  static const int n = [] {
    return cudaFuncSetAttribute(frame_kernel<K, COUT_T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_MAX) == cudaSuccess
               ? cw::sm_count()
               : 0;
  }();
  return n;
}

template <int K, int COUT_T>
int launch_t(const CUtensorMap& xm, const Args& a, int smem, cudaStream_t stream) {
  const int cap = resident_ctas<K, COUT_T>();
  if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long spatial = (long long)a.groups * a.tiles_y * a.tiles_x;
  const long long units = spatial * (a.cout / COUT_T);
  const long long grid = units < cap ? units : cap;
  frame_kernel<K, COUT_T><<<(int)grid, NTHREAD, smem, stream>>>(xm, a);
  return (int)cudaGetLastError();
}

// One conv over x (a.n, a.h, a.w, a.cin) NHWC into a.out, k = 3 or 5, with
// a tile of a.fr x a.rows x a.tw. Returns the CUDA error code (or
// cw::TENSOR_MAP_ERROR + a CUresult).
inline int launch(const bf16* x, Args a, int k, cudaStream_t stream) {
  if ((k != 3 && k != 5) || a.n < 1 || a.h < 1 || a.w < 1 || a.cin < CHUNK || a.cin % CHUNK ||
      a.cout < 64 || a.cout % 64 || a.cout_pad % COUT_PAD || a.cout_pad < a.cout || a.fr < 1 ||
      a.rows < 1 || a.tw < 1 || a.tw > a.w || a.rows > a.h || (a.fr > 1 && a.rows != a.h))
    return (int)cudaErrorInvalidValue;
  const int bw = a.tw + k - 1, bh = a.rows + k - 1;
  if (((a.fr - 1) * bh + a.rows - 1) * bw + a.tw > COLS || bw > 256 || bh > 256 || a.fr > 256)
    return (int)cudaErrorInvalidValue;  // an output column past the two n144 halves
  const int cout_t = a.cout % 128 == 0 ? 128 : 64;
  a.a_tx = a.fr * bh * bw * 128;
  a.a_bytes = (a.a_tx + 1023) / 1024 * 1024;
  const int smem = smem_bytes(a.a_bytes, cout_t);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidConfiguration;
  a.tiles_x = (a.w + a.tw - 1) / a.tw;
  a.tiles_y = (a.h + a.rows - 1) / a.rows;
  a.groups = (a.n + a.fr - 1) / a.fr;
  CUtensorMap xm;
  const int e = make_map(&xm, x, a.cin, a.w, a.h, a.n, bw, bh, a.fr);
  if (e != 0) return e;
  if (k == 3) return cout_t == 128 ? launch_t<3, 128>(xm, a, smem, stream)
                                   : launch_t<3, 64>(xm, a, smem, stream);
  return cout_t == 128 ? launch_t<5, 128>(xm, a, smem, stream) : launch_t<5, 64>(xm, a, smem, stream);
}

}  // namespace
}  // namespace fw
