// K3 (an RRDB's backward) and K6 (the RRDBNet tail's backward) in f32 on
// Hopper's tensor cores in 3xTF32 (conv_frame_tf32_wgmma.cuh holds the
// split, the descriptors and the forward's modes): one ctypes call each.
//
// Replaces, in f32: master_thesis_tpu/ops/pallas_rrdb.py:rrdb_bwd_pallas
// (K3, body _rdb_bwd_block) and master_thesis_tpu/ops/pallas_tail.py:
// tail_bwd_pallas (K6, body _tail_bwd_kernel, its fold-back
// fused_upsample_conv_kernel_adjoint).
//
// K3 (rrdb_backward_tf32, 18 launches an RRDB). Per RDB the cotangents
// dP_1..dP_5 of its convs' pre-activations live in one NHWC f32 buffer D of
// 192 channels, dP_1..dP_4 at [0, 128), dP_5 at [128, 192) (one D an RDB,
// all three kept for the weight grads); source s (x, x1..x4) feeds convs
// s+1..5, so its cotangent is one 3x3 conv of the suffix D[32 s:]:
//   prep    the third RDB's dP_5 = 0.2 (0.2 g) -> D[128:], its bias sums
//   pull s  (s = 4..1, gc mode, Cin 64..160 -> 32, the mask epilogue):
//           dP_s = mask(x_s) conv(D[32 s:]) -> D[32 (s - 1):], bias sums
//   pull 0  (conv mode, 192 -> 64, the dx epilogue): d = rs r + conv(D)
//           (r: 0.2 g for the third RDB, else the RDB above's d; + g on
//           the first RDB, whose d is dx); 0.2 d -> the next RDB's
//           D[128:] and its bias sums
// then one weight-grad launch for all 15 convs (below) and one reduce:
// 1 + 3 x 5 + 1 + 1 = 18 launches, no atomics, a fixed order: two runs are
// bit-identical. The pull matrices (ops/rrdb_bwd.py:pack_rdb_pulls_tf32)
// are each conv's kernel transposed and flipped, stacked over the convs a
// source feeds, in the gc and conv layouts.
//
// K6 (tail_backward_tf32, 10 launches): the recompute h1, h2, h3 (K4's
// phase, phase and conv launches), conv_last's weight grad and its adjoint
// (two thin SIMT kernels below: 3 cotangent channels, bound by bytes; the
// adjoint masked by h3, in place over h3), hr_conv's adjoint (conv mode,
// masked by h2), upconv2's and upconv1's adjoints (conv mode over the
// phase-major view of the cotangent, s2d: the 4-phase kernel's 3x3 adjoint,
// 2.25x the 16 phase-taps' products; upconv2's masked by h1), the weight
// grads of hr_conv (9 taps) and of upconv2 / upconv1 in the 4-phase form
// (4 phases x 4 taps at the low resolution) in one launch, and the reduce,
// which folds the phase taps back to 3x3 kernels.
//
// The weight-grad mode: dW[o, tap, c] = sum_p dP[p, o] src[p + tap, c],
// K = pixels. tf32 wgmma reads both operands K-major, here pixel-major,
// while NHWC keeps channels contiguous, and a tap's one-pixel shift is 4
// bytes along K, finer than a descriptor's 16-byte start. So the producer's
// split pass, which reads every value into registers anyway, writes
// transposed planes: per tile (one frame row x 32 pixels, one K-chunk) the
// cotangent's 64 channels x 32 pixels (A, hi and lo) and, for each of the
// source box's rows (3 rows x 34 columns, TMA's zero fill at the frame's
// border), one plane per dx shift, 3 x 32 channels x 32 pixels (B, hi and
// lo), each a K-major 128-byte-swizzled block as the forward's weights. A
// work unit (a job) is 64 cotangent channels x 32 source channels: three
// consumer warpgroups, warpgroup dy one m64 n96 (3 dx x 32 channels)
// product a k8 step x 4 x 3 products a tile, over source row dy; a phase
// job (a, b) takes taps a + ti, b + tj (ti, tj < 2): two warpgroups of m64
// n64 products, its planes from the box's rows a, a + 1 and columns from b.
// Each tile's products go into a fresh partial sum (the tensor cores
// truncate their sums), added in f32; a job's tiles are split K-split-wise
// over items (ks, ks + KS, ...), each item's sums to its own slot; the
// reduce adds the slots in order. The bf16 template is conv_bwd_wgmma.cuh's
// wgrad (units: source x 64-channel block of D x source-channel half).
//
// Bound on an H100 SXM (495 TFLOP/s TF32, 3 products; 3.35 TB/s): at the
// train step (8 frames of 64^2) an RRDB's backward is 94.2 GFLOP (the pulls
// 47.1, the weight grads 47.1, the latter with 10% more products, the units
// that meet D's suffix half), a 0.571 ms floor by operations; K6's
// adjoints and weight grads 2.25x the 4-phase products in the upsample-convs'
// adjoints (chip_smoke.py prints each launch's floor).
//
// Planted faults (-DTF32_PLANT): 6 leaves the weight grads' tap (0, 0) out
// (each item's slot stores zeros there); 7 leaves the last K-split out of
// every weight-grad sum in the reduces; 8 (conv_frame_tf32_wgmma.cuh) the
// mask slope at 0.25, here too; 9 has the phase (0, 1) jobs of the weight
// grads read phase (1, 0)'s plane of the cotangent.
#pragma once

#include "conv_frame_tf32_wgmma.cuh"

namespace ft {
namespace {

constexpr int WG_TW = 32;  // pixels a tile: one K-chunk, one 128-byte plane row
constexpr int WG_NCONS = 384, WG_NTHREAD = WG_NCONS + 128, WG_CONS_WARPS = WG_NCONS / 32;
constexpr int WG_PROD_REGS = 56, WG_CONS_REGS = 152;
static_assert(WG_PROD_REGS * 128 + WG_CONS_REGS * WG_NCONS <= 65536, "register file");
constexpr int WG_SLOT = 9 * 64 * 32;  // an item's sums: tap slot (3 ti + tj), 64 outputs, 32 channels
constexpr int WG_MAPS = 6, WG_JOBS = 48;
constexpr int SRC_BOX = 3 * (WG_TW + 2) * CHUNK * 4;  // the source box: 3 rows x 34 columns x 32
constexpr int D_BOX = WG_TW * 64 * 4;                 // the cotangent box: 32 pixels x 64
constexpr int RAW_STAGE = SRC_BOX + D_BOX;
constexpr int A_BYTES = 64 * 128;      // a cotangent plane, hi or lo: 64 rows of 32 pixels
constexpr int B_ROW = 3 * 32 * 128;    // a box row's three dx planes, hi or lo: 96 rows
constexpr int P_STAGE = 2 * A_BYTES + 2 * 3 * B_ROW;
constexpr int WG_SMEM = 2 * P_STAGE + 2 * RAW_STAGE + 64;
static_assert(WG_SMEM <= SMEM_MAX && P_STAGE % 1024 == 0 && RAW_STAGE % 128 == 0, "shared memory");
constexpr int TGRID = 2048;     // the thin kernels' CTAs at most
constexpr int LW_ROW = 27 * 64 + 4;  // conv_last's weight-grad row: OIHW (3, 64, 3, 3), its 3 bias sums

// One weight-grad job (a unit): 64 cotangent channels x 32 source channels
// over a pixel grid, its tiles split over `ks` items from item0.
struct WgJob {
  int maps;   // bits 0-3 the cotangent's map, 4-7 the source's, 8-9 kt (3, or 2 for a phase),
              // 10 row0 and 11 dx0 (the phase's planes), 12 the cotangent map is phase-major
              // (5-D), 13 its phase row a
  int c0;     // the cotangent map's first channel (bits 0-15), the source map's (16-31)
  int nh;     // frames (bits 0-15) and rows (16-31) of the grid
  int wks;    // columns (bits 0-15) and K-splits (16-31)
  int item0;  // the job's first item, its K-split 0's slot
};
struct WgParams {
  CUtensorMap maps[WG_MAPS];
  WgJob jobs[WG_JOBS];
  float* part;  // items x WG_SLOT
  int njobs, items;
};
struct JobInfo {
  int dmap, smap, kt, row0, dx0, d5, da, dc0, sc0, n, h, w, ks, tx;
};

__device__ __forceinline__ JobInfo job_of(const WgParams& P, int item, int& ks) {
  int j = 0;
  while (j + 1 < P.njobs && P.jobs[j + 1].item0 <= item) ++j;
  const WgJob b = P.jobs[j];
  JobInfo i;
  i.dmap = b.maps & 15;
  i.smap = b.maps >> 4 & 15;
  i.kt = b.maps >> 8 & 3;
  i.row0 = b.maps >> 10 & 1;
  i.dx0 = b.maps >> 11 & 1;
  i.d5 = b.maps >> 12 & 1;
  i.da = b.maps >> 13 & 1;
  i.dc0 = b.c0 & 0xFFFF;
  i.sc0 = b.c0 >> 16;
  i.n = b.nh & 0xFFFF;
  i.h = b.nh >> 16;
  i.w = b.wks & 0xFFFF;
  i.ks = b.wks >> 16;
  i.tx = (i.w + WG_TW - 1) / WG_TW;
  ks = item - b.item0;
  return i;
}

// D (64 x 64 f32 in d[0..31]) = A (64 x 8) B (8 x 64) + (acc ? D : 0), tf32,
// both K-major from shared memory (the fragment layout of mma96).
__device__ __forceinline__ void mma64(float (&d)[48], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ float4 split_hi(float4 v) {
  return make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
}

__global__ void __launch_bounds__(WG_NTHREAD, 1) wgrad_kernel(const __grid_constant__ WgParams P) {
  extern __shared__ __align__(1024) unsigned char ft_smem[];
  unsigned char* smem = ft_smem;
  unsigned char* raw = smem + 2 * P_STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(raw + 2 * RAW_STAGE);
  const uint32_t rfull0 = cw::smem_u32(bars), rempty0 = rfull0 + 16, pfull0 = rfull0 + 32, pempty0 = rfull0 + 48;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      cw::mbar_init(rfull0 + 8 * s, 1);
      cw::mbar_init(rempty0 + 8 * s, SPLIT_WARPS);
      cw::mbar_init(pfull0 + 8 * s, SPLIT_WARPS);
      cw::mbar_init(pempty0 + 8 * s, WG_CONS_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (cw::smem_u32(smem) & 1023) __trap();  // the swizzle pattern needs 1024-byte planes
  __syncthreads();

  if (warp >= WG_CONS_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PROD_REGS));
    if (warp == WG_CONS_WARPS) {  // lane 0 issues every load: each tile's two boxes
      if (lane != 0) return;
      int q = 0;
      for (int it = blockIdx.x; it < P.items; it += gridDim.x) {
        int ks;
        const JobInfo jb = job_of(P, it, ks);
        const int T = jb.n * jb.h * jb.tx;
        for (int t = ks; t < T; t += jb.ks, ++q) {
          const int s = q & 1;
          if (q >= 2) cw::mbar_wait(rempty0 + 8 * s, ((q >> 1) - 1) & 1);
          cw::mbar_expect_tx(rfull0 + 8 * s, RAW_STAGE);
          const int xt = t % jb.tx, rest = t / jb.tx, y = rest % jb.h, f = rest / jb.h;
          const uint32_t dst = cw::smem_u32(raw + s * RAW_STAGE);
          cw::tma_load_4d(dst, &P.maps[jb.smap], jb.sc0, WG_TW * xt - 1, y - 1, f, rfull0 + 8 * s);
          if (jb.d5) {
            int da = jb.da, dc = jb.dc0;
            if (TF32_PLANT == 9 && da == 0 && dc == 64) {  // phase (0, 1) reads phase (1, 0)'s plane
              da = 1;
              dc = 0;
            }
            tma_load_5d(dst + SRC_BOX, &P.maps[jb.dmap], dc, WG_TW * xt, da, y, f, rfull0 + 8 * s);
          } else {
            cw::tma_load_4d(dst + SRC_BOX, &P.maps[jb.dmap], jb.dc0, WG_TW * xt, y, f, rfull0 + 8 * s);
          }
        }
      }
      return;
    }
    // Warps 1-3: each tile's boxes, once landed, split into hi and lo and
    // written as transposed 128-byte-swizzled planes (row r's 16-byte chunk
    // k / 4 at chunk (k / 4) ^ (r % 8)).
    const int st = threadIdx.x - (WG_CONS_WARPS + 1) * 32;
    int q = 0;
    for (int it = blockIdx.x; it < P.items; it += gridDim.x) {
      int ks;
      const JobInfo jb = job_of(P, it, ks);
      const int T = jb.n * jb.h * jb.tx;
      for (int t = ks; t < T; t += jb.ks, ++q) {
        const int s = q & 1;
        cw::mbar_wait(rfull0 + 8 * s, (q >> 1) & 1);
        if (q >= 2) cw::mbar_wait(pempty0 + 8 * s, ((q >> 1) - 1) & 1);
        const float* rs = reinterpret_cast<const float*>(raw + s * RAW_STAGE);
        const float* rd = rs + SRC_BOX / 4;
        unsigned char* ps = smem + s * P_STAGE;
        for (int i = st; i < 64 * 8; i += SPLIT_WARPS * 32) {  // A: channel o, pixels 4 kq ..
          const int o = i & 63, kq = i >> 6;
          const float* p = rd + 4 * kq * 64 + o;
          const float4 v = make_float4(p[0], p[64], p[128], p[192]);
          const float4 hi = split_hi(v);
          const float4 lo = split_hi(make_float4(v.x - hi.x, v.y - hi.y, v.z - hi.z, v.w - hi.w));
          const int off = o * 128 + ((kq ^ (o & 7)) << 4);
          *reinterpret_cast<float4*>(ps + off) = hi;
          *reinterpret_cast<float4*>(ps + A_BYTES + off) = lo;
        }
        for (int i = st; i < jb.kt * 256; i += SPLIT_WARPS * 32) {  // B: row r, channel c, pixels 4 kq ..
          const int c = i & 31, kq = i >> 5 & 7, r = i >> 8;
          const float* p = rs + ((jb.row0 + r) * (WG_TW + 2) + 4 * kq + jb.dx0) * CHUNK + c;
          float hi[6], lo[6];
#pragma unroll
          for (int e = 0; e < 6; ++e) {
            const float v = e < jb.kt + 3 ? p[e * CHUNK] : 0.0f;
            hi[e] = tf32_rna(v);
            lo[e] = tf32_rna(v - hi[e]);
          }
          unsigned char* pb = ps + 2 * A_BYTES + r * 2 * B_ROW;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            if (dx >= jb.kt) break;
            const int off = (32 * dx + c) * 128 + ((kq ^ (c & 7)) << 4);
            *reinterpret_cast<float4*>(pb + off) = make_float4(hi[dx], hi[dx + 1], hi[dx + 2], hi[dx + 3]);
            *reinterpret_cast<float4*>(pb + B_ROW + off) =
                make_float4(lo[dx], lo[dx + 1], lo[dx + 2], lo[dx + 3]);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) {
          cw::mbar_arrive(rempty0 + 8 * s);
          cw::mbar_arrive(pfull0 + 8 * s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONS_REGS));
  const int wgi = warp >> 2, wl = warp & 3, g = lane >> 2, q4 = lane & 3;
  int q = 0;
  for (int it = blockIdx.x; it < P.items; it += gridDim.x) {
    int ks;
    const JobInfo jb = job_of(P, it, ks);
    const int T = jb.n * jb.h * jb.tx;
    float acc[48], part[48];
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[i] = part[i] = 0.0f;
    for (int t = ks; t < T; t += jb.ks, ++q) {
      const int s = q & 1;
      cw::mbar_wait(pfull0 + 8 * s, (q >> 1) & 1);
      if (wgi < jb.kt) {  // warpgroup wgi: taps of source row wgi; each tile a fresh partial sum
        const uint32_t a_hi = cw::smem_u32(smem + s * P_STAGE), a_lo = a_hi + A_BYTES;
        const uint32_t b_hi = a_hi + 2 * A_BYTES + wgi * 2 * B_ROW, b_lo = b_hi + B_ROW;
        cw::fence_acc(part);
        cw::wgmma_fence();
        if (jb.kt == 3) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (TF32_PLANT != 1) {
              mma96(part, desc(a_lo + 32 * kk), desc(b_hi + 32 * kk), kk > 0);
              mma96(part, desc(a_hi + 32 * kk), desc(b_lo + 32 * kk), 1);
            }
            mma96(part, desc(a_hi + 32 * kk), desc(b_hi + 32 * kk), TF32_PLANT != 1 || kk > 0);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (TF32_PLANT != 1) {
              mma64(part, desc(a_lo + 32 * kk), desc(b_hi + 32 * kk), kk > 0);
              mma64(part, desc(a_hi + 32 * kk), desc(b_lo + 32 * kk), 1);
            }
            mma64(part, desc(a_hi + 32 * kk), desc(b_hi + 32 * kk), TF32_PLANT != 1 || kk > 0);
          }
        }
        cw::wgmma_commit();
        cw::wgmma_wait<0>();
        cw::fence_acc(part);
#pragma unroll
        for (int i = 0; i < 48; ++i) acc[i] += part[i];
      }
      __syncwarp();
      if (lane == 0) cw::mbar_arrive(pempty0 + 8 * s);
    }
    if (wgi < jb.kt) {  // the item's sums: column 32 dx + c of row o is tap slot (3 wgi + dx)
      float* dst = P.part + (size_t)it * WG_SLOT;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        if (j >= 4 * jb.kt) break;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = 8 * j + 2 * q4, tap = 3 * wgi + (n >> 5), o = 16 * wl + g + 8 * i;
          float2 v = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
          if (TF32_PLANT == 6 && tap == 0) v = make_float2(0.0f, 0.0f);
          *reinterpret_cast<float2*>(dst + (tap * 64 + o) * 32 + (n & 31)) = v;
        }
      }
    }
  }
}

// An NHWC f32 tensor (n, h, w, c) with pixels xc floats apart read in
// unswizzled boxes of bc channels x bw x bh pixels of one frame (the
// weight-grad mode's raw boxes, transposed by its split pass).
inline int make_map_raw(CUtensorMap* m, const void* base, int c, int w, int h, int n, long long xc, int bc,
                        int bw, int bh) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = cw::encode_fn();
  if (fn == nullptr) return cw::TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)xc * 4, (cuuint64_t)w * xc * 4, (cuuint64_t)h * w * xc * 4};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides, box,
                        estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cw::TENSOR_MAP_ERROR + (int)r;
}
// The cotangent's map: 64 channels from c0 of pixels xc apart (boxes of 32 pixels).
inline int map_cot(CUtensorMap* m, const float* base, int c, int w, int h, int n, long long xc) {
  return make_map_raw(m, base, c, w, h, n, xc, 64, WG_TW, 1);
}
// The source's map: boxes of 32 channels x 34 x 3 (a tile's row with its halo).
inline int map_src(CUtensorMap* m, const float* base, int c, int w, int h, int n, long long xc) {
  return make_map_raw(m, base, c, w, h, n, xc, CHUNK, WG_TW + 2, 3);
}

inline int wgrad_launch(const WgParams& P, int grid, cudaStream_t stream) {
  static const bool ok = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              WG_SMEM) == cudaSuccess;
  if (!ok || P.njobs < 1 || P.njobs > WG_JOBS || P.items < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  wgrad_kernel<<<grid < P.items ? grid : P.items, WG_NTHREAD, WG_SMEM, stream>>>(P);
  return (int)cudaGetLastError();
}

inline WgJob job(int dmap, int smap, int kt, int row0, int dx0, int d5, int da, int dc0, int sc0, int n, int h,
                 int w, int ks, int item0) {
  return {dmap | smap << 4 | kt << 8 | row0 << 10 | dx0 << 11 | d5 << 12 | da << 13, dc0 | sc0 << 16,
          n | h << 16, w | ks << 16, item0};
}

// Sums of 16 pixel lanes' 4-channel partials (each thread one channel quad
// cq of pixel lane pl) in a fixed order, to row blockIdx.x of part.
__device__ __forceinline__ void quad_rows(float (&s)[4], float* part) {
  __shared__ float red[16][64];
  const int pl = threadIdx.x >> 4, cq = threadIdx.x & 15;
#pragma unroll
  for (int e = 0; e < 4; ++e) red[pl][4 * cq + e] = s[e];
  __syncthreads();
  if (threadIdx.x < 64) {
    float v = 0.0f;
    for (int i = 0; i < 16; ++i) v += red[i][threadIdx.x];
    part[(size_t)blockIdx.x * PART_ROW + threadIdx.x] = v;
  }
}

// A thin kernel's CTAs (256 threads, smem bytes of dynamic shared memory):
// as many as are resident on the card at once, at most TGRID (the rows of
// its partial sums).
template <typename Kern>
inline int thin_grid(Kern kernel, int smem) {
  const int b = cw::blocks_per_sm(kernel, 256, smem) * cw::sm_count();
  return b < 1 ? 1 : b > TGRID ? TGRID : b;
}

// K3's first launch: the third RDB's dP_5 = 0.2 (0.2 g) into D[.., 128:]
// (g NHWC 64, D NHWC 192), and its bias sums.
__global__ void __launch_bounds__(256) prep_kernel(const float* g, float* d, float* part, long long pixels) {
  const int pl = threadIdx.x >> 4, cq = threadIdx.x & 15;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long p = (long long)blockIdx.x * 16 + pl; p < pixels; p += (long long)gridDim.x * 16) {
    float4 v = *reinterpret_cast<const float4*>(g + p * 64 + 4 * cq);
    v = make_float4(0.2f * (0.2f * v.x), 0.2f * (0.2f * v.y), 0.2f * (0.2f * v.z), 0.2f * (0.2f * v.w));
    *reinterpret_cast<float4*>(d + p * 192 + 128 + 4 * cq) = v;
    s[0] += v.x;
    s[1] += v.y;
    s[2] += v.z;
    s[3] += v.w;
  }
  quad_rows(s, part);
}

// conv_last's adjoint, masked, in place over h3: dP[p, c] = mask(h3[p, c])
// sum_{ky, kx, o} g[y - ky + 1, x - kx + 1, o] w[o, c, ky, kx] (g NHWC with
// 3 channels, w OIHW (3, 64, 3, 3)), and the CTA's sums of dP (hr_conv's
// bias grad). Bound by bytes: h3 read and written, g read.
__global__ void __launch_bounds__(256) last_adj_kernel(const float* g, const float* w, float* h3, float* part,
                                                       int n, int hh, int ww) {
  __shared__ float4 ws[27][16];  // [tap][o][channel quad]
  for (int i = threadIdx.x; i < 27 * 64; i += 256) {
    const int c = i & 63, to = i >> 6;
    reinterpret_cast<float*>(ws)[i] = w[((to % 3) * 64 + c) * 9 + to / 3];
  }
  __syncthreads();
  const int pl = threadIdx.x >> 4, cq = threadIdx.x & 15;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long pixels = (long long)n * hh * ww;
  for (long long p = (long long)blockIdx.x * 16 + pl; p < pixels; p += (long long)gridDim.x * 16) {
    const int x = (int)(p % ww), y = (int)(p / ww % hh);
    const long long f = p / ww / hh;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = y - ky + 1;
      if (yy < 0 || yy >= hh) continue;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int xx = x - kx + 1;
        if (xx < 0 || xx >= ww) continue;
        const float* gp = g + ((f * hh + yy) * ww + xx) * 3;
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          const float gv = gp[o];
          const float4 wv = ws[(3 * ky + kx) * 3 + o][cq];
          acc.x = fmaf(gv, wv.x, acc.x);
          acc.y = fmaf(gv, wv.y, acc.y);
          acc.z = fmaf(gv, wv.z, acc.z);
          acc.w = fmaf(gv, wv.w, acc.w);
        }
      }
    }
    float4* hp = reinterpret_cast<float4*>(h3 + p * 64 + 4 * cq);
    const float4 m = *hp;
    acc.x = m.x >= 0.0f ? acc.x : MASK_SLOPE * acc.x;
    acc.y = m.y >= 0.0f ? acc.y : MASK_SLOPE * acc.y;
    acc.z = m.z >= 0.0f ? acc.z : MASK_SLOPE * acc.z;
    acc.w = m.w >= 0.0f ? acc.w : MASK_SLOPE * acc.w;
    *hp = acc;
    s[0] += acc.x;
    s[1] += acc.y;
    s[2] += acc.z;
    s[3] += acc.w;
  }
  quad_rows(s, part);
}

// conv_last's weight grad: the CTA's sums over its frame rows of g[q - tap
// + 1, o] h3[q, c] (OIHW order) and of g[q, o] (the bias grad), a row of
// LW_ROW floats of part. Thread (c, column lane); g's three rows around the
// frame row in shared memory (3 outputs padded to a float4). Bound by
// bytes: h3 read once.
__global__ void __launch_bounds__(256) last_wgrad_kernel(const float* g, const float* h3, float* part, int n,
                                                         int hh, int ww) {
  extern __shared__ float4 gs[];  // [3][ww + 2], later the reduction's [4][27 x 64] floats
  const int c = threadIdx.x & 63, xl = threadIdx.x >> 6;
  float acc[27], gb = 0.0f;
#pragma unroll
  for (int i = 0; i < 27; ++i) acc[i] = 0.0f;
  for (long long row = blockIdx.x; row < (long long)n * hh; row += gridDim.x) {
    const int y = (int)(row % hh);
    const long long f = row / hh;
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * (ww + 2); i += 256) {
      const int rr = i / (ww + 2), xx = i % (ww + 2) - 1, yy = y - 1 + rr;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (yy >= 0 && yy < hh && xx >= 0 && xx < ww) {
        const float* gp = g + ((f * hh + yy) * ww + xx) * 3;
        v = make_float4(gp[0], gp[1], gp[2], 0.0f);
      }
      gs[i] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int x = xl; x < ww; x += 4) {  // unrolled: four h3 loads in flight a thread
      const float v = h3[((f * hh + y) * ww + x) * 64 + c];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 gv = gs[(2 - ky) * (ww + 2) + x + 2 - kx];
          acc[3 * ky + kx] = fmaf(gv.x, v, acc[3 * ky + kx]);
          acc[9 + 3 * ky + kx] = fmaf(gv.y, v, acc[9 + 3 * ky + kx]);
          acc[18 + 3 * ky + kx] = fmaf(gv.z, v, acc[18 + 3 * ky + kx]);
        }
    }
    if (threadIdx.x < 3)
      for (int x = 0; x < ww; ++x) {
        const float4 gv = gs[(ww + 2) + x + 1];
        gb += threadIdx.x == 0 ? gv.x : threadIdx.x == 1 ? gv.y : gv.z;
      }
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(gs);
#pragma unroll
  for (int i = 0; i < 27; ++i) red[(xl * 27 + i) * 64 + c] = acc[i];
  __syncthreads();
  float* row = part + (size_t)blockIdx.x * LW_ROW;
  for (int e = threadIdx.x; e < 27 * 64; e += 256) {  // e = (o * 64 + c) * 9 + tap
    const int tap = e % 9, cc = e / 9 % 64, o = e / 9 / 64;
    float v = 0.0f;
    for (int l = 0; l < 4; ++l) v += red[(l * 27 + 9 * o + tap) * 64 + cc];
    row[e] = v;
  }
  if (threadIdx.x < 3) row[27 * 64 + threadIdx.x] = gb;
}

// ---- K3 ----
constexpr int K3_UNITS = 14;  // weight-grad jobs of an RDB
__host__ __device__ constexpr int rdb_cin(int t) { return 64 + 32 * (t - 1); }  // conv t = 1..5
__host__ __device__ constexpr int rdb_cout(int t) { return t < 5 ? 32 : 64; }
__host__ __device__ constexpr int rdb_w_off(int t) {  // conv t's dW in an RDB's grads, then its db
  int off = 0;
  for (int u = 1; u < t; ++u) off += 9 * rdb_cin(u) * rdb_cout(u) + rdb_cout(u);
  return off;
}
constexpr int RDB_GRADS_F32 = rdb_w_off(6);
// Job u of an RDB: source s (x, x1..x4), the 64-channel block mb of D, the
// source's first channel in the dense concat (x in two halves).
struct K3Unit {
  int s, mb, ch;
};
__host__ __device__ inline K3Unit k3_unit(int u) {
  if (u < 6) return {0, u / 2, 32 * (u % 2)};
  if (u < 9) return {1, u - 6, 64};
  if (u < 11) return {2, u - 8, 96};
  if (u < 13) return {3, u - 10, 128};
  return {4, 2, 160};
}
// The pull matrices of an RDB, each hi then lo: pull 0 (conv layout, 192 ->
// 64 padded to 128), pulls 1..4 (gc layout, 192 - 32 s -> 32).
__host__ __device__ constexpr long long pull_size(int s) {
  return s == 0 ? 2LL * 9 * 128 * 192 : 2LL * 9 * 32 * (192 - 32 * s);
}
__host__ __device__ constexpr long long pull_off(int s) {
  long long off = 0;
  for (int u = 0; u < s; ++u) off += pull_size(u);
  return off;
}
constexpr long long PULLS_F32 = pull_off(5);

struct K3Red {
  int ks, bstride;  // K-splits, rows a bias partial slot holds
  int brows[15];    // bias partial rows of slot (RDB j, conv t): 5 j + t - 1
};

// Columns c0 .. c0 + 31 (< ncols) of `rows` rows of `stride` floats summed
// by one CTA of 256 threads in a fixed order: warp w adds rows w, w + 8,
// ... for its lane's column, then the 8 warps' sums in turn; column c0 +
// c's sum to out[c * ostride] (returned by thread c < 32 of the CTA).
__device__ __forceinline__ void rows_sum32(const float* part, int stride, int rows, int c0, int ncols, float* out,
                                           int ostride) {
  __shared__ float red[8][32];
  const int w = threadIdx.x >> 5, c = threadIdx.x & 31;
  float v = 0.0f;
  if (c0 + c < ncols)
    for (int row = w; row < rows; row += 8) v += part[(size_t)row * stride + c0 + c];
  red[w][c] = v;
  __syncthreads();
  if (threadIdx.x < 32 && c0 + c < ncols) {
    float sum = 0.0f;
    for (int i = 0; i < 8; ++i) sum += red[i][c];
    out[(size_t)c * ostride] = sum;
  }
}

// K3's reduce: CTAs [0, K3_WCTAS) one slot element of a job a thread (the
// weight grads), then 2 CTAs a bias slot (32 outputs each).
constexpr int K3_WCTAS = 3 * K3_UNITS * WG_SLOT / 256;

__global__ void __launch_bounds__(256) k3_reduce_kernel(const float* wpart, const float* bpart, float* grads,
                                                         const K3Red r) {
  if ((int)blockIdx.x >= K3_WCTAS) {  // a bias grad: its launch's partial rows
    const int b = blockIdx.x - K3_WCTAS, slot = b / 2, j = slot / 5, t = slot % 5 + 1, o0 = 32 * (b % 2);
    rows_sum32(bpart + (size_t)slot * r.bstride * PART_ROW, PART_ROW, r.brows[slot], o0, rdb_cout(t),
               grads + (size_t)j * RDB_GRADS_F32 + rdb_w_off(t) + 9 * rdb_cin(t) * rdb_cout(t) + o0, 1);
    return;
  }
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  {  // one slot element of job (j, u): the weight grad it belongs to, if any
    const int jb = (int)(i / WG_SLOT), se = (int)(i % WG_SLOT), j = jb / K3_UNITS;
    const K3Unit un = k3_unit(jb % K3_UNITS);
    const int tap = se / 2048, d = 64 * un.mb + se / 32 % 64, cl = se % 32;
    const int t = d < 128 ? d / 32 + 1 : 5, o = d < 128 ? d % 32 : d - 128;
    if (t < un.s + 1) return;  // conv t does not read source s
    const int nk = TF32_PLANT == 7 && r.ks > 1 ? r.ks - 1 : r.ks;
    float v = 0.0f;
    for (int k = 0; k < nk; ++k) v += wpart[((size_t)jb * r.ks + k) * WG_SLOT + se];
    grads[(size_t)j * RDB_GRADS_F32 + rdb_w_off(t) + ((size_t)o * rdb_cin(t) + un.ch + cl) * 9 + tap] = v;
  }
}

// Scratch of one K3 call, in floats: D x 3, d x 2, the weight-grad slots,
// the bias partial slots.
struct K3Scratch {
  float* d[3];
  float* dt[2];
  float* wpart;
  float* bpart;
  long long floats;
};
inline K3Scratch k3_carve(float* base, long long px, int ks, int br) {
  K3Scratch s;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += (n + 63) / 64 * 64;
    return p;
  };
  for (int j = 0; j < 3; ++j) s.d[j] = take(px * 192);
  for (int j = 0; j < 2; ++j) s.dt[j] = take(px * 64);
  s.wpart = take(3LL * K3_UNITS * ks * WG_SLOT);
  s.bpart = take(15LL * br * PART_ROW);
  s.floats = off;
  return s;
}

// The tiles (from ops/conv_stack.py:tf32_tile) and K-splits of a K3 call.
struct K3Cfg {
  int gc_rows, gc_tw, cv_fr, cv_rows, cv_tw, cv_nh, ks;
};
inline int cdiv(int a, int b) { return (a + b - 1) / b; }
// The rows a bias partial slot of a K3 call holds: gc mode's (a warp a
// unit), conv mode's (a warpgroup a unit), the prep's (a CTA).
inline int k3_brows(const K3Cfg& c, int n, int h, int w) {
  const int gc = CONS_WARPS * n * cdiv(h, c.gc_rows) * cdiv(w, c.gc_tw);
  const int cv = 2 * cdiv(n, c.cv_fr) * cdiv(h, c.cv_rows) * cdiv(w, c.cv_tw);
  const int m = gc > cv ? gc : cv;
  return m > TGRID ? m : TGRID;
}

// Launch arguments of a 3x3 conv over NHWC (n, h, w) frames storing NHWC
// at (pixel stride sp) into out.
inline Args conv_args(const float* mat, long long lo_off, const float* bias, float* out, int n, int h, int w,
                      int cin, int cout, int cout_pad, int epi, int fr, int rows, int tw, long long sp) {
  Args a = {};
  a.wt = mat;
  a.lo_off = lo_off;
  a.bias = bias;
  a.out = out;
  a.tg = n;
  a.sg = 0;
  a.sp = sp;
  a.sr = w * sp;
  a.st = (long long)h * w * sp;
  a.n = n;
  a.h = h;
  a.w = w;
  a.cin = cin;
  a.cout = cout;
  a.cout_pad = cout_pad;
  a.epi = epi;
  a.fr = fr;
  a.rows = rows;
  a.tw = tw;
  a.r0 = 0;
  a.r1 = h;
  a.rs = 1.0f;
  return a;
}
inline void set_r(Args& a, const float* r, int h, int w, long long sp) {
  a.r = r;
  a.r_sn = (long long)h * w * sp;
  a.r_sy = w * sp;
  a.r_sx = sp;
}

#define FT_TRY(call)           \
  do {                         \
    const int e_ = (call);     \
    if (e_ != 0) return e_;    \
  } while (0)

// One RRDB's backward (18 launches): cats[j] RDB j's dense concat (x_j and
// x1..x4, NHWC (n, h, w, 192)) as K1's f32 route kept it, g (NHWC 64) the
// RRDB's output cotangent, mats the three RDBs' pull matrices (PULLS_F32
// each), dx (NHWC 64), grads 3 x RDB_GRADS_F32 (ops/rrdb_bwd.py:flat_grads
// order), scratch k3_carve's floats.
inline int rrdb_backward_tf32(const float* const cats[3], const float* g, const float* mats, float* dx,
                              float* grads, float* scratch, const K3Cfg& c, int n, int h, int w,
                              cudaStream_t stream) {
  if (n < 1 || h < 1 || w < 1 || c.ks < 1 || c.ks > 65535 || c.cv_nh != 2) return (int)cudaErrorInvalidValue;
  const long long px = (long long)n * h * w;
  if (c.gc_rows < 1 || c.gc_tw < 1 || c.cv_fr < 1 || c.cv_rows < 1 || c.cv_tw < 1) return (int)cudaErrorInvalidValue;
  const int br = k3_brows(c, n, h, w);
  const K3Scratch s = k3_carve(scratch, px, c.ks, br);
  K3Red red = {};
  red.ks = c.ks;
  red.bstride = br;
  const int pgrid = thin_grid(prep_kernel, 0);
  prep_kernel<<<pgrid, 256, 0, stream>>>(g, s.d[2], s.bpart + (size_t)(5 * 2 + 4) * br * PART_ROW, px);
  FT_TRY((int)cudaGetLastError());
  red.brows[5 * 2 + 4] = pgrid;
  for (int j = 2; j >= 0; --j) {
    const float* mat = mats + j * PULLS_F32;
    float* d = s.d[j];
    for (int sidx = 4; sidx >= 1; --sidx) {  // pull s: gc mode over D[32 s:], masked by x_s
      const int slot = 5 * j + sidx - 1;
      Args a = conv_args(mat + pull_off(sidx), pull_size(sidx) / 2, nullptr, d + 32 * (sidx - 1), n, h, w,
                         192 - 32 * sidx, GC_N, 3 * GC_N, EPI_MASK, 1, c.gc_rows, c.gc_tw, 192);
      set_r(a, cats[j] + 64 + 32 * (sidx - 1), h, w, 192);
      a.part = s.bpart + (size_t)slot * br * PART_ROW;
      FT_TRY(launch(d + 32 * sidx, a, 3, 1, GC, h, 192, px / n * 192, stream, &red.brows[slot]));
    }
    // Pull 0: d = rs r + conv(D) (+ g), 0.2 d into the next RDB's D[128:].
    Args a = conv_args(mat, pull_size(0) / 2, nullptr, j == 0 ? dx : s.dt[j - 1], n, h, w, 192, 64, 128,
                       EPI_DX, c.cv_fr, c.cv_rows, c.cv_tw, 64);
    set_r(a, j == 2 ? g : s.dt[j], h, w, 64);
    a.rs = j == 2 ? 0.2f : 1.0f;
    if (j == 0) {
      a.r2 = g;
      a.r2_sn = a.r_sn;
      a.r2_sy = a.r_sy;
      a.r2_sx = a.r_sx;
    } else {
      a.out2 = s.d[j - 1] + 128;
      a.o2_sn = px / n * 192;
      a.o2_sy = (long long)w * 192;
      a.o2_sx = 192;
      a.part = s.bpart + (size_t)(5 * (j - 1) + 4) * br * PART_ROW;
    }
    int rows = 0;
    FT_TRY(launch(d, a, 3, 2, CONV, h, 192, px / n * 192, stream, &rows));
    if (j > 0) red.brows[5 * (j - 1) + 4] = rows;
  }
  // The 15 convs' weight grads: job (RDB j, unit u), D[j]'s 64-channel block
  // against a 32-channel slice of cats[j].
  WgParams P = {};
  for (int j = 0; j < 3; ++j) {
    FT_TRY(map_cot(&P.maps[j], s.d[j], 192, w, h, n, 192));
    FT_TRY(map_src(&P.maps[3 + j], cats[j], 192, w, h, n, 192));
    for (int u = 0; u < K3_UNITS; ++u) {
      const K3Unit un = k3_unit(u);
      const int jb = j * K3_UNITS + u;
      P.jobs[jb] = job(j, 3 + j, 3, 0, 0, 0, 0, 64 * un.mb, un.ch, n, h, w, c.ks, jb * c.ks);
    }
  }
  P.njobs = 3 * K3_UNITS;
  P.items = P.njobs * c.ks;
  P.part = s.wpart;
  if ((long long)n * h * ((w + WG_TW - 1) / WG_TW) < c.ks || n > 65535 || h > 65535 || w > 65535)
    return (int)cudaErrorInvalidValue;
  FT_TRY(wgrad_launch(P, cw::sm_count(), stream));
  k3_reduce_kernel<<<K3_WCTAS + 2 * 15, 256, 0, stream>>>(s.wpart, s.bpart, grads, red);
  return (int)cudaGetLastError();
}
constexpr int K3_LAUNCHES = 1 + 3 * 5 + 1 + 1;

// ---- K6 ----
// Its grads (ops/tail_bwd.py:PARAM_NAMES order): up1 w, b, up2 w, b, hr w,
// b, last w, b.
constexpr int T6_W = 64 * 64 * 9, T6_LW = 3 * 64 * 9;
constexpr int T6_UP1 = 0, T6_UP2 = T6_W + 64, T6_HR = 2 * (T6_W + 64), T6_LAST = 3 * (T6_W + 64);
constexpr int T6_GRADS = T6_LAST + T6_LW + 3;

struct K6Red {
  int ks[3], item0[3];    // hr_conv's, upconv2's, upconv1's jobs
  int brows[3], bstride;  // bias partial rows: hr_b (conv_last's adjoint), up2_b, up1_b; a slot's rows
  int lrows;              // conv_last's weight-grad rows
};

// K6's reduce: CTAs [0, T6_WCTAS) one weight of upconv1, upconv2, hr_conv
// a thread (ordered tap, output, input channel, so a warp reads 32
// consecutive floats of a slot), then 2 CTAs for each bias (hr_b, up2_b,
// up1_b) and the CTAs of conv_last's weight and bias grads.
constexpr int T6_WCTAS = 3 * T6_W / 256, T6_LCTAS = (T6_LW + 3 + 31) / 32;

__global__ void __launch_bounds__(256) k6_reduce_kernel(const float* wpart, const float* bpart,
                                                         const float* lpart, float* grads, const K6Red r) {
  const int bid = blockIdx.x;
  if (bid >= T6_WCTAS + 6) {  // conv_last's weight and bias grads: the thin kernel's rows
    const int c0 = 32 * (bid - T6_WCTAS - 6);
    rows_sum32(lpart, LW_ROW, r.lrows, c0, T6_LW + 3, grads + T6_LAST + c0, 1);
    return;
  }
  if (bid >= T6_WCTAS) {  // a bias (hr_b, up2_b, up1_b): its launch's partial rows
    const int kind = (bid - T6_WCTAS) / 2, o0 = 32 * ((bid - T6_WCTAS) % 2);
    const int off = kind == 0 ? T6_HR : kind == 1 ? T6_UP2 : T6_UP1;
    rows_sum32(bpart + (size_t)kind * r.bstride * PART_ROW, PART_ROW, r.brows[kind], o0, 64,
               grads + off + T6_W + o0, 1);
    return;
  }
  const int i = bid * 256 + threadIdx.x, cv = i / T6_W, le = i % T6_W;  // cv: 0 upconv1, 1 upconv2, 2 hr_conv
  const int kind = 2 - cv;                                                  // index into r: 0 hr, 1 up2, 2 up1
  const int tap = le / 4096, o = le / 64 % 64, c = le % 64, ki = tap / 3, kj = tap % 3, half = c / 32, cl = c % 32;
  const int nk = TF32_PLANT == 7 && r.ks[kind] > 1 ? r.ks[kind] - 1 : r.ks[kind];
  float v = 0.0f;
  if (kind == 0) {
    const int item0 = r.item0[0] + half * r.ks[0];
    for (int k = 0; k < nk; ++k) v += wpart[(size_t)(item0 + k) * WG_SLOT + (tap * 64 + o) * 32 + cl];
  } else {  // the fold-back: phase (a, b)'s tap (ti, tj) at (ki, kj) of the 3x3 kernel
    for (int ph = 0; ph < 4; ++ph) {
      const int pa = ph >> 1, pb = ph & 1;
      const int ti = ((pa + ki + 1) >> 1) - pa, tj = ((pb + kj + 1) >> 1) - pb;
      const int item0 = r.item0[kind] + (2 * ph + half) * r.ks[kind];
      float sp = 0.0f;
      for (int k = 0; k < nk; ++k)
        sp += wpart[(size_t)(item0 + k) * WG_SLOT + ((3 * ti + tj) * 64 + o) * 32 + cl];
      v += sp;
    }
  }
  grads[cv * (T6_W + 64) + o * 576 + c * 9 + tap] = v;
}

// Scratch of one K6 call, in floats.
struct K6Scratch {
  float *h1, *h2, *h3, *dp2, *dp1, *wpart, *bpart, *lpart;
  long long floats;
};
inline K6Scratch k6_carve(float* base, int n, int h, int w, int items, int br) {
  K6Scratch s;
  long long off = 0;
  auto take = [&](long long k) {
    float* p = base == nullptr ? nullptr : base + off;
    off += (k + 63) / 64 * 64;
    return p;
  };
  const long long lo = (long long)n * h * w * 64;
  s.h1 = take(4 * lo);
  s.h2 = take(16 * lo);
  s.h3 = take(16 * lo);  // becomes hr_conv's dP (conv_last's adjoint, in place)
  s.dp2 = take(16 * lo);
  s.dp1 = take(4 * lo);
  s.wpart = take((long long)items * WG_SLOT);
  s.bpart = take(3LL * br * PART_ROW);
  s.lpart = take((long long)TGRID * LW_ROW);
  s.floats = off;
  return s;
}

// The tiles of K6's conv launches (fr, rows, tw, nh each: upconv1 and
// upconv2 in phase mode, hr_conv and its adjoint, upconv2's and upconv1's
// adjoints) and its weight grads' K-splits (hr_conv, upconv2, upconv1).
struct K6Cfg {
  int tile[5][4];
  int ks[3];
};
inline int k6_items(const K6Cfg& c) { return 2 * c.ks[0] + 8 * c.ks[1] + 8 * c.ks[2]; }
// The rows a bias partial slot of a K6 call holds: the adjoints' (conv
// mode, a warpgroup a unit: tile 2 at 4h x 4w, 3 at 2h x 2w), the thin
// kernel's (a CTA).
inline int k6_brows(const K6Cfg& c, int n, int h, int w) {
  int m = TGRID;
  for (int k = 0; k < 2; ++k) {
    const int* t = c.tile[2 + k];
    const int r = 2 * cdiv(n, t[0]) * cdiv((4 * h) >> k, t[1]) * cdiv((4 * w) >> k, t[2]);
    m = r > m ? r : m;
  }
  return m;
}

// The tail's backward (10 launches): x NHWC (n, h, w, 64), g NHWC (n, 4h,
// 4w, 3); the recompute's operands (ops/tail.py:pack_tail's up1_tf32,
// up2_tf32, hr_tf32 and biases), the adjoints' (ops/tail_bwd.py:
// pack_tail_bwd_tf32: hr_conv's, and the s2d 3x3 adjoints of upconv2's and
// upconv1's 4-phase kernels, conv layout), conv_last's OIHW kernel; dx NHWC
// (n, h, w, 64), grads T6_GRADS floats.
inline int tail_backward_tf32(const float* x, const float* g, const float* const rec[6], const float* const adj[3],
                              const float* last_w, float* dx, float* grads, float* scratch, const K6Cfg& c,
                              int n, int h, int w, cudaStream_t stream) {
  if (n < 1 || h < 1 || w < 1 || 4 * h > 65535 || 4 * w > 65535) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 3; ++k)
    if (c.ks[k] < 1 || c.ks[k] > 65535) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 5; ++k)
    if (c.tile[k][0] < 1 || c.tile[k][1] < 1 || c.tile[k][2] < 1) return (int)cudaErrorInvalidValue;
  const int br = k6_brows(c, n, h, w);
  const K6Scratch s = k6_carve(scratch, n, h, w, k6_items(c), br);
  const float* srcs[3] = {x, s.h1, s.h2};
  float* outs[3] = {s.h1, s.h2, s.h3};
  for (int k = 0; k < 3; ++k) {  // the recompute: upconv1, upconv2 (phase mode), hr_conv
    const int hk = h << k, wk = w << k, up = k < 2;
    const int* t = c.tile[k < 2 ? k : 2];
    Args a = conv_args(rec[2 * k], up ? 2LL * 4 * 4 * 64 * 64 / 2 : 2LL * 9 * 128 * 64 / 2, rec[2 * k + 1],
                       outs[k], n, hk, wk, 64, up ? 256 : 64, up ? 256 : 128, EPI_LEAKY, t[0], t[1], t[2], 64);
    if (up) {  // phase mode: the output is 2h x 2w
      a.sr = 2LL * wk * 64;
      a.st = 4LL * hk * wk * 64;
      a.r1 = 2 * hk;
    }
    FT_TRY(launch(srcs[k], a, 3, t[3], up ? PHASE : CONV, hk, 64, (long long)hk * wk * 64, stream));
  }
  const int H = 4 * h, W = 4 * w;
  const long long px4 = (long long)n * H * W;
  K6Red red = {};
  red.bstride = br;
  const int lsm = 3 * (W + 2) * 16 > 4 * 27 * 64 * 4 ? 3 * (W + 2) * 16 : 4 * 27 * 64 * 4;
  if (lsm > 48 * 1024) return (int)cudaErrorInvalidValue;  // g's three rows in shared memory
  red.lrows = thin_grid(last_wgrad_kernel, lsm);
  last_wgrad_kernel<<<red.lrows, 256, lsm, stream>>>(g, s.h3, s.lpart, n, H, W);
  FT_TRY((int)cudaGetLastError());
  red.brows[0] = thin_grid(last_adj_kernel, 0);
  last_adj_kernel<<<red.brows[0], 256, 0, stream>>>(g, last_w, s.h3, s.bpart, n, H, W);
  FT_TRY((int)cudaGetLastError());
  {  // hr_conv's adjoint, masked by h2: upconv2's dP, its bias sums
    const int* t = c.tile[2];
    Args a = conv_args(adj[0], 2LL * 9 * 128 * 64 / 2, nullptr, s.dp2, n, H, W, 64, 64, 128, EPI_MASK, t[0],
                       t[1], t[2], 64);
    set_r(a, s.h2, H, W, 64);
    a.part = s.bpart + (size_t)1 * br * PART_ROW;
    FT_TRY(launch(s.h3, a, 3, t[3], CONV, H, 64, px4 / n * 64, stream, &red.brows[1]));
  }
  for (int k = 0; k < 2; ++k) {  // upconv2's (masked by h1) and upconv1's adjoints over the phase planes
    const int hk = 2 * h >> k, wk = 2 * w >> k;
    const int* t = c.tile[3 + k];
    Args a = conv_args(adj[1 + k], 2LL * 9 * 128 * 256 / 2, nullptr, k == 0 ? s.dp1 : dx, n, hk, wk, 256, 64, 128,
                       k == 0 ? EPI_MASK : EPI_NONE, t[0], t[1], t[2], 64);
    a.s2d = 1;
    if (k == 0) {
      set_r(a, s.h1, hk, wk, 64);
      a.part = s.bpart + (size_t)2 * br * PART_ROW;
    }
    FT_TRY(launch(k == 0 ? s.dp2 : s.dp1, a, 3, t[3], CONV, hk, 0, 0, stream, k == 0 ? &red.brows[2] : nullptr));
  }
  // The weight grads: hr_conv (dP at 4h x 4w against h2), upconv2 and
  // upconv1 per phase (their dP's phase planes against h1, x).
  WgParams P = {};
  FT_TRY(map_cot(&P.maps[0], s.h3, 64, W, H, n, 64));
  FT_TRY(make_map5(&P.maps[1], s.dp2, 2 * w, 2 * h, n, 64, WG_TW, 1, 1));
  FT_TRY(make_map5(&P.maps[2], s.dp1, w, h, n, 64, WG_TW, 1, 1));
  FT_TRY(map_src(&P.maps[3], s.h2, 64, W, H, n, 64));
  FT_TRY(map_src(&P.maps[4], s.h1, 64, 2 * w, 2 * h, n, 64));
  FT_TRY(map_src(&P.maps[5], x, 64, w, h, n, 64));
  int item = 0, nj = 0;
  red.item0[0] = item;
  red.ks[0] = c.ks[0];
  for (int half = 0; half < 2; ++half, item += c.ks[0])
    P.jobs[nj++] = job(0, 3, 3, 0, 0, 0, 0, 0, 32 * half, n, H, W, c.ks[0], item);
  for (int k = 1; k < 3; ++k) {
    const int hk = 4 * h >> k, wk = 4 * w >> k;
    red.item0[k] = item;
    red.ks[k] = c.ks[k];
    for (int ph = 0; ph < 4; ++ph)
      for (int half = 0; half < 2; ++half, item += c.ks[k])
        P.jobs[nj++] = job(k, 3 + k, 2, ph >> 1, ph & 1, 1, ph >> 1, 64 * (ph & 1), 32 * half, n, hk, wk, c.ks[k],
                           item);
  }
  P.njobs = nj;
  P.items = item;
  P.part = s.wpart;
  FT_TRY(wgrad_launch(P, cw::sm_count(), stream));
  k6_reduce_kernel<<<T6_WCTAS + 6 + T6_LCTAS, 256, 0, stream>>>(s.wpart, s.bpart, s.lpart, grads, red);
  return (int)cudaGetLastError();
}
constexpr int K6_LAUNCHES = 3 + 2 + 3 + 1 + 1;

}  // namespace
}  // namespace ft
