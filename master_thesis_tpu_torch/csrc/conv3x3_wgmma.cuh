// K1 / K2: the five dense 3x3 convs of one residual dense block (RDB) of the
// CHN trunk, each as an implicit GEMM on Hopper's warpgroup MMA (wgmma)
// with TMA-fed tiles.
//
// Replaces: master_thesis_tpu/ops/pallas_rrdb.py:rrdb_pallas (K1, body
// _rrdb_kernel / _rdb_fwd_block: a whole RRDB per frame in VMEM) and
// rrdb_trunk_pallas_banded (K2, body _rdb_band_kernel: one RDB per row band
// with a 5-row halo).
//
// Computes, per RDB, on NHWC bf16 x (64 channels):
//   x_k = lrelu(conv_k(cat(x, x1..x_{k-1})) + b_k)   k = 1..4, 32 channels
//   y   = 0.2 * (conv_5(cat(x, x1..x4)) + b_5) + x   rounded to bf16
//   out = res ? 0.2 * y + res : y                    (the RRDB residual)
// Operands bf16, sums / bias / lrelu in f32, x1..x4 rounded to bf16 (the
// rounding of ops/rrdb.py:rdb_plain). x1..x4 live in one scratch tensor h,
// NHWC with 128 channels, x_k in channels [32 (k - 1), 32 k).
//
// Bound on an H100 SXM at the serving shape (80 frames at 64x64): one RDB
// is 157 GFLOP at the dense 3x3 convs, 0.159 ms at 989 TFLOP/s bf16. Per
// conv, max(operations, bytes if every byte went to device memory) is
// 18.8 / 25.0 / 31.3 / 37.6 / 73.3 us for conv1..conv5: 186 us an RDB, so
// unfused convs cost 1.17x the fused bound in the worst case, and L2 hits
// lower that.
//
// Design: one launch per conv, M = output pixels, N = 32 (conv1-4) or 64
// (conv5), K = 9 taps x Cin, in K-chunks of 32 input channels (chunks 0-1
// from x, chunk j >= 2 from h's slot j - 2). A tile is ROWS output rows x
// 64 pixels; a warpgroup owns RPW of its rows (one m64 wgmma tile a row),
// a CTA holds WG consumer warpgroups and one producer warp, and walks the
// tiles b, b + grid, ... (as many CTAs as fit the card at once). Per chunk
// the producer loads, into a ring stage guarded by mbarriers:
//   A: the tile's input, (ROWS + 2) x 66 pixels x 32 channels, by four
//      TMA loads (one per 8-channel group) from NHWC tensor maps. TMA's
//      out-of-bounds zero fill is the conv's zero padding at the frame
//      border and past a ragged row end. Each group lands as its own plane,
//      pixel after pixel, 16 bytes each: wgmma's no-swizzle core-matrix
//      layout with 128 bytes between 8-pixel groups (SBO) and one plane
//      between the two 8-channel halves of a k16 step (LBO). The nine taps
//      are nine shifted descriptors of that one tile: a one-pixel shift is
//      a 16-byte step of the start address.
//   B: the conv's weights for the chunk (9 taps x 32 channels x N), one
//      bulk copy of a block packed on the host in the descriptor's order
//      (ops/fragments.py:wgmma_conv_matrix).
// The producer runs ahead across tiles; the consumers accumulate in f32
// registers, release a stage once the wgmma group that read it has
// retired, and end each tile with an epilogue through a staging area of
// its own that stores 16-byte vectors: x_k into h, or conv5's output with
// x (and res) added, in the same rounding as rdb_plain. Defaults (from the
// sweep, PERF.md): 2 rows a warpgroup, 2 warpgroups, 3 stages for every
// conv: 149 KB (conv1-4) and 219 KB (conv5) of shared memory, one CTA an
// SM.
//
// What this does about the four limits of the fused design (rdb_fwd.cuh):
// (1) no halo recompute: a conv computes each output pixel once, reading
// x1..x4 back from L2 or device memory instead; (2) no idle warps: every
// consumer warp owns output rows of every conv; (3) wgmma with A and B
// from shared memory, fed by TMA, in place of mma.sync with B from L2;
// (4) one 200 KB block an SM with nothing to hide its latency: here the
// producer's loads of the next chunks and tiles overlap the wgmmas and
// the epilogue. What holds it now (PERF.md): every tile re-reads its
// conv's weights from L2, and a tile's epilogue is not overlapped with
// wgmmas.

// Row windows (K2): a band [r0, r1) runs conv k over the rows [r0 - (5 -
// k), r1 + (5 - k)) clipped to the frame, x read in place from the frame
// and x1..x4 in band-sized scratch; conv5 writes only the band's rows.
// Each output pixel sums the same products in the same order as in K1,
// so K2 equals K1 bit for bit.
//
// Planted faults for the checks on the card: -DRDB_PLANT=1 reads every
// tile's right halo column as zeros (a ragged row end must catch it);
// -DBAND_PLANT=1 reads x's row r0 - 1 as zeros in every band with r0 > 0.
// Tuning (master_thesis_tpu_torch/sweep_rrdb.py): -DRDB_ROWS (rows a
// warpgroup), -DRDB_WG (consumer warpgroups a CTA), -DRDB_STAGES (ring
// stages), the same for all five convs.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// The tile configuration: rows a warpgroup, consumer warpgroups a CTA, ring
// stages.
#ifndef RDB_ROWS
#define RDB_ROWS 2
#endif
#ifndef RDB_WG
#define RDB_WG 2
#endif
#ifndef RDB_STAGES
#define RDB_STAGES 3
#endif

// Everything has internal linkage: each variant of the library (tuning and
// planted-fault builds) keeps its own kernels and its own once-per-kernel
// state when several are loaded into one process.
namespace cw {
namespace {

using bf16 = __nv_bfloat16;

constexpr int NF = 64, GC = 32, HC = 4 * GC;  // x's and h's channels
constexpr int RUN = 64;                       // output pixels of an M-tile
constexpr int TW = RUN + 2;                   // tile columns
constexpr int CHUNK = 32;                     // input channels a K-chunk

__host__ __device__ constexpr int b_bytes(int n) { return 9 * CHUNK * n * 2; }

struct Cfg {
  static constexpr int RPW = RDB_ROWS, WG = RDB_WG, S = RDB_STAGES;
  static constexpr int ROWS = RPW * WG, TR = ROWS + 2;  // output / tile rows a CTA
  static constexpr int NCONS = 128 * WG, NTHREAD = NCONS + 32;
  static constexpr int PLANE = (TR * TW * 16 + 127) / 128 * 128;  // one 8-channel group
  static constexpr int A_BYTES = 4 * PLANE;
  static constexpr uint32_t A_TX = 4 * TR * TW * 16;  // bytes the four TMA boxes bring
  __host__ __device__ static constexpr int stage_bytes(int n) { return A_BYTES + b_bytes(n); }
  // The ring, the output staging area (bf16), the mbarriers.
  __host__ __device__ static constexpr int smem_bytes(int n) {
    return S * stage_bytes(n) + ROWS * RUN * (n + 8) * 2 + 2 * S * 8;
  }
};

__host__ __device__ constexpr int cin_of(int k) { return NF + (k - 1) * GC; }
__host__ __device__ constexpr int out_of(int k) { return k < 5 ? GC : NF; }
__host__ __device__ constexpr int64_t w_off(int k) {  // conv k's B in the packed RDB
  int64_t off = 0;
  for (int j = 1; j < k; ++j) off += 9 * cin_of(j) * out_of(j);
  return off;
}

struct ConvArgs {
  const bf16* w;      // this conv's packed B (nchunk blocks of 9 * 32 * N)
  const float* bias;  // N
  const bf16* x;      // the frames, NHWC (conv5 adds x)
  const bf16* res;    // conv5: the RRDB residual, NHWC, or null
  bf16* out;          // conv5: the output, NHWC; conv1-4: h
  int H, W;           // frame rows and columns
  int ylo, yhi;       // frame rows computed (and stored) by this launch
  int n0;             // first frame of x / out / res
  int frames;         // frames computed (h holds them from its frame 0)
  int h_row0;         // frame row of h's row 0
  int h_rows;         // rows of h
  int slot;           // conv1-4: first channel of x_k in h
  int nchunk;         // K-chunks: cin / 32
  int plant_row;      // BAND_PLANT: x's frame row read as zeros (-1: none)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` of the barrier has completed. A
// wait of ~10 s means a load that never lands: the kernel traps (an error
// the wrapper reports) instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma shared-memory descriptor, no swizzle: start address, LBO (the
// K-direction step between core matrices), SBO (the M / N-direction step).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int M>
__device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N f32, N / 2 registers a thread) += A (64 x 16) B (16 x N), bf16,
// A and B from shared memory. Thread
// l of warp w of the warpgroup holds, for each n8 block j, d[4 j + 2 i + e]
// = D[16 w + l / 4 + 8 i][8 j + 2 (l % 4) + e].
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ float lrelu(float v) { return v >= 0.0f ? v : 0.2f * v; }

// Zeroes one tile pixel (all four channel planes) of a ring stage.
template <int PLANE>
__device__ __forceinline__ void zero_pixel(unsigned char* stage, int pix) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
    *reinterpret_cast<uint4*>(stage + g * PLANE + pix * 16) = make_uint4(0, 0, 0, 0);
}

// One conv over the tiles of ROWS x 64 output pixels of [ylo, yhi) x W x
// frames, tile t = (frame, row group, column run) in that order from the
// slowest. CTA b takes the tiles b, b + gridDim.x, ...: the producer runs
// ahead into a CTA's next tile while the consumers store the last one.
template <int N, bool FINAL>
__global__ void __launch_bounds__(Cfg::NTHREAD)
conv_kernel(__grid_constant__ const CUtensorMap xmap, __grid_constant__ const CUtensorMap hmap,
            const ConvArgs a) {
  using C = Cfg;
  constexpr int RPW = C::RPW, S = C::S, ROWS = C::ROWS, TR = C::TR;
  constexpr int NCONS = C::NCONS, PLANE = C::PLANE, A_BYTES = C::A_BYTES;
  constexpr int STAGE = C::stage_bytes(N), B_BYTES = b_bytes(N);
  constexpr int NB8 = N / 8, P = N + 8;  // staged outputs: P bf16 a pixel
  extern __shared__ __align__(1024) unsigned char cw_smem[];
  unsigned char* smem = cw_smem;
  bf16* stg = reinterpret_cast<bf16*>(smem + S * STAGE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::smem_bytes(N) - 2 * S * 8);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int runs = (a.W + RUN - 1) / RUN, groups = (a.yhi - a.ylo + ROWS - 1) / ROWS;
  const int tiles = runs * groups * a.frames;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCONS / 32) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      int q = 0;  // chunks loaded so far, over all of this CTA's tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int x0 = (t % runs) * RUN, y0 = a.ylo + (t / runs % groups) * ROWS;
        const int n = t / (runs * groups);
        for (int c = 0; c < a.nchunk; ++c, ++q) {
          const int s = q % S, u = q / S;
          if (u > 0) mbar_wait(empty0 + 8 * s, (u - 1) & 1);
          const uint32_t full = full0 + 8 * s, dst = smem_u32(smem + s * STAGE);
          mbar_expect_tx(full, C::A_TX + B_BYTES);
          for (int g = 0; g < 4; ++g) {
            if (c < 2)
              tma_load_4d(dst + g * PLANE, &xmap, CHUNK * c + 8 * g, x0 - 1, y0 - 1, a.n0 + n,
                          full);
            else
              tma_load_4d(dst + g * PLANE, &hmap, CHUNK * (c - 2) + 8 * g, x0 - 1,
                          y0 - 1 - a.h_row0, n, full);
          }
          bulk_load(dst + A_BYTES, a.w + (size_t)c * (B_BYTES / 2), B_BYTES, full);
        }
      }
    }
    return;
  }

  const int wgi = warp >> 2, wl = warp & 3, tid = threadIdx.x;
  const int g = lane >> 2, q4 = lane & 3;
  float bias[NB8][2];
#pragma unroll
  for (int j = 0; j < NB8; ++j) {
    bias[j][0] = a.bias[8 * j + 2 * q4];
    bias[j][1] = a.bias[8 * j + 2 * q4 + 1];
  }
  int q = 0;  // chunks consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int x0 = (t % runs) * RUN, y0 = a.ylo + (t / runs % groups) * ROWS;
    const int n = t / (runs * groups);
    float acc[RPW][N / 2];
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[r][i] = 0.0f;

    for (int c = 0; c < a.nchunk; ++c, ++q) {
      const int s = q % S;
      unsigned char* stage = smem + s * STAGE;
      mbar_wait(full0 + 8 * s, (q / S) & 1);
#if defined(RDB_PLANT) || defined(BAND_PLANT)
      {
        const int tt = tid & 127;
#ifdef RDB_PLANT
        if (tt < TR) zero_pixel<PLANE>(stage, tt * TW + TW - 1);  // the right halo column
#endif
#ifdef BAND_PLANT
        const int pr = a.plant_row - (y0 - 1);
        if (c < 2 && a.plant_row >= 0 && pr >= 0 && pr < TR)
          for (int p = tt; p < TW; p += 128) zero_pixel<PLANE>(stage, pr * TW + p);
#endif
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_sync(1 + wgi, 128);
      }
#endif
      const uint32_t a_base = smem_u32(stage), b_base = a_base + A_BYTES;
#pragma unroll
      for (int r = 0; r < RPW; ++r) fence_acc(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint64_t bd = make_desc(b_base + (tap * 2 + hh) * 2 * NB8 * 128, NB8 * 128, 128);
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const int pix = (wgi * RPW + r + tap / 3) * TW + tap % 3;
            mma_ss(acc[r], make_desc(a_base + 2 * hh * PLANE + pix * 16, PLANE, 128), bd);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int r = 0; r < RPW; ++r) fence_acc(acc[r]);
      if (c > 0) mbar_arrive(empty0 + 8 * ((q - 1) % S));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < RPW; ++r) fence_acc(acc[r]);
    mbar_arrive(empty0 + 8 * ((q - 1) % S));

    // Epilogue: the outputs (ROWS x 64 pixels, bf16) through the staging
    // area, then 16-byte stores. conv1-4: lrelu(acc + b); conv5: (0.2
    // (acc + b) + x), then with res 0.2 y + res, each rounded to bf16.
    named_sync(1 + C::WG, NCONS);  // the last tile's stores have read stg
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int pix = (wgi * RPW + r) * RUN + 16 * wl + g + 8 * i;
        const int y = y0 + pix / RUN, xc = x0 + pix % RUN;
        const bool inside = y < a.yhi && xc < a.W;
        const size_t o = (((size_t)(a.n0 + n) * a.H + y) * a.W + xc) * NF;
#pragma unroll
        for (int j = 0; j < NB8; ++j) {
          const int col = 8 * j + 2 * q4;
          float v0 = acc[r][4 * j + 2 * i] + bias[j][0];
          float v1 = acc[r][4 * j + 2 * i + 1] + bias[j][1];
          if (!FINAL) {
            v0 = lrelu(v0);
            v1 = lrelu(v1);
          } else if (inside) {
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(a.x + o + col);
            v0 = __bfloat162float(__float2bfloat16(0.2f * v0 + __bfloat162float(xv.x)));
            v1 = __bfloat162float(__float2bfloat16(0.2f * v1 + __bfloat162float(xv.y)));
            if (a.res != nullptr) {
              const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(a.res + o + col);
              v0 = 0.2f * v0 + __bfloat162float(rv.x);
              v1 = 0.2f * v1 + __bfloat162float(rv.y);
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(stg + pix * P + col) = __floats2bfloat162_rn(v0, v1);
        }
      }
    named_sync(1 + C::WG, NCONS);

    for (int v = tid; v < ROWS * RUN * NB8; v += NCONS) {
      const int pix = v / NB8, c8 = v - pix * NB8;
      const int y = y0 + pix / RUN, xc = x0 + pix % RUN;
      if (y >= a.yhi || xc >= a.W) continue;
      const size_t o = FINAL ? (((size_t)(a.n0 + n) * a.H + y) * a.W + xc) * NF + 8 * c8
                             : (((size_t)n * a.h_rows + (y - a.h_row0)) * a.W + xc) * HC + a.slot +
                                   8 * c8;
      *reinterpret_cast<uint4*>(a.out + o) = *reinterpret_cast<const uint4*>(stg + pix * P + 8 * c8);
    }
  }
}

// Error codes at or above this are TENSOR_MAP_ERROR + the CUresult of a
// failed cuTensorMapEncodeTiled (conv_tile.cuh:kernel_error_string).
constexpr int TENSOR_MAP_ERROR = 100000;

// cuTensorMapEncodeTiled, from the driver through the runtime, so that the
// library links against nothing but the CUDA runtime.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
                                            : nullptr;
  }();
  return fn;
}

// An NHWC bf16 tensor (frames, rows, cols, ch) read in boxes of 8 channels
// x TW columns x box_rows rows of one frame.
inline int make_map(CUtensorMap* m, const void* base, int ch, int cols, int rows, int frames,
                    int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)ch, (cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)frames};
  const cuuint64_t strides[3] = {(cuuint64_t)ch * 2, (cuuint64_t)cols * ch * 2,
                                 (cuuint64_t)rows * cols * ch * 2};
  const cuuint32_t box[4] = {8, TW, (cuuint32_t)box_rows, 1}, estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

// The frames and rows one conv launch covers, and where its inputs live.
struct Span {
  const bf16* x;  // (n_x, H, W, 64) NHWC
  bf16* h;        // (frames, h_rows, W, 128) NHWC: x1..x4
  int n_x, H, W;
  int ylo, yhi;   // frame rows computed
  int n0, frames; // frames of x computed (h holds them from its frame 0)
  int h_row0, h_rows;
  int plant_row;
};

// Tiles of a launch over `sp` of `rows` output rows each.
inline long long tile_count(const Span& sp, int rows) {
  return (long long)((sp.W + RUN - 1) / RUN) * ((sp.yhi - sp.ylo + rows - 1) / rows) * sp.frames;
}

// Streaming multiprocessors of the current device.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

// Once per kernel: the shared-memory opt-in, then how many CTAs fit an SM
// (0 if the kernel cannot launch).
template <typename K>
inline int blocks_per_sm(K kernel, int threads, int smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return 0;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return blocks;
}

// Sums v over the 8 lanes of a warp that share lane % 4 (the accumulator
// rows of one column pair), in a fixed order.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

template <int N, bool FINAL>
inline int launch_conv(const Span& sp, ConvArgs a, cudaStream_t stream) {
  constexpr int smem = Cfg::smem_bytes(N);
  static_assert(smem <= 232448, "a CTA's shared memory exceeds 227 KB");
  // Once per kernel: the shared-memory opt-in, then how many CTAs fit an SM.
  static const int per_sm = [] {
    if (cudaFuncSetAttribute(conv_kernel<N, FINAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return 0;
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, conv_kernel<N, FINAL>, Cfg::NTHREAD,
                                                  smem);
    return blocks;
  }();
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap xm, hm;
  int e = make_map(&xm, sp.x, NF, sp.W, sp.H, sp.n_x, Cfg::TR);
  if (e == 0) e = make_map(&hm, sp.h, HC, sp.W, sp.h_rows, sp.frames, Cfg::TR);
  if (e != 0) return e;
  // As many CTAs as fit the card at once, each walking tiles.
  const long long tiles = tile_count(sp, Cfg::ROWS), cap = (long long)per_sm * sm_count();
  const int grid = (int)(tiles < cap ? tiles : cap);
  conv_kernel<N, FINAL><<<grid, Cfg::NTHREAD, smem, stream>>>(xm, hm, a);
  return (int)cudaGetLastError();
}

// Conv k (1..5) of an RDB over `sp` (conv1-4 into sp.h, conv5 into out).
// Returns the CUDA error code.
inline int conv(int k, const Span& sp, const bf16* w, const float* b, const bf16* res, bf16* out,
                cudaStream_t stream) {
  if (sp.ylo >= sp.yhi) return 0;
  ConvArgs a;
  a.w = w + w_off(k);
  a.bias = b + (k - 1) * GC;
  a.x = sp.x;
  a.res = k == 5 ? res : nullptr;
  a.out = k == 5 ? out : sp.h;
  a.H = sp.H;
  a.W = sp.W;
  a.ylo = sp.ylo;
  a.yhi = sp.yhi;
  a.n0 = sp.n0;
  a.frames = sp.frames;
  a.h_row0 = sp.h_row0;
  a.h_rows = sp.h_rows;
  a.slot = (k - 1) * GC;
  a.nchunk = cin_of(k) / CHUNK;
  a.plant_row = sp.plant_row;
  return k == 5 ? launch_conv<NF, true>(sp, a, stream) : launch_conv<GC, false>(sp, a, stream);
}

}  // namespace
}  // namespace cw
