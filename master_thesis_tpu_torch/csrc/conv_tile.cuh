// Shared pieces of the port's conv kernels: halo tiles in shared memory
// and 3x3 (or 2x2) convs over them as implicit GEMMs on bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulation).
//
// A tile is stored pixel-major: pixel p of a tile `cols` wide sits at
// buf[p * CP + c], channels contiguous. CP is the channel count padded by
// 8 (16 bytes), so the 8 pixel rows an ldmatrix reads fall in 8 different
// groups of 4 shared-memory banks. A conv tap (ky, kx) of an output pixel
// p reads pixel p + ky * cols + kx (relative to the top-left tap), so 16
// consecutive output pixels form one 16-row A operand; the weights are the
// B operand, a (taps * CIN, N) matrix with rows ordered (tap, channel),
// pre-packed in fragment order (master_thesis_tpu_torch/ops/fragments.py)
// so each lane fetches the B fragments of two n8 tiles in one 16-byte load.
//
// Sixteen consecutive pixels may wrap from one tile row to the next; the
// kernels place such M-tiles so that every wrapped output lies outside the
// region later stages read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace ct {

using bf16 = __nv_bfloat16;

// Zeroes `bytes` (a multiple of 16) of shared memory with the whole block.
__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) q[i] = make_uint4(0, 0, 0, 0);
}

// Copies rows [gy0, gy0 + rows) x cols [gx0, gx0 + cols) of channels [0, C)
// of one NCHW bf16 frame (C x H x W) into a pixel-major tile with channel
// stride CP. Pixels outside the frame are stored as zero: the conv's zero
// padding. Each step of a thread gathers 8 channels of one pixel (8 loads
// that neighbouring threads make on neighbouring pixels) and stores them
// as one 16-byte word. C is a multiple of 8.
template <int CP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int C,
                                          int H, int W, int gy0, int gx0, int rows, int cols) {
  const int np = rows * cols;
  const size_t plane = (size_t)H * W;
  for (int i = threadIdx.x; i < (C / 8) * np; i += blockDim.x) {
    const int c8 = i / np, p = i - c8 * np;
    const int r = p / cols, q = p - r * cols;
    const int gy = gy0 + r, gx = gx0 + q;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const unsigned short* s =
          reinterpret_cast<const unsigned short*>(src) + 8 * c8 * plane + (size_t)gy * W + gx;
      unsigned short e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __ldg(s + j * plane);
      v = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                     e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
    }
    *reinterpret_cast<uint4*>(dst + (ptrdiff_t)p * CP + 8 * c8) = v;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j] (f32) = the KH x KW conv of the 16 tile pixels starting at
// pix + i * mstride (the top-left tap's pixel index) over channels
// [0, CIN), for n8 tile j of the 16 * NT output columns starting at column
// 16 * nb0 of the packed weights w (NB 16-column blocks in all). One warp;
// tile rows are ROW pixels wide, channels CP apart. Accumulator element r
// of lane 4 g + t is pixel g + 8 (r >> 1), column 2 t + (r & 1).
//
// The K dimension runs in steps of 16 rows, s = tap * CIN / 16 + chunk;
// the B fragments of step s sit at w + (s * NB + nb0 + nb) * 32. They come
// from L2, so the loop fetches them one step ahead into registers, two
// register sets in turn, to keep their latency off the MMA chain.
template <int CIN, int MT, int NT, int KH, int KW, int ROW, int CP, int NB>
__device__ __forceinline__ void mma_taps(float (&acc)[MT][2 * NT][4], const bf16* buf, int pix,
                                         int mstride, const uint4* __restrict__ w, int nb0,
                                         int lane) {
  constexpr int KC = CIN / 16, STEPS = KH * KW * KC;
  static_assert(STEPS % 2 == 0, "steps run in pairs");
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
  // ldmatrix.x4: lane l gives the address of A row l % 16, k-half l / 16.
  const bf16* a_lane = buf + (ptrdiff_t)(pix + (lane & 15)) * CP + (lane >> 4) * 8;
  const uint4* w_lane = w + nb0 * 32 + lane;

  auto fetch = [&](uint4 (&b)[NT], int s) {
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) b[nb] = __ldg(w_lane + ((size_t)s * NB + nb) * 32);
  };
  auto step = [&](const uint4 (&b)[NT], int s) {
    const int t = s / KC, kc = s - t * KC;
    const bf16* a_s = a_lane + (ptrdiff_t)((t / KW) * ROW + (t % KW)) * CP + kc * 16;
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], a_s + (ptrdiff_t)i * mstride * CP);
#pragma unroll
    for (int nb = 0; nb < NT; ++nb)
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][2 * nb], a[i], b[nb].x, b[nb].y);
        mma_bf16(acc[i][2 * nb + 1], a[i], b[nb].z, b[nb].w);
      }
  };

  uint4 b0[NT], b1[NT];
  fetch(b0, 0);
#pragma unroll 1
  for (int s = 0; s < STEPS; s += 2) {
    fetch(b1, s + 1);
    step(b0, s);
    if (s + 2 < STEPS) fetch(b0, s + 2);
    step(b1, s + 1);
  }
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.0f ? v : 0.2f * v; }

// Stores two channels (c, c + 1) of one pixel of a pixel-major tile.
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

}  // namespace ct

// A launcher's error code: a CUDA error, or 100000 + the CUresult of a
// failed tensor-map encode (conv3x3_wgmma.cuh).
extern "C" const char* kernel_error_string(int e) {
  if (e >= 100000) return "cuTensorMapEncodeTiled failed (code - 100000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
