// K4: the RRDBNet tail, (N, 64, h, w) -> (N, 3, 4h, 4w), in three
// launches. The kernels, their design note and bound are in tail_fwd.cuh.
#include "tail_fwd.cuh"

// x: (n, 64, h, w) bf16 NCHW; w: 4 phases of (4 * 64, 64) bf16 matrices,
// rows (tap, channel), each in fragment order; bias: 64 f32;
// out: (n, 64, 2h, 2w).
extern "C" int upconv_forward(const void* x, const void* w, const void* bias, void* out, int n,
                              int h, int w_img, void* stream) {
  return tail::upconv(x, w, bias, out, n, h, w_img, stream);
}

// x: (n, 64, h, w) bf16 NCHW; w_hr: (9 * 64, 64) and w_last: (9 * 64, 16)
// (outputs 3..15 zero), rows (tap, channel), in fragment order; out:
// (n, 3, h, w) bf16.
extern "C" int hr_last_forward(const void* x, const void* w_hr, const void* b_hr,
                               const void* w_last, const void* b_last, void* out, int n, int h,
                               int w_img, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(hr_last_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)HL_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((w_img + HL_TW - 1) / HL_TW, (h + HL_TH - 1) / HL_TH, n);
  hr_last_kernel<<<grid, NTHREAD, HL_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const uint4*>(w_hr),
      static_cast<const float*>(b_hr), static_cast<const uint4*>(w_last),
      static_cast<const float*>(b_last), static_cast<bf16*>(out), h, w_img);
  return (int)cudaGetLastError();
}
