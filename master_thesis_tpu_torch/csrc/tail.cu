// K4: the RRDBNet tail, (N, h, w, 64) -> (N, 4h, 4w, 3) channels-last, in
// four wgmma launches (tail_wgmma.cuh); K5: the same per row band, with row
// windows. The kernels, their design note and bound are in tail_wgmma.cuh.
//
// upconv_forward / hr_last_forward keep the first design (tail_fwd.cuh:
// three mma.sync launches, NCHW) as an independent implementation to time
// the new one against on the card; the first K6 design (tail_bwd.cu)
// recomputes with its upconv_kernel.
#include "tail_fwd.cuh"
#include "tail_wgmma.cuh"

// x: (n, h, w, 64) bf16 NHWC; w_*: the stages' B operands packed for wgmma
// (ops/tail.py:pack_tail: up{1,2}_wg, hr_wg, last_wg), b_*: f32 biases.
// Computes the input rows [lo, hi) (R = hi - lo): upconv1 into h13 as h1,
// (n, 2R, 2w, 64); upconv2 into h2, (n, 4R, 4w, 64); hr_conv into h13 as
// h3, (n, 4R, 4w, 64), over h1 once upconv2 has read it; conv_last of h3's
// rows [q0, q0 + nq) into out, (n, 4h, 4w, 3) NHWC, at rows o0.. (the full
// frame: lo 0, hi h, q0 0, nq 4h, o0 0). Four launches on `stream`;
// returns the first CUDA error code.
extern "C" int tail_forward(const void* x, const void* w_up1, const void* b_up1, const void* w_up2,
                            const void* b_up2, const void* w_hr, const void* b_hr,
                            const void* w_last, const void* b_last, void* h13, void* h2, void* out,
                            int n, int h, int w_img, int lo, int hi, int q0, int nq, int o0,
                            void* stream) {
  if (lo < 0 || hi > h || lo >= hi) return (int)cudaErrorInvalidValue;
  const int r = hi - lo;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = tw::stage(0, x, w_up1, b_up1, h13, n, h, w_img, lo, hi, 2 * r, 0, s);
  if (e == 0) e = tw::stage(1, h13, w_up2, b_up2, h2, n, 2 * r, 2 * w_img, 0, 2 * r, 4 * r, 0, s);
  if (e == 0) e = tw::stage(2, h2, w_hr, b_hr, h13, n, 4 * r, 4 * w_img, 0, 4 * r, 4 * r, 0, s);
  if (e == 0)
    e = tw::stage(3, h13, w_last, b_last, out, n, 4 * r, 4 * w_img, q0, q0 + nq, 4 * h, o0, s);
  return e;
}

// One stage k of tail_forward alone (0 upconv1, 1 upconv2, 2 hr_conv, 3
// conv_last) over the input rows [ylo, yhi) of x, (n, h_in, w_in, 64) NHWC,
// into out with oh rows, input row ylo's outputs at row o0. For timing each
// launch against its floor.
extern "C" int tail_stage(int k, const void* x, const void* w, const void* b, void* out, int n,
                          int h_in, int w_in, int ylo, int yhi, int oh, int o0, void* stream) {
  return tw::stage(k, x, w, b, out, n, h_in, w_in, ylo, yhi, oh, o0,
                   static_cast<cudaStream_t>(stream));
}

// The first design. x: (n, 64, h, w) bf16 NCHW; w: 4 phases of (4 * 64, 64)
// bf16 matrices, rows (tap, channel), each in fragment order; bias: 64
// f32; out: (n, 64, 2 * rows, 2w), the input rows [r0, r0 + rows)
// upsampled.
extern "C" int upconv_forward(const void* x, const void* w, const void* bias, void* out, int n,
                              int h, int w_img, int r0, int rows, void* stream) {
  return tail::upconv(x, w, bias, out, n, h, w_img, stream, r0, rows);
}

// The first design. x: (n, 64, h, w) bf16 NCHW; w_hr: (9 * 64, 64) and
// w_last: (9 * 64, 16) (outputs 3..15 zero), rows (tap, channel), in
// fragment order; out: (n, 3, oh, w) bf16, whose rows [o0, o0 + nq) receive
// hr_conv + conv_last of the input rows [q0, q0 + nq).
extern "C" int hr_last_forward(const void* x, const void* w_hr, const void* b_hr,
                               const void* w_last, const void* b_last, void* out, int n, int h,
                               int w_img, int q0, int nq, int o0, int oh, void* stream) {
  return tail::hr_last(x, w_hr, b_hr, w_last, b_last, out, n, h, w_img, q0, nq, o0, oh, stream);
}
