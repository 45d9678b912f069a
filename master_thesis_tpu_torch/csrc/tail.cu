// K4: the RRDBNet tail, (N, 64, h, w) -> (N, 3, 4h, 4w), in three
// launches; K5: the same per row band, with row windows. The kernels,
// their design note and bound are in tail_fwd.cuh.
#include "tail_fwd.cuh"

// x: (n, 64, h, w) bf16 NCHW; w: 4 phases of (4 * 64, 64) bf16 matrices,
// rows (tap, channel), each in fragment order; bias: 64 f32;
// out: (n, 64, 2 * rows, 2w), the input rows [r0, r0 + rows) upsampled.
extern "C" int upconv_forward(const void* x, const void* w, const void* bias, void* out, int n,
                              int h, int w_img, int r0, int rows, void* stream) {
  return tail::upconv(x, w, bias, out, n, h, w_img, stream, r0, rows);
}

// x: (n, 64, h, w) bf16 NCHW; w_hr: (9 * 64, 64) and w_last: (9 * 64, 16)
// (outputs 3..15 zero), rows (tap, channel), in fragment order; out:
// (n, 3, oh, w) bf16, whose rows [o0, o0 + nq) receive hr_conv + conv_last
// of the input rows [q0, q0 + nq).
extern "C" int hr_last_forward(const void* x, const void* w_hr, const void* b_hr,
                               const void* w_last, const void* b_last, void* out, int n, int h,
                               int w_img, int q0, int nq, int o0, int oh, void* stream) {
  return tail::hr_last(x, w_hr, b_hr, w_last, b_last, out, n, h, w_img, q0, nq, o0, oh, stream);
}
