// K6: the backward of the RRDBNet tail.
//
// Replaces: master_thesis_tpu/ops/pallas_tail.py:tail_bwd_pallas (body
// _tail_bwd_kernel), which per frame recomputes the tail in phase space in
// VMEM, runs the adjoint phase-convs of conv_last, hr_conv, upconv2 and
// upconv1 with the lrelu masks from the post-activation signs, and writes
// dx and per-frame weight grads that XLA sums and folds back through the
// 4-phase kernel's adjoint (fused_upsample_conv_kernel_adjoint).
//
// Here, over the whole batch (ops/tail_bwd.py drives it; 17 launches):
//   recompute  h1, h2 with upconv_kernel (tail_fwd.cuh, K4's) and h3 =
//              lrelu(hr_conv(h2)) with conv3x3 (conv_bwd.cuh);
//   conv_last  bias-grad sums of g; wgrad against h3; adjoint -> dh3;
//   hr_conv    prep (mask by h3) -> dP; wgrad against h2; adjoint -> dh2;
//   upconv2    prep (mask by h2); wgrad against nearest-2x(h1), read and
//              never formed; adjoint at the high resolution, then
//   upconv1    prep sums each 2x2 block (the adjoint of the nearest-2x
//              upsample) and masks by h1; wgrad against nearest-2x(x);
//              adjoint; a last prep sums the 2x2 blocks into dx (bf16);
//   reduce     the partial sums of all 8 weight and bias grads, in order.
// The upsample-convs' grads are taken at the high resolution, where a
// nearest-2x upsample then a 3x3 conv is a plain conv: their weight grads
// are the original 3x3 kernels' directly (no fold), at 9 taps per output
// pixel instead of the phase form's 4. Rounding as _tail_bwd_kernel: dP in
// bf16 before every product, f32 cotangents and sums, f32 dW / db.
//
// Bound on an H100 SXM (train step: 8 frames, 64x64 -> 256x256): the
// adjoint convs and the weight grads each cost one forward's operations,
// with the upsample-convs counted in their 4-phase form (62 GFLOP for the
// tail at 8 frames), plus the recompute of h1..h3 (60 GFLOP): 184 GFLOP,
// 0.186 ms at 989 TFLOP/s bf16; bytes (x, g in, dx out) about 11 MB. So it
// is bound by operations. This first version does the upsample-convs'
// backward at 9 taps (2.25x their phase-form count) and passes h3 and the
// f32 cotangents through device memory; the phase form and fused stages
// are later work.
#include "tail_fwd.cuh"
#include "conv_bwd.cuh"

using cb::bf16;

// As upconv_forward (csrc/tail.cu): nearest-2x upsample + 3x3 conv + bias +
// lrelu in the 4-phase form.
extern "C" int tail_upconv(const void* x, const void* w, const void* bias, void* out, int n,
                           int h, int w_img, void* stream) {
  return tail::upconv(x, w, bias, out, n, h, w_img, stream);
}

extern "C" int bwd_prep(const void* in_f, const void* in_b, float scale, int in_cs, int ci0,
                        const void* sign, int s_cs, int cs0, void* out, int o_cs, int co0,
                        void* partial, long long pstride, long long poff, int c, int n, int h,
                        int w, int pool, int ks, void* stream) {
  return cb::prep(static_cast<const float*>(in_f), static_cast<const bf16*>(in_b), scale, in_cs,
                  ci0, static_cast<const bf16*>(sign), s_cs, cs0, static_cast<bf16*>(out), o_cs,
                  co0, static_cast<float*>(partial), pstride, poff, c, n, h, w, pool, ks,
                  static_cast<cudaStream_t>(stream));
}

// hr_conv's recompute (cin 64, cout 64, mode 1: OUT_BF16_LRELU) and the
// adjoint convs (mode 0: OUT_F32): conv_last's from its 3-channel
// cotangent (cin 32, cin_real 3) and the 64-channel others.
extern "C" int bwd_conv(int cin, int cout, int mode, const void* in, int in_cs, int cin_real,
                        const void* w, const void* bias, void* acc_f32, int out_cs,
                        int accumulate, void* out_f32, void* out_bf16, const void* gout,
                        const void* gres, int n, int h, int w_img, void* stream) {
  const bf16* i = static_cast<const bf16*>(in);
  const uint4* wt = static_cast<const uint4*>(w);
  const float* bs = static_cast<const float*>(bias);
  float* acc = static_cast<float*>(acc_f32);
  float* of = static_cast<float*>(out_f32);
  bf16* ob = static_cast<bf16*>(out_bf16);
  const float* go = static_cast<const float*>(gout);
  const bf16* gr = static_cast<const bf16*>(gres);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV(CI, CO, MODE)                                                                     \
  if (cin == CI && cout == CO && mode == MODE)                                                 \
    return cb::conv3x3<CI, CO, MODE>(i, in_cs, cin_real, wt, bs, acc, out_cs, accumulate, of, \
                                     ob, go, gr, n, h, w_img, s);
  CONV(64, 64, cb::OUT_BF16_LRELU)
  CONV(64, 64, cb::OUT_F32)
  CONV(32, 64, cb::OUT_F32)
#undef CONV
  return (int)cudaErrorInvalidValue;
}

extern "C" int bwd_wgrad(int coutp, int up, const void* src_a, int ca, const void* src_b, int cb_,
                         int cin, const void* dp, int d_cs, int cout_real, void* partial,
                         long long pstride, long long poff, int n, int h, int w, int ks,
                         void* stream) {
  const bf16* a = static_cast<const bf16*>(src_a);
  const bf16* b = static_cast<const bf16*>(src_b);
  const bf16* d = static_cast<const bf16*>(dp);
  float* p = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coutp == 16 && !up)
    return cb::wgrad<16, false>(a, ca, b, cb_, cin, d, d_cs, cout_real, p, pstride, poff, n, h, w,
                                ks, s);
  if (coutp == 64 && !up)
    return cb::wgrad<64, false>(a, ca, b, cb_, cin, d, d_cs, cout_real, p, pstride, poff, n, h, w,
                                ks, s);
  if (coutp == 64 && up)
    return cb::wgrad<64, true>(a, ca, b, cb_, cin, d, d_cs, cout_real, p, pstride, poff, n, h, w,
                               ks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bwd_reduce(const void* partial, int rows, long long cols, void* out,
                          void* stream) {
  return cb::reduce(static_cast<const float*>(partial), rows, cols, static_cast<float*>(out),
                    static_cast<cudaStream_t>(stream));
}
