// K6: the backward of the RRDBNet tail, one call (tail_backward) of 11
// launches: the channels-last wgmma design of tail_bwd_wgmma.cuh, whose
// note holds its stages, its bound and what it does about the first
// design's limits.
//
// The first design stays beside it (tail_upconv and the bwd_* entries over
// conv_bwd.cuh, driven from ops/tail_bwd.py:tail_bwd_first_cuda) as an
// independent implementation to time the new one against on the card; no
// path of the port calls it. Over the whole batch, NCHW, 17 launches:
//   recompute  h1, h2 with upconv_kernel (tail_fwd.cuh, K4's first design)
//              and h3 = lrelu(hr_conv(h2)) with conv3x3 (conv_bwd.cuh);
//   conv_last  bias-grad sums of g; wgrad against h3; adjoint -> dh3;
//   hr_conv    prep (mask by h3) -> dP; wgrad against h2; adjoint -> dh2;
//   upconv2    prep (mask by h2); wgrad against nearest-2x(h1), read and
//              never formed; adjoint at the high resolution, then
//   upconv1    prep sums each 2x2 block (the adjoint of the nearest-2x
//              upsample) and masks by h1; wgrad against nearest-2x(x);
//              adjoint; a last prep sums the 2x2 blocks into dx (bf16);
//   reduce     the partial sums of all 8 weight and bias grads, in order.
// Its upsample-convs' grads are taken at the high resolution (9 taps a
// high-res pixel instead of the phase form's 4), conv_last's cotangent is
// padded to 32 channels for the adjoint, and f32 cotangents pass through
// device memory.
#include "tail_fwd.cuh"
#include "conv_bwd.cuh"
#include "tail_bwd_wgmma.cuh"

using cb::bf16;

// The bytes of scratch tail_backward needs for n frames of h x w.
extern "C" long long tail_backward_scratch(int n, int h, int w) {
  return tb::carve(nullptr, n, h, w).bytes;
}

// Kernel launches of one tail_backward call, and the f32 grads it writes.
extern "C" int tail_backward_launches() { return tb::LAUNCHES; }
extern "C" int tail_backward_grads() { return tb::GRADS; }

// The tail's backward (11 launches on `stream`), NHWC bf16: x (n, h, w,
// 64) the tail input, g (n, 4h, 4w, 3) the output cotangent, dx (n, h, w,
// 64). w_* / b_*: the forward's packed B operands and f32 biases of
// upconv1, upconv2, hr_conv (ops/tail.py:pack_tail: up{1,2}_wg, hr_wg);
// a_*: the adjoints' B operands (ops/tail_bwd.py:pack_tail_bwd). grads:
// tail_backward_grads() f32, the grads of ops/tail_bwd.py:PARAM_NAMES in
// order (kernels OIHW); scratch: tail_backward_scratch(n, h, w) bytes.
// Returns the first CUDA error code.
extern "C" int tail_backward(const void* x, const void* g, const void* w_up1, const void* b_up1,
                             const void* w_up2, const void* b_up2, const void* w_hr,
                             const void* b_hr, const void* a_hr, const void* a_up2,
                             const void* a_up1, const void* a_last, void* dx, void* grads,
                             void* scratch, int n, int h, int w, void* stream) {
  const void* fw[3] = {w_up1, w_up2, w_hr};
  const void* fb[3] = {b_up1, b_up2, b_hr};
  return tb::backward(static_cast<const bf16*>(x), static_cast<const bf16*>(g), fw, fb,
                      static_cast<const bf16*>(a_hr), static_cast<const bf16*>(a_up2),
                      static_cast<const bf16*>(a_up1), static_cast<const bf16*>(a_last),
                      static_cast<bf16*>(dx), static_cast<float*>(grads), scratch, n, h, w,
                      static_cast<cudaStream_t>(stream));
}

// The first design. As upconv_forward (csrc/tail.cu): nearest-2x upsample
// + 3x3 conv + bias + lrelu in the 4-phase form.
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
