// K3: the backward of one RRDB of the CHN trunk.
//
// Replaces: master_thesis_tpu/ops/pallas_rrdb.py:rrdb_bwd_pallas (body
// _rrdb_bwd_kernel / _rdb_bwd_block), which per frame recomputes the RRDB
// in VMEM, sweeps rdb3, rdb2, rdb1 in reverse and writes dx and per-frame
// dW / db that XLA sums over the frames.
//
// Here the same computation is a chain of launches over the whole batch
// (the layered design; ops/rrdb_bwd.py drives it):
//   recompute  rdb_kernel<true> (rdb_fwd.cuh, K1 writing x1..x4) for rdb1,
//              rdb2, rdb3: their inputs and hidden activations;
//   per RDB, conv5 .. conv1 (conv_bwd.cuh):
//     prep     dP_t = mask(d) in bf16, bias-grad partial sums: d is 0.2 x
//              the RDB's output cotangent for conv5, else the f32 source
//              cotangent of x_t, masked by the sign of x_t;
//     wgrad    dW_t against cat(x, x1..x_{t-1}), partial sums over pixels;
//     adjoint  cat(x, x1..x_{t-1})'s cotangent += conv3x3(dP_t, W_t
//              transposed and flipped), f32; conv1's epilogue forms the
//              RDB's input cotangent g_out + dsrc[x] (f32) and, for rdb1,
//              the RRDB's dx = bf16(that + g);
//     reduce   the partial sums of the RDB's 5 dW and 5 db, in order.
// 3 + 3 x 16 = 51 launches per RRDB. Rounding as _rdb_bwd_block: dP in
// bf16 before every product, f32 source cotangents and cotangents between
// the RDBs of an RRDB, bf16 between RRDBs, f32 dW / db.
//
// Bound on an H100 SXM (train step: 8 frames at 64x64 per RRDB): the
// adjoint convs and the weight grads are each one forward's dense 3x3
// operations (47 GFLOP per RRDB), plus the forward recompute (47 more): 141
// GFLOP, 0.143 ms at 989 TFLOP/s bf16; bytes (x, g in, dx out, the weights
// and their grads) about 13 MB, 0.004 ms. So it is bound by operations,
// and every product runs on bf16 tensor cores. Against that bound this
// first version pays for: the K1 halo recompute (1.8x), intermediates
// through device memory between launches (the f32 source cotangents, 3 x 4
// bytes x 192 channels per pixel and RDB), and partial sums of the weight
// grads (64 K-splits) reduced in a second pass. Fusing an RDB's backward
// over halo tiles is later work.
#include "rdb_fwd.cuh"
#include "conv_bwd.cuh"

using cb::bf16;

// As rdb_forward (csrc/rrdb.cu), also writing x1..x4 to hidden, (n, 128, h,
// w) bf16.
extern "C" int rdb_forward_hidden(const void* x, const void* res, const void* w, const void* b,
                                  void* out, void* hidden, int n, int h, int w_img,
                                  void* stream) {
  return rdb::launch<true>(x, res, w, b, out, hidden, n, h, w_img, stream);
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

// The adjoint of RDB conv t: cin = out_t (the cotangent's channels), cout =
// the conv's input width; mode 0 (OUT_F32) or, for conv1, 2 (OUT_RRDB_DX).
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
  CONV(64, 192, cb::OUT_F32)
  CONV(32, 160, cb::OUT_F32)
  CONV(32, 128, cb::OUT_F32)
  CONV(32, 96, cb::OUT_F32)
  CONV(32, 64, cb::OUT_RRDB_DX)
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
  if (up) return (int)cudaErrorInvalidValue;
  if (coutp == 32)
    return cb::wgrad<32, false>(a, ca, b, cb_, cin, d, d_cs, cout_real, p, pstride, poff, n, h, w,
                                ks, s);
  if (coutp == 64)
    return cb::wgrad<64, false>(a, ca, b, cb_, cin, d, d_cs, cout_real, p, pstride, poff, n, h, w,
                                ks, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int bwd_reduce(const void* partial, int rows, long long cols, void* out,
                          void* stream) {
  return cb::reduce(static_cast<const float*>(partial), rows, cols, static_cast<float*>(out),
                    static_cast<cudaStream_t>(stream));
}
