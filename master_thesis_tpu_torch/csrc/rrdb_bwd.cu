// K3: the backward of one RRDB of the CHN trunk, one call (rrdb_backward)
// an RRDB: wgmma implicit GEMMs over the activations the forward kept. The
// kernels, their design note and their bound are in conv_bwd_wgmma.cuh.
//
// The first design stays beside it (rdb_forward_hidden and the bwd_*
// entries over conv_bwd.cuh, driven from ops/rrdb_bwd.py:rrdb_bwd_first)
// as an independent implementation to time the new one against on the
// card; no path of the port calls it. It recomputed rdb1..rdb3 and their
// x1..x4 with the fused first K1 design (rdb_fwd.cuh), then per RDB ran
// conv5 .. conv1 as prep (dP_t = mask(d) in bf16 and bias partials), wgrad
// (mma.sync, partial sums over pixels) and adjoint conv (f32 source
// cotangents through device memory), and a reduce: 3 + 3 x 16 = 51
// launches an RRDB, NCHW.
#include "rdb_fwd.cuh"
#include "conv_bwd.cuh"
#include "conv_bwd_wgmma.cuh"

using cb::bf16;

// The bytes of scratch rrdb_backward needs for n frames of h x w.
extern "C" long long rrdb_backward_scratch(int n, int h, int w) {
  return kb::carve(nullptr, (long long)n * h * w).bytes;
}

// One RRDB's backward (20 kernel launches on `stream`), all activations
// NHWC bf16: ins[j] rdb j+1's input (n, h, w, 64) (x, then rdb1's and
// rdb2's outputs as the forward kept them), hid[j] its x1..x4 (n, h, w,
// 128), g the RRDB's output cotangent, dx (n, h, w, 64) the input's;
// pulls the three RDBs' pull matrices (ops/fragments.py:wgmma_pull_matrix,
// sources 0..4 each); grads (3 x 239 808 f32) each RDB's conv1..conv5
// (dW OIHW, db); scratch rrdb_backward_scratch(n, h, w) bytes. Returns the
// first CUDA error code.
extern "C" int rrdb_backward(const void* x, const void* y1, const void* y2, const void* h1,
                             const void* h2, const void* h3, const void* g, const void* pulls,
                             void* dx, void* grads, void* scratch, int n, int h, int w,
                             void* stream) {
  const kb::bf16* ins[3] = {static_cast<const kb::bf16*>(x), static_cast<const kb::bf16*>(y1),
                            static_cast<const kb::bf16*>(y2)};
  const kb::bf16* hid[3] = {static_cast<const kb::bf16*>(h1), static_cast<const kb::bf16*>(h2),
                            static_cast<const kb::bf16*>(h3)};
  return kb::rrdb_backward(ins, hid, static_cast<const kb::bf16*>(g),
                           static_cast<const kb::bf16*>(pulls), static_cast<kb::bf16*>(dx),
                           static_cast<float*>(grads), scratch, n, h, w,
                           static_cast<cudaStream_t>(stream));
}

// Kernel launches of one rrdb_backward call.
extern "C" int rrdb_backward_launches() { return kb::LAUNCHES; }

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
