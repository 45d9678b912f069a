// K1: one residual dense block (RDB) of the CHN trunk as five implicit-GEMM
// convs on wgmma; K2: the same over one row band of every frame. The kernel,
// its design note and its bound are in conv3x3_wgmma.cuh.
//
// rdb_forward_tiles keeps the first design (rdb_fwd.cuh: one fused RDB per
// 8x16 tile, NCHW) as an independent implementation to time and check the
// new one against on the card; no path of the port calls it.
#include "conv3x3_wgmma.cuh"
#include "rdb_fwd.cuh"

namespace {

// The frame rows [lo, hi) conv k computes for the band [r0, r1) of a frame
// of h rows (ops/rrdb.py:band_windows): widened by the 5 - k convs after it.
int window_lo(int k, int r0) { return r0 - (5 - k) > 0 ? r0 - (5 - k) : 0; }
int window_hi(int k, int r1, int h) { return r1 + (5 - k) < h ? r1 + (5 - k) : h; }

cw::Span span(const void* x, void* hbuf, int n, int h, int w_img) {
  cw::Span sp;
  sp.x = static_cast<const cw::bf16*>(x);
  sp.h = static_cast<cw::bf16*>(hbuf);
  sp.n_x = n;
  sp.H = h;
  sp.W = w_img;
  sp.ylo = 0;
  sp.yhi = h;
  sp.n0 = 0;
  sp.frames = n;
  sp.h_row0 = 0;
  sp.h_rows = h;
  sp.plant_row = -1;
  return sp;
}

}  // namespace

// x, res, out: (n, h, w, 64) bf16 NHWC (res may be null); w: the RDB packed
// for wgmma (ops/fragments.py:wgmma_conv_matrix, conv1..conv5); b: 192 f32
// biases; hbuf: scratch for x1..x4, (n, h, w, 128) bf16 NHWC. Launches 5
// kernels on `stream`; returns the first CUDA error code.
extern "C" int rdb_forward(const void* x, const void* res, const void* w, const void* b,
                           void* out, void* hbuf, int n, int h, int w_img, void* stream) {
  const cw::Span sp = span(x, hbuf, n, h, w_img);
  int e = 0;
  for (int k = 1; k <= 5 && e == 0; ++k)
    e = cw::conv(k, sp, static_cast<const cw::bf16*>(w), static_cast<const float*>(b),
                 static_cast<const cw::bf16*>(res), static_cast<cw::bf16*>(out),
                 static_cast<cudaStream_t>(stream));
  return e;
}

// As rdb_forward over the frame rows [r0, r1) only (K2: one band a call):
// conv k runs over the rows [r0 - (5 - k), r1 + (5 - k)) within the frame,
// x1..x4 in hbuf, (n, hi - lo, w, 128) bf16 NHWC for conv1's window [lo,
// hi); rows of `out` outside the band are left as they are.
extern "C" int rdb_forward_rows(const void* x, const void* res, const void* w, const void* b,
                                void* out, void* hbuf, int n, int h, int w_img, int r0, int r1,
                                void* stream) {
  if (r0 < 0 || r1 > h || r0 >= r1) return (int)cudaErrorInvalidValue;
  cw::Span sp = span(x, hbuf, n, h, w_img);
  sp.h_row0 = window_lo(1, r0);
  sp.h_rows = window_hi(1, r1, h) - sp.h_row0;
#ifdef BAND_PLANT
  if (r0 > 0) sp.plant_row = r0 - 1;
#endif
  int e = 0;
  for (int k = 1; k <= 5 && e == 0; ++k) {
    sp.ylo = window_lo(k, r0);
    sp.yhi = window_hi(k, r1, h);
    e = cw::conv(k, sp, static_cast<const cw::bf16*>(w), static_cast<const float*>(b),
                 static_cast<const cw::bf16*>(res), static_cast<cw::bf16*>(out),
                 static_cast<cudaStream_t>(stream));
  }
  return e;
}

// One conv k (1..5) of rdb_forward alone, over all frames: x1..x_{k-1} are
// read from hbuf, (n, h, w, 128). For timing each conv against its floor.
extern "C" int rdb_conv(int k, const void* x, const void* res, const void* w, const void* b,
                        void* out, void* hbuf, int n, int h, int w_img, void* stream) {
  if (k < 1 || k > 5) return (int)cudaErrorInvalidValue;
  return cw::conv(k, span(x, hbuf, n, h, w_img), static_cast<const cw::bf16*>(w),
                  static_cast<const float*>(b), static_cast<const cw::bf16*>(res),
                  static_cast<cw::bf16*>(out), static_cast<cudaStream_t>(stream));
}

// The first design (rdb_fwd.cuh), NCHW: x, res, out (n, 64, h, w); w the
// RDB packed in mma.sync fragment order (ops/fragments.py:conv_matrix).
extern "C" int rdb_forward_tiles(const void* x, const void* res, const void* w, const void* b,
                                 void* out, int n, int h, int w_img, void* stream) {
  return rdb::launch<false>(x, res, w, b, out, nullptr, n, h, w_img, stream);
}
