// K1: one residual dense block (RDB) of the CHN trunk per launch, fused;
// K2: the same over one row band of every frame. The kernel, its design
// note and its bound are in rdb_fwd.cuh.
#include "rdb_fwd.cuh"

// x, res, out: (n, 64, h, w) bf16 NCHW (res may be null); w: the packed
// RDB (5 row-major (9*Cin_k, out_k) matrices, bf16); b: 192 f32 biases.
// Launches on `stream`; returns the CUDA error code of the launch.
extern "C" int rdb_forward(const void* x, const void* res, const void* w, const void* b,
                           void* out, int n, int h, int w_img, void* stream) {
  return rdb::launch<false>(x, res, w, b, out, nullptr, n, h, w_img, stream);
}

// As rdb_forward over the frame rows [r0, r1) only (K2: one band per
// launch); rows outside the band of `out` are left as they are.
extern "C" int rdb_forward_rows(const void* x, const void* res, const void* w, const void* b,
                                void* out, int n, int h, int w_img, int r0, int r1,
                                void* stream) {
  return rdb::launch<false>(x, res, w, b, out, nullptr, n, h, w_img, stream, r0, r1);
}
