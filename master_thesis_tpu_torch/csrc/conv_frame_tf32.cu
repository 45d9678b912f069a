// K7's and K8's f32 convs with 64-multiple widths on Hopper's tensor cores
// in 3xTF32 (conv_frame_tf32_wgmma.cuh holds the design note and the
// bound): one k x k conv (k = 3 or 5) over NHWC f32 frames, K7's tiles being
// frames of 16x16. ops/conv_stack.py routes those convs of an f32 stack here
// and the rest to conv_f32.cu.
#include "conv_tile.cuh"
#include "conv_frame_tf32_wgmma.cuh"

// x: (n, h, wd, cin) f32 NHWC, contiguous; w: ops/fragments.py:
// wgmma_tf32_matrix of the OIHW kernel, the hi matrix (cin / 32, k * k,
// cout_pad, 32) with the lo matrix lo_off floats further; b: cout f32
// biases; out: frame f's pixel q, channel o at (f / tg) * sg + (f % tg) * st
// + q * sp + o floats (NHWC: tg = n, sg = 0, st = h wd cout, sp = cout).
// The tile is fr frames x rows x tw output pixels on nh n144 halves
// (ops/conv_stack.py:frame_tile_tf32), 128 / nh outputs a CTA. ReLU after
// the bias when relu != 0.
// One launch on `stream`; returns the CUDA error code.
extern "C" int conv_frame_tf32_forward(const void* x, const void* w, const void* b, void* out,
                                       long long lo_off, int n, int h, int wd, int cin, int cout,
                                       int cout_pad, int k, int relu, int fr, int rows, int tw,
                                       int nh, long long tg, long long sg, long long st,
                                       long long sp, void* stream) {
  ft::Args a = {};
  a.wt = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(b);
  a.out = static_cast<float*>(out);
  a.lo_off = lo_off;
  a.tg = tg;
  a.sg = sg;
  a.st = st;
  a.sp = sp;
  a.n = n;
  a.h = h;
  a.w = wd;
  a.cin = cin;
  a.cout = cout;
  a.cout_pad = cout_pad;
  a.relu = relu;
  a.fr = fr;
  a.rows = rows;
  a.tw = tw;
  return ft::launch(static_cast<const float*>(x), a, k, nh, static_cast<cudaStream_t>(stream));
}
