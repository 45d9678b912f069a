// One conv a launch on Hopper's wgmma, channels-last: K7's wide convs (one
// 3x3 conv over NT 16x16 images, conv3x3_wide_wgmma.cuh) and K8's frame
// convs (one 3x3 or 5x5 conv over whole NHWC frames, conv_frame_wgmma.cuh),
// Cin and Cout multiples of 64; each header holds its design note and
// bound. ops/conv_stack.py routes those convs of a stack here and the rest
// to conv_stack.cu.
#include "conv_tile.cuh"
#include "conv3x3_wide_wgmma.cuh"
#include "conv_frame_wgmma.cuh"

// x: (nt, 16, 16, cin) bf16 NHWC; w: ops/fragments.py:wgmma_wide_matrix of
// the OIHW kernel, (cin / 64, 9, cout_pad, 64) bf16; b: cout f32 biases;
// out: tile t's pixel q, channel o at (t / tg) * sg + (t % tg) * st + q * sp
// + o (the plain NHWC output: tg >= nt, st = 256 cout, sp = cout). ReLU
// after the bias when relu != 0. One launch on `stream`; returns the CUDA
// error code.
extern "C" int conv3x3_wide_forward(const void* x, const void* w, const void* b, void* out, int nt,
                                    int cin, int cout, int cout_pad, int relu, long long tg,
                                    long long sg, long long st, long long sp, void* stream) {
  ww::Args a;
  a.w = static_cast<const ww::bf16*>(w);
  a.bias = static_cast<const float*>(b);
  a.out = static_cast<ww::bf16*>(out);
  a.nt = nt;
  a.cin = cin;
  a.cout = cout;
  a.cout_pad = cout_pad;
  a.relu = relu;
  a.tg = tg;
  a.sg = sg;
  a.st = st;
  a.sp = sp;
  return ww::launch(static_cast<const ww::bf16*>(x), a, static_cast<cudaStream_t>(stream));
}

// The kernel's shared memory in bytes and its outputs a CTA (for the
// planner's record and chip_smoke.py).
extern "C" int conv3x3_wide_smem() { return ww::Cfg::SMEM; }
extern "C" int conv3x3_wide_cout_tile() { return ww::Cfg::COUT_T; }

// K8's frame convs: one 3x3 or 5x5 conv (k) over n NHWC bf16 frames of h x w,
// Cin and Cout multiples of 64, in one wgmma launch (conv_frame_wgmma.cuh,
// which holds the design note and the bound), over tiles of fr frames x
// rows x tw output pixels (ops/conv_stack.py:frame_tile). x: (n, h, w, cin);
// w: ops/fragments.py:wgmma_wide_matrix of the OIHW kernel, (cin / 64, k *
// k, cout_pad, 64) bf16; b: cout f32 biases; out: (n, h, w, cout). ReLU after
// the bias when relu != 0. One launch on `stream`; returns the CUDA error
// code.
extern "C" int conv_frame_forward(const void* x, const void* w, const void* b, void* out, int n,
                                  int h, int wd, int cin, int cout, int cout_pad, int k, int relu,
                                  int fr, int rows, int tw, void* stream) {
  fw::Args a = {};
  a.wt = static_cast<const fw::bf16*>(w);
  a.bias = static_cast<const float*>(b);
  a.out = static_cast<fw::bf16*>(out);
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
  return fw::launch(static_cast<const fw::bf16*>(x), a, k, static_cast<cudaStream_t>(stream));
}
