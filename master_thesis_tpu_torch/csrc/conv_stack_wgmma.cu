// K7's wide convs: one 3x3 conv over NT 16x16 images, NHWC bf16, Cin and
// Cout multiples of 64, in one wgmma launch (conv3x3_wide_wgmma.cuh, which
// holds the design note and the bound). ops/conv_stack.py routes a tile
// stack's wide convs here and the rest to conv_stack.cu.
#include "conv_tile.cuh"
#include "conv3x3_wide_wgmma.cuh"

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
