// The 3xTF32 wgmma conv kernel (conv_frame_tf32_wgmma.cuh holds the design
// note and the bound): K7's and K8's f32 convs with 64-multiple widths (conv
// mode, one k x k conv over NHWC f32 frames, K7's tiles being frames of
// 16x16; ops/conv_stack.py routes those convs of an f32 stack here and the
// rest to conv_f32.cu), K4's / K5's f32 tail, four launches: upconv1 and
// upconv2 in phase mode, hr_conv in conv mode, conv_last in last mode
// (ops/tail.py), and K1's / K2's f32 RDB, five launches: conv1..conv4 in gc
// mode, conv5 in conv mode with the residual epilogue (ops/rrdb.py).
#include "conv_tile.cuh"
#include "conv_frame_tf32_wgmma.cuh"

// One launch, field for field ops/conv_stack.py:_TF32Call. x: (n, x_rows,
// wd, cin) f32 NHWC with contiguous channels, pixels xc floats apart (the
// first cin channels of a wider buffer where xc > cin), rows wd * xc, frames
// xn; frame rows from x_row0 of frames of h rows;
// w: the packed hi matrix (ops/fragments.py: wgmma_tf32_matrix,
// wgmma_tf32_phase_matrix, or wgmma_tf32_matrix padded to 8 outputs for last
// mode) with the lo matrix lo_off floats further; b: the biases (phase mode:
// cout / 4 of them); out: frame f's row y, column x, channel o at (f / tg) *
// sg + (f % tg) * st + (y - out_row0) * sr + x * sp + o floats, for the
// output rows [r0, r1). The tile is fr frames x rows x tw pixels of x's
// resolution on nh n144 halves (ops/conv_stack.py:frame_tile_tf32,
// last_tile_tf32). mode: 0 conv (k = 3 or 5), 1 phase (cout = 4 phases x
// 64), 2 last (cout <= 3, cout_pad 24), 3 gc (cout 32, cout_pad 96); epi: 0
// none, 1 ReLU, 2 leaky ReLU (0.2), after the bias, 3 (conv mode) 0.2 *
// (0.2 * (acc + b) + r) + r2, r and r2 (r2 null for none) whole frames read
// at frame f, row y, column x, channel o at f * r_sn + y * r_sy + x * r_sx + o
// (r2 likewise with its own strides).
struct TF32Call {
  const void* x;
  const void* w;
  const void* b;
  void* out;
  const void* r;
  const void* r2;
  long long lo_off, tg, sg, st, sr, sp, xc, xn, r_sn, r_sy, r_sx, r2_sn, r2_sy, r2_sx;
  int n, h, wd, cin, cout, cout_pad, k, mode, epi, fr, rows, tw, nh, x_row0, x_rows, r0, r1, out_row0;
};

// One launch on `stream`; returns the CUDA error code.
extern "C" int conv_frame_tf32_forward(const TF32Call* c, void* stream) {
  ft::Args a = {};
  a.wt = static_cast<const float*>(c->w);
  a.bias = static_cast<const float*>(c->b);
  a.out = static_cast<float*>(c->out);
  a.lo_off = c->lo_off;
  a.tg = c->tg;
  a.sg = c->sg;
  a.st = c->st;
  a.sr = c->sr;
  a.sp = c->sp;
  a.n = c->n;
  a.h = c->h;
  a.w = c->wd;
  a.cin = c->cin;
  a.cout = c->cout;
  a.cout_pad = c->cout_pad;
  a.epi = c->epi;
  a.fr = c->fr;
  a.rows = c->rows;
  a.tw = c->tw;
  a.x_row0 = c->x_row0;
  a.r0 = c->r0;
  a.r1 = c->r1;
  a.out_row0 = c->out_row0;
  a.r = static_cast<const float*>(c->r);
  a.r2 = static_cast<const float*>(c->r2);
  a.r_sn = c->r_sn;
  a.r_sy = c->r_sy;
  a.r_sx = c->r_sx;
  a.r2_sn = c->r2_sn;
  a.r2_sy = c->r2_sy;
  a.r2_sx = c->r2_sx;
  return ft::launch(static_cast<const float*>(c->x), a, c->k, c->nh, c->mode, c->x_rows, c->xc, c->xn,
                    static_cast<cudaStream_t>(stream));
}

// K3 and K6 in f32 (conv_bwd_tf32_wgmma.cuh): one call each. cfg: K3Cfg's
// (gc_rows, gc_tw, cv_fr, cv_rows, cv_tw, cv_nh, ks) or K6Cfg's (5 tiles of
// (fr, rows, tw, nh), then 3 K-splits), from ops/rrdb_bwd.py /
// ops/tail_bwd.py.
#include "conv_bwd_tf32_wgmma.cuh"

extern "C" long long rrdb_backward_tf32_scratch(const int* cfg, int n, int h, int w) {
  const ft::K3Cfg c = {cfg[0], cfg[1], cfg[2], cfg[3], cfg[4], cfg[5], cfg[6]};
  return ft::k3_carve(nullptr, (long long)n * h * w, c.ks, ft::k3_brows(c, n, h, w)).floats * 4;
}

extern "C" int rrdb_backward_tf32(const void* cat0, const void* cat1, const void* cat2, const void* g,
                                  const void* mats, void* dx, void* grads, void* scratch, const int* cfg, int n,
                                  int h, int w, void* stream) {
  const float* cats[3] = {static_cast<const float*>(cat0), static_cast<const float*>(cat1),
                          static_cast<const float*>(cat2)};
  const ft::K3Cfg c = {cfg[0], cfg[1], cfg[2], cfg[3], cfg[4], cfg[5], cfg[6]};
  return ft::rrdb_backward_tf32(cats, static_cast<const float*>(g), static_cast<const float*>(mats),
                                static_cast<float*>(dx), static_cast<float*>(grads), static_cast<float*>(scratch),
                                c, n, h, w, static_cast<cudaStream_t>(stream));
}

static ft::K6Cfg k6_cfg(const int* cfg) {
  ft::K6Cfg c;
  for (int i = 0; i < 20; ++i) c.tile[i / 4][i % 4] = cfg[i];
  for (int i = 0; i < 3; ++i) c.ks[i] = cfg[20 + i];
  return c;
}

extern "C" long long tail_backward_tf32_scratch(const int* cfg, int n, int h, int w) {
  const ft::K6Cfg c = k6_cfg(cfg);
  return ft::k6_carve(nullptr, n, h, w, ft::k6_items(c), ft::k6_brows(c, n, h, w)).floats * 4;
}

// rec: up1_tf32, up1_b, up2_tf32, up2_b, hr_tf32, hr_b; adj: hr_conv's,
// upconv2's, upconv1's adjoint operands.
extern "C" int tail_backward_tf32(const void* x, const void* g, const void* const* rec, const void* const* adj,
                                  const void* last_w, void* dx, void* grads, void* scratch, const int* cfg, int n,
                                  int h, int w, void* stream) {
  const ft::K6Cfg c = k6_cfg(cfg);
  const float* r[6];
  const float* a[3];
  for (int i = 0; i < 6; ++i) r[i] = static_cast<const float*>(rec[i]);
  for (int i = 0; i < 3; ++i) a[i] = static_cast<const float*>(adj[i]);
  return ft::tail_backward_tf32(static_cast<const float*>(x), static_cast<const float*>(g), r, a,
                                static_cast<const float*>(last_w), static_cast<float*>(dx),
                                static_cast<float*>(grads), static_cast<float*>(scratch), c, n, h, w,
                                static_cast<cudaStream_t>(stream));
}

// Kernel launches of one rrdb_backward_tf32 / tail_backward_tf32 call, and
// the sizes the wrappers check: an RDB's pull matrices, an RDB's grads, the
// tail's grads.
extern "C" int rrdb_backward_tf32_launches() { return ft::K3_LAUNCHES; }
extern "C" int tail_backward_tf32_launches() { return ft::K6_LAUNCHES; }
extern "C" long long rrdb_backward_tf32_pulls() { return ft::PULLS_F32; }
extern "C" int rrdb_backward_tf32_grads() { return ft::RDB_GRADS_F32; }
extern "C" int tail_backward_tf32_grads() { return ft::T6_GRADS; }
