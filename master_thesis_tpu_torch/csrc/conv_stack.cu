// K7 and K8: a fused stack of same-padded odd k x k convs (f32 bias, then
// ReLU where asked) over a batch of images, as implicit GEMMs on bf16
// tensor cores (mma.sync m16n8k16, f32 accumulation).
//
// Replaces: master_thesis_tpu/ops/pallas_sep4d.py:conv_stack_tiles (K7,
// body _conv_stack_kernel / _accum_taps_tile: each 16x16 tile its own
// image, zero padding at every tile's border) and conv_stack_banded (K8,
// body _conv_stack_band_kernel / _band_tap_masks_r: full frames in row
// bands, a halo of the sum of the radii, zero padding only at the frame's
// border). Both are one kernel here: a block owns a TH x TW output tile of
// one image and runs a group of consecutive convs of the stack over it.
// K7's tile is the whole image (a 16x16 correlation tile); K8's is a piece
// of a frame with a halo, recomputed at every stage. Either way a pixel
// outside the image is an exact zero at every stage: no stage computes
// one, and the buffers start zeroed.
//
// Rounding, shared with ops/conv_stack.py:conv_stack_plain: operands bf16,
// sums in f32, the f32 bias added, then ReLU, each conv's output rounded to
// bf16 before the next conv.
//
// Shared memory. A 16x16 tile of 256 channels is 128 KiB in bf16 and 200
// KiB with the 2-pixel border of a 5x5 conv, so an input and an output
// buffer of that width do not fit a block's 227 KB together. The TPU
// kernel fuses a whole stack in VMEM; here ops/conv_stack.py:plan cuts the
// stack into groups whose two buffers (A: the group's input and the
// outputs of its odd stages; B: the outputs of its even stages) fit, and
// launches once per group. It cuts where that is cheapest: on K8's halo
// tiles fusing also recomputes the halo at every stage, on tiles small
// enough for both buffers, which costs more than the round trip it saves
// for 128-channel convs, so those run one conv a launch on larger tiles.
// The last stage of a group writes to device
// memory from registers, so a single wide conv needs only its input
// buffer, and its output channels may be split across blocks (grid z) when
// there are few tiles. The cost is one device-memory round trip per group
// boundary: at the sep4d stages (B=4, F=5) the 256-channel boundaries are
// 671 MB each (0.4 ms at 3.35 TB/s per write and read), against 4.7 ms of
// tensor-core work.
//
// Layout. A buffer holds a (TH + 2 border) x (TW + 2 border) tile
// pixel-major, channels contiguous with a stride padded by 8 (16 bytes) so
// the 8 rows an ldmatrix reads fall in different bank groups. A conv tap
// (dy, dx) of output pixel p reads pixel p + dy * CS + dx, so 16
// consecutive flat pixels form one A operand (an M-tile); an M-tile may
// wrap from one tile row to the next, and the epilogue stores only the
// pixels of the stage's region. A stage's region lies at least its radius
// inside the buffer, so no tap reads before the buffer, and the last
// M-tile pair reads at most 31 pixels past it: the zero slack. Thin
// operands are padded: each tap's input channels to 16 (K) and the
// outputs to 16 (N), with zero weights
// (ops/conv_stack.py:pack_stack), so Cin = 1, 3 or 10 and Cout = 1 or 2
// run on the same path; the bias is padded with zeros too.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s) at the CHN+DFPN
// step's shapes (B=4, F=5, 256x256): K7 on sep4d 4.64 TFLOP, 4.7 ms, and
// on the mixer 23 GFLOP, 0.024 ms; K8 on flow_256's segments 2.87 TFLOP,
// 2.9 ms, and on VGG's pool-4 tower 0.88 TFLOP, 0.9 ms. All are bound by
// operations; the design keeps every conv on tensor cores and each
// group's intermediates in shared memory; 16 warps a block, each fetching
// its B fragments two K-steps ahead, hide the L2 latency that bound the
// first 8-warp version (master_thesis_tpu_torch/sweep_conv_stack.py). K7's
// wide 3x3 convs (Cin and Cout multiples of 64 on 16x16 tiles: sep4d's
// four, the mixer's one) have left this kernel for csrc/conv_stack_wgmma.cu
// (wgmma fed by TMA, persistent CTAs; ops/conv_stack.py:tile_plan routes
// them); this one keeps K7's thin convs and 5x5s. K8's 3x3 and 5x5 convs
// with Cin and Cout multiples of 64 (all of the flow estimators' but c0
// and c17, all of VGG's pool-4 tower but its 3 -> 64) have left it too, for
// csrc/conv_stack_wgmma.cu's frame kernel (conv_frame_wgmma.cuh: one TMA
// box with its halo a tile over whole NHWC frames, no halo recomputed;
// ops/conv_stack.py:band_plan routes them); this one keeps K8's thin
// convs, and all of K8 in its first design
// (ops/conv_stack.py:conv_stack_banded_first_cuda, which chip_smoke.py
// times beside the new route).
//
// Faults for chip_smoke.py to catch, compiled in with -DSTACK_PLANT=n:
// 1 leaves out the corner tap (dy, dx) = (-r, -r) of every conv, 2 leaves
// the ReLU off the last conv with one in every launch, 3 drops the biases.
#include "conv_tile.cuh"

#ifndef STACK_PLANT
#define STACK_PLANT 0
#endif
// Tuning (master_thesis_tpu_torch/sweep_conv_stack.py times the variants):
// warps a block, the widest output-channel step of a warp (in blocks of
// 16), and how many K-steps ahead a warp fetches its B fragments.
#ifndef STACK_NWARP
#define STACK_NWARP 16
#endif
#ifndef STACK_NT
#define STACK_NT 2
#endif
#ifndef STACK_DEPTH
#define STACK_DEPTH 2
#endif

namespace cstack {

constexpr int MAX_STAGES = 16;

// One conv of a group. Offsets: w_off in 16-byte words into the packed B
// matrices, b_off in floats into the padded biases.
struct Stage {
  int k, cin16, cout, cout16, relu, w_off, b_off;
};

// One launch; mirrored by ops/conv_stack.py:_Launch (same field order).
struct Launch {
  Stage st[MAX_STAGES];
  int nst;            // stages in this group
  int cin;            // real input channels
  int H, W;           // image size
  int TH, TW;         // output tile
  int tiles_x, tiles; // tiles per image row, per image
  int border, halo;   // buffer border around the tile; sum of the radii
  int RS, CS;         // buffer rows and columns
  int slack;          // zero pixels after each buffer
  int cpa, cpb;       // channel strides of buffers A and B (cpb 0: no B)
  int n_chunk;        // output channels per block of the last stage
  long long in_sn, out_sn;  // element (n, c, pixel) at n * sn + c * sc + pixel * sp
  int in_sc, in_sp, out_sc, out_sp;
};

}  // namespace cstack

namespace {

using ct::bf16;
using cstack::Launch;
using cstack::Stage;

constexpr int NWARP = STACK_NWARP, NTHREAD = 32 * NWARP, DEPTH = STACK_DEPTH;

// acc = the k x k conv over channels [0, cin16) of the 32 buffer pixels
// from `pix` (two M-tiles of 16), for output channels 16 * nb0 + [0, 16 NT)
// (NT blocks of 16 of the NB in the packed matrix). The B fragments come
// from L2 DEPTH K-steps ahead of their use, DEPTH + 1 register sets in
// turn.
template <int NT>
__device__ __forceinline__ void conv_mma(float (&acc)[2][2 * NT][4], const bf16* src, int cp,
                                         int pix, int CS, int k, int kc,
                                         const uint4* __restrict__ w, int NB, int nb0, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int r = k >> 1, steps = k * k * kc;
  // ldmatrix.x4: lane l gives the address of A row l % 16, k-half l / 16.
  const bf16* a_lane = src + (ptrdiff_t)(pix + (lane & 15)) * cp + (lane >> 4) * 8;
  const uint4* w_lane = w + nb0 * 32 + lane;
  int dy = -r, dx = -r, ch = 0;  // the tap and channel block of the next step

  auto fetch = [&](uint4 (&b)[NT], int s) {
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) b[nb] = __ldg(w_lane + ((size_t)s * NB + nb) * 32);
  };
  auto step = [&](const uint4 (&b)[NT]) {
    const bool skip = STACK_PLANT == 1 && dy == -r && dx == -r;
    if (!skip) {
      const bf16* as = a_lane + (ptrdiff_t)(dy * CS + dx) * cp + ch * 16;
      uint32_t a[2][4];
      ct::ldmatrix_x4(a[0], as);
      ct::ldmatrix_x4(a[1], as + (ptrdiff_t)16 * cp);
#pragma unroll
      for (int nb = 0; nb < NT; ++nb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ct::mma_bf16(acc[i][2 * nb], a[i], b[nb].x, b[nb].y);
          ct::mma_bf16(acc[i][2 * nb + 1], a[i], b[nb].z, b[nb].w);
        }
    }
    if (++ch == kc) {
      ch = 0;
      if (++dx > r) {
        dx = -r;
        ++dy;
      }
    }
  };

  uint4 b[DEPTH + 1][NT];
#pragma unroll
  for (int j = 0; j < DEPTH; ++j)
    if (j < steps) fetch(b[j], j);
#pragma unroll 1
  for (int s0 = 0; s0 < steps; s0 += DEPTH + 1) {
#pragma unroll
    for (int j = 0; j <= DEPTH; ++j) {
      if (s0 + j < steps) {
        if (s0 + j + DEPTH < steps) fetch(b[(j + DEPTH) % (DEPTH + 1)], s0 + j + DEPTH);
        step(b[j]);
      }
    }
  }
}

// Copies the input tile (buffer pixel (0, 0) is image pixel (by0, bx0))
// into buffer A; pixels outside the image stay zero. Consecutive threads
// take consecutive pixels of a channel-major input and consecutive channel
// octets of a pixel-major one.
__device__ __forceinline__ void load_input(const Launch& g, bf16* a, const bf16* __restrict__ x,
                                           int n, int by0, int bx0) {
  const int oct = (g.cin + 7) / 8, np = g.RS * g.CS;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x) + n * g.in_sn;
  const bool vec = g.in_sc == 1 && g.cin % 8 == 0;
  for (int i = threadIdx.x; i < oct * np; i += NTHREAD) {
    int p, c8;
    if (g.in_sp == 1) {
      c8 = i / np;
      p = i - c8 * np;
    } else {
      p = i / oct;
      c8 = i - p * oct;
    }
    const int br = p / g.CS, gy = by0 + br, gx = bx0 + (p - br * g.CS);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gy >= 0 && gy < g.H && gx >= 0 && gx < g.W) {
      const unsigned short* s =
          xs + (size_t)(gy * g.W + gx) * g.in_sp + (size_t)8 * c8 * g.in_sc;
      if (vec) {
        v = __ldg(reinterpret_cast<const uint4*>(s));
      } else {
        unsigned short e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = 8 * c8 + j < g.cin ? __ldg(s + (size_t)j * g.in_sc) : 0;
        v = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                       e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
      }
    }
    *reinterpret_cast<uint4*>(a + (ptrdiff_t)p * g.cpa + 8 * c8) = v;
  }
}

// One stage over the flat pixel range [start, end) of the buffer, storing
// the pixels of columns [c0, c1): to `dst` (channel stride cpd) or, for
// the last stage, to the output image.
template <int NT>
__device__ __forceinline__ void run_stage(const Launch& g, const Stage& st, bool relu, bool last,
                                          const bf16* src, int cps, bf16* dst, int cpd,
                                          int start, int end, int c0, int c1, int n_lo, int nb16,
                                          const uint4* __restrict__ w,
                                          const float* __restrict__ bias, bf16* __restrict__ out,
                                          int n, int by0, int bx0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int npair = nb16 / NT, items = (end - start + 31) / 32 * npair;
  const float* bs = bias + st.b_off;
  for (int it = warp; it < items; it += NWARP) {
    const int mp = it / npair, nb0 = n_lo / 16 + (it - mp * npair) * NT;
    const int pix = start + 32 * mp;
    float acc[2][2 * NT][4];
    conv_mma<NT>(acc, src, cps, pix, g.CS, st.k, st.cin16 / 16, w + st.w_off, st.cout16 / 16, nb0,
                 lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = pix + 16 * i + gq + 8 * h;
        const int br = p / g.CS, bc = p - br * g.CS;
        if (p >= end || bc < c0 || bc >= c1) continue;
        const size_t base = n * g.out_sn + (size_t)((by0 + br) * g.W + bx0 + bc) * g.out_sp;
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j) {
          const int o = 16 * nb0 + 8 * j + 2 * tq;
          float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (STACK_PLANT != 3) {
            v0 += bs[o];
            v1 += bs[o + 1];
          }
          if (relu) {
            v0 = fmaxf(v0, 0.0f);
            v1 = fmaxf(v1, 0.0f);
          }
          if (!last) {
            ct::store2(dst + (ptrdiff_t)p * cpd + o, v0, v1);
          } else {
            if (o < st.cout) out[base + (size_t)o * g.out_sc] = __float2bfloat16(v0);
            if (o + 1 < st.cout) out[base + (size_t)(o + 1) * g.out_sc] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NTHREAD)
stack_kernel(const __grid_constant__ Launch g, const bf16* __restrict__ x,
             const uint4* __restrict__ w, const float* __restrict__ bias,
             bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int npix = g.RS * g.CS + g.slack;
  bf16* bufa = reinterpret_cast<bf16*>(smem);
  bf16* bufb = bufa + (size_t)npix * g.cpa;
  const int n = blockIdx.x / g.tiles, tile = blockIdx.x - n * g.tiles;
  const int ty = tile / g.tiles_x, tx = tile - ty * g.tiles_x;
  const int y0 = ty * g.TH, x0 = tx * g.TW;
  const int by0 = y0 - g.border, bx0 = x0 - g.border;  // image pixel of buffer pixel (0, 0)

  ct::zero_smem(smem, npix * (g.cpa + g.cpb) * (int)sizeof(bf16));
  __syncthreads();
  load_input(g, bufa, x, n, by0, bx0);
  __syncthreads();

  int last_relu = -1;  // the fault of -DSTACK_PLANT=2
  for (int s = 0; s < g.nst; ++s) last_relu = g.st[s].relu ? s : last_relu;
  int done = 0;  // sum of the radii of the stages so far
  for (int s = 0; s < g.nst; ++s) {
    const Stage& st = g.st[s];
    done += st.k >> 1;
    const int rem = g.halo - done;  // how far past the tile this stage's output is needed
    const bool last = s == g.nst - 1;
    const int r0 = max(y0 - rem, 0) - by0, r1 = min(y0 + g.TH + rem, g.H) - by0;
    const int c0 = max(x0 - rem, 0) - bx0, c1 = min(x0 + g.TW + rem, g.W) - bx0;
    if (r0 < r1 && c0 < c1) {
      const bool odd = s & 1;
      const int n_lo = last ? blockIdx.z * g.n_chunk : 0;
      const int n_hi = last ? min(st.cout16, n_lo + g.n_chunk) : st.cout16;
      const int nb16 = (n_hi - n_lo) / 16;
      const bool relu = st.relu && !(STACK_PLANT == 2 && s == last_relu);
      const bf16* src = odd ? bufb : bufa;
      bf16* dst = odd ? bufa : bufb;
      const int cps = odd ? g.cpb : g.cpa, cpd = odd ? g.cpa : g.cpb;
      const int start = r0 * g.CS + c0, end = (r1 - 1) * g.CS + c1;
      if (STACK_NT >= 4 && nb16 % 4 == 0)
        run_stage<STACK_NT >= 4 ? 4 : 2>(g, st, relu, last, src, cps, dst, cpd, start, end, c0,
                                         c1, n_lo, nb16, w, bias, out, n, by0, bx0);
      else if (nb16 % 2 == 0)
        run_stage<2>(g, st, relu, last, src, cps, dst, cpd, start, end, c0, c1, n_lo, nb16, w,
                     bias, out, n, by0, bx0);
      else
        run_stage<1>(g, st, relu, last, src, cps, dst, cpd, start, end, c0, c1, n_lo, nb16, w,
                     bias, out, n, by0, bx0);
    }
    __syncthreads();
  }
}

}  // namespace

// x: the group's input (n images, strides in *g); out: its output; w: the
// stack's packed B matrices (bf16, fragment order); b: its padded f32
// biases. Launches n * g->tiles blocks (times the output-channel split) on
// `stream`; returns the CUDA error code of the launch.
extern "C" int conv_stack_forward(const void* x, void* out, const void* w, const void* b,
                                  const cstack::Launch* g, int n, void* stream) {
  if (g->nst < 1 || g->nst > cstack::MAX_STAGES) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(g->RS * g->CS + g->slack) * (g->cpa + g->cpb) * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int split = (g->st[g->nst - 1].cout16 + g->n_chunk - 1) / g->n_chunk;
  const dim3 grid(n * g->tiles, 1, split);
  stack_kernel<<<grid, NTHREAD, smem, static_cast<cudaStream_t>(stream)>>>(
      *g, static_cast<const bf16*>(x), static_cast<const uint4*>(w), static_cast<const float*>(b),
      static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}
