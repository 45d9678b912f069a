// The f32 route of every kernel site: two SIMT kernels with f32 operands and
// f32 sums, shared by the f32 routes of K1-K8 (ops/conv_f32.py binds them;
// ops/rrdb.py, rrdb_bwd.py, tail.py, tail_bwd.py and conv_stack.py issue
// them in the order their TPU kernel's function takes).
//
// Replaces, in f32 (the TPU kernels take Precision.HIGHEST there):
//   master_thesis_tpu/ops/pallas_rrdb.py  rrdb_pallas (K1),
//     rrdb_trunk_pallas_banded (K2), rrdb_bwd_pallas (K3);
//   master_thesis_tpu/ops/pallas_tail.py  rrdbnet_tail_pallas, full frame
//     (K4) and banded (K5), tail_bwd_pallas (K6);
//   master_thesis_tpu/ops/pallas_sep4d.py conv_stack_tiles (K7),
//     conv_stack_banded (K8).
//
// conv_f32_fwd: one direct k x k convolution (k = 3 or 5, stride 1, zero
// padding at the frame's border), NHWC, as an implicit GEMM over output
// pixels (M) x output channels (N) x taps and input channels (K). Options:
// the input a channel slice of a wider buffer and the output a channel slice
// with its own pixel stride (the RDB's dense concat); the input read through
// nearest x2 upsampling (the tail's upconvs); the output rows a window
// [r0, r1) of the frame, the input buffer holding the rows it reads from
// x_row0 on (K2 / K5's bands); the outputs' 2x2 sums (pool: the adjoint of a
// nearest x2 read); an epilogue after the bias: none, leaky 0.2, ReLU,
// alpha acc + r (then beta . + r2), or the leaky / ReLU mask read from a
// kept activation (the adjoints). The adjoint of every forward conv is this
// kernel on the cotangent, with the weights flipped and transposed.
//
// conv_f32_wgrad: one conv's weight and bias grads,
// dW[o, ky, kx, c] = sum_p dY[p, o] X[p + (ky, kx) - pad, c], db[o] =
// sum_p dY[p, o], with the input slice and upsampled read options: per-block
// partial sums over a share of at most 256 pixels, then a reduce pass that
// adds the shares in a fixed order (no atomics: a step's grads are the same
// from run to run), writing dW in OIHW. Short chains keep the f32 rounding of
// sums over a whole batch's pixels (tens of thousands) near that of a sum of
// a few hundred.
//
// Bound on an H100 SXM: f32 outside the tensor cores, 67 TFLOP/s, against
// 3.35 TB/s. A 3x3 conv of Cin x Cout does 18 Cin Cout FLOPs a pixel for
// 4 (Cin + Cout) bytes: above ~90 channels a side it is bound by operations
// (an RDB conv at 64 + 32 k -> 32: ~1 900 FLOP/B). The design goes for the
// FFMA rate: a 256-pixel x 32-channel output tile a block, 8 x 4 outputs a
// thread in registers, the operands staged through shared memory in chunks of
// 8 input channels of one tap (per-tap pixel offsets computed once a tap,
// the next chunk's loads in flight while the current one is summed); the
// input is read again for each of the k^2 taps and each 32-channel column of
// outputs, from L2. The weight grads keep 8 outputs x k taps of one kernel
// row a thread over 32-pixel row segments. A later design on the tensor
// cores (3 x TF32 split operands on wgmma, 3 x FLOPs / 495 TFLOP/s) is
// queued in ROADMAP D.
//
// Planted faults for chip_smoke.py's checks (never in a normal build):
//   -DF32_PLANT=1  tap (0, 0) dropped from both kernels;
//   -DF32_PLANT=2  the input's channel slice read one group of 8 channels
//                  off (channel c read as (c + 8) mod Cin) in both kernels.
#include <cuda_runtime.h>

#ifndef F32_PLANT
#define F32_PLANT 0
#endif

namespace cf {

enum Epi { NONE = 0, LEAKY = 1, RELU = 2, RESID = 3, MASK_LEAKY = 4, MASK_RELU = 5 };

// ops/conv_f32.py:_Fwd, field for field. Strides in elements; channels are
// contiguous in every buffer.
struct Fwd {
  const float* x;
  long long x_sn, x_sy, x_sx;
  int x_row0, hin, win, cin;
  const float* w;     // (k * k, cin, cout) row-major: HWIO
  const float* bias;  // cout, or null
  float* y;
  long long y_sn, y_sy, y_sx;
  int y_row0, cout;
  int n, hout, wout, r0, r1, k, up, pool, epi;
  float alpha, beta;
  const float* r;
  long long r_sn, r_sy, r_sx;
  const float* r2;
  long long r2_sn, r2_sy, r2_sx;
  const float* m;
  long long m_sn, m_sy, m_sx;
};

// ops/conv_f32.py:_Wgrad, field for field.
struct Wgrad {
  const float* x;
  long long x_sn, x_sy, x_sx;
  int hin, win, cin;
  const float* dy;
  long long d_sn, d_sy, d_sx;
  int cout, n, hout, wout, k, up, splits;
  float* part;  // (splits, cout, k * k, cin), then (splits, cout)
  float* dw;    // (cout, cin, k, k)
  float* db;    // cout
};

constexpr int BM = 256, BN = 32, BK = 8, TM = 8, TN = 4, PAD = 4, THREADS = 256;

__device__ __forceinline__ int rotate(int c, int cin) {
#if F32_PLANT == 2
  return (c + 8) % cin;
#else
  (void)cin;
  return c;
#endif
}

__global__ void __launch_bounds__(THREADS, 2) conv_fwd_kernel(const Fwd a) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int rows = a.r1 - a.r0;
  const long long M = (long long)a.n * rows * a.wout;
  const long long m0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const int p = a.k / 2, taps = a.k * a.k;
  const int so = a.pool ? 2 : 1, subs = a.pool ? 4 : 1;
  const int he = a.up ? 2 * a.hin : a.hin, we = a.up ? 2 * a.win : a.win;
  const int nc = (a.cin + BK - 1) / BK;
  const int nq = subs * taps * nc;

  // Load role: input channel kc of the chunk for pixels mrow + 32 j; weight
  // row bk, column bn.
  const int kc = tid & 7, mrow = tid >> 3;
  const int bk = tid >> 5, bn = tid & 31;
  int pn[TM], pyx[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    long long m = m0 + mrow + 32 * j;
    if (m < M) {
      int nn = (int)(m / ((long long)rows * a.wout));
      int rem = (int)(m - (long long)nn * rows * a.wout);
      pn[j] = nn;
      pyx[j] = ((a.r0 + rem / a.wout) << 16) | (rem % a.wout);
    } else {
      pn[j] = 0;
      pyx[j] = -1;
    }
  }
  long long off[TM];
  auto set_tap = [&](int s, int tap) {
    const int dy = tap / a.k - p + (s >> 1), dx = tap % a.k - p + (s & 1);
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      off[j] = -1;
      if (pyx[j] >= 0) {
        int yy = (pyx[j] >> 16) * so + dy, xx = (pyx[j] & 0xffff) * so + dx;
        if (yy >= 0 && yy < he && xx >= 0 && xx < we) {
          int iy = (yy >> a.up) - a.x_row0, ix = xx >> a.up;
          off[j] = pn[j] * a.x_sn + iy * a.x_sy + ix * a.x_sx;
        }
      }
    }
  };
  float ra[TM], rb;
  auto load = [&](int q) {
    const int c0 = (q % nc) * BK, tap = (q / nc) % taps;
    const int c = c0 + kc;
#pragma unroll
    for (int j = 0; j < TM; ++j)
      ra[j] = (off[j] >= 0 && c < a.cin) ? a.x[off[j] + rotate(c, a.cin)] : 0.f;
    const int cb = c0 + bk, o = o0 + bn;
    rb = (cb < a.cin && o < a.cout) ? a.w[((long long)tap * a.cin + cb) * a.cout + o] : 0.f;
#if F32_PLANT == 1
    if (tap == 0) rb = 0.f;
#endif
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;

  const int tx = tid & 7, ty = tid >> 3;
  set_tap(0, 0);
  load(0);
  for (int q = 0; q < nq; ++q) {
#pragma unroll
    for (int j = 0; j < TM; ++j) As[kc][mrow + 32 * j] = ra[j];
    Bs[bk][bn] = rb;
    __syncthreads();
    if (q + 1 < nq) {
      if ((q + 1) % nc == 0) set_tap((q + 1) / (taps * nc), ((q + 1) / nc) % taps);
      load(q + 1);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
    const int nn = (int)(m / ((long long)rows * a.wout));
    const int rem = (int)(m - (long long)nn * rows * a.wout);
    const int yy = a.r0 + rem / a.wout - a.y_row0, xx = rem % a.wout;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int o = o0 + tx * TN + jj;
      if (o >= a.cout) continue;
      float v = acc[i][jj] + (a.bias ? a.bias[o] : 0.f);
      if (a.epi == LEAKY) {
        v = v >= 0.f ? v : 0.2f * v;
      } else if (a.epi == RELU) {
        v = fmaxf(v, 0.f);
      } else if (a.epi == RESID) {
        v = a.alpha * v + a.r[nn * a.r_sn + yy * a.r_sy + xx * a.r_sx + o];
        if (a.r2) v = a.beta * v + a.r2[nn * a.r2_sn + yy * a.r2_sy + xx * a.r2_sx + o];
      } else if (a.epi == MASK_LEAKY || a.epi == MASK_RELU) {
        const float mv = a.m[nn * a.m_sn + yy * a.m_sy + xx * a.m_sx + o];
        if (a.epi == MASK_LEAKY) v = mv >= 0.f ? v : 0.2f * v;
        else v = mv > 0.f ? v : 0.f;
      }
      a.y[nn * a.y_sn + yy * a.y_sy + xx * a.y_sx + o] = v;
    }
  }
}

constexpr int WT = 128, SEG = 32, WO = 8, KMAX = 5, SEGS_SPLIT = 8;

__global__ void __launch_bounds__(WT) wgrad_kernel(const Wgrad a) {
  __shared__ __align__(16) float Ds[SEG][32];
  __shared__ float Xs[SEG + KMAX - 1][32];
  const int tid = threadIdx.x, lane = tid & 31, og = tid >> 5;
  const int k = a.k, p = k / 2;
  const int ctiles = (a.cin + 31) / 32;
  const int ky = blockIdx.y / ctiles, c0 = (blockIdx.y % ctiles) * 32;
  const int o0 = blockIdx.z * 32;
  const bool bias_block = blockIdx.y == 0;
  const int he = a.up ? 2 * a.hin : a.hin, we = a.up ? 2 * a.win : a.win;
  const int segs_row = (a.wout + SEG - 1) / SEG;
  const long long total = (long long)a.n * a.hout * segs_row;
  const long long s0 = total * blockIdx.x / a.splits, s1 = total * (blockIdx.x + 1) / a.splits;

  float acc[WO][KMAX], dbacc[WO];
#pragma unroll
  for (int oi = 0; oi < WO; ++oi) {
    dbacc[oi] = 0.f;
#pragma unroll
    for (int kx = 0; kx < KMAX; ++kx) acc[oi][kx] = 0.f;
  }
  const int c = c0 + lane;
  for (long long sg = s0; sg < s1; ++sg) {
    const int nn = (int)(sg / ((long long)a.hout * segs_row));
    const int rem = (int)(sg - (long long)nn * a.hout * segs_row);
    const int y = rem / segs_row, x0 = (rem % segs_row) * SEG;
    // dY: 32 pixels x 32 outputs; thread (lane = o, row group).
    for (int px = tid >> 5; px < SEG; px += WT / 32) {
      const int o = o0 + lane, xx = x0 + px;
      Ds[px][lane] = (o < a.cout && xx < a.wout)
                         ? a.dy[nn * a.d_sn + y * a.d_sy + xx * a.d_sx + o] : 0.f;
    }
    // X: the input row y + ky - p, columns x0 - p .. x0 + 31 + p.
    const int yy = y + ky - p;
    for (int j = tid >> 5; j < SEG + k - 1; j += WT / 32) {
      const int xx = x0 - p + j;
      float v = 0.f;
      if (c < a.cin && yy >= 0 && yy < he && xx >= 0 && xx < we)
        v = a.x[nn * a.x_sn + (yy >> a.up) * a.x_sy + (xx >> a.up) * a.x_sx + rotate(c, a.cin)];
      Xs[j][lane] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int px = 0; px < SEG; ++px) {
      const float4 d0 = *reinterpret_cast<const float4*>(&Ds[px][og * WO]);
      const float4 d1 = *reinterpret_cast<const float4*>(&Ds[px][og * WO + 4]);
      const float d[WO] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      if (bias_block) {
#pragma unroll
        for (int oi = 0; oi < WO; ++oi) dbacc[oi] += d[oi];
      }
#pragma unroll
      for (int kx = 0; kx < KMAX; ++kx) {
        if (kx < k) {
          const float xv = Xs[px + kx][lane];
#pragma unroll
          for (int oi = 0; oi < WO; ++oi) acc[oi][kx] = fmaf(d[oi], xv, acc[oi][kx]);
        }
      }
    }
    __syncthreads();
  }
  const int taps = k * k;
#pragma unroll
  for (int oi = 0; oi < WO; ++oi) {
    const int o = o0 + og * WO + oi;
    if (o >= a.cout) continue;
    if (c < a.cin) {
#pragma unroll
      for (int kx = 0; kx < KMAX; ++kx) {
        if (kx >= k) continue;
        float v = acc[oi][kx];
#if F32_PLANT == 1
        if (ky == 0 && kx == 0) v = 0.f;
#endif
        a.part[(((long long)blockIdx.x * a.cout + o) * taps + ky * k + kx) * a.cin + c] = v;
      }
    }
    if (bias_block && lane == 0)
      a.part[(long long)a.splits * a.cout * taps * a.cin + (long long)blockIdx.x * a.cout + o] = dbacc[oi];
  }
}

// Sums the splits' partial grads in split order; writes dW (OIHW) and db.
__global__ void wgrad_reduce_kernel(const Wgrad a) {
  const int taps = a.k * a.k;
  const long long nw = (long long)a.cout * taps * a.cin;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nw + a.cout) return;
  // Two levels, each a short chain in a fixed order: groups of 32 shares,
  // then the groups.
  float s = 0.f;
  if (e < nw) {
    for (int i0 = 0; i0 < a.splits; i0 += 32) {
      float t = 0.f;
      for (int i = i0; i < min(a.splits, i0 + 32); ++i) t += a.part[i * nw + e];
      s += t;
    }
    const int c = (int)(e % a.cin), tap = (int)((e / a.cin) % taps), o = (int)(e / ((long long)a.cin * taps));
    a.dw[((long long)o * a.cin + c) * taps + tap] = s;
  } else {
    const int o = (int)(e - nw);
    for (int i0 = 0; i0 < a.splits; i0 += 32) {
      float t = 0.f;
      for (int i = i0; i < min(a.splits, i0 + 32); ++i) t += a.part[a.splits * nw + (long long)i * a.cout + o];
      s += t;
    }
    a.db[o] = s;
  }
}

}  // namespace cf

extern "C" const char* kernel_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// One conv_f32_fwd launch over the Fwd descriptor `a`, on `stream`.
// Returns the CUDA error code.
extern "C" int conv_f32_fwd(const cf::Fwd* a, void* stream) {
  const long long m = (long long)a->n * (a->r1 - a->r0) * a->wout;
  if (m <= 0 || a->cout <= 0) return 0;
  dim3 grid((unsigned)((m + cf::BM - 1) / cf::BM), (a->cout + cf::BN - 1) / cf::BN);
  cf::conv_fwd_kernel<<<grid, cf::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// Floats of the partial sums a conv_f32_wgrad of `a` needs (its `part`).
extern "C" long long conv_f32_wgrad_scratch(const cf::Wgrad* a) {
  return (long long)a->splits * a->cout * (a->k * a->k * (long long)a->cin + 1);
}

// The splits: at most SEGS_SPLIT 32-pixel row segments a share (each
// thread's chain of f32 sums then spans at most 256 pixels, and the reduce
// adds the shares in chains of 32), and at least about four blocks an SM
// (132 SMs); at most one a segment.
extern "C" int conv_f32_wgrad_splits(int n, int hout, int wout, int k, int cin, int cout) {
  const long long segs = (long long)n * hout * ((wout + cf::SEG - 1) / cf::SEG);
  const long long per = (long long)k * ((cin + 31) / 32) * ((cout + 31) / 32);
  long long s = (segs + cf::SEGS_SPLIT - 1) / cf::SEGS_SPLIT;
  if (s < (4 * 132 + per - 1) / per) s = (4 * 132 + per - 1) / per;
  if (s > segs) s = segs;
  return s < 1 ? 1 : (int)s;
}

// conv_f32_wgrad: the partial sums, then the reduce (two launches on
// `stream`). Returns the CUDA error code.
extern "C" int conv_f32_wgrad(const cf::Wgrad* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->k > cf::KMAX) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(a->splits, a->k * ((a->cin + 31) / 32), (a->cout + 31) / 32);
  cf::wgrad_kernel<<<grid, cf::WT, 0, st>>>(*a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long total = (long long)a->cout * (a->k * a->k * (long long)a->cin + 1);
  cf::wgrad_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
