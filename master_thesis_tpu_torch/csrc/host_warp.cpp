// Host warps of the data pipeline: the movement simulator's bilinear grid
// sample and fused affine warp, and the per-axis linear resize, behind a
// plain C interface loaded with ctypes (runtime/native.py). Each is
// bit-exact with its numpy twin (ops/movements.py, ops/interp.py): the same
// f64 coordinate math and f32 value math in the same order. No library
// is needed, so they build wherever a host C++ compiler is.

#include <cmath>
#include <cstdint>

// ---------------------------------------------------------------------------
// Bilinear grid sample (the movement-simulator hot loop)
// ---------------------------------------------------------------------------
//
// Native twin of ops/movements.py:grid_sample_bilinear_np (itself the numpy
// twin of torch's CPU grid_sample, bilinear + zeros padding): the data
// pipeline warps one background/mask frame into an n-frame synthetic camera
// path per simulated item (reference dataset.py:563-605), and the 4-tap
// gather+lerp dominates single-core item latency. Bit-exact with the numpy
// path: coordinates in f64, weights and value lerp in f32, out-of-bounds
// taps dropped by zeroing their interpolation weight, products summed
// left-to-right.

template <int C>
static void mtt_grid_sample_rows(const float* x, const float* grid, float* out,
                                 int32_t h, int32_t w, int32_t oh, int32_t ow,
                                 int32_t align_corners) {
  for (int64_t p = 0; p < (int64_t)oh * ow; ++p) {
    const double gx = grid[p * 2 + 0];
    const double gy = grid[p * 2 + 1];
    double fx, fy;
    if (align_corners) {
      fx = (gx + 1.0) * 0.5 * (w - 1);
      fy = (gy + 1.0) * 0.5 * (h - 1);
    } else {
      fx = ((gx + 1.0) * w - 1.0) * 0.5;
      fy = ((gy + 1.0) * h - 1.0) * 0.5;
    }
    const double x0d = std::floor(fx);
    const double y0d = std::floor(fy);
    const int64_t x0 = (int64_t)x0d;
    const int64_t y0 = (int64_t)y0d;
    const float wx = (float)(fx - x0d);
    const float wy = (float)(fy - y0d);

    float w00 = (1.0f - wx) * (1.0f - wy);
    float w01 = wx * (1.0f - wy);
    float w10 = (1.0f - wx) * wy;
    float w11 = wx * wy;
    const bool xv0 = x0 >= 0 && x0 < w, xv1 = x0 + 1 >= 0 && x0 + 1 < w;
    const bool yv0 = y0 >= 0 && y0 < h, yv1 = y0 + 1 >= 0 && y0 + 1 < h;
    if (!(xv0 && yv0)) w00 = 0.0f;
    if (!(xv1 && yv0)) w01 = 0.0f;
    if (!(xv0 && yv1)) w10 = 0.0f;
    if (!(xv1 && yv1)) w11 = 0.0f;

    // Clamped tap addresses (weight already zeroed when out of bounds —
    // same clip-then-zero-weight scheme as the numpy twin).
    const int64_t cx0 = x0 < 0 ? 0 : (x0 > w - 1 ? w - 1 : x0);
    const int64_t cx1 = x0 + 1 < 0 ? 0 : (x0 + 1 > w - 1 ? w - 1 : x0 + 1);
    const int64_t cy0 = y0 < 0 ? 0 : (y0 > h - 1 ? h - 1 : y0);
    const int64_t cy1 = y0 + 1 < 0 ? 0 : (y0 + 1 > h - 1 ? h - 1 : y0 + 1);
    const float* r0 = x + cy0 * w * C;
    const float* r1 = x + cy1 * w * C;
    float* dst = out + p * C;
    for (int c = 0; c < C; ++c) {
      dst[c] = r0[cx0 * C + c] * w00 + r0[cx1 * C + c] * w01 +
               r1[cx0 * C + c] * w10 + r1[cx1 * C + c] * w11;
    }
  }
}

// to_orig of ops/movements.py:simulate_movement_resized — virtual-
// normalized warp coordinate -> original-normalized sample coordinate
// through the align_corners=False keep-ratio upscale. r < 0 encodes the
// identity branch (rsize is None); op order mirrors the numpy expression
// exactly (f64, left-associated).
static inline double mtt_to_orig(double pn, double v, double r, double o) {
  if (r < 0.0 || r == o) return pn;
  const double pv = (pn + 1.0) * 0.5 * (v - 1.0);
  const double po = (pv + 0.5) * (o / r) - 0.5;
  return o > 1.0 ? 2.0 * po / (o - 1.0) - 1.0 : pv * 0.0;
}

template <int C>
static void mtt_affine_warp_frame(const float* x, int32_t h, int32_t w,
                                  const double* th, const double* gxv,
                                  int32_t ow, const double* gyv, int32_t oh,
                                  double vx, double rx, double osx,
                                  double vy, double ry, double osy,
                                  float* out) {
  const double t00 = th[0], t01 = th[1], t02 = th[2];
  const double t10 = th[3], t11 = th[4], t12 = th[5];
  for (int32_t i = 0; i < oh; ++i) {
    const double gy = gyv[i];
    for (int32_t j = 0; j < ow; ++j) {
      const double gx = gxv[j];
      // apply_theta -> to_orig -> the f32 rounding the numpy path's
      // astype(np.float32) applies before the warp reads the grid.
      const float gxf = (float)mtt_to_orig(t00 * gx + t01 * gy + t02, vx, rx, osx);
      const float gyf = (float)mtt_to_orig(t10 * gx + t11 * gy + t12, vy, ry, osy);
      // Bilinear gather, align_corners=True (mtt_grid_sample_rows math).
      const double fx = ((double)gxf + 1.0) * 0.5 * (w - 1);
      const double fy = ((double)gyf + 1.0) * 0.5 * (h - 1);
      const double x0d = std::floor(fx);
      const double y0d = std::floor(fy);
      const int64_t x0 = (int64_t)x0d;
      const int64_t y0 = (int64_t)y0d;
      const float wx = (float)(fx - x0d);
      const float wy = (float)(fy - y0d);
      float w00 = (1.0f - wx) * (1.0f - wy);
      float w01 = wx * (1.0f - wy);
      float w10 = (1.0f - wx) * wy;
      float w11 = wx * wy;
      const bool xv0 = x0 >= 0 && x0 < w, xv1 = x0 + 1 >= 0 && x0 + 1 < w;
      const bool yv0 = y0 >= 0 && y0 < h, yv1 = y0 + 1 >= 0 && y0 + 1 < h;
      if (!(xv0 && yv0)) w00 = 0.0f;
      if (!(xv1 && yv0)) w01 = 0.0f;
      if (!(xv0 && yv1)) w10 = 0.0f;
      if (!(xv1 && yv1)) w11 = 0.0f;
      const int64_t cx0 = x0 < 0 ? 0 : (x0 > w - 1 ? w - 1 : x0);
      const int64_t cx1 = x0 + 1 < 0 ? 0 : (x0 + 1 > w - 1 ? w - 1 : x0 + 1);
      const int64_t cy0 = y0 < 0 ? 0 : (y0 > h - 1 ? h - 1 : y0);
      const int64_t cy1 = y0 + 1 < 0 ? 0 : (y0 + 1 > h - 1 ? h - 1 : y0 + 1);
      const float* r0 = x + cy0 * w * C;
      const float* r1 = x + cy1 * w * C;
      float* dst = out + ((int64_t)i * ow + j) * C;
      for (int ch = 0; ch < C; ++ch) {
        dst[ch] = r0[cx0 * C + ch] * w00 + r0[cx1 * C + ch] * w01 +
                  r1[cx0 * C + ch] * w10 + r1[cx1 * C + ch] * w11;
      }
    }
  }
}

extern "C" {

// Fused movement-simulator warp (ops/movements.py:simulate_movement_resized
// hot chain): evaluates the composed-affine grid on the fly — apply_theta
// (f64) -> to_orig (f64) -> f32 round — and gathers the bilinear
// align_corners=True taps from ONE shared source frame, instead of
// materializing (N, OH, OW, 2) grids in numpy and repeating the source N
// times. Bit-exact with the numpy chain by construction (same IEEE f64
// op order, rounded to f32 exactly where the numpy path rounds).
// x: (H, W, C) f32; theta: (N, 2, 3) f64 row-major; gxv (OW) / gyv (OH):
// align_corners=True normalized output positions; (v, r, o) per axis are
// the to_orig parameters, r < 0 for identity. out: (N, OH, OW, C) f32.
int mtt_affine_warp_f32(const float* x, int32_t h, int32_t w, int32_t c,
                        const double* theta, int32_t n, const double* gxv,
                        int32_t ow, const double* gyv, int32_t oh,
                        double vx, double rx, double osx,
                        double vy, double ry, double osy, float* out) {
  if (h <= 0 || w <= 0 || c <= 0 || n <= 0 || ow <= 0 || oh <= 0) return 1;
  for (int32_t f = 0; f < n; ++f) {
    const double* th = theta + (int64_t)f * 6;
    float* of = out + (int64_t)f * oh * ow * c;
    switch (c) {
      case 1:
        mtt_affine_warp_frame<1>(x, h, w, th, gxv, ow, gyv, oh, vx, rx, osx, vy, ry, osy, of);
        break;
      case 2:
        mtt_affine_warp_frame<2>(x, h, w, th, gxv, ow, gyv, oh, vx, rx, osx, vy, ry, osy, of);
        break;
      case 3:
        mtt_affine_warp_frame<3>(x, h, w, th, gxv, ow, gyv, oh, vx, rx, osx, vy, ry, osy, of);
        break;
      default:
        return 2;  // simulator sources are C=1 (masks) or C=3 (frames)
    }
  }
  return 0;
}

// Per-axis linear resize, bit-exact native twin of the host pipeline's
// ops/interp.py:resize_hw_np bilinear branch: the caller precomputes the
// tap tables (idx0, idx1, w1 = interp._linear_taps) and the kernel
// evaluates out = x0*(1-w) + x1*w in f32, the same op order as the numpy
// expression (no FMA contraction at the SSE2 baseline this builds at).
// The array is viewed as (outer, in_size, inner) around the resized axis.
int mtt_resize_axis_linear_f32(const float* x, float* out, int64_t outer,
                               int32_t in_size, int64_t inner,
                               const int32_t* idx0, const int32_t* idx1,
                               const float* w1, int32_t out_size) {
  if (outer <= 0 || in_size <= 0 || inner <= 0 || out_size <= 0) return 1;
  for (int64_t o = 0; o < outer; ++o) {
    const float* xo = x + o * (int64_t)in_size * inner;
    float* oo = out + o * (int64_t)out_size * inner;
    for (int32_t i = 0; i < out_size; ++i) {
      const float w = w1[i];
      const float vw = 1.0f - w;
      const float* r0 = xo + (int64_t)idx0[i] * inner;
      const float* r1 = xo + (int64_t)idx1[i] * inner;
      float* dst = oo + (int64_t)i * inner;
      for (int64_t k = 0; k < inner; ++k) dst[k] = r0[k] * vw + r1[k] * w;
    }
  }
  return 0;
}

// x: (N, H, W, C) f32 contiguous; grid: (N, OH, OW, 2) f32 normalized
// (x, y) in [-1, 1]; out: (N, OH, OW, C) f32 (caller-allocated).
// Returns 0 on success.
int mtt_grid_sample_bilinear_f32(const float* x, const float* grid, float* out,
                                 int32_t n, int32_t h, int32_t w, int32_t c,
                                 int32_t oh, int32_t ow,
                                 int32_t align_corners) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) return 1;
  for (int i = 0; i < n; ++i) {
    const float* xi = x + (int64_t)i * h * w * c;
    const float* gi = grid + (int64_t)i * oh * ow * 2;
    float* oi = out + (int64_t)i * oh * ow * c;
    switch (c) {
      case 1: mtt_grid_sample_rows<1>(xi, gi, oi, h, w, oh, ow, align_corners); break;
      case 2: mtt_grid_sample_rows<2>(xi, gi, oi, h, w, oh, ow, align_corners); break;
      case 3: mtt_grid_sample_rows<3>(xi, gi, oi, h, w, oh, ow, align_corners); break;
      default:
        for (int64_t p = 0; p < (int64_t)oh * ow; ++p) {
          // Generic channel count: reuse the C=1 kernel per channel would
          // re-derive coordinates; keep a scalar inner loop instead.
          const double gx = gi[p * 2 + 0];
          const double gy = gi[p * 2 + 1];
          double fx, fy;
          if (align_corners) {
            fx = (gx + 1.0) * 0.5 * (w - 1);
            fy = (gy + 1.0) * 0.5 * (h - 1);
          } else {
            fx = ((gx + 1.0) * w - 1.0) * 0.5;
            fy = ((gy + 1.0) * h - 1.0) * 0.5;
          }
          const double x0d = std::floor(fx);
          const double y0d = std::floor(fy);
          const int64_t x0 = (int64_t)x0d, y0 = (int64_t)y0d;
          const float wx = (float)(fx - x0d), wy = (float)(fy - y0d);
          float w00 = (1.0f - wx) * (1.0f - wy), w01 = wx * (1.0f - wy);
          float w10 = (1.0f - wx) * wy, w11 = wx * wy;
          const bool xv0 = x0 >= 0 && x0 < w, xv1 = x0 + 1 >= 0 && x0 + 1 < w;
          const bool yv0 = y0 >= 0 && y0 < h, yv1 = y0 + 1 >= 0 && y0 + 1 < h;
          if (!(xv0 && yv0)) w00 = 0.0f;
          if (!(xv1 && yv0)) w01 = 0.0f;
          if (!(xv0 && yv1)) w10 = 0.0f;
          if (!(xv1 && yv1)) w11 = 0.0f;
          const int64_t cx0 = x0 < 0 ? 0 : (x0 > w - 1 ? w - 1 : x0);
          const int64_t cx1 = x0 + 1 < 0 ? 0 : (x0 + 1 > w - 1 ? w - 1 : x0 + 1);
          const int64_t cy0 = y0 < 0 ? 0 : (y0 > h - 1 ? h - 1 : y0);
          const int64_t cy1 = y0 + 1 < 0 ? 0 : (y0 + 1 > h - 1 ? h - 1 : y0 + 1);
          const float* r0 = xi + (cy0 * w + 0) * c;
          const float* r1 = xi + (cy1 * w + 0) * c;
          float* dst = oi + p * c;
          for (int ch = 0; ch < c; ++ch) {
            dst[ch] = r0[cx0 * c + ch] * w00 + r0[cx1 * c + ch] * w01 +
                      r1[cx0 * c + ch] * w10 + r1[cx1 * c + ch] * w11;
          }
        }
    }
  }
  return 0;
}

}  // extern "C"
