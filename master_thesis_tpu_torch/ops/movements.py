"""Synthetic camera-motion simulator (master_thesis_tpu/ops/movements.py:
MovementSimulator, affine_matrix, stack_transformations, affine2theta,
affine_grid_np, crop_flow_np, grid_sample_bilinear_np).

Generates random affine camera paths, warps a single frame into an n-frame
sequence, and returns the inverse flows as ground truth for DFPN's supervised
flow loss (reference: utils.py:227-401). Numpy only, no torch: it runs in the
data pipeline's worker threads and processes. The coordinate conventions
are those of :mod:`.grid_sample`, so the ground-truth flows mean what the
flows DFPN predicts on the device mean. The warps take the native host
library (:mod:`..runtime.native`, bit-exact with the numpy expressions here)
where it loaded, and numpy elsewhere.

Matrix convention: 3x3 homogeneous affine acting on pixel coordinates
``(x, y, 1)``, composed like ``skimage.transform.AffineTransform(
translation, scale, rotation).params``:

    [[sx*cos r, -sy*sin r, tx],
     [sx*sin r,  sy*cos r, ty],
     [0,         0,         1]]
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from master_thesis_tpu_torch.runtime import native


class MovementSimulator:
    """Random affine movement generator (reference utils.py:227-260)."""

    def __init__(
        self,
        max_displacement: float,
        max_scaling: float,
        max_rotation: float,
        rng: Optional[np.random.RandomState] = None,
    ):
        self.max_displacement = max_displacement
        self.max_scaling = max_scaling
        self.max_rotation = max_rotation
        self.rng = rng if rng is not None else np.random.RandomState()

    def random_affine(self) -> np.ndarray:
        if self.max_displacement > 0:
            tx, ty = self.rng.randint(
                low=-int(self.max_displacement), high=int(self.max_displacement), size=2
            )
        else:
            tx, ty = 0, 0
        sx, sy = self.rng.uniform(
            low=1 - self.max_scaling, high=1 + self.max_scaling, size=2
        )
        rot = self.rng.uniform(low=-self.max_rotation, high=self.max_rotation)
        return affine_matrix(translation=(tx, ty), scale=(sx, sy), rotation=rot)

    def simulate_movement(
        self,
        x: np.ndarray,
        n: int,
        affine_matrices: Optional[List[np.ndarray]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
        """Warps frame ``x`` (H, W, C) into an ``n``-frame moving sequence.

        Returns ``(y, flow_inv, affine_matrices)`` where ``y`` is
        ``(n, H, W, C)`` and ``flow_inv`` is the ``(n, H, W, 2)`` ground-truth
        inverse flow (reference utils.py:262-318).
        """
        h, w = x.shape[0], x.shape[1]
        if affine_matrices is None:
            mats = [self.random_affine() for _ in range(n - 1)]
            affine_matrices = mats[: n // 2] + [identity_affine()] + mats[n // 2 :]
        mats_inv = [np.linalg.inv(m) for m in affine_matrices]

        stacked = stack_transformations(np.stack(affine_matrices), t=n // 2)
        stacked_inv = stack_transformations(np.stack(mats_inv), t=n // 2)

        theta = np.stack([affine2theta(m, h, w) for m in stacked])
        theta_inv = np.stack([affine2theta(m, h, w) for m in stacked_inv])

        flow = affine_grid_np(theta, (h, w), align_corners=True)
        flow_inv = affine_grid_np(theta_inv, (h, w), align_corners=True)

        y = grid_sample_bilinear_np(
            np.repeat(x[None], n, axis=0), flow, align_corners=True
        )
        return y, flow_inv.astype(np.float32), affine_matrices

    def simulate_movement_resized(
        self,
        x: np.ndarray,
        n: int,
        out_size: Tuple[int, int],
        virtual_hw: Optional[Tuple[int, int]] = None,
        affine_matrices: Optional[List[np.ndarray]] = None,
        value_mode: str = "bilinear",
        resized_hw: Optional[Tuple[int, int]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
        """The data-pipeline composite ``upscale to virtual_hw -> warp ->
        resize to out_size`` evaluated directly at ``out_size`` — the
        single-core fast path of the simulator hot loop.

        The reference pipeline (dataset.py:563-605 + :135-156) upscales the
        background to >= 2x train size, warps every frame at that size, then
        resizes down to the train size — ~8x more warped pixels than the
        train frames keep. All three maps are (bi)linear in *coordinates*,
        so their composition is evaluated analytically and only ``out_size``
        pixels are ever gathered:

        - **flows** are EXACT: the inverse-affine grid is evaluated at the
          virtual-resolution positions the reference's nearest resize would
          have picked (``floor(i*in/out)``, ops/interp.py:_nearest_indices).
        - **masks** (``value_mode="nearest"``, no min-height upscale, so
          ``virtual_hw`` = native) are EXACT: nearest-resize-of-warp equals
          the warp evaluated at the nearest-picked positions.
        - **background values** deviate: ``bilinear_resize(warp(upscale(x)))``
          is a cascade of bilinear kernels while the fast path samples ``x``
          once at the composed coordinate — a low-pass difference bounded by
          the image's local curvature (PARITY.md deviation; the exact path
          stays for ``image_resize=False`` and ``--fast_simulator false``).

        Args:
            virtual_hw: size the reference path would warp at (the
                min-height keep-ratio target after its drop-last-column
                crop, or ``x.shape[:2]``).
            value_mode: back-projection rule of the final resize —
                ``"bilinear"`` (align_corners=False source positions, the
                backgrounds' resize) or ``"nearest"`` (the masks' resize).
            resized_hw: the UNCROPPED keep-ratio resize target when the
                exact path upscales first (``interp.resize_hw_np`` with
                align_corners=False); virtual coordinates are back-mapped
                through that resize so the composed grid addresses the
                original pixels the upscale would have interpolated.
        """
        h, w = x.shape[0], x.shape[1]
        hs, ws = virtual_hw if virtual_hw is not None else (h, w)
        oh, ow = out_size
        if affine_matrices is None:
            mats = [self.random_affine() for _ in range(n - 1)]
            affine_matrices = mats[: n // 2] + [identity_affine()] + mats[n // 2 :]
        mats_inv = [np.linalg.inv(m) for m in affine_matrices]

        stacked = stack_transformations(np.stack(affine_matrices), t=n // 2)
        stacked_inv = stack_transformations(np.stack(mats_inv), t=n // 2)
        theta = np.stack([affine2theta(m, hs, ws) for m in stacked]).astype(np.float64)
        theta_inv = np.stack(
            [affine2theta(m, hs, ws) for m in stacked_inv]
        ).astype(np.float64)

        def norm(idx, size):
            # Virtual-pixel position -> align_corners=True normalized coord.
            return 2.0 * idx / (size - 1) - 1.0 if size > 1 else np.zeros_like(idx)

        if value_mode == "bilinear":
            # torch bilinear (align_corners=False) source positions.
            sy = np.clip((np.arange(oh) + 0.5) * (hs / oh) - 0.5, 0.0, hs - 1)
            sx = np.clip((np.arange(ow) + 0.5) * (ws / ow) - 0.5, 0.0, ws - 1)
        elif value_mode == "nearest":
            sy = np.clip(np.floor(np.arange(oh) * (hs / oh)), 0, hs - 1)
            sx = np.clip(np.floor(np.arange(ow) * (ws / ow)), 0, ws - 1)
        else:
            raise ValueError(f"unknown value_mode: {value_mode}")
        def apply_theta(t, gx, gy):
            # (N, oh, ow, 2) normalized grid: theta @ (gx, gy, 1).
            ox = t[:, None, None, 0, 0] * gx + t[:, None, None, 0, 1] * gy + t[:, None, None, 0, 2]
            oy = t[:, None, None, 1, 0] * gx + t[:, None, None, 1, 1] * gy + t[:, None, None, 1, 2]
            return np.stack([ox, oy], axis=-1)

        def to_orig(pn, vsize, rsize, osize):
            """Virtual-normalized warp coord -> original-normalized sample
            coord through the align_corners=False keep-ratio upscale."""
            if rsize is None or rsize == osize:
                return pn
            pv = (pn + 1.0) * 0.5 * (vsize - 1)  # virtual pixel position
            po = (pv + 0.5) * (osize / rsize) - 0.5  # original pixel position
            return 2.0 * po / (osize - 1) - 1.0 if osize > 1 else pv * 0.0

        rh, rw = resized_hw if resized_hw is not None else (None, None)
        gx1 = norm(sx, ws)
        gy1 = norm(sy, hs)
        if x.dtype == np.float32 and x.shape[-1] in (1, 2, 3) and native.is_available()["warp"]:
            # Fused native chain (csrc/host_warp.cpp:mtt_affine_warp_f32):
            # apply_theta -> to_orig -> f32 round -> bilinear gather from
            # the ONE shared source frame, evaluated per output pixel —
            # bit-exact with the numpy chain below (same f64 op order,
            # rounded to f32 exactly where astype rounds) without
            # materializing (n, oh, ow, 2) grids or repeating the source n
            # times.
            y = native.affine_warp(
                x, theta, gx1, gy1,
                (ws, -1.0 if rw is None else rw, w),
                (hs, -1.0 if rh is None else rh, h),
            )
        else:
            gy_v, gx_v = np.meshgrid(gy1, gx1, indexing="ij")
            flow = apply_theta(theta, gx_v, gy_v)
            flow = np.stack(
                [to_orig(flow[..., 0], ws, rw, w), to_orig(flow[..., 1], hs, rh, h)],
                axis=-1,
            ).astype(np.float32)
            y = grid_sample_bilinear_np(
                np.repeat(x[None], n, axis=0), flow, align_corners=True
            )

        # The ground-truth flow the reference would produce: computed at
        # virtual resolution, nearest-resized to out_size — exact here.
        iy = np.clip(np.floor(np.arange(oh) * (hs / oh)), 0, hs - 1)
        ix = np.clip(np.floor(np.arange(ow) * (ws / ow)), 0, ws - 1)
        gy_n, gx_n = np.meshgrid(norm(iy, hs), norm(ix, ws), indexing="ij")
        flow_inv = apply_theta(theta_inv, gx_n, gy_n).astype(np.float32)

        return y, flow_inv, affine_matrices


def affine_matrix(
    translation=(0.0, 0.0), scale=(1.0, 1.0), rotation: float = 0.0
) -> np.ndarray:
    sx, sy = scale
    r = rotation
    return np.array(
        [
            [sx * np.cos(r), -sy * np.sin(r), translation[0]],
            [sx * np.sin(r), sy * np.cos(r), translation[1]],
            [0.0, 0.0, 1.0],
        ],
        dtype=np.float64,
    )


def identity_affine() -> np.ndarray:
    return np.eye(3, dtype=np.float64)


def stack_transformations(affine_matrices: np.ndarray, t: int) -> np.ndarray:
    """Composes per-step transforms outward from center frame ``t``.

    ``out[i]`` maps target-frame coordinates to frame ``i``'s coordinates
    (reference utils.py:347-377).
    """
    out = np.zeros_like(affine_matrices)
    out[t] = affine_matrices[t]
    for i in reversed(range(t)):
        out[i] = np.linalg.inv(affine_matrices[i]) @ out[i + 1]
    for i in range(t + 1, len(affine_matrices)):
        out[i] = affine_matrices[i] @ out[i - 1]
    return out


def affine2theta(param: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pixel-space 3x3 affine -> normalized 2x3 grid-generator matrix.

    Same conversion as the reference (utils.py:379-401), valid for the
    align_corners=True normalized coordinate system.
    """
    theta = np.zeros((2, 3))
    theta[0, 0] = param[0, 0]
    theta[0, 1] = param[0, 1] * h / w
    theta[0, 2] = param[0, 2] * 2 / w + param[0, 0] + param[0, 1] - 1
    theta[1, 0] = param[1, 0] * w / h
    theta[1, 1] = param[1, 1]
    theta[1, 2] = param[1, 2] * 2 / h + param[1, 0] + param[1, 1] - 1
    return theta.astype(np.float32)


def affine_grid_np(
    theta: np.ndarray, size_hw: Tuple[int, int], align_corners: bool = True
) -> np.ndarray:
    """Numpy twin of ops.grid_sample.affine_grid: (N,2,3) -> (N,H,W,2)."""
    h, w = size_hw
    if align_corners:
        xs = np.linspace(-1.0, 1.0, w)
        ys = np.linspace(-1.0, 1.0, h)
    else:
        xs = (np.arange(w) * 2 + 1) / w - 1.0
        ys = (np.arange(h) * 2 + 1) / h - 1.0
    gx, gy = np.meshgrid(xs, ys)
    t = theta.astype(np.float64)
    out_x = t[:, None, None, 0, 0] * gx + t[:, None, None, 0, 1] * gy + t[:, None, None, 0, 2]
    out_y = t[:, None, None, 1, 0] * gx + t[:, None, None, 1, 1] * gy + t[:, None, None, 1, 2]
    return np.stack([out_x, out_y], axis=-1).astype(np.float32)


def identity_grid_np(h: int, w: int) -> np.ndarray:
    xs = np.linspace(-1.0, 1.0, w, dtype=np.float32)
    ys = np.linspace(-1.0, 1.0, h, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx, gy], axis=-1)


def crop_flow_np(flow: np.ndarray, crop_size, crop_position) -> np.ndarray:
    """Numpy twin of ops.flows.crop_flow for the host pipeline (keeps data
    workers off the accelerator). flow: ``(F, H, W, 2)`` absolute."""
    h, w = flow.shape[-3], flow.shape[-2]
    ch, cw = crop_size
    ph, pw = crop_position
    rel = flow - identity_grid_np(h, w)
    rel = rel[..., ph : ph + ch, pw : pw + cw, :]
    rel = rel * np.asarray([w / cw, h / ch], dtype=flow.dtype)
    return rel + identity_grid_np(ch, cw)


def grid_sample_bilinear_np(
    x: np.ndarray, grid: np.ndarray, align_corners: bool = True
) -> np.ndarray:
    """Numpy twin of ops.grid_sample.grid_sample (bilinear, zeros padding).

    x: (N, H, W, C); grid: (N, H', W', 2) with (x, y) in [-1, 1].

    The all-f32 case (the fast-simulator hot loop: one background/mask
    frame warped into an n-frame camera path per simulated item) routes
    to the native library's bit-exact single-pass kernel
    (csrc/host_warp.cpp:mtt_grid_sample_bilinear_f32) where it loaded;
    f64 grids (the exact simulator path, which keeps its coordinates in f64
    end-to-end) stay on the numpy path below.
    """
    if x.dtype == np.float32 and grid.dtype == np.float32 and native.is_available()["warp"]:
        return native.grid_sample_bilinear(x, grid, align_corners)
    n, h, w, c = x.shape
    gx = grid[..., 0].astype(np.float64)
    gy = grid[..., 1].astype(np.float64)
    if align_corners:
        fx = (gx + 1) * 0.5 * (w - 1)
        fy = (gy + 1) * 0.5 * (h - 1)
    else:
        fx = ((gx + 1) * w - 1) * 0.5
        fy = ((gy + 1) * h - 1) * 0.5

    # Coordinates in f64 (cheap, (N,H',W')-sized); VALUE math in f32 —
    # matching torch's CPU grid_sample, which lerps in the input dtype.
    # This is the data-worker hot loop (the movement simulator warps a
    # >=2x-train-size background per simulated item, dataset.py:589-594),
    # so taps gather via flat take_along_axis and out-of-bounds taps are
    # dropped by zeroing their *interpolation weight* — no per-tap
    # full-size np.where temporaries.
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    wx = (fx - x0).astype(np.float32)
    wy = (fy - y0).astype(np.float32)

    x_flat = np.ascontiguousarray(x.reshape(n, h * w, c))

    def take(iy, ix):
        valid = ((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)).astype(np.float32)
        idx = np.clip(iy, 0, h - 1) * w + np.clip(ix, 0, w - 1)
        vals = np.take_along_axis(x_flat, idx.reshape(n, -1, 1), axis=1)
        return vals.reshape(iy.shape + (c,)), valid

    v00, m00 = take(y0, x0)
    v01, m01 = take(y0, x0 + 1)
    v10, m10 = take(y0 + 1, x0)
    v11, m11 = take(y0 + 1, x0 + 1)
    out = (
        v00 * (((1 - wx) * (1 - wy)) * m00)[..., None]
        + v01 * ((wx * (1 - wy)) * m01)[..., None]
        + v10 * (((1 - wx) * wy) * m10)[..., None]
        + v11 * ((wx * wy) * m11)[..., None]
    )
    return out.astype(x.dtype)
