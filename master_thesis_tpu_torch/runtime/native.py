"""ctypes bindings of the data pipeline's host libraries
(master_thesis_tpu/runtime/native.py).

Two libraries, built at first use by the host C++ compiler into the
package's ``build/`` (:func:`.._build.build_host`):

- ``warp`` (``csrc/host_warp.cpp``, no dependency): the movement
  simulator's grid sample and fused affine warp, and the per-axis linear
  resize, each bit-exact with its numpy twin;
- ``codec`` (``csrc/host_decode.cpp``, ``-ljpeg -lpng``): JPEG and PNG-mask
  decoding. It builds only where libjpeg's and libpng's headers are.

:func:`is_available` reports each. A library that fails to build or load
is tried once: the failure is kept for the process (and the failed compile
for later processes, :mod:`.._build`), and the callers take their numpy,
OpenCV or zlib paths. Calls hold no Python state, so loader threads run
them in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import numpy as np

from master_thesis_tpu_torch import _build

LIBS = {"warp": ("host_warp", ()), "codec": ("host_decode", ("-ljpeg", "-lpng"))}

_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_errors: Dict[str, str] = {}
_lock = threading.Lock()

_f32 = ctypes.POINTER(ctypes.c_float)
_f64 = ctypes.POINTER(ctypes.c_double)
_i32 = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "warp": {
        "mtt_grid_sample_bilinear_f32": [_f32, _f32, _f32] + [ctypes.c_int32] * 7,
        "mtt_resize_axis_linear_f32": [_f32, _f32, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int64, _i32, _i32, _f32, ctypes.c_int32],
        "mtt_affine_warp_f32": [_f32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                _f64, ctypes.c_int32, _f64, ctypes.c_int32, _f64,
                                ctypes.c_int32] + [ctypes.c_double] * 6 + [_f32],
    },
    "codec": {
        "mtt_jpeg_probe": [ctypes.c_char_p, _i32, _i32],
        "mtt_png_probe": [ctypes.c_char_p, _i32, _i32],
        "mtt_jpeg_decode_f32": [ctypes.c_char_p, _f32, ctypes.c_int32, ctypes.c_int32],
        "mtt_jpeg_decode_scaled_f32": [ctypes.c_char_p, _f32, ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_int32, _i32, _i32],
        "mtt_png_decode_mask_f32": [ctypes.c_char_p, _f32, ctypes.c_int32, ctypes.c_int32],
    },
}


def _load(kind: str) -> Optional[ctypes.CDLL]:
    """The ``kind`` library, built and loaded on the first call; None, with
    the reason in :func:`error`, when that failed (not tried again)."""
    if kind in _libs:
        return _libs[kind]
    with _lock:
        if kind not in _libs:
            name, libs = LIBS[kind]
            lib = None
            try:
                lib = ctypes.CDLL(str(_build.build_host(name, libs)))
                for fn, argtypes in _SIGNATURES[kind].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            except (_build.HostBuildError, OSError, AttributeError) as e:
                lib = None
                _errors[kind] = str(e)
            _libs[kind] = lib
    return _libs[kind]


def is_available() -> Dict[str, bool]:
    """``{"warp": ..., "codec": ...}``: whether each library loaded."""
    return {kind: _load(kind) is not None for kind in LIBS}


def error(kind: str) -> Optional[str]:
    """Why the ``kind`` library is unavailable, if it is."""
    _load(kind)
    return _errors.get(kind)


def _lib(kind: str) -> ctypes.CDLL:
    lib = _load(kind)
    if lib is None:
        raise ImportError(f"the native {kind} library is unavailable: {_errors[kind]}")
    return lib


def jpeg_scale_num(h: int, w: int, min_h: int, min_w: int) -> int:
    """Smallest DCT scale numerator n (denominator 8) whose scaled decode
    still covers ``(min_h, min_w)``, ceil(dim * n / 8) >= target on both
    axes; 8 = full size. n stops at 5: libjpeg-turbo's 6/8 and 7/8 scaled
    IDCTs are not SIMD and decode slower than full size."""
    for n in range(1, 6):
        if -(-h * n // 8) >= min_h and -(-w * n // 8) >= min_w:
            return n
    return 8


def decode_jpeg(path: str, min_hw: Optional[tuple] = None) -> np.ndarray:
    """JPEG -> float32 [0, 1] ``(H, W, 3)`` RGB. With ``min_hw=(h, w)``:
    decoded at the smallest DCT scale (:func:`jpeg_scale_num`) that still
    covers it, for a caller that resizes down to it. Raises ``IOError`` on
    a file that is not a readable JPEG."""
    lib = _lib("codec")
    h, w = ctypes.c_int32(), ctypes.c_int32()
    p = path.encode()
    if lib.mtt_jpeg_probe(p, ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"jpeg probe failed: {path}")
    if min_hw is not None:
        n = jpeg_scale_num(h.value, w.value, min_hw[0], min_hw[1])
        if n < 8:
            bh, bw = -(-h.value * n // 8), -(-w.value * n // 8)
            out = np.empty((bh, bw, 3), np.float32)
            oh, ow = ctypes.c_int32(), ctypes.c_int32()
            rc = lib.mtt_jpeg_decode_scaled_f32(p, out.ctypes.data_as(_f32), bh, bw, n,
                                                ctypes.byref(oh), ctypes.byref(ow))
            if rc == 0:
                # Rows are packed at the scaled width the library chose.
                k = oh.value * ow.value * 3
                return out.ravel()[:k].reshape(oh.value, ow.value, 3).copy()
            # rc 4: the library's scaled size exceeds the buffer; decode
            # at full size.
    out = np.empty((h.value, w.value, 3), np.float32)
    rc = lib.mtt_jpeg_decode_f32(p, out.ctypes.data_as(_f32), h, w)
    if rc != 0:
        raise IOError(f"jpeg decode failed ({rc}): {path}")
    return out


def decode_mask_png(path: str) -> np.ndarray:
    """PNG -> float32 binary mask ``(H, W, 1)``: 1 where any colour channel
    (or the gray value, or the palette entry's colour) is nonzero."""
    lib = _lib("codec")
    h, w = ctypes.c_int32(), ctypes.c_int32()
    p = path.encode()
    if lib.mtt_png_probe(p, ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"png probe failed: {path}")
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.mtt_png_decode_mask_f32(p, out.ctypes.data_as(_f32), h, w)
    if rc != 0:
        raise IOError(f"png decode failed ({rc}): {path}")
    return out[..., None]


def resize_axis_linear(x: np.ndarray, axis: int, idx0: np.ndarray, idx1: np.ndarray,
                       w1: np.ndarray, out_size: int) -> np.ndarray:
    """``take(x, idx0, axis) * (1 - w1) + take(x, idx1, axis) * w1`` in f32,
    bit-exact with that numpy expression (:func:`..ops.interp.resize_hw_np`)."""
    lib = _lib("warp")
    x = np.ascontiguousarray(x, np.float32)
    axis = axis % x.ndim
    outer = int(np.prod(x.shape[:axis], dtype=np.int64))
    inner = int(np.prod(x.shape[axis + 1:], dtype=np.int64))
    out = np.empty(x.shape[:axis] + (int(out_size),) + x.shape[axis + 1:], np.float32)
    idx0 = np.ascontiguousarray(idx0, np.int32)
    idx1 = np.ascontiguousarray(idx1, np.int32)
    w1 = np.ascontiguousarray(w1, np.float32)
    rc = lib.mtt_resize_axis_linear_f32(
        x.ctypes.data_as(_f32), out.ctypes.data_as(_f32), outer, x.shape[axis], inner,
        idx0.ctypes.data_as(_i32), idx1.ctypes.data_as(_i32), w1.ctypes.data_as(_f32),
        int(out_size))
    if rc != 0:
        raise RuntimeError(f"resize_axis_linear failed ({rc})")
    return out


def affine_warp(x: np.ndarray, theta: np.ndarray, gxv: np.ndarray, gyv: np.ndarray,
                x_orig: tuple, y_orig: tuple) -> np.ndarray:
    """The simulator's fused warp (:meth:`..ops.movements.MovementSimulator.
    simulate_movement_resized`): per output pixel the grid chain
    (apply_theta, to_orig, f32 round) and the bilinear align_corners=True
    gather from one source frame. ``x`` ``(H, W, C)`` f32, C in 1..3;
    ``theta`` ``(N, 2, 3)`` f64; ``gxv`` ``(OW,)`` / ``gyv`` ``(OH,)`` the
    normalised output positions; ``x_orig`` / ``y_orig`` to_orig's ``(vsize,
    rsize, osize)`` per axis, rsize < 0 for the identity. Returns ``(N, OH,
    OW, C)`` f32."""
    lib = _lib("warp")
    x = np.ascontiguousarray(x, np.float32)
    theta = np.ascontiguousarray(theta, np.float64)
    gxv = np.ascontiguousarray(gxv, np.float64)
    gyv = np.ascontiguousarray(gyv, np.float64)
    h, w, c = x.shape
    n = theta.shape[0]
    ow, oh = gxv.shape[0], gyv.shape[0]
    out = np.empty((n, oh, ow, c), np.float32)
    rc = lib.mtt_affine_warp_f32(
        x.ctypes.data_as(_f32), h, w, c, theta.ctypes.data_as(_f64), n,
        gxv.ctypes.data_as(_f64), ow, gyv.ctypes.data_as(_f64), oh,
        *(float(v) for v in x_orig), *(float(v) for v in y_orig), out.ctypes.data_as(_f32))
    if rc != 0:
        raise RuntimeError(f"affine_warp failed ({rc})")
    return out


def grid_sample_bilinear(x: np.ndarray, grid: np.ndarray, align_corners: bool) -> np.ndarray:
    """Bilinear grid sample with zeros padding, bit-exact with
    :func:`..ops.movements.grid_sample_bilinear_np`. ``x`` ``(N, H, W, C)``
    f32; ``grid`` ``(N, OH, OW, 2)`` f32."""
    lib = _lib("warp")
    x = np.ascontiguousarray(x, np.float32)
    grid = np.ascontiguousarray(grid, np.float32)
    n, h, w, c = x.shape
    oh, ow = grid.shape[1:3]
    out = np.empty((n, oh, ow, c), np.float32)
    rc = lib.mtt_grid_sample_bilinear_f32(
        x.ctypes.data_as(_f32), grid.ctypes.data_as(_f32), out.ctypes.data_as(_f32),
        n, h, w, c, oh, ow, int(align_corners))
    if rc != 0:
        raise RuntimeError(f"grid_sample_bilinear failed ({rc})")
    return out
