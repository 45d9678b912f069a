"""Image decoding and mask dilation of the host data pipeline, on whatever
the host has (master_thesis_tpu/data/pipeline.py: ContentProvider._decode_bg,
_decode_mask, dilate_np; data/meta.py: clean_masks_meta's reads).

- JPEG backgrounds: the native codec (:mod:`..runtime.native`) where it
  built, else OpenCV, else ``ImportError`` naming both.
- PNG content (masks, and PNG files under a background's name): the native
  codec for masks, else OpenCV, else the zlib reader
  (:mod:`..runtime.png`), which gives OpenCV's pixels exactly.
- Dilation: ``scipy.ndimage.binary_dilation`` with OpenCV's cross element
  and iteration count, equal to ``cv2.dilate`` on binary masks.

The native mask decoder marks a pixel where any colour channel is nonzero;
OpenCV's (and the zlib reader's) gray conversion rounds a few colours
near black to 0. Both agree on gray and on the datasets' palette masks.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from master_thesis_tpu_torch.runtime import native, png

_UNSET = object()
_CV2 = _UNSET

JPEG_HELP = (
    "decoding the JPEG {path} needs the native codec or OpenCV, and this host has neither: "
    "the codec did not build ({reason}); install libjpeg and libpng with their headers "
    "(e.g. apt-get install libjpeg-dev libpng-dev), or OpenCV (pip install "
    "opencv-python-headless)"
)


def opencv():
    """The ``cv2`` module, or None where it is not installed (imported once)."""
    global _CV2
    if _CV2 is _UNSET:
        try:
            import cv2
        except ImportError:
            cv2 = None
        _CV2 = cv2
    return _CV2


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == png.SIGNATURE


def decode_background(path: str, min_hw=None) -> np.ndarray:
    """A background frame as float32 RGB in [0, 1], ``(H, W, 3)``. A JPEG
    through the native codec may decode at a reduced DCT scale that still
    covers ``min_hw`` (:func:`..runtime.native.decode_jpeg`); OpenCV and
    PNG files decode at full size."""
    if not _is_png(path) and native.is_available()["codec"]:
        return native.decode_jpeg(path, min_hw=min_hw)
    cv2 = opencv()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return (img[:, :, ::-1].astype(np.float32)) / 255.0  # BGR -> RGB
    if not _is_png(path):
        raise ImportError(JPEG_HELP.format(path=path, reason=native.error("codec")))
    return png.read_png_rgb(path).astype(np.float32) / 255.0


def read_gray(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``, through the zlib reader
    where OpenCV is missing (PNG only)."""
    cv2 = opencv()
    if cv2 is None:
        return png.read_png_gray(path)
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def decode_mask(path: str) -> np.ndarray:
    """A PNG mask as float32 0 / 1, ``(H, W, 1)``."""
    if native.is_available()["codec"]:
        return native.decode_mask_png(path)
    return (read_gray(path) > 0).astype(np.float32)[..., None]


def cross_element(filter_size) -> np.ndarray:
    """OpenCV's ``MORPH_CROSS`` element of size ``(width, height)``: the
    anchor's row and column."""
    w, h = int(filter_size[0]), int(filter_size[1])
    se = np.zeros((h, w), bool)
    se[h // 2, :] = True
    se[:, w // 2] = True
    return se


def dilate_np(mask: np.ndarray, filter_size, iterations: int) -> np.ndarray:
    """``cv2.dilate`` with the cross element per frame of ``mask`` ``(F, H,
    W, 1)`` (0 / 1): OpenCV takes the maximum over the element anchored at
    ``size // 2``, which is scipy's dilation by the reflected element,
    shifted one pixel on an axis of even size."""
    if iterations < 1:  # OpenCV copies; scipy would dilate to a fixed point
        return mask.copy()
    se = cross_element(filter_size)[::-1, ::-1]
    origin = tuple(-(1 - s % 2) for s in se.shape)
    out = np.empty_like(mask)
    for f in range(mask.shape[0]):
        out[f, :, :, 0] = ndimage.binary_dilation(
            mask[f, :, :, 0] > 0, structure=se, iterations=iterations, origin=origin)
    return out
