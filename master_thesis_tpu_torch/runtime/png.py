"""PNG reading and writing over ``zlib`` and numpy, for a host that has
neither the native codec (:mod:`.native`) nor OpenCV.

:func:`read_png` reads the PNGs the datasets, OpenCV and PIL write: not
interlaced, bit depth 8 for gray, gray + alpha, RGB and RGBA, and 1, 2, 4
or 8 for gray and palette. The two conversions give OpenCV's pixels
exactly (PNG is lossless, and ``cv2`` reads through libpng):

- :func:`read_png_gray` is ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: a
  colour pixel (a palette entry's colour too) becomes libpng's
  ``png_set_rgb_to_gray(1, 0.299, 0.587)`` gray, ``(9797 R + 19234 G +
  3737 B) >> 15``, alpha dropped;
- :func:`read_png_rgb` is ``cv2.imread(path, cv2.IMREAD_COLOR)`` in RGB
  order: gray repeated, alpha dropped.

:func:`write_png` writes 8-bit gray or RGB (filter 0), which every reader
takes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels per colour type: gray, RGB, palette, gray + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's fixed-point gray coefficients for (0.299, 0.587), out of 32768.
_GRAY_RC, _GRAY_GC = 9797, 19234
_GRAY_BC = 32768 - _GRAY_RC - _GRAY_GC


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        yield data[pos + 4: pos + 8], data[pos + 8: pos + 8 + n]
        pos += 12 + n


def _unfilter(raw: np.ndarray, h: int, n: int, bpp: int) -> np.ndarray:
    """Undoes the per-row filters (PNG spec 9.2) of ``raw``: h rows of a
    filter byte and ``n`` bytes, ``bpp`` bytes a pixel (1 below 8 bits)."""
    rows = raw.reshape(h, 1 + n)
    out = np.zeros((h, n), np.uint8)
    prior = np.zeros(n, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along the row, per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (line + prior) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: each byte reads the one left
            cur = np.zeros_like(line)
            for i in range(n):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prior[i])
                if kind == 3:
                    cur[i] = (line[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = int(prior[i - bpp]) if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str):
    """``(pixels, palette)``: pixels ``(H, W, C)`` uint8 as stored (C = 1
    for gray and palette indexes, 2, 3 or 4), palette ``(n, 3)`` uint8 or
    None. Raises ``ValueError`` on a PNG outside the supported kinds."""
    with open(path, "rb") as f:
        data = f.read()
    idat, palette, header = [], None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    packed = depth in (1, 2, 4) and color in (0, 3)
    if interlace != 0 or color not in _CHANNELS or not (depth == 8 or packed):
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type {color}, interlace "
                         f"{interlace} is not supported")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not packed:
        pixels = _unfilter(raw, h, w * bpp, bpp).reshape(h, w, bpp)
        return pixels, (palette if color == 3 else None)
    rows = _unfilter(raw, h, -(-w * depth // 8), 1)
    shifts = (8 - depth) - depth * np.arange(8 // depth)  # the first pixel in the high bits
    values = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    if color == 3:
        return values.astype(np.uint8)[..., None], palette
    # Gray below 8 bits scales to 0..255, as libpng's expansion does.
    return (values * (255 // ((1 << depth) - 1))).astype(np.uint8)[..., None], None


def _rgb(pixels: np.ndarray, palette) -> np.ndarray:
    """``(H, W, 3)`` uint8 RGB of a :func:`read_png` result."""
    if palette is not None:
        return palette[pixels[..., 0]]
    if pixels.shape[-1] in (1, 2):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return pixels[..., :3]


def read_png_gray(path: str) -> np.ndarray:
    """``(H, W)`` uint8, as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``."""
    pixels, palette = read_png(path)
    if palette is None and pixels.shape[-1] in (1, 2):
        return np.ascontiguousarray(pixels[..., 0])
    rgb = _rgb(pixels, palette).astype(np.uint32)
    gray = (_GRAY_RC * rgb[..., 0] + _GRAY_GC * rgb[..., 1] + _GRAY_BC * rgb[..., 2]) >> 15
    return gray.astype(np.uint8)


def read_png_rgb(path: str) -> np.ndarray:
    """``(H, W, 3)`` uint8 RGB, as ``cv2.imread(path, cv2.IMREAD_COLOR)``
    with its channels reversed."""
    return np.ascontiguousarray(_rgb(*read_png(path)))


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Writes ``image`` uint8 ``(H, W)`` (gray) or ``(H, W, 3)`` (RGB) as an
    8-bit PNG with every row unfiltered."""
    image = np.ascontiguousarray(image, np.uint8)
    color = 0 if image.ndim == 2 else 2
    h, w = image.shape[:2]
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))
