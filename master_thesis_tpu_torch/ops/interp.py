"""Image resizing on channel-last tensors and numpy arrays
(master_thesis_tpu/ops/interp.py: resize_hw, resize_hw_np).

The JAX package builds its own tap tables so a resize is a pair of matmuls
on the TPU; here bilinear is ``F.interpolate`` without antialiasing (torch
semantics, which the JAX tables reproduce), and nearest gathers along each
axis with the JAX package's own index table, torch's legacy nearest
``src = floor(dst * in / out)`` computed in float64 (``F.interpolate``
computes it in float32, which can round the other way).

:func:`resize_hw_np` is the data pipeline's host resize on numpy arrays,
with the JAX package's tap tables in float64 (``_linear_taps``), so host
and device resizes agree bit for bit; its bilinear axes of a float32 array
take the native host library (:mod:`..runtime.native`) where it loaded.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from master_thesis_tpu_torch.device import constant
from master_thesis_tpu_torch.runtime import native


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def _linear_taps(in_size: int, out_size: int, align_corners: bool):
    """``(idx0, idx1, weight of idx1)`` of a 1-D linear resize, torch's
    source positions computed in float64."""
    if align_corners and out_size > 1:
        src = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    elif align_corners:
        src = np.zeros(out_size)
    else:
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    src = np.clip(src, 0.0, max(in_size - 1, 0))
    idx0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    idx1 = np.clip(idx0 + 1, 0, in_size - 1)
    w1 = (src - idx0).astype(np.float32)
    return idx0, idx1, w1


def resize_hw_np(
    x: np.ndarray, size: Sequence[int], mode: str = "bilinear", align_corners: bool = False
) -> np.ndarray:
    """Resizes axes (-3, -2) of a channel-last numpy array to ``size=(H',
    W')``: nearest gathers :func:`_nearest_indices`; bilinear is
    ``take(x, idx0) * (1 - w1) + take(x, idx1) * w1`` per axis, natively
    for float32 where the warp library loaded (bit-exact with the numpy
    expression)."""
    h, w = int(size[0]), int(size[1])
    h_axis, w_axis = x.ndim - 3, x.ndim - 2
    if mode == "nearest":
        if x.shape[h_axis] != h:
            x = np.take(x, _nearest_indices(x.shape[h_axis], h), axis=h_axis)
        if x.shape[w_axis] != w:
            x = np.take(x, _nearest_indices(x.shape[w_axis], w), axis=w_axis)
        return x
    if mode != "bilinear":
        raise ValueError(f"unknown resize mode: {mode}")
    for axis, out_size in ((h_axis, h), (w_axis, w)):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        idx0, idx1, w1 = _linear_taps(in_size, out_size, align_corners)
        if x.dtype == np.float32 and native.is_available()["warp"]:
            x = native.resize_axis_linear(x, axis, idx0, idx1, w1, out_size)
            continue
        shape = [1] * x.ndim
        shape[axis] = out_size
        w1 = w1.astype(x.dtype).reshape(shape)
        x = np.take(x, idx0, axis=axis) * (1 - w1) + np.take(x, idx1, axis=axis) * w1
    return x


def resize_hw(
    x: torch.Tensor, size: Sequence[int], mode: str = "bilinear", *, align_corners: bool = False
) -> torch.Tensor:
    """Resizes axes (-3, -2) of a channel-last tensor to ``size=(H', W')``,
    ``mode`` "bilinear" or "nearest" (which ignores ``align_corners``)."""
    h, w = int(size[0]), int(size[1])
    if mode == "nearest":
        for axis, out_size in ((x.ndim - 3, h), (x.ndim - 2, w)):
            if x.shape[axis] != out_size:
                idx = constant(_nearest_indices(x.shape[axis], out_size).tolist(), torch.int64, x.device)
                x = x.index_select(axis, idx)
        return x
    if mode != "bilinear":
        raise ValueError(f"unknown resize mode: {mode}")
    lead = x.shape[:-3]
    hh, ww, c = x.shape[-3:]
    nchw = x.reshape(-1, hh, ww, c).permute(0, 3, 1, 2)
    out = F.interpolate(
        nchw, size=(h, w), mode="bilinear", align_corners=align_corners, antialias=False
    )
    return out.permute(0, 2, 3, 1).reshape(*lead, h, w, c)
