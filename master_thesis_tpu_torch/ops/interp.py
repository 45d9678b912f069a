"""Image resizing on channel-last tensors (master_thesis_tpu/ops/interp.py:
resize_hw).

The JAX package builds its own tap tables so a resize is a pair of matmuls
on the TPU; here bilinear is ``F.interpolate`` without antialiasing (torch
semantics, which the JAX tables reproduce), and nearest gathers along each
axis with the JAX package's own index table, torch's legacy nearest
``src = floor(dst * in / out)`` computed in float64 (``F.interpolate``
computes it in float32, which can round the other way).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from master_thesis_tpu_torch.device import constant


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


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
