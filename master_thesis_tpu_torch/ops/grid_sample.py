"""Affine grids and image warping on channel-last tensors
(master_thesis_tpu/ops/grid_sample.py: affine_grid, grid_sample).

The JAX package writes the warp as tent-weight matmuls for the TPU's
matrix unit; here it is ``F.affine_grid``/``F.grid_sample`` with zeros
padding, whose semantics the JAX version copies: bilinear, and nearest
rounding half to even. ``align_corners`` has no default: CPN warps with
``False`` and flows with ``True``, and each caller states which.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def affine_grid(
    theta: torch.Tensor, size_hw: Tuple[int, int], *, align_corners: bool
) -> torch.Tensor:
    """``(N, 2, 3)`` affine maps -> ``(N, H, W, 2)`` grid, ``(x, y)`` last."""
    h, w = size_hw
    return F.affine_grid(
        theta.float(), [theta.shape[0], 1, h, w], align_corners=align_corners
    )


def grid_sample(
    x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear", *, align_corners: bool
) -> torch.Tensor:
    """Samples ``x`` ``(N, H, W, C)`` at ``grid`` ``(N, H', W', 2)`` ->
    ``(N, H', W', C)``, ``mode`` "bilinear" or "nearest"; out-of-frame taps
    contribute zero."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown grid_sample mode: {mode}")
    out = F.grid_sample(
        x.permute(0, 3, 1, 2), grid.to(x.dtype), mode=mode,
        padding_mode="zeros", align_corners=align_corners,
    )
    return out.permute(0, 2, 3, 1)
