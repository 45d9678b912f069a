"""Dense-flow utilities on channel-last tensors
(master_thesis_tpu/ops/flows.py).

Flows are absolute sampling grids in normalised ``[-1, 1]`` coordinates:
``flow[b, f, i, j] = (x, y)`` is where frame ``f`` samples from to land at
pixel ``(i, j)``; a relative flow is the displacement from the identity
grid. Images ``(B, F, H, W, C)``, visibility maps ``(B, F, H, W, 1)``,
flows ``(B, F, H, W, 2)``.

``align_corners`` differs by function, as in the JAX package: the warp in
:func:`align_set` uses ``True`` (frames bilinear, visibility nearest), and
:func:`resize_flow` resizes bilinearly with ``False`` and leaves the
values as they are (they are absolute).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from master_thesis_tpu_torch.device import constant
from master_thesis_tpu_torch.ops.grid_sample import grid_sample
from master_thesis_tpu_torch.ops.interp import resize_hw


def identity_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity sampling grid ``(H, W, 2)`` (align_corners=True spacing)."""
    ys = torch.linspace(-1.0, 1.0, h, dtype=torch.float32, device=device)
    xs = torch.linspace(-1.0, 1.0, w, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1).to(dtype)


def flow_abs_to_relative(flow: torch.Tensor) -> torch.Tensor:
    """Absolute grid -> relative displacement."""
    h, w = flow.shape[-3], flow.shape[-2]
    return flow - identity_grid(h, w, flow.dtype, flow.device)


def flow_relative_to_abs(flow_rel: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`flow_abs_to_relative`."""
    h, w = flow_rel.shape[-3], flow_rel.shape[-2]
    return flow_rel + identity_grid(h, w, flow_rel.dtype, flow_rel.device)


def crop_flow(
    flow: torch.Tensor, crop_size: Sequence[int], crop_position: Sequence[int]
) -> torch.Tensor:
    """Crops an absolute flow, rescaling displacements to the new frame."""
    h, w = flow.shape[-3], flow.shape[-2]
    ch, cw = crop_size
    ph, pw = crop_position
    rel = flow_abs_to_relative(flow)[..., ph: ph + ch, pw: pw + cw, :]
    scale = constant((w / cw, h / ch), flow.dtype, flow.device)
    return flow_relative_to_abs(rel * scale)


def align_set(
    x: torch.Tensor, v: torch.Tensor, flow: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warps frames ``x`` (bilinear) and visibility maps ``v`` (nearest, so
    they stay binary) by the absolute ``flow``, align_corners=True."""
    b, f, h, w, c = x.shape
    grid = flow.reshape(b * f, h, w, 2)
    x_aligned = grid_sample(x.reshape(b * f, h, w, c), grid, "bilinear", align_corners=True)
    v_aligned = grid_sample(v.reshape(b * f, h, w, v.shape[-1]), grid, "nearest", align_corners=True)
    return x_aligned.reshape(x.shape), v_aligned.reshape(v.shape)


def resize_flow(flow: torch.Tensor, size: Sequence[int], mode: str = "nearest") -> torch.Tensor:
    """Spatially resizes a flow field, align_corners=False; the values stay
    as they are."""
    if tuple(flow.shape[-3:-1]) == (int(size[0]), int(size[1])):
        return flow
    return resize_hw(flow, size, mode, align_corners=False)
