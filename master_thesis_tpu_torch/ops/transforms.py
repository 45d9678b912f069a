"""Image transforms on channel-last tensors
(master_thesis_tpu/ops/transforms.py: resize, resize_set, resize_set_bis)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from master_thesis_tpu_torch.ops.interp import resize_hw


def resize(
    image: torch.Tensor, size: Sequence[int], mode: str = "bilinear", keep_ratio: bool = True
) -> torch.Tensor:
    """Resizes ``(..., H, W, C)`` images to ``size=(H', W')``. With
    ``keep_ratio`` the shorter side is scaled to its target and the other
    cropped, as the reference does (utils.py:485-491), quirk included: a
    ``size=(H', -1)`` request slices the width with ``[:-1]`` and so drops
    the last column."""
    h, w = image.shape[-3], image.shape[-2]
    if keep_ratio and size[1] == -1:
        out = resize_hw(image, (size[0], round(w * size[0] / h)), mode)
        return out[..., : size[0], : size[1], :]
    if keep_ratio:
        new_h = size[0] if h < w else round(h * size[1] / w)
        new_w = size[1] if w <= h else round(w * size[0] / h)
        out = resize_hw(image, (new_h, new_w), mode)
        return out[..., : size[0], : size[1], :]
    return resize_hw(image, size, mode)


def resize_set(
    x: torch.Tensor, v: torch.Tensor, y: torch.Tensor, size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resizes frames ``x`` and ``y`` (bilinear) and visibility maps ``v``
    (nearest) to ``size`` square."""
    return (resize_hw(x, (size, size), "bilinear"), resize_hw(v, (size, size), "nearest"),
            resize_hw(y, (size, size), "bilinear"))


def resize_set_bis(
    x_target: torch.Tensor,
    m_target: torch.Tensor,
    x_ref: torch.Tensor,
    m_ref: torch.Tensor,
    size: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resizes target ``(B, H, W, C)`` and refs ``(B, F, H, W, C)`` to
    ``size``: frames bilinear, masks nearest. At the size they already
    have, returns the inputs unchanged."""
    h, w = x_ref.shape[-3], x_ref.shape[-2]
    if h == size[0] and w == size[1]:
        return x_target, m_target, x_ref, m_ref
    return (
        resize_hw(x_target, size, "bilinear"),
        resize_hw(m_target, size, "nearest"),
        resize_hw(x_ref, size, "bilinear"),
        resize_hw(m_ref, size, "nearest"),
    )
