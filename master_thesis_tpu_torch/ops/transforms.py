"""Image transforms on channel-last tensors
(master_thesis_tpu/ops/transforms.py: resize_set_bis)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from master_thesis_tpu_torch.ops.interp import resize_hw


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
