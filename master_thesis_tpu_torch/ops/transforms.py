"""Image transforms on channel-last tensors
(master_thesis_tpu/ops/transforms.py: resize, resize_set, resize_set_bis,
crop, dilate)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

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


def crop(image: torch.Tensor, size: Sequence[int], crop_position: Sequence[int]) -> torch.Tensor:
    """The ``size=(h, w)`` window of ``(..., H, W, C)`` images whose top-left
    corner is ``crop_position`` (a view). The caller picks the position, as
    in the JAX package (the reference draws it on the host, utils.py:597-616)."""
    ph, pw = crop_position
    return image[..., ph:ph + size[0], pw:pw + size[1], :]


def dilate(mask: torch.Tensor, filter_size: Sequence[int] = (3, 3), iterations: int = 4) -> torch.Tensor:
    """Morphological dilation of ``(..., H, W, C)`` masks by a ``kh x kw``
    cross, ``iterations`` times, as ``cv2.dilate`` with ``MORPH_CROSS``
    (reference utils.py:618-640): each time the elementwise max of a ``kh x
    1`` and a ``1 x kw`` max-pool, same-padded; in f32, returned in the
    mask's dtype (a bool mask too)."""
    kh, kw = int(filter_size[0]), int(filter_size[1])
    h, w, c = mask.shape[-3:]
    x = mask.to(torch.float32).reshape(-1, h, w, c).permute(0, 3, 1, 2)
    for _ in range(iterations):
        x = torch.maximum(F.max_pool2d(x, (kh, 1), 1, (kh // 2, 0)),
                          F.max_pool2d(x, (1, kw), 1, (0, kw // 2)))
    return x.permute(0, 2, 3, 1).reshape(*mask.shape[:-3], *x.shape[2:], c).to(mask.dtype)
