"""Loss functions (master_thesis_tpu/ops/losses.py: masked_l1, perceptual,
sobel_grads, grad). Images are channel-last, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch.device import constant

# Sobel kernels (kh, kw), applied per RGB channel (losses.py:18-19).
_GRAD_H = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_GRAD_V = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


# A reducer: a denominator summed over the processes of a mesh
# (:func:`..parallel.mesh.reducer`). None is one process: the plain mean.
Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def mean(x: torch.Tensor, reduce: Reduce = None) -> torch.Tensor:
    """``x.mean()``; with ``reduce``, ``x``'s sum over the element count of
    every process's ``x``, so the processes' values sum to the mean of all
    of them (f32 or wider)."""
    if reduce is None:
        return x.mean()
    acc = torch.promote_types(x.dtype, torch.float32)
    n = reduce(torch.full((), x.numel(), dtype=torch.float64, device=x.device))
    return x.sum(dtype=acc) / n.to(acc)


def masked_l1(
    y_hat: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    batch_mask: Optional[torch.Tensor] = None,
    reduction: str = "mean",
    weight: float = 1.0,
    reduce: Reduce = None,
) -> torch.Tensor:
    """L1 between ``y_hat`` and ``y`` restricted to ``mask`` (losses.py:22).

    ``reduction="sum"`` normalises by ``sum(mask) + 1e-9``, the mask's own
    element count (a 1-channel mask on 3-channel images counts each pixel
    once). ``batch_mask`` (``(B,)`` bool) drops rows; with no row left the
    ``"mean"`` loss is 0. ``reduce`` sums each denominator over the
    processes of a mesh: each returns its own numerator over the whole
    batch's denominator.
    """
    diff = (y_hat * mask - y * mask).abs()
    bm = None
    if batch_mask is not None:
        bm = batch_mask.to(diff.dtype).reshape((-1,) + (1,) * (diff.dim() - 1))
        diff = diff * bm
    if reduction == "sum":
        mask_sum = (mask * bm if bm is not None else mask).sum()
        if reduce is not None:
            mask_sum = reduce(mask_sum)
        return weight * diff.sum() / (mask_sum + 1e-9)
    if reduction == "mean":
        if bm is None:
            return weight * mean(diff, reduce)
        denom = batch_mask.to(diff.dtype).sum() * float(diff.numel() // diff.shape[0])
        if reduce is not None:
            denom = reduce(denom)
        return weight * torch.where(denom > 0, diff.sum() / denom.clamp(min=1.0), 0.0)
    raise ValueError(f"unknown reduction: {reduction}")


def perceptual(
    feats_hat: Sequence[torch.Tensor], feats_gt: Sequence[torch.Tensor], weight: float = 1.0,
    reduce: Reduce = None,
) -> torch.Tensor:
    """Mean L1 across the VGG pool-feature pyramids (losses.py:64)."""
    loss = 0.0
    for fh, fg in zip(feats_hat, feats_gt):
        loss = loss + mean((fh - fg).abs(), reduce)
    return weight * loss / len(feats_hat)


def sobel_grads(y: torch.Tensor) -> torch.Tensor:
    """Sobel responses of ``(B, H, W, C)`` images -> ``(B, H, W, 2C)``: all
    H-gradients, then all V-gradients (losses.py:80). A depthwise conv in
    f32 (or wider)."""
    c = y.shape[-1]
    dt = torch.promote_types(y.dtype, torch.float32)
    k = constant((_GRAD_H, _GRAD_V), dt, y.device)  # (2, 3, 3)
    k = k.repeat(c, 1, 1).unsqueeze(1)  # (2C, 1, 3, 3): out 2ch + j
    out = F.conv2d(y.to(dt).permute(0, 3, 1, 2), k, padding=1, groups=c)
    out = out.reshape(out.shape[0], c, 2, *out.shape[2:])
    return torch.cat([out[:, :, 0], out[:, :, 1]], dim=1).permute(0, 2, 3, 1)


def grad(
    y_hat: torch.Tensor, y: torch.Tensor, reduction: str = "mean", weight: float = 1.0,
    reduce: Reduce = None,
) -> torch.Tensor:
    """Sobel gradient loss (losses.py:107)."""
    gh, gg = sobel_grads(y_hat), sobel_grads(y)
    return masked_l1(gh, gg, torch.ones_like(gh), reduction=reduction, weight=weight, reduce=reduce)
