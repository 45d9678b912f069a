"""Quality metrics (master_thesis_tpu/ops/measures.py: psnr, ssim).

Both follow skimage's conventions as the JAX package does: PSNR with
``data_range = 1`` and zero-error frames left out of the mean; SSIM with a
7x7 uniform window, K1=0.01, K2=0.03, the sample covariance, the border
cropped (valid filtering) and skimage's float quirk ``data_range = 2``.
Frames are ``(F, H, W, C)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from master_thesis_tpu_torch.ops.losses import Reduce, mean


def psnr(y_hat: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         reduce: Reduce = None) -> torch.Tensor:
    """Mean per-frame PSNR; frames with zero error are excluded. ``reduce``
    sums the frame count over the processes of a mesh (each returns its
    frames' share of the mean of all)."""
    dims = tuple(range(1, y.dim()))
    mse = ((y_hat.float() - y.float()) ** 2).mean(dim=dims)
    vals = 10.0 * torch.log10(data_range**2 / mse.clamp(min=1e-38))
    finite = mse > 0
    n = finite.sum()
    if reduce is not None:
        n = reduce(n)
    n = n.clamp(min=1)
    return torch.where(finite, vals, 0.0).sum() / n


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over ``win`` x ``win`` windows, valid padding; x NHWC."""
    c = x.shape[-1]
    k = torch.ones((c, 1, win, win), dtype=x.dtype, device=x.device)
    out = F.conv2d(x.permute(0, 3, 1, 2), k, groups=c).permute(0, 2, 3, 1)
    return out / (win * win)


def ssim(
    y_hat: torch.Tensor, y: torch.Tensor, data_range: float = 2.0, win: int = 7,
    k1: float = 0.01, k2: float = 0.03, reduce: Reduce = None,
) -> torch.Tensor:
    """Mean SSIM of frame stacks (skimage-compatible); ``reduce`` as
    :func:`psnr`'s, over the window count."""
    x, z = y_hat.float(), y.float()
    np_ = win * win
    cov_norm = np_ / (np_ - 1.0)
    ux, uz = _uniform_filter_valid(x, win), _uniform_filter_valid(z, win)
    uxx = _uniform_filter_valid(x * x, win)
    uzz = _uniform_filter_valid(z * z, win)
    uxz = _uniform_filter_valid(x * z, win)
    vx = cov_norm * (uxx - ux * ux)
    vz = cov_norm * (uzz - uz * uz)
    vxz = cov_norm * (uxz - ux * uz)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    s = ((2 * ux * uz + c1) * (2 * vxz + c2)) / ((ux * ux + uz * uz + c1) * (vx + vz + c2))
    return mean(s, reduce)

