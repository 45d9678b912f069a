"""CHN training and evaluation steps (master_thesis_tpu/train/chn_task.py:
LOSSES_NAMES, target_ref_indexes, compute_loss, make_train_step,
make_eval_step).

A step: the frozen aligner under ``torch.no_grad()`` (the JAX
``stop_gradient``), the CHN forward with autograd (its trunk and tail
backward passes are the kernels K3 and K6 on the card), the five-part
loss, backward into the window's summed grads, and, every
``accumulate_grad_batches`` steps, the Adam update, after which the packed
kernel weights are dropped (:meth:`..state.TrainState.apply_gradients`).

Loss (reference model_chn.py:324-376): non-hole (w=0.5) and visible-hole
(w=2) masked L1 on ``y_hat``, non-visible-hole (w=1) on the composite, all
sum-normalised; perceptual (w=0.5) over the 5 VGG pool maps of the folded
``(B*F)`` frames, which carries no gradient by default because the
reference detaches both feature sets (``perceptual_grad=False``: VGG then
runs under ``torch.no_grad()``); Sobel gradient loss (w=1) on the folded
frames.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from master_thesis_tpu_torch.models.chn import chn_infer_apply
from master_thesis_tpu_torch.ops import losses, measures

LOSSES_NAMES = ("loss_nh", "loss_vh", "loss_nvh", "loss_perceptual", "loss_grad")


def target_ref_indexes(frames_n: int) -> Tuple[int, List[int]]:
    """The centre frame is the target, the rest are references."""
    t = frames_n // 2
    return t, [i for i in range(frames_n) if i != t]


def compute_loss(
    y_target: torch.Tensor,
    v_target: torch.Tensor,
    y_hat: torch.Tensor,
    y_hat_comp: torch.Tensor,
    v_map: torch.Tensor,
    vgg: Callable,
    perceptual_grad: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Five-part CHN loss. Shapes: y_target ``(B, H, W, 3)``; y_hat
    ``(B, F, H, W, 3)``; v_target ``(B, H, W, 1)``; v_map ``(B, F, H, W, 1)``."""
    b, f, h, w, c = y_hat.shape
    target = y_target[:, None].expand(y_hat.shape)
    nh_mask = v_target[:, None].expand(v_map.shape)
    loss_nh = losses.masked_l1(y_hat, target, nh_mask, reduction="sum", weight=0.5)
    loss_vh = losses.masked_l1(y_hat, target, v_map, reduction="sum", weight=2.0)
    nvh_mask = (1 - nh_mask) - v_map
    loss_nvh = losses.masked_l1(y_hat_comp, target, nvh_mask, reduction="sum", weight=1.0)

    y_hat_flat = y_hat.reshape(b * f, h, w, c)
    target_flat = target.reshape(b * f, h, w, c)
    with torch.set_grad_enabled(perceptual_grad and torch.is_grad_enabled()):
        feats_hat = vgg(y_hat_flat)
    with torch.no_grad():
        feats_gt = vgg(target_flat)
    loss_perceptual = losses.perceptual(feats_hat, feats_gt, weight=0.5)
    loss_grad = losses.grad(y_hat_flat, target_flat, reduction="mean", weight=1.0)

    total = loss_nh + loss_vh + loss_nvh + loss_perceptual + loss_grad
    return total, {
        "loss_nh": loss_nh,
        "loss_vh": loss_vh,
        "loss_nvh": loss_nvh,
        "loss_perceptual": loss_perceptual,
        "loss_grad": loss_grad,
    }


def _split(x, m, y):
    t, refs = target_ref_indexes(x.shape[1])
    return x[:, t], m[:, t], x[:, refs], m[:, refs], y[:, t]


def make_train_step(chn, align_fn: Callable, vgg: Callable, perceptual_grad: bool = False):
    """``train_step(state, x, m, y) -> items``: one micro-step of ``state``
    (its model is ``chn``; an update every ``accumulate_grad_batches``) on
    the batch ``x``, ``m``, ``y`` ``(B, F, H, W, C)``.
    ``align_fn(x_t, m_t, x_refs, m_refs) -> (x_aligned, v_aligned, v_maps)``
    is frozen: no gradient reaches it."""

    def train_step(state, x, m, y):
        x_t, m_t, x_r, m_r, y_t = _split(x, m, y)
        with torch.no_grad():
            xa, va, vm = align_fn(x_t, m_t, x_r, m_r)
        y_hat, y_hat_comp = chn_infer_apply(chn, x_t, 1 - m_t, xa, va, vm)
        total, items = compute_loss(
            y_t, 1 - m_t, y_hat, y_hat_comp, vm, vgg, perceptual_grad=perceptual_grad
        )
        total.backward()
        state.apply_gradients()
        items["loss"] = total
        return {k: v.detach() for k, v in items.items()}

    return train_step


def make_eval_step(chn, align_fn: Callable, vgg: Callable):
    """``eval_step(x, m, y) -> (items, y_hat_comp)``: the loss items and the
    PSNR / SSIM of the first composite (reference model_chn.py:282-307).
    LPIPS waits for converted metric weights."""

    @torch.no_grad()
    def eval_step(x, m, y):
        x_t, m_t, x_r, m_r, y_t = _split(x, m, y)
        xa, va, vm = align_fn(x_t, m_t, x_r, m_r)
        y_hat, y_hat_comp = chn_infer_apply(chn, x_t, 1 - m_t, xa, va, vm)
        total, items = compute_loss(y_t, 1 - m_t, y_hat, y_hat_comp, vm, vgg)
        items["loss"] = total
        items["psnr"] = measures.psnr(y_hat_comp[:, 0], y_t)
        items["ssim"] = measures.ssim(y_hat_comp[:, 0], y_t)
        return items, y_hat_comp

    return eval_step
