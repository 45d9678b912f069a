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

On a mesh (JAX's ``ref_sharding``; :mod:`..parallel.mesh`) a step takes its
data rank's rows and keeps its model rank's share of the references: the
frozen aligner and the CHN run on those alone (both treat each reference
on its own), and every loss term is a sum over references, so each rank's
loss is its numerator over the whole batch's denominator and the ranks'
losses sum to the one-process loss; the train state sums the grads over
the world at each update.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import torch

from master_thesis_tpu_torch.models.chn import chn_infer_apply
from master_thesis_tpu_torch.ops import losses, measures
from master_thesis_tpu_torch.ops.losses import Reduce
from master_thesis_tpu_torch.parallel.mesh import Mesh, reducer, ref_slice
from master_thesis_tpu_torch.runtime.spans import span

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
    reduce: Reduce = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Five-part CHN loss. Shapes: y_target ``(B, H, W, 3)``; y_hat
    ``(B, F, H, W, 3)``; v_target ``(B, H, W, 1)``; v_map ``(B, F, H, W, 1)``.
    ``reduce`` sums the denominators over a mesh (:mod:`..ops.losses`)."""
    b, f, h, w, c = y_hat.shape
    target = y_target[:, None].expand(y_hat.shape)
    nh_mask = v_target[:, None].expand(v_map.shape)
    l1 = partial(losses.masked_l1, reduction="sum", reduce=reduce)
    loss_nh = l1(y_hat, target, nh_mask, weight=0.5)
    loss_vh = l1(y_hat, target, v_map, weight=2.0)
    nvh_mask = (1 - nh_mask) - v_map
    loss_nvh = l1(y_hat_comp, target, nvh_mask, weight=1.0)

    y_hat_flat = y_hat.reshape(b * f, h, w, c)
    target_flat = target.reshape(b * f, h, w, c)
    with torch.set_grad_enabled(perceptual_grad and torch.is_grad_enabled()):
        feats_hat = vgg(y_hat_flat)
    with torch.no_grad():
        feats_gt = vgg(target_flat)
    loss_perceptual = losses.perceptual(feats_hat, feats_gt, weight=0.5, reduce=reduce)
    loss_grad = losses.grad(y_hat_flat, target_flat, reduction="mean", weight=1.0, reduce=reduce)

    total = loss_nh + loss_vh + loss_nvh + loss_perceptual + loss_grad
    return total, {
        "loss_nh": loss_nh,
        "loss_vh": loss_vh,
        "loss_nvh": loss_nvh,
        "loss_perceptual": loss_perceptual,
        "loss_grad": loss_grad,
    }


def _split(x, m, y, mesh: Optional[Mesh] = None):
    """The target, this model rank's share of the references, and the
    clean target."""
    t, refs = target_ref_indexes(x.shape[1])
    refs = refs[ref_slice(len(refs), mesh)]
    return x[:, t], m[:, t], x[:, refs], m[:, refs], y[:, t]


def make_train_step(chn, align_fn: Callable, vgg: Callable, perceptual_grad: bool = False,
                    chn_apply: Optional[Callable] = None, mesh: Optional[Mesh] = None):
    """``train_step(state, x, m, y) -> items``: one micro-step of ``state``
    (its model is ``chn``; an update every ``accumulate_grad_batches``) on
    the batch ``x``, ``m``, ``y`` ``(B, F, H, W, C)``.
    ``align_fn(x_t, m_t, x_refs, m_refs) -> (x_aligned, v_aligned, v_maps)``
    is frozen: no gradient reaches it. ``chn_apply`` (default
    ``chn_infer_apply`` on ``chn``, the kernel route) computes ``(y_hat,
    y_hat_comp)``. On ``mesh`` the batch is this data rank's rows and the
    items are this rank's contributions (:func:`..parallel.sum_scalars`
    adds them up)."""
    chn_apply = chn_apply or partial(chn_infer_apply, chn)
    reduce = reducer(mesh)

    def train_step(state, x, m, y):
        with span("train.step"):
            x_t, m_t, x_r, m_r, y_t = _split(x, m, y, mesh)
            with torch.no_grad():
                xa, va, vm = align_fn(x_t, m_t, x_r, m_r)
            y_hat, y_hat_comp = chn_apply(x_t, 1 - m_t, xa, va, vm)
            with span("train.loss"):
                total, items = compute_loss(
                    y_t, 1 - m_t, y_hat, y_hat_comp, vm, vgg, perceptual_grad=perceptual_grad,
                    reduce=reduce,
                )
            with span("train.backward"):
                total.backward()
            with span("train.update"):
                state.apply_gradients()
            items["loss"] = total
            return {k: v.detach() for k, v in items.items()}

    return train_step


def make_eval_step(chn, align_fn: Callable, vgg: Callable, chn_apply: Optional[Callable] = None,
                   lpips_fn: Optional[Callable] = None, mesh: Optional[Mesh] = None):
    """``eval_step(x, m, y) -> (items, y_hat_comp)``: the loss items and the
    PSNR / SSIM of the first composite (reference model_chn.py:282-307),
    and its LPIPS where ``lpips_fn`` (which needs converted metric weights,
    :func:`..build.build_lpips`) is given. On ``mesh`` the items are this
    rank's contributions, as the train step's; the measures of the first
    composite come from the model rank that holds the first reference, the
    others contribute 0 over a count of 0; ``y_hat_comp`` holds this rank's
    references."""
    chn_apply = chn_apply or partial(chn_infer_apply, chn)
    reduce = reducer(mesh)
    first_ref = mesh is None or mesh.model_rank == 0

    @torch.no_grad()
    def eval_step(x, m, y):
        x_t, m_t, x_r, m_r, y_t = _split(x, m, y, mesh)
        xa, va, vm = align_fn(x_t, m_t, x_r, m_r)
        y_hat, y_hat_comp = chn_apply(x_t, 1 - m_t, xa, va, vm)
        total, items = compute_loss(y_t, 1 - m_t, y_hat, y_hat_comp, vm, vgg, reduce=reduce)
        items["loss"] = total
        rows = slice(None) if first_ref else slice(0, 0)
        comp, target = y_hat_comp[rows, 0], y_t[rows]
        items["psnr"] = measures.psnr(comp, target, reduce=reduce)
        items["ssim"] = measures.ssim(comp, target, reduce=reduce)
        if lpips_fn is not None:
            if reduce is None:
                items["lpips"] = lpips_fn(comp, target)
            else:
                n = comp.shape[0]
                local = lpips_fn(comp, target) * n if n else total.new_zeros(())
                items["lpips"] = local / reduce(torch.full((), n, dtype=local.dtype, device=local.device))
        return items, y_hat_comp

    return eval_step
