"""DFPN training and evaluation steps (master_thesis_tpu/train/dfpn_task.py:
LOSSES_NAMES, target_ref_indexes, forward_and_loss, log_alignment_frames,
make_train_step, make_eval_step).

A step: the frozen VGG-16 pool-4 features of the masked target and
references and of the clean frames under ``torch.no_grad()`` (the JAX
``stop_gradient``; on K8 with ``pallas_vgg``), the DFPN forward through its
modules with autograd (K7 and K8 have no backward, so every ``pallas_*``
flag of :func:`..models.dfpn.dfpn_infer_apply` is off), the three
predicted-flow warps, the six-part loss in f32, backward, and the end of
the micro-step (:meth:`..state.TrainState.apply_gradients`).

Loss (reference model_dfpn.py:210-293):

- correlation L1 against the VGG correlation of the clean frames, mean;
- flow L1 at 16 / 64 / 256, batch-masked by ``flows_use`` (only items the
  movement simulator made carry a supervised flow);
- alignment-reconstruction L1 at 64 / 256, sum-normalised, masked by the
  target's visibility less the out-of-range flow positions.

As in the JAX package, the reference's warps by the ground-truth flows and
its 16-tier image pyramid feed no loss and are skipped (PARITY.md #1).

On a mesh (JAX's ``ref_sharding``; :mod:`..parallel.mesh`) a step takes its
data rank's rows and keeps the target and its model rank's share of the
references; the target's frozen features are computed on every model rank.
Every loss term is a sum over references, so each rank's loss is its
numerator over the whole batch's denominator, and the ranks' losses sum to
the one-process loss.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from master_thesis_tpu_torch.models.dfpn import (
    DFPN,
    correlation_masked_4d,
    dfpn_infer_apply,
    prepare_vgg_input,
)
from master_thesis_tpu_torch.models.vgg import VGGFeatures, normalize_imagenet, vgg_pool4_pallas
from master_thesis_tpu_torch.ops import losses, transforms
from master_thesis_tpu_torch.ops.flows import align_set, resize_flow
from master_thesis_tpu_torch.ops.interp import resize_hw
from master_thesis_tpu_torch.parallel.mesh import Mesh, reducer, ref_slice
from master_thesis_tpu_torch.train.chn_task import target_ref_indexes

LOSSES_NAMES = (
    "corr_loss", "flow_16", "flow_64", "flow_256",
    "alignment_recons_64", "alignment_recons_256",
)


def _out_mask(flow: torch.Tensor) -> torch.Tensor:
    """1 where a flow samples outside ``[-1, 1]`` on either axis."""
    oob = (flow < -1).float() + (flow > 1).float()
    return oob.sum(dim=-1, keepdim=True).clamp(0, 1)


def forward_and_loss(
    dfpn: DFPN,
    vgg: VGGFeatures,
    x: torch.Tensor,
    m: torch.Tensor,
    y: torch.Tensor,
    flow_gt: torch.Tensor,
    flows_use: torch.Tensor,
    pallas_vgg: bool = False,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Runs DFPN on a ``(B, F, H, W, C)`` batch (masked frames ``x``, masks
    ``m``, clean frames ``y``, absolute flows ``flow_gt`` ``(B, F, H, W,
    2)``, ``flows_use`` ``(B,)`` bool) and returns the total loss and its
    six parts, all f32. ``pallas_vgg`` runs the frozen pool-4 features on
    K8 (:func:`..models.vgg.vgg_pool4_pallas`) instead of the module. On
    ``mesh`` the batch is this data rank's rows, and the loss and its parts
    are this rank's contributions."""
    t, r_list = target_ref_indexes(x.shape[1])
    keep = sorted([t] + r_list[ref_slice(len(r_list), mesh)])
    if len(keep) < x.shape[1]:
        # This model rank's frames: the target and its references.
        x, m, y, flow_gt = (a[:, keep] for a in (x, m, y, flow_gt))
        t, r_list = keep.index(t), [i for i, k in enumerate(keep) if k != t]
    reduce = reducer(mesh)
    b, f, h, w, _ = x.shape
    fr = len(r_list)
    x_t, m_t = x[:, t], m[:, t]
    x_r, m_r = x[:, r_list], m[:, r_list]
    base = dfpn.base_size

    pool4 = partial(vgg_pool4_pallas, vgg) if pallas_vgg else vgg.pool4
    with torch.no_grad():
        feats_t = pool4(prepare_vgg_input(x_t, size=base))
        feats_r = pool4(prepare_vgg_input(x_r.reshape(b * fr, h, w, 3), size=base))
        # The clean frames' pool-4 map: JAX's vgg_apply(y)[3], resized first
        # and then normalised as there, without block 5.
        y_in = y.reshape(b * f, h, w, 3)
        if (h, w) != (base, base):
            y_in = resize_hw(y_in, (base, base), "bilinear")
        y_feats = pool4(normalize_imagenet(y_in))
    feats_r = feats_r.reshape(b, fr, *feats_r.shape[1:])
    y_feats = y_feats.reshape(b, f, *y_feats.shape[1:])

    # corr and the flows come out of the compute dtype's convs; the loss is
    # f32 throughout.
    corr, flow_16, flow_64, flow_256 = (o.float() for o in dfpn_infer_apply(
        dfpn, x_t, m_t, x_r, m_r, feats_t, feats_r,
        pallas_sep4d=False, pallas_mixer=False, pallas_flow=False))

    s16, s64 = base // 16, base // 4
    x_64, v_64, _ = transforms.resize_set(x, 1 - m, y, s64)
    x_256, v_256 = x, 1 - m
    flow_gt_r = flow_gt[:, r_list].float()
    flow_16_gt = resize_flow(flow_gt_r, (s16, s16))
    flow_64_gt = resize_flow(flow_gt_r, (s64, s64))
    x_64_al, _ = align_set(x_64[:, r_list], v_64[:, r_list], flow_64)
    x_256_al, _ = align_set(x_256[:, r_list], v_256[:, r_list], flow_256)

    corr_y = correlation_masked_4d(y_feats[:, t], None, y_feats[:, r_list], None)
    corr_loss = losses.mean((corr - corr_y).abs(), reduce)

    flow_loss = {
        name: losses.masked_l1(pred, gt, torch.ones_like(pred), batch_mask=flows_use, reduce=reduce)
        for name, pred, gt in (("flow_16", flow_16, flow_16_gt), ("flow_64", flow_64, flow_64_gt),
                               ("flow_256", flow_256, flow_gt_r))
    }

    def recons(x_s, v_s, x_al, flow):
        refs = x_s[:, r_list].shape
        v_t = v_s[:, t][:, None].expand(*refs[:-1], v_s.shape[-1])
        x_t_rep = x_s[:, t][:, None].expand(refs)
        return losses.masked_l1(x_t_rep, x_al, v_t * (1 - _out_mask(flow)), reduction="sum",
                                reduce=reduce)

    items = {
        "corr_loss": corr_loss,
        **flow_loss,
        "alignment_recons_64": recons(x_64, v_64, x_64_al, flow_64),
        "alignment_recons_256": recons(x_256, v_256, x_256_al, flow_256),
    }
    total = sum(items[k] for k in LOSSES_NAMES)
    return total, items


def log_alignment_frames(logger, align_fn: Callable, x, m, y, step: int, max_items: int = 4):
    """Logs a strip of image rows per batch item (reference ``_log_frames``,
    model_dfpn.py:411-456): the masked input, the aligned references with
    the target inserted, the visibility maps, and the copy-composite.
    ``align_fn(x_t, m_t, x_refs, m_refs) -> (x_aligned, v_aligned,
    v_map)``, as :func:`..build.dfpn_align_fn` makes it."""
    b, f = x.shape[0], x.shape[1]
    t, r_list = target_ref_indexes(f)
    x_t, m_t = x[:, t], m[:, t]
    with torch.no_grad():
        xa, va, v_map = align_fn(x_t, m_t, x[:, r_list], m[:, r_list])
        trivial = x_t[:, None] * (1 - v_map) + xa * v_map
    x_np, m_np, y_np, xa, va, trivial = (a.float().cpu().numpy() for a in (x, m, y, xa, va, trivial))
    for i in range(min(b, max_items)):
        aligned = np.insert(xa[i], t, x_np[i, t], axis=0)
        vmaps = np.insert(np.repeat(va[i], 3, axis=-1), t, np.repeat(m_np[i, t], 3, axis=-1), axis=0)
        composite = np.insert(trivial[i], t, y_np[i, t], axis=0)
        strip = np.concatenate([x_np[i], aligned, vmaps, composite], axis=1)
        logger.log_images(f"frames/{i + 1}", np.clip(strip, 0, 1), step)


def make_train_step(dfpn: DFPN, vgg: VGGFeatures, pallas_vgg: bool = False,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``train_step(state, x, m, y, flow_gt, flows_use) -> items``: one
    micro-step of ``state`` (its model is ``dfpn``; an update every
    ``accumulate_grad_batches``). ``vgg`` is frozen. ``mesh``: as
    :func:`forward_and_loss`'s."""

    def train_step(state, x, m, y, flow_gt, flows_use):
        total, items = forward_and_loss(dfpn, vgg, x, m, y, flow_gt, flows_use, pallas_vgg, mesh)
        total.backward()
        state.apply_gradients()
        items["loss"] = total
        return {k: v.detach() for k, v in items.items()}

    return train_step


def make_eval_step(dfpn: DFPN, vgg: VGGFeatures, pallas_vgg: bool = False,
                   mesh: Optional[Mesh] = None) -> Callable:
    """``eval_step(x, m, y, flow_gt, flows_use) -> items``: the loss and its
    parts, without grad (on ``mesh``, this rank's contributions)."""

    @torch.no_grad()
    def eval_step(x, m, y, flow_gt, flows_use):
        total, items = forward_and_loss(dfpn, vgg, x, m, y, flow_gt, flows_use, pallas_vgg, mesh)
        items["loss"] = total
        return items

    return eval_step
