"""The plain reference of the CHN train step behind the frozen CPN aligner
(model_chn.py:324-376, five-part loss), followed by Adam with torch's
defaults under the reference's StepLR schedule. Float32, TF32 off;
imports nothing of the program under test."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from port_bench.reference import nets
from port_bench.reference.nets import SD, Q, ident

_SOBEL_H = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
_SOBEL_V = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def masked_l1_sum(y_hat, y, mask, weight=1.0):
    """L1 inside ``mask`` over the mask's own sum (+1e-9)."""
    return weight * (y_hat * mask - y * mask).abs().sum() / (mask.sum() + 1e-9)


def sobel(y):
    """Sobel responses of NHWC ``y`` -> ``(B, H, W, 2C)``: the H-gradients of
    each channel, then the V-gradients."""
    c = y.shape[-1]
    k = torch.tensor((_SOBEL_H, _SOBEL_V), dtype=torch.float32, device=y.device).repeat(c, 1, 1)
    out = F.conv2d(y.permute(0, 3, 1, 2), k.unsqueeze(1), padding=1, groups=c)
    out = out.reshape(out.shape[0], c, 2, *out.shape[2:])
    return torch.cat([out[:, :, 0], out[:, :, 1]], dim=1).permute(0, 2, 3, 1)


def chn_loss(sd_vgg: SD, y_t, v_t, y_hat, y_comp, v_map, q: Q = ident) -> Dict[str, torch.Tensor]:
    """The five CHN losses. The perceptual term's features carry no
    gradient (the reference detaches them)."""
    b, f, h, w, c = y_hat.shape
    target = y_t[:, None].expand(y_hat.shape)
    nh = v_t[:, None].expand(v_map.shape)
    items = {
        "loss_nh": masked_l1_sum(y_hat, target, nh, 0.5),
        "loss_vh": masked_l1_sum(y_hat, target, v_map, 2.0),
        "loss_nvh": masked_l1_sum(y_comp, target, (1 - nh) - v_map, 1.0),
    }
    flat_hat, flat_t = y_hat.reshape(b * f, h, w, c), target.reshape(b * f, h, w, c)
    with torch.no_grad():
        fh = nets.vgg_features(sd_vgg, flat_hat, q)
        fg = nets.vgg_features(sd_vgg, flat_t, q)
    items["loss_perceptual"] = 0.5 * sum((a - b_).abs().mean() for a, b_ in zip(fh, fg)) / len(fh)
    items["loss_grad"] = (sobel(flat_hat) - sobel(flat_t)).abs().mean()
    return items


def chn_forward(params: SD, frozen: Dict[str, SD], nb: int, x, m, y, aligned=None, q: Q = ident):
    """The CHN step's forward on a ``(B, F, H, W, C)`` batch, the centre
    frame the target, the others its references: ``(y_t, v_t, y_hat,
    y_comp, v_map)``. The references are aligned by the frozen CPN, or
    taken as ``aligned`` ``(x_aligned, v_aligned, v_map)``."""
    fr = x.shape[1]
    t = fr // 2
    refs = [i for i in range(fr) if i != t]
    x_t, m_t, x_r, m_r, y_t = x[:, t], m[:, t], x[:, refs], m[:, refs], y[:, t]
    if aligned is None:
        with torch.no_grad():
            aligned = nets.cpn_align(frozen["cpn"], x_t, m_t, x_r, m_r, q)
    xa, va, vm = (a.float() for a in aligned)
    y_hat, y_comp = nets.chn(params, nb, x_t, 1 - m_t, xa, va, vm, q)
    return y_t, 1 - m_t, y_hat, y_comp, vm


def chn_step_loss(params: SD, frozen: Dict[str, SD], nb: int, x, m, y, aligned=None, q: Q = ident):
    """The CHN step's loss items and ``y_hat`` (:func:`chn_forward`)."""
    y_t, v_t, y_hat, y_comp, vm = chn_forward(params, frozen, nb, x, m, y, aligned, q)
    return chn_loss(frozen["vgg"], y_t, v_t, y_hat, y_comp, vm, q), y_hat


def run_steps(loss_fn, params: SD, batches: List[Tuple], lr: float) -> Dict[str, object]:
    """Adam (betas 0.9 / 0.999, eps 1e-8, torch's) over ``batches``, one
    update each, at learning rate ``lr`` (the schedule's first epoch);
    ``loss_fn(leaves, i, batch) -> (items, y_hat)``. Returns each step's
    loss items (floats, ``loss`` their sum), the first step's ``y_hat``,
    its gradient norm of each leaf, and each leaf's change norm after the
    last step."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    steps, grad0, y0 = [], {}, None
    for i, batch in enumerate(batches):
        items, y_hat = loss_fn(leaves, i, batch)
        total = sum(items.values())
        opt.zero_grad(set_to_none=True)
        total.backward()
        if i == 0:
            y0 = y_hat.detach()
            grad0 = {k: float(torch.linalg.vector_norm(v.grad)) if v.grad is not None else 0.0
                     for k, v in leaves.items()}
        opt.step()
        steps.append({**{k: float(v.detach()) for k, v in items.items()}, "loss": float(total.detach())})
    change = {k: float(torch.linalg.vector_norm(leaves[k].detach() - start[k])) for k in leaves}
    return {"steps": steps, "y0": y0, "grad0": grad0, "change": change}
