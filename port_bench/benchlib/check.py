"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (:mod:`port_bench.reference`), one number a
property; each cell compares those its ``port_bench/limits/<cell>.json``
names, each against its limit.

The aligner's outputs, worst over the steps kept:

- ``align_x_ratio``: the L2 gap of the aligned references ``x_aligned``
  from the reference aligner's (run on the same inputs), over the gap of
  the reference computed in the configuration's precision (the witness);
- ``align_v_ratio``: the aligned-visibility pixels that differ from the
  reference's, over the witness's, each plus one.

Serving, worst over the steps kept from the window:

- ``chn_y_rel``: the relative L2 gap of ``y_hat`` from the reference CHN's
  run on the program's aligned outputs (the stage followed from the
  aligner's outputs, which the numbers above check on their own);
- ``chn_y_ref``: the same from the reference CHN run on the reference
  aligner's outputs (the two stages together);
- ``comp_exact``, ``vis_exact``: the largest gap of ``y_hat_comp`` from ``v
  x_t + (1 - v) y_hat``, and of ``v_map`` from ``clip(v_aligned - (1 -
  m_t), 0, 1)`` or of ``v_aligned`` from {0, 1}: they hold exactly.

Training, over the first steps, which the reference follows from the same
weights and batches and from the program's aligned references (the
aligner's outputs are checked on their own, above):

- ``y1_rel``: the relative L2 gap of the first step's ``y_hat`` over the
  pixels the reference does not clamp to 0 or 1 (at the seed's weights
  most of ``y_hat`` sits on the clamp);
- ``change_leaf``: the worst leaf's gap of change norms after the last
  step, over the larger of the reference leaf's and the median leaf's.

Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone; they are left out of the
change. A program that returns fewer rows than its batch holds reads
infinite on every training number. :func:`look_numbers` reads what is
not compared (the first step's loss items and the first gradient's norm),
for ``calibrate.py``.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

from port_bench.reference import nets
from port_bench.reference import train as ref_train
from port_bench.reference.nets import Q, ident
from port_bench.reference.precision import quantizer

ROUND_OFF_LEAF = 1e-3
TRAIN_NUMBERS = ("align_x_ratio", "align_v_ratio", "y1_rel", "change_leaf")


def worst(values) -> float:
    """The largest of ``values``; NaN if any is."""
    values = [float(v) for v in values]
    return float("nan") if any(math.isnan(v) for v in values) else max(values)


def worst_of(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst over ``readings``."""
    return {k: worst(r[k] for r in readings) for k in readings[0]}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want).clamp(min=1e-30))


def reference_align(config: Dict, w: Dict, batch, q: Q = ident):
    x_t, m_t, x_r, m_r = batch
    if config["aligner"] == "cpn":
        return nets.cpn_align(w["cpn"], x_t, m_t, x_r, m_r, q)
    return nets.dfpn_align(w["dfpn"], w["vgg"], config["cli"]["dfpn_base_size"], x_t, m_t, x_r, m_r, q)


def align_numbers(config: Dict, w: Dict, batch, xa: torch.Tensor, va: torch.Tensor):
    """``(numbers, reference alignment)`` of the program's aligned
    references ``xa`` and visibility ``va`` on ``batch``."""
    with torch.no_grad():
        ref = reference_align(config, w, batch)
        # The yardstick of the aligner's gaps: the reference itself computed
        # in the configuration's precision.
        wa, wv, _ = reference_align(config, w, batch, quantizer(config["cli"]["compute_dtype"]))
    ra, rv = ref[0], ref[1]
    flips, flips_w = float((va.float() != rv).sum()), float((wv != rv).sum())
    gap, yard = _norm(xa.float() - ra), _norm(wa - ra)
    return {"align_x_ratio": gap / yard if yard else (0.0 if gap == 0 else math.inf),
            "align_v_ratio": (flips + 1) / (flips_w + 1)}, ref


def control_serve(config: Dict, w: Dict, batch, q: Q):
    """What the reference computed at precision ``q`` produces in the
    program's place: ``(xa, va, vm, y_hat, y_hat_comp)``."""
    x_t, m_t = batch[0], batch[1]
    xa, va, vm = reference_align(config, w, batch, q)
    y, yc = nets.chn(w["chn"], config["cli"]["chn_nb"], x_t, 1 - m_t, xa, va, vm, q, block=16)
    return xa, va, vm, y, yc


def serve_numbers(config: Dict, w: Dict, batch, outs: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The serving numbers of one step's outputs ``outs = (xa, va, vm,
    y_hat, y_hat_comp)`` on ``batch``."""
    x_t, m_t = batch[0], batch[1]
    xa, va, vm, y, yc = (o.float() for o in outs)
    nb = config["cli"]["chn_nb"]
    out, (ra, rv, rm) = align_numbers(config, w, batch, xa, va)
    ry, _ = nets.chn(w["chn"], nb, x_t, 1 - m_t, xa, va, vm, block=16)
    ry_ref, _ = nets.chn(w["chn"], nb, x_t, 1 - m_t, ra, rv, rm, block=16)
    v_t = (1 - m_t)[:, None]
    comp = v_t * x_t[:, None] + (1 - v_t) * y
    vis = torch.maximum((vm - torch.clamp(va - (1 - m_t[:, None]), 0.0, 1.0)).abs(),
                        torch.minimum(va.abs(), (1 - va).abs()))
    return {**out, "chn_y_rel": rel_l2(y, ry), "chn_y_ref": rel_l2(y, ry_ref),
            "comp_exact": float((yc - comp).abs().max()), "vis_exact": float(vis.max())}


# ---------------------------------------------------------------- training


def train_split(batch):
    """``(x_t, m_t, x_r, m_r)`` of a CHN train batch ``(x, m, y)``: the
    centre frame the target, the others its references."""
    x, m = batch[0], batch[1]
    t = x.shape[1] // 2
    refs = [i for i in range(x.shape[1]) if i != t]
    return x[:, t], m[:, t], x[:, refs], m[:, refs]


def reference_aligned(config: Dict, w: Dict, batches: List, q: Q = ident) -> List:
    """The reference aligner's outputs on each train batch, at ``q``."""
    with torch.no_grad():
        return [reference_align(config, w, train_split(b), q) for b in batches]


def reference_train(config: Dict, w: Dict, batches: List, aligned: List, q: Q = ident):
    """The reference's first steps from the seed's weights ``w`` on
    ``batches``, with step ``i``'s references aligned as ``aligned[i]``
    (:func:`..reference.train.run_steps`)."""
    nb, frozen = config["cli"]["chn_nb"], {"cpn": w["cpn"], "vgg": w["vgg"]}

    def loss(p, i, b):
        return ref_train.chn_step_loss(p, frozen, nb, *b, aligned=aligned[i], q=q)
    return ref_train.run_steps(loss, w["chn"], batches, config["cli"]["lr"])


def _kept(want: Dict) -> List[str]:
    """The leaves whose reference gradient is not round-off."""
    med_g = statistics.median(want["grad0"].values())
    return [k for k, v in want["grad0"].items() if v >= ROUND_OFF_LEAF * med_g]


def train_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """The compared step numbers of the program's first steps ``got``
    against the reference's ``want`` (both as
    :func:`..reference.train.run_steps` returns them)."""
    ry = want["y0"].float()
    y = got["y0"].to(ry.device).float()
    free = ((ry > 0) & (ry < 1)).float()
    keep = _kept(want)
    med_c = statistics.median(want["change"][k] for k in keep)
    changes = [abs(got["change"][k] - want["change"][k]) / max(want["change"][k], med_c) for k in keep]
    return {"y1_rel": _norm((y - ry) * free) / max(_norm(ry * free), 1e-30), "change_leaf": worst(changes)}


def look_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """What the check does not compare: ``loss1_item``, the first step's
    largest loss-item gap over that item, and ``grad_global``, the gap
    between the first gradient's norms (the program's read from Adam's
    first moment after one update, over ``1 - beta1``) over the
    reference's."""
    r0, g0 = want["steps"][0], got["steps"][0]
    keep = _kept(want)
    norm = lambda d: math.sqrt(sum(d.get(k, 0.0) ** 2 for k in keep))
    return {"loss1_item": worst(abs(g0[k] - r0[k]) / abs(r0[k]) for k in r0
                                if abs(r0[k]) >= ROUND_OFF_LEAF * abs(r0["loss"])),
            "grad_global": abs(norm(got["grad0"]) - norm(want["grad0"])) / norm(want["grad0"])}


def train_check(config: Dict, w: Dict, batches: List, got: Dict, look: bool = False) -> Dict[str, float]:
    """Every training number of the program's first steps ``got`` (with its
    aligned references ``got["aligned"]`` and first ``y_hat`` ``got["y0"]``)
    on ``batches``; with ``look`` also :func:`look_numbers`."""
    rows = batches[0][0].shape[0]
    if len(got["aligned"]) != len(batches) or any(a[0].shape[0] != rows for a in got["aligned"]) \
            or got["y0"].shape[0] != rows:
        return {k: math.inf for k in TRAIN_NUMBERS + (("loss1_item", "grad_global") if look else ())}
    device = batches[0][0].device
    aligned = [tuple(t.to(device).float() for t in a) for a in got["aligned"]]
    out = worst_of([align_numbers(config, w, train_split(b), a[0], a[1])[0] for b, a in zip(batches, aligned)])
    want = reference_train(config, w, batches, aligned)
    return {**out, **train_numbers(got, want), **(look_numbers(got, want) if look else {})}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a NaN is not)."""
    return all(numbers[k] <= limits[k] for k in limits)
