"""The CHN train step (``kind: chn_train``): the step and state as
``__main__.run_chn_train`` assembles them (``make_train_step``,
``create_train_state`` with the command line's optimizer settings), on
seeded device batches in the loader's place, steps back to back.

Set-up drives the state through its first ``checked_steps`` steps, on
batches that all differ, through the window's own call, and reads what the
check compares (:func:`first_steps`); the reference follows them from the
same weights and batches (:func:`..benchlib.check.train_check`). The
aligner and the CHN reach the train step through :class:`Recorder`, which
keeps their outputs while set-up asks it to and passes them on untouched.
End to end: ``samples_per_s`` (clips stepped over the window).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from port_bench.benchlib import check, inputs, runner
from port_bench.benchlib.cells import modules_of
from port_bench.reference import train as ref_train
from port_bench.reference.precision import reference_mode

ADAM_BETA1 = 0.9


class Recorder:
    """Calls ``fn``; while ``kept`` is a list, appends a detached copy of
    each call's outputs to it, on the host."""

    def __init__(self, fn):
        self.fn, self.kept = fn, None

    def __call__(self, *args):
        out = self.fn(*args)
        if self.kept is not None:
            self.kept.append(tuple(o.detach().cpu() for o in out))
        return out


def batch(seed: int, index: int, t: Dict, device):
    """Batch ``index``: ``(x, m, y)``, ``(B, F, H, W, C)``."""
    g = inputs.generator(seed, f"chn_train:{index}", device)
    y, m, x = inputs.clip(g, t, t["batch"], t["frames"], device)
    return x, m, y


def build(cell, config: Dict):
    """CPN (frozen), VGG-16 for the loss and the CHN, their weights loaded
    under ``cpn``, ``vgg`` and ``chn``, and the train state; returns train
    step ``i`` on pool batch ``i % pool``."""
    from master_thesis_tpu_torch import __main__ as cli
    from master_thesis_tpu_torch.train import build as program
    from master_thesis_tpu_torch.train import chn_task

    cfg = cell.configure(config)
    vgg = program.build_vgg(cfg, cfg.vgg_checkpoint)
    cell.aligner = Recorder(cli.build_aligner(cfg, vgg))
    chn = program.build_chn(cfg)
    cell.chn_apply = Recorder(program.chn_train_fn(cfg, chn))
    train_step = chn_task.make_train_step(
        chn, cell.aligner, vgg, perceptual_grad=cfg.perceptual_grad, chn_apply=cell.chn_apply)
    aligner = [m for m in modules_of(cell.aligner.fn) if type(m).__name__ == "CPN"]
    if len(aligner) != 1:
        raise RuntimeError(f"the aligner closes over {len(aligner)} CPN modules, not 1")
    cell._load("cpn", aligner[0])
    cell._load("vgg", vgg)
    cell._load("chn", chn)
    cell.model = chn
    reseed(cell)
    return lambda i: train_step(cell.state, *cell.pool[i % len(cell.pool)])


def reseed(cell) -> None:
    """A fresh train state over the loaded weights."""
    from master_thesis_tpu_torch.train.state import create_train_state

    cell.model.train()
    cell.state = create_train_state(cell.model, cell.cfg, steps_per_epoch=cell.cfg.train_max_iterations)


def first_steps(cell) -> Dict[str, object]:
    """Steps 0 .. ``checked_steps - 1`` through the window's own call, on
    pool batches that all differ: each step's loss items and aligned
    references, the first step's ``y_hat``, the first gradient's norm by
    leaf (Adam's first moment after one update over ``1 - beta1``), and
    each leaf's change after the last step."""
    n = cell.traffic["checked_steps"]
    if n > len(cell.pool):
        raise ValueError(f"{n} checked steps need as many distinct batches; the pool has {len(cell.pool)}")
    names = {id(p): k for k, p in cell.model.named_parameters()}
    steps, grad0 = [], {}
    cell.aligner.kept, cell.chn_apply.kept = [], []
    for i in range(n):
        items = cell.step(i)
        steps.append({k: float(v) for k, v in items.items()})
        if i == 0:
            grad0 = {names[id(p)]: float(torch.linalg.vector_norm(s["exp_avg"])) / (1 - ADAM_BETA1)
                     for p, s in cell.state.optimizer.state.items()}
    aligned, y0 = cell.aligner.kept, cell.chn_apply.kept[0][0]
    cell.aligner.kept = cell.chn_apply.kept = None
    start = inputs.weights(cell.templates["chn"], cell.seed, "chn", cell.device)
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
                  for k, p in cell.model.named_parameters()}
    del start
    return {"steps": steps, "grad0": grad0, "change": change, "aligned": aligned, "y0": y0}


def before(cell, sync):
    """The checked first steps (:func:`first_steps`)."""
    return first_steps(cell)


def window(cell, seconds: float, first, sync) -> Dict:
    return runner.train_window(cell, cell.traffic["checked_steps"], seconds, sync)


def end_to_end(win: Dict, traffic: Dict) -> Dict[str, float]:
    return {"samples_per_s": win["steps"] * traffic["batch"] / win["window_s"]}


def _batches(seed, traffic, device):
    return [batch(seed, i, traffic, device) for i in range(traffic["checked_steps"])]


def numbers(config, traffic, seed, device, w, win, first) -> Dict[str, float]:
    """The compared numbers of the first steps."""
    with torch.enable_grad():
        return check.train_check(config, w, _batches(seed, traffic, device), first)


# ------------------------------------------------------------ calibrate.py


def _look(config, w, batches, first, log, seed):
    """The sound run's numbers against the reference on its own aligned
    references, and each step's visible-hole pixels and flips."""
    own = check.reference_aligned(config, w, batches)
    want = check.reference_train(config, w, batches, own)
    nums = {f"{k}_own": v for k, v in {**check.train_numbers(first, want), **check.look_numbers(first, want)}.items()}
    # The reference's first gradient, term by term, and how much of y_hat
    # sits on the clamp.
    nb, frozen = config["cli"]["chn_nb"], {"cpn": w["cpn"], "vgg": w["vgg"]}
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in w["chn"].items()}
    fwd = ref_train.chn_forward(leaves, frozen, nb, *batches[0], aligned=[t.to(batches[0][0].device)
                                                                           for t in first["aligned"][0]])
    items = ref_train.chn_loss(frozen["vgg"], *fwd)
    terms = {**items, "total": sum(items.values())}
    norms = {}
    for k, v in terms.items():
        if v.requires_grad:
            g = torch.autograd.grad(v, list(leaves.values()), retain_graph=True, allow_unused=True)
            norms[k] = math.sqrt(sum(float(x.pow(2).sum()) for x in g if x is not None))
    y, py = fwd[2].detach(), first["y0"].to(fwd[2].device).float()
    clamped = lambda t: (t <= 0) | (t >= 1)
    gaps = sorted(((abs(first["grad0"][k] - v), k, first["grad0"][k], v) for k, v in want["grad0"].items()),
                  reverse=True)[:4]
    log(f"  seed {seed} worst first-gradient leaves program / reference: "
        + "; ".join(f"{k} {a:.4g} / {b:.4g}" for _, k, a, b in gaps))
    log(f"  seed {seed} first-gradient norm by term: " + ", ".join(f"{k} {v:.4g}" for k, v in norms.items())
        + f"; y_hat at 0: {float((y == 0).float().mean()):.3f}, at 1: {float((y == 1).float().mean()):.3f}"
        + f", on the clamp on one side only: {float((clamped(y) != clamped(py)).float().mean()):.5f}"
        + f"; items program / reference: " + ", ".join(f"{k} {first['steps'][0][k]:.5g} / {float(v):.5g}"
                                                      for k, v in items.items()))
    for i, (a, r) in enumerate(zip(first["aligned"], own)):
        log(f"  seed {seed} step {i}: v_map pixels program {float(a[2].sum()):.0f}, reference "
            f"{float(r[2].sum()):.0f}; v_aligned flips {float((a[1].to(r[1].device).float() != r[1]).sum()):.0f}")
    return nums


def sound(cell, config, seed, log, look=False) -> Dict[str, float]:
    """The numbers of the program's first steps, with the look numbers
    (:func:`..benchlib.check.look_numbers`); with ``look`` also
    :func:`_look`'s."""
    first = first_steps(cell)
    w, batches = cell.reference_weights(), _batches(seed, cell.traffic, cell.device)
    with reference_mode():
        nums = check.train_check(config, w, batches, first, look=True)
        if look:
            nums.update(_look(config, w, batches, first, log, seed))
    return nums


def _half_loss(config, w, batches, rows):
    """The reference's steps with each step's loss taken over ``rows`` of
    the batch alone (the forward over all of it)."""
    nb, frozen = config["cli"]["chn_nb"], {"cpn": w["cpn"], "vgg": w["vgg"]}
    aligned = check.reference_aligned(config, w, batches)

    def loss(p, i, b):
        fwd = ref_train.chn_forward(p, frozen, nb, *b, aligned=aligned[i])
        return ref_train.chn_loss(frozen["vgg"], *(t[rows] for t in fwd)), fwd[2]
    got = ref_train.run_steps(loss, w["chn"], batches, config["cli"]["lr"])
    return {**got, "aligned": aligned}


def others(cell, config, seed, kinds) -> Dict[str, Dict[str, float]]:
    """The numbers of the reference at each precision of ``kinds`` (name ->
    quantizer) in the program's place, and of the half-batch faults (the
    loss over each batch's first half, or its even rows)."""
    w, batches, out = cell.reference_weights(), _batches(seed, cell.traffic, cell.device), {}
    with reference_mode(), torch.enable_grad():
        for name, q in kinds.items():
            aligned = check.reference_aligned(config, w, batches, q)
            got = check.reference_train(config, w, batches, aligned, q)
            out[name] = check.train_check(config, w, batches, {**got, "aligned": aligned}, look=True)
        half = batches[0][0].shape[0] // 2
        for name, rows in (("half_first", slice(0, half)), ("half_even", slice(0, None, 2))):
            out[name] = check.train_check(config, w, batches, _half_loss(config, w, batches, rows), look=True)
    return out
