"""Serving (``kind: serve``): one client in a closed loop, each step
``batch`` targets with ``refs`` references of their clip. A step is the
two calls ``Inpainter._refine`` makes each round, under
``torch.inference_mode``: the aligner from the command line's
``__main__.build_aligner``, then ``train.build.chn_infer_fn(chn,
kernels=build.use_kernels(cfg))``; it ends when its outputs are ready.

Before the window ``warmup_steps`` steps; the window
(:func:`..benchlib.runner.serve_window`) keeps the outputs of the steps
:func:`..benchlib.runner.sample_steps` draws, which the check holds
against the reference aligner and CHN (:func:`..benchlib.check.
serve_numbers`). End to end: ``frames_per_s`` (targets inpainted over the
window) and ``step_p95_ms`` (every window step's latency).
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

from port_bench.benchlib import check, inputs, runner
from port_bench.benchlib.cells import modules_of
from port_bench.reference.precision import reference_mode


def batch(seed: int, index: int, t: Dict, device):
    """Batch ``index``: ``(x_t, m_t, x_r, m_r)``, ``batch`` targets each with
    ``refs`` references of its clip, the target the clip's centre frame."""
    g = inputs.generator(seed, f"serve:{index}", device)
    f = t["refs"] + 1
    _, m, x = inputs.clip(g, t, t["batch"], f, device)
    c = f // 2
    refs = [i for i in range(f) if i != c]
    return x[:, c].contiguous(), m[:, c].contiguous(), x[:, refs].contiguous(), m[:, refs].contiguous()


def build(cell, config: Dict):
    """The aligner the configuration names and the CHN, their weights
    loaded under ``cpn`` or ``dfpn``, ``vgg`` (DFPN's) and ``chn``; returns
    step ``i`` on pool batch ``i % pool``: ``(xa, va, vm, y_hat,
    y_hat_comp)``."""
    from master_thesis_tpu_torch import __main__ as cli
    from master_thesis_tpu_torch.train import build as program

    cfg = cell.configure(config, chn_aligner=config["aligner"])
    vgg = program.build_vgg(cfg, cfg.vgg_checkpoint) if cfg.chn_aligner == "dfpn" else None
    align_fn = cli.build_aligner(cfg, vgg)
    chn = program.build_chn(cfg).requires_grad_(False).eval()
    chn_fn = program.chn_infer_fn(chn, kernels=program.use_kernels(cfg))
    aligner = [m for m in modules_of(align_fn) if type(m).__name__ in ("CPN", "DFPN")]
    if len(aligner) != 1:
        raise RuntimeError(f"the aligner closes over {len(aligner)} CPN / DFPN modules, not 1")
    cell._load(cfg.chn_aligner, aligner[0])
    if vgg is not None:
        cell._load("vgg", vgg)
    cell._load("chn", chn)

    def step(i: int):
        x_t, m_t, x_r, m_r = cell.pool[i % len(cell.pool)]
        with torch.inference_mode():
            xa, va, vm = align_fn(x_t, m_t, x_r, m_r)
            y_hat, y_comp = chn_fn(x_t, 1 - m_t, xa, va, vm)
        return xa, va, vm, y_hat, y_comp
    return step


def reseed(cell) -> None:
    """Nothing but the weights and batches is made from the seed."""


def before(cell, sync):
    """The warm-up; returns the window steps whose outputs are kept."""
    for i in range(cell.traffic["warmup_steps"]):
        cell.step(i)
    sync()
    return runner.sample_steps(cell.seed, cell.traffic)


def window(cell, seconds: float, keep, sync) -> Dict:
    return runner.serve_window(cell, seconds, keep, sync)


def end_to_end(win: Dict, traffic: Dict) -> Dict[str, float]:
    return {"frames_per_s": win["steps"] * traffic["batch"] / win["window_s"],
            "step_p95_ms": 1e3 * statistics.quantiles(win["lat"], n=100, method="inclusive")[94]}


def _numbers(config, traffic, seed, device, w, steps, make_outs) -> Dict[str, float]:
    """The serving numbers, worst over ``steps``, with ``make_outs(i, batch,
    w)`` giving step ``i``'s outputs."""
    with torch.no_grad():
        return check.worst_of([
            check.serve_numbers(config, w, b, make_outs(i, b, w))
            for i, b in ((i, batch(seed, i % traffic["pool"], traffic, device)) for i in steps)])


def numbers(config, traffic, seed, device, w, win, keep) -> Dict[str, float]:
    """The compared numbers, worst over the steps kept from the window."""
    kept = win["kept"]
    return _numbers(config, traffic, seed, device, w, kept, lambda i, b, w: [o.to(device) for o in kept[i]])


# ------------------------------------------------------------ calibrate.py


def sound(cell, config, seed, log, look=False) -> Dict[str, float]:
    """The numbers of the program's outputs on the steps the seed samples."""
    steps = runner.sample_steps(seed, cell.traffic)
    outs = {i: tuple(o.float().clone() for o in cell.step(i)) for i in steps}
    with reference_mode():
        return _numbers(config, cell.traffic, seed, cell.device, cell.reference_weights(), steps,
                        lambda i, b, w: outs[i])


def others(cell, config, seed, kinds) -> Dict[str, Dict[str, float]]:
    """The numbers of the reference at each precision of ``kinds`` (name ->
    quantizer) in the program's place."""
    steps, w = runner.sample_steps(seed, cell.traffic), cell.reference_weights()
    with reference_mode():
        return {name: _numbers(config, cell.traffic, seed, cell.device, w, steps,
                               lambda i, b, w, q=q: check.control_serve(config, w, b, q))
                for name, q in kinds.items()}
