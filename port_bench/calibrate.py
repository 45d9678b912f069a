"""Readings that set a cell's comparison limits (``port_bench/limits/``):
the compared numbers of sound runs of the program over many seeds, and,
over a few, of the control (the reference computed in the configuration's
``control`` precision, in the program's place), of the reference in the
configuration's own precision (a witness, with ``--witness``) and, for a
training cell, of planted faults (the loss taken over half of each batch,
its first half or its even rows), all in one process at the cell's own
size.

    python3 port_bench/calibrate.py --workload NAME --seeds 12 --control 3 --first 5000000000

The benchmark's runs do not run this. Prints one line a reading and, last,
a JSON object: each number's largest sound reading, the smallest of each
other kind, and every reading. With ``--look`` a training cell's sound
lines also give the numbers against the reference on its own aligned
references (``*_own``), and each step's visible-hole pixels and
visibility flips.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench.benchlib import check, inputs, runner  # noqa: E402
from port_bench.benchlib.cells import Cell  # noqa: E402
from port_bench.benchlib.manifest import Manifest  # noqa: E402
from port_bench.reference import train as ref_train  # noqa: E402
from port_bench.reference.precision import quantizer, reference_mode  # noqa: E402


def _serve(cell, config, seed, make_outs):
    """The serving numbers, worst over the steps the seed samples, with
    ``make_outs(i, batch, w)`` giving step ``i``'s outputs."""
    w, out = cell.reference_weights(), []
    for i in runner.sample_steps(seed, cell.traffic):
        batch = inputs.serve_batch(seed, i % cell.traffic["pool"], cell.traffic, cell.device)
        out.append(check.serve_numbers(config, w, batch, make_outs(i, batch, w)))
    return check.worst_of(out)


def _batches(cell, seed):
    return [inputs.BATCHES[cell.kind](seed, i, cell.traffic, cell.device)
            for i in range(cell.traffic["checked_steps"])]


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


def _program(cell, config, seed, log, look=False):
    """A sound run's numbers: the program's outputs (serving: the steps the
    seed samples; training: its first steps) against the reference."""
    cell.reseed(seed)
    if cell.kind == "serve":
        outs = {i: tuple(o.float().clone() for o in cell.serve_step(i))
                for i in runner.sample_steps(seed, cell.traffic)}
        with reference_mode(), torch.no_grad():
            return _serve(cell, config, seed, lambda i, b, w: outs[i])
    first = cell.first_steps()
    w, batches = cell.reference_weights(), _batches(cell, seed)
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


def _others(cell, config, seed, kinds):
    """The numbers of the reference at each precision of ``kinds`` (name ->
    quantizer) in the program's place, and for a training cell of the
    half-batch faults."""
    cell.reseed(seed)
    w, out = cell.reference_weights(), {}
    with reference_mode(), torch.no_grad() if cell.kind == "serve" else torch.enable_grad():
        if cell.kind == "serve":
            for name, q in kinds.items():
                out[name] = _serve(cell, config, seed, lambda i, b, w, q=q: check.control_serve(config, w, b, q))
            return out
        batches = _batches(cell, seed)
        for name, q in kinds.items():
            aligned = check.reference_aligned(config, w, batches, q)
            got = check.reference_train(config, w, batches, aligned, q)
            out[name] = check.train_check(config, w, batches, {**got, "aligned": aligned}, look=True)
        half = batches[0][0].shape[0] // 2
        for name, rows in (("half_first", slice(0, half)), ("half_even", slice(0, None, 2))):
            out[name] = check.train_check(config, w, batches, _half_loss(config, w, batches, rows), look=True)
    return out


def readings(workload, seeds, control_seeds, witness=False, device="cuda", cli=None, log=print, look=False):
    """Every reading of ``workload``: sound runs on ``seeds``; the control,
    the witness and the faults on ``control_seeds``."""
    man = Manifest(ROOT)
    wl = man.workload(workload)
    config, traffic = man.config(wl["config"]), man.traffic(wl["traffic"])
    config["cli"].update(cli or {})
    if device.startswith("cuda"):
        from master_thesis_tpu_torch import _build

        _build.build(_build.SOURCES)
    kinds = {"control": quantizer(config["control"])}
    if witness:
        kinds["witness"] = quantizer(config["cli"]["compute_dtype"])
    cell = Cell(config, traffic, (list(seeds) or list(control_seeds))[0], device)
    out = {"sound": [], "control": [], "witness": [], "half_first": [], "half_even": []}
    for s in seeds:
        t0 = time.perf_counter()
        out["sound"].append(_program(cell, config, s, log, look))
        log(f"sound seed {s}: {json.dumps(out['sound'][-1])} ({time.perf_counter() - t0:.1f} s)")
    for s in control_seeds:
        for name, got in _others(cell, config, s, kinds).items():
            out[name].append(got)
            log(f"{name} seed {s}: {json.dumps(got)}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first", type=int, default=5_000_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--witness", action="store_true",
                    help="also read the reference computed in the configuration's own precision")
    ap.add_argument("--look", action="store_true", help="training: also the numbers against the reference "
                    "on its own aligned references, and each step's visible-hole pixels and flips")
    ap.add_argument("--cli", nargs="*", default=[], help="KEY=JSON overrides of the program's settings")
    args = ap.parse_args(argv)
    seeds = [args.first + i for i in range(args.seeds)]
    cli = {k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.cli)}
    out = readings(args.workload, seeds, seeds[:args.control], args.witness, args.device, cli,
                   lambda m: print(m, flush=True), args.look)
    keys = out["sound"][0].keys()
    summary = {k: {"sound_max": max(r[k] for r in out["sound"]),
                   **{f"{n}_min": min(r[k] for r in out[n]) for n in out if n != "sound" and out[n] and k in out[n][0]}}
               for k in keys}
    print(json.dumps({"workload": args.workload, "seeds": seeds, "summary": summary, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
