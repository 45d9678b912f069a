"""Readings that set a cell's comparison limits (``port_bench/limits/``):
the compared numbers of sound runs of the program over many seeds, and,
over a few, of the control (the reference computed in the configuration's
``control`` precision, in the program's place), of the reference in the
configuration's own precision (a witness, with ``--witness``) and of the
faults the cell's step kind plants (``sound`` and ``others`` of
``port_bench/kinds/<kind>.py``; the CHN train step's: the loss taken over
half of each batch, its first half or its even rows), all in one process
at the cell's own size.

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
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.benchlib.cells import Cell  # noqa: E402
from port_bench.benchlib.manifest import Manifest  # noqa: E402
from port_bench.reference.precision import quantizer  # noqa: E402


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
    cell = Cell(config, traffic, (list(seeds) or list(control_seeds))[0], device, man.kind(traffic["kind"]))
    out = {"sound": []}
    for s in seeds:
        t0 = time.perf_counter()
        cell.reseed(s)
        out["sound"].append(cell.kind.sound(cell, config, s, log, look))
        log(f"sound seed {s}: {json.dumps(out['sound'][-1])} ({time.perf_counter() - t0:.1f} s)")
    for s in control_seeds:
        cell.reseed(s)
        for name, got in cell.kind.others(cell, config, s, kinds).items():
            out.setdefault(name, []).append(got)
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
