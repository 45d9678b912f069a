"""One run of one cell: set-up, the measured window, with ``trace`` a
profiled stretch after it, then the check against the reference.

What is the cell's own comes from its step kind (``port_bench/kinds/<kind>.py``,
the traffic file's ``kind``): its step, what runs before the window (a
warm-up, or the checked first steps), the window (one of the loops below),
its end-to-end values and its compared numbers. With ``trace`` 0 the
result's metrics are the cell's end-to-end metrics; with 1 its per-layer
metrics, read by their readers (``port_bench/metrics/<name>.py``) from the
window and the profile. Both decide ``correct`` alike."""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from port_bench.benchlib import check, inputs
from port_bench.benchlib.cells import Cell
from port_bench.benchlib.manifest import Manifest
from port_bench.benchlib.trace import Trace, counter_value
from port_bench.reference.precision import reference_mode

GIB = float(1 << 30)
TRACE_READINGS = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sample_steps(seed: int, traffic: Dict) -> List[int]:
    """The window steps whose outputs the check compares: ``check_steps``
    pool batches drawn from the seed, each at a cycle of the pool drawn
    from the seed among those of the first ``check_within`` steps (about
    the window's steps), so that the checks fall over the whole window."""
    g = inputs.generator(seed, "check", "cpu")
    pool = traffic["pool"]
    batches = torch.randperm(pool, generator=g)[: traffic["check_steps"]]
    cycles = torch.randint(max(1, traffic["check_within"] // pool), (len(batches),), generator=g)
    return sorted(int(c) * pool + int(b) for c, b in zip(cycles, batches))


def _sync(device: str):
    return torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)


def serve_window(cell: Cell, seconds: float, keep: List[int], sync) -> Dict:
    """Closed loop, one client: each step from dispatch to its outputs
    ready, for ``seconds`` and at least past the last step of ``keep``.
    The outputs of the steps of ``keep`` are copied to host memory after
    the step's time is read; the window's time leaves those copies out."""
    lat, kept, i, copy_s = [], {}, 0, 0.0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        outs = cell.step(i)
        sync()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if i in keep:
            kept[i] = tuple(o.cpu() for o in outs)
            copy_s += time.perf_counter() - t1
        del outs
        i += 1
        if t1 - t_start - copy_s >= seconds and i > max(keep):
            break
    return {"steps": i, "window_s": t1 - t_start - copy_s, "lat": lat, "kept": kept, "next": i}


def train_window(cell: Cell, first: int, seconds: float, sync) -> Dict:
    """Steps back to back from step ``first`` while the host clock is inside
    the window, then a sync: all the work over all the time."""
    sync()
    i = first
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        cell.step(i)
        i += 1
    sync()
    return {"steps": i - first, "window_s": time.perf_counter() - t_start, "next": i}


def traced(step, first: int, count: int, sync, readers: Dict) -> Trace:
    """A profile of ``count`` steps from ``first`` whose kernel counts,
    for every reader that names its kernels and the program's counters of
    them, agree with those counters; read again where they do not."""
    checked = {k: r for k, r in readers.items() if getattr(r, "COUNTERS", None)}
    for reading in range(1, TRACE_READINGS + 1):
        before = {k: sum(counter_value(c) for c in r.COUNTERS) for k, r in checked.items()}
        tr = Trace(step, range(first, first + count), sync)
        ok = True
        for k, r in checked.items():
            launched = sum(counter_value(c) for c in r.COUNTERS) - before[k]
            seen = tr.kernels(r.KERNELS, getattr(r, "SCOPE", None))[1]
            log(f"kernels {k}: profile {seen}, counters {launched} (reading {reading})")
            ok &= seen == launched
        if ok:
            return tr
    raise RuntimeError(f"the profile miscounted the kernels in {TRACE_READINGS} readings")


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        cli: Optional[Dict] = None, traffic: Optional[Dict] = None, manifest: Optional[Manifest] = None,
        t0: Optional[float] = None) -> Dict:
    """Runs cell ``workload``; returns the result line's object, its last
    key ``checks`` each compared number with its limit. ``cli`` and
    ``traffic`` override the cell's settings (the tests shrink it)."""
    t0 = time.perf_counter() if t0 is None else t0
    man = manifest or Manifest()
    wl = man.workload(workload)
    config = man.config(wl["config"])
    config = {**config, "cli": {**config["cli"], **(cli or {})}}
    traffic = {**man.traffic(wl["traffic"]), **(traffic or {})}
    limits = man.limits(workload)
    kind = man.kind(traffic["kind"])
    sync = _sync(device)
    on_card = device.startswith("cuda")

    if on_card:
        from master_thesis_tpu_torch import _build

        _build.build(_build.SOURCES)
    cell = Cell(config, traffic, seed, device, kind)

    readers = {}
    if trace:
        readers = {m["name"]: man.reader(m["name"]) for m in man.per_layer(workload)}

    before = kind.before(cell, sync)
    setup_s = time.perf_counter() - t0

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    win = kind.window(cell, seconds, before, sync)
    tr = traced(cell.step, win["next"], traffic["profile_steps"], sync, readers) if trace else None
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics = {}
    if not trace:
        e2e = {"setup_s": setup_s, "peak_mem_gib": peak / GIB, **kind.end_to_end(win, traffic)}
        for m in man.end_to_end(workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        peaks = man.peaks()
        ctx = SimpleNamespace(config=config, traffic=traffic, kind=traffic["kind"], steps=win["steps"],
                              window_s=win["window_s"], win=win, before=before, trace=tr,
                              peak_flops=peaks[config["peak"]], peak_bytes=peaks["hbm_bytes_per_s"])
        for m in man.per_layer(workload):
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    w_ref = cell.reference_weights()
    cell.free()
    del cell
    # The reference in float32, TF32 off.
    with reference_mode():
        numbers = kind.numbers(config, traffic, seed, device, w_ref, win, before)
    result = {
        "correct": check.verdict(numbers, limits),
        "attempted": win["steps"],
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.span_s()
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result
