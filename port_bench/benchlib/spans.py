"""What the span readers share: the program's named spans
(``master_thesis_tpu_torch/runtime/spans.py``, profiler ranges that exist
only while a profiler records) in the traced window
(:class:`.trace.Trace`), reduced to a step's device time under them, host
time in them and device idle time inside them. Each returns None where the
profile holds none of the named spans, so that a span the program lacks or
renamed reads as missing, not as 0. Host and device times share the
profile's clock (Kineto aligns the device's timestamps to the host's).

A kernel is under a span when the host call that launched it (the CUDA
runtime or driver call the profiler records, which shares the kernel's
correlation id) ran inside the span. The kernel lists the profiler hangs
on each host op are not used: on an H100 they held the trunk kernels of a
serving step about a hundred times over under ``chn.trunk``."""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Tuple

from port_bench.benchlib.trace import is_device


def _spans(trace, names: Iterable[str]) -> List:
    names = set(names)
    return [e for e in trace.events if not is_device(e) and e.name in names]


def _union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _launches(trace) -> Dict[int, float]:
    """Each launch call's host start by its correlation id: the host events
    of the CUDA runtime and driver APIs (``cuda*``, ``cu*``), whose ids are
    the profiler's correlation ids and not an op's."""
    return {e.id: e.time_range.start for e in trace.events if not is_device(e) and e.name.startswith("cu")}


def device_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """The device time a step of the device events (kernels, copies,
    fills) launched while one of the spans ``names`` was open, each once
    however the spans nest."""
    hits = _spans(ctx.trace, names)
    if not hits:
        return None
    iv = _union((e.time_range.start, e.time_range.end) for e in hits)
    starts, launched, total = [s for s, _ in iv], _launches(ctx.trace), 0.0
    for k in ctx.trace.device:
        t = launched.get(k.id)
        i = -1 if t is None else bisect_right(starts, t) - 1
        if i >= 0 and t <= iv[i][1]:
            total += k.time_range.end - k.time_range.start
    return total / 1e3 / ctx.trace.steps


def host_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """The length a step of the union of the spans' host intervals."""
    hits = _spans(ctx.trace, names)
    if not hits:
        return None
    iv = _union((e.time_range.start, e.time_range.end) for e in hits)
    return sum(t - s for s, t in iv) / 1e3 / ctx.trace.steps


def idle_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """The part a step of the union of the spans' host intervals in which
    no device event (kernel, copy or fill) ran."""
    hits = _spans(ctx.trace, names)
    if not hits:
        return None
    busy, j, idle = ctx.trace.intervals(), 0, 0.0
    for s, t in _union((e.time_range.start, e.time_range.end) for e in hits):
        idle += t - s
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < t:
            idle -= min(t, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return idle / 1e3 / ctx.trace.steps
