"""The traced window: a ``torch.profiler`` profile of a few steps, kept in
memory, reduced to device busy time, kernel time and counts by name
pattern (optionally only under given autograd nodes), the longest idle
gaps by what the host was doing, and the device operations that took most
time."""

from __future__ import annotations

import importlib
import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def is_device(e) -> bool:
    return str(e.device_type).endswith(("CUDA", "PrivateUse1"))


class Trace:
    """A profile of ``steps`` calls of ``step(i)``, the last followed by
    ``sync()``. ``window_s`` is their host time."""

    def __init__(self, step: Callable[[int], None], steps: Sequence[int], sync: Callable[[], None]):
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in steps:
                step(i)
            sync()
            self.window_s = time.perf_counter() - t0
        self.steps = len(steps)
        self.events = list(prof.events())
        self.device = sorted((e for e in self.events if is_device(e)), key=lambda e: e.time_range.start)

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals, in microseconds."""
        out: List[List[float]] = []
        for e in self.device:
            s, t = e.time_range.start, e.time_range.end
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.intervals()) / 1e6

    def span_s(self) -> float:
        """The traced window: the host's, or the device events' span where
        that is longer."""
        iv = self.intervals()
        return max(self.window_s, (iv[-1][1] - iv[0][0]) / 1e6 if iv else 0.0)

    def kernels(self, pattern: str, scope: Optional[str] = None) -> Tuple[float, int]:
        """(seconds, count) of the device kernels whose name matches
        ``pattern``; with ``scope``, only those launched under a host op
        whose name matches it (an autograd node, say)."""
        rx = re.compile(pattern)
        if scope is None:
            hit = [e for e in self.device if rx.search(e.name)]
            return sum(e.time_range.end - e.time_range.start for e in hit) / 1e6, len(hit)
        sx = re.compile(scope)
        total, count = 0.0, 0
        for root in (e for e in self.events if not is_device(e) and sx.search(e.name)):
            stack = [root]
            while stack:
                e = stack.pop()
                for k in e.kernels:
                    if rx.search(k.name):
                        total += k.duration
                        count += 1
                stack.extend(e.cpu_children)
        return total / 1e6, count

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.device:
            by[e.name] = by.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
        return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, longest: int = 200) -> List[list]:
        """The ``longest`` idle gaps between device work, summed by the
        innermost host op running at each gap's middle."""
        host = [e for e in self.events if not is_device(e)]
        iv = self.intervals()
        gaps = sorted(((s - e, e, s) for (_, e), (s, _) in zip(iv, iv[1:])), reverse=True)[:longest]
        by: Dict[str, float] = {}
        for _, end, start in gaps:
            mid = (end + start) / 2
            inner = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
            name = min(inner, key=lambda e: e.time_range.end - e.time_range.start).name if inner else "(none)"
            by[name[:200]] = by.get(name[:200], 0.0) + (start - end) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def counter_value(spec: Sequence) -> int:
    """A program counter ``(module, function, multiplier)``: the function's
    ``launches`` attribute times ``multiplier`` (a number, or the name of a
    constant of the module)."""
    mod = importlib.import_module(spec[0])
    mult = spec[2] if isinstance(spec[2], int) else getattr(mod, spec[2])
    return int(getattr(mod, spec[1]).launches) * int(mult)
