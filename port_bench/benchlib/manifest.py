"""``BENCHMARK.json`` and the files its names lead to, found by name:

- configuration ``c``: ``port_bench/configs/c.json``;
- traffic mix ``t``: ``port_bench/traffic/t.json``;
- cell ``w``'s comparison limits: ``port_bench/limits/w.json``;
- per-layer metric ``m``: the reader ``port_bench/metrics/m.py``;
- the chip's peaks: ``port_bench/peaks.json``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = _json(self.root / "BENCHMARK.json")
        self.workloads = {w["name"]: w for w in self.data["workloads"]}
        self.configs = {c["name"]: c for c in self.data["configs"]}

    def workload(self, name: str) -> Dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(self.workloads)})")
        return self.workloads[name]

    def config(self, name: str) -> Dict:
        return _json(self.root / self.configs[name]["file"])

    def traffic(self, name: str) -> Dict:
        return _json(BENCH / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> Dict[str, float]:
        return _json(BENCH / "limits" / f"{workload}.json")

    def peaks(self) -> Dict[str, float]:
        return _json(BENCH / "peaks.json")

    def end_to_end(self, workload: str) -> List[Dict]:
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics a cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in moves else [])]

    @staticmethod
    def reader(name: str) -> ModuleType:
        path = BENCH / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
