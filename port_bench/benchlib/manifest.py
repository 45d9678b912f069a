"""``BENCHMARK.json`` and the files its names lead to, found by name:

- configuration ``c``: ``port_bench/configs/c.json``;
- traffic mix ``t``: ``port_bench/traffic/t.json``;
- cell ``w``'s comparison limits: ``port_bench/limits/w.json``;
- per-layer metric ``m``: the reader ``port_bench/metrics/m.py``;
- traffic kind ``k`` (a traffic file's ``kind``): the step kind
  ``port_bench/kinds/k.py``, which builds the cell's step and runs, times
  and checks it (``port_bench/README.md``, "A kind");
- the chip's peaks: ``port_bench/peaks.json``.

Each is looked up under the ``port_bench`` directory beside the manifest's
``BENCHMARK.json``.
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


def _module(path: Path, prefix: str, what: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {what}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"{prefix}{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / BENCH.name
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
        return _json(self.bench / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> Dict[str, float]:
        return _json(self.bench / "limits" / f"{workload}.json")

    def peaks(self) -> Dict[str, float]:
        return _json(self.bench / "peaks.json")

    def end_to_end(self, workload: str) -> List[Dict]:
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics a cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        moves = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [workload] if m["moves"] in moves else [])]

    def reader(self, name: str) -> ModuleType:
        return _module(self.bench / "metrics" / f"{name}.py", "port_bench_metric_", f"reader of metric {name!r}")

    def kind(self, name: str) -> ModuleType:
        """The step kind of traffic kind ``name``."""
        return _module(self.bench / "kinds" / f"{name}.py", "port_bench_kind_", f"kind file for traffic kind {name!r}")
