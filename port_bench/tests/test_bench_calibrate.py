"""``calibrate.py``'s readings through each cell's step kind on the CPU at a
tiny size: the sound run's numbers, and the control's, the witness's and
(training) the half-batch faults' on the same seed, each with every number
the cell's limits compare."""

import pytest

from port_bench import calibrate
from port_bench.benchlib.manifest import Manifest
from port_bench.tests.conftest import tiny

MAN = Manifest()


@pytest.mark.parametrize("workload", ["cpn_serve_b16", "dfpn_serve_b4", "cpn_train_b32"])
def test_readings_run_through_the_kind(monkeypatch, workload):
    traffic, cli = tiny(workload)
    real = Manifest.traffic
    monkeypatch.setattr(Manifest, "traffic", lambda self, name: {**real(self, name), **traffic})
    out = calibrate.readings(workload, [11], [11], witness=True, device="cpu", cli=cli, log=lambda m: None)
    want = {"sound", "control", "witness"} | ({"half_first", "half_even"} if workload.endswith("train_b32") else set())
    assert set(out) == want and all(len(v) == 1 for v in out.values())
    limits = MAN.limits(workload)
    assert all(set(limits) <= set(v[0]) for v in out.values())
