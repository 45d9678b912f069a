"""On the card, at each cell's own size: the control (the reference
computed one precision below the configuration's, in the program's place)
comes out not correct on three seeds, and the program's own run correct,
by the cell's limits. Run on a machine with a card:

    python -m pytest port_bench/tests/test_bench_control.py -q
"""

import pytest

from port_bench import calibrate
from port_bench.benchlib import check
from port_bench.benchlib.manifest import Manifest

pytestmark = pytest.mark.gpu
MAN = Manifest()
SEEDS = [2**32 + 101, 2**32 + 102, 2**32 + 103]


@pytest.mark.parametrize("workload", list(MAN.workloads))
def test_the_control_fails_and_the_program_passes(cuda, workload):
    limits = MAN.limits(workload)
    out = calibrate.readings(workload, SEEDS[:1], SEEDS, log=lambda m: None)
    assert all(check.verdict(r, limits) for r in out["sound"]), out["sound"]
    assert not any(check.verdict(r, limits) for r in out["control"]), out["control"]
