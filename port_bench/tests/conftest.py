"""The benchmark's own tests. Those marked ``gpu`` need a CUDA device and
ask the ``cuda`` fixture for it, which skips them without one; the others
run on the CPU at tiny sizes."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; the test skips without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode)")
    return torch.device("cuda")


# A cell shrunk for the CPU: frames of 32², two targets of two references
# (or two clips of two frames), CHN of 2 RRDBs, DFPN at base 64.
TINY_TRAFFIC = {"height": 32, "width": 32, "batch": 2, "pool": 3, "warmup_steps": 1, "check_within": 2,
                "check_steps": 1, "profile_steps": 2}
TINY_CLI = {"chn_nb": 2, "dfpn_base_size": 64}


def tiny(name: str, **cli):
    """``(traffic, cli)`` overrides that shrink a cell or a traffic mix
    ``name`` for the CPU."""
    traffic = dict(TINY_TRAFFIC)
    if "serve" in name:
        traffic["refs"] = 2
    return traffic, {**TINY_CLI, **cli}
