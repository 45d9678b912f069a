"""What the harness and the reference load: nothing whose top-level name is
``jax``, ``jaxlib``, ``flax`` or ``master_thesis_tpu`` (compared whole:
``master_thesis_tpu_torch`` is neither), and the reference nothing of
``master_thesis_tpu_torch``. Each check runs in a fresh interpreter."""

import json
import subprocess
import sys

from port_bench.benchlib.manifest import ROOT
from port_bench.run import FORBIDDEN, forbidden_modules

PRELUDE = f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); import torch; torch.set_num_threads(2)\n"


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code + "\nprint(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _tops(modules) -> set:
    return {m.split(".")[0] for m in modules}


def test_the_comparison_is_by_whole_top_level_names():
    assert forbidden_modules() == sorted(_tops(sys.modules) & set(FORBIDDEN))
    assert "master_thesis_tpu_torch" not in FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops(_loaded_after("import port_bench.reference.nets, port_bench.reference.train, "
                               "port_bench.reference.precision"))
    assert not tops & {"master_thesis_tpu_torch", *FORBIDDEN}


def test_a_whole_run_loads_no_jax():
    code = ("from port_bench.benchlib.runner import run\n"
            "from port_bench.tests.conftest import tiny\n"
            "t, c = tiny('dfpn_serve_b4')\n"
            "run('dfpn_serve_b4', 5, 0.2, True, device='cpu', cli=c, traffic=t)\n"
            "t, c = tiny('cpn_train_b32')\n"
            "run('cpn_train_b32', 5, 0.2, False, device='cpu', cli=c, traffic=t)\n")
    tops = _tops(_loaded_after(code))
    assert "master_thesis_tpu_torch" in tops and not tops & set(FORBIDDEN)
