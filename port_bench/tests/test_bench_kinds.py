"""A configuration whose model is not "aligner + CHN" comes in with new
files and manifest entries only: a toy step kind (VGG-16's features of a
batch of frames, the port's ``VGGFeatures`` as ``train/build.py:build_vgg``
makes it) is written with its configuration (with a cut in ``reduced``),
traffic, limits, one cell and two per-layer metrics (one from the kind's
window, one from a span of its own) into a copy of the benchmark's layout,
and run there through :func:`..benchlib.runner.run` on the CPU at a tiny
size, with no file of ``port_bench/`` changed; the manifest and span
checks hold for it unedited, and a fault planted in its step reads
``correct: false``."""

import hashlib
import json
import shutil

import pytest

from port_bench.benchlib.manifest import BENCH, Manifest
from port_bench.benchlib.runner import run
from port_bench.tests.test_bench_manifest import check_manifest
from port_bench.tests.test_bench_spans import check_every_span_metric_is_found, check_span_metric, span_metrics

SEED = 2**31 + 91

TOY_KIND = '''"""A toy kind: VGG-16's five post-pool maps of a batch of frames under a
span ``toy.features``, one client in a closed loop; the check holds one
kept step's maps against the plain reference's."""

import torch

from port_bench.benchlib import check, inputs, runner
from port_bench.reference import nets


def batch(seed, index, t, device):
    g = inputs.generator(seed, f"toy_vgg:{index}", device)
    return inputs.smooth_frames(g, t["batch"], 1, t["height"], t["width"], tuple(t["pan_px"]), device)[:, 0]


def build(cell, config):
    from master_thesis_tpu_torch.runtime.spans import span
    from master_thesis_tpu_torch.train import build as program

    cfg = cell.configure(config)
    vgg = program.build_vgg(cfg, cfg.vgg_checkpoint)
    cell._load("vgg", vgg)

    def step(i):
        with torch.inference_mode(), span("toy.features"):
            return vgg(cell.pool[i % len(cell.pool)])
    return step


def reseed(cell):
    pass


def before(cell, sync):
    cell.step(0)
    sync()
    return [1]


def window(cell, seconds, keep, sync):
    return runner.serve_window(cell, seconds, keep, sync)


def end_to_end(win, traffic):
    return {"images_per_s": win["steps"] * traffic["batch"] / win["window_s"]}


def numbers(config, traffic, seed, device, w, win, keep):
    with torch.no_grad():
        want = nets.vgg_features(w["vgg"], batch(seed, 1 % traffic["pool"], traffic, device))
    return {"feat_rel": max(check.rel_l2(g.to(device), r) for g, r in zip(win["kept"][1], want))}
'''

TOY_METRIC = '''"""The median step of the kind's window, from its latencies."""

import statistics

LAYER = "whole step"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "images_per_s"


def read(ctx):
    return 1e3 * statistics.median(ctx.win["lat"])
'''

TOY_SPAN_METRIC = '''"""The host time a step under the toy's span."""

from port_bench.benchlib import spans

LAYER = "features"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "images_per_s"
SPANS = ["toy.features"]


def read(ctx):
    return spans.host_ms(ctx, SPANS)
'''

MANIFEST = {
    "command": ["python3", "port_bench/run.py"], "paths": ["port_bench"], "run_seconds": 10,
    "configs": [{"name": "toy_vgg", "source": "https://arxiv.org/abs/1409.1556", "file": "port_bench/configs/toy_vgg.json",
                 "reduced": ["input_px"], "why": "VGG-16's feature tower alone"}],
    "workloads": [{"name": "toy_vgg_b2", "config": "toy_vgg", "traffic": "toy_b2", "chips": 1,
                   "why": "two frames of 32^2 a step, one client"}],
    "end_to_end": [
        {"name": "images_per_s", "unit": "images/s", "better": "higher", "bound": 0.05, "source": "host_clock"},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}],
    "per_layer": [{"name": "step_ms.toy", "unit": "ms", "better": "lower", "source": "host_clock",
                   "layer": "whole step", "moves": "images_per_s"},
                  {"name": "host_ms.toy", "unit": "ms", "better": "lower", "source": "program_span",
                   "layer": "features", "moves": "images_per_s", "workloads": ["toy_vgg_b2"]}],
}
FILES = {
    "kinds/toy_vgg.py": TOY_KIND,
    "metrics/step_ms.toy.py": TOY_METRIC,
    "metrics/host_ms.toy.py": TOY_SPAN_METRIC,
    "configs/toy_vgg.json": json.dumps({"name": "toy_vgg", "cli": {"compute_dtype": "float32"}, "peak": "float32",
                                        "input_px": 32}),
    "traffic/toy_b2.json": json.dumps({"kind": "toy_vgg", "batch": 2, "height": 32, "width": 32, "pan_px": [1, 3],
                                       "pool": 2, "profile_steps": 2}),
    "limits/toy_vgg_b2.json": json.dumps({"feat_rel": 1e-4}),
}


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(p for p in BENCH.rglob("*") if p.is_file() and "__pycache__" not in p.parts):
        h.update(str(path.relative_to(BENCH)).encode() + path.read_bytes())
    return h.hexdigest()


@pytest.fixture
def toy(tmp_path):
    """A copy of the layout holding the toy alone (and the chip's peaks)."""
    bench = tmp_path / BENCH.name
    for rel, text in FILES.items():
        (bench / rel).parent.mkdir(parents=True, exist_ok=True)
        (bench / rel).write_text(text)
    shutil.copy(BENCH / "peaks.json", bench / "peaks.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(MANIFEST))
    return Manifest(tmp_path)


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_kind_runs_with_new_files_only(toy, trace):
    before = _digest()
    out = run("toy_vgg_b2", SEED, 0.2, trace, device="cpu", manifest=toy)
    assert _digest() == before
    assert out["correct"] and out["attempted"] >= 2 and list(out["checks"]) == ["feat_rel"]
    want = {"step_ms.toy", "host_ms.toy"} if trace else {"images_per_s", "setup_s"}
    assert set(out["metrics"]) == want and all(m["value"] > 0 for m in out["metrics"].values())


def test_the_manifest_and_span_checks_hold_for_the_toy(toy):
    check_manifest(toy)
    check_every_span_metric_is_found(toy)
    assert span_metrics(toy) == ["host_ms.toy"]
    for name in span_metrics(toy):
        check_span_metric(toy, name)


def test_a_fault_in_the_new_kind_is_caught(toy, monkeypatch):
    from master_thesis_tpu_torch.models import vgg

    real = vgg.VGGFeatures.forward

    def altered(self, x, normalize_input=True):
        feats = real(self, x, normalize_input)
        feats[0] = feats[0].clone()
        feats[0][0, :2, :2] += 0.25  # an answer altered where it is produced
        return feats
    monkeypatch.setattr(vgg.VGGFeatures, "forward", altered)
    out = run("toy_vgg_b2", SEED, 0.2, False, device="cpu", manifest=toy)
    assert not out["correct"] and out["checks"]["feat_rel"]["value"] > 1e-4


def test_a_kind_without_its_file_names_the_missing_path(toy):
    (toy.bench / "kinds" / "toy_vgg.py").unlink()
    with pytest.raises(FileNotFoundError, match=r"kinds/toy_vgg\.py"):
        run("toy_vgg_b2", SEED, 0.2, False, device="cpu", manifest=toy)
