"""BENCHMARK.json against its schema and limits, and each of its names
against the file it leads to. Each check takes the manifest it checks, so
that a copy of the layout (``test_bench_kinds.py``'s toy) is held to the
same ones: :func:`check_manifest` runs them all."""

import json
import re

import pytest

from port_bench.benchlib.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# A width may not be cut: a key that names one.
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state_size|proj|head_size|width|expansion|per_tok")
MAN = Manifest()
DATA = MAN.data


def _keys(obj) -> set:
    """Every key of a JSON object, at any depth."""
    if isinstance(obj, dict):
        return set(obj) | set().union(*(_keys(v) for v in obj.values()))
    if isinstance(obj, list):
        return set().union(*(_keys(v) for v in obj))
    return set()


def check_top_level(man):
    data = man.data
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (man.root / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert data["paths"] == ["port_bench"] and data["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= data["run_seconds"] <= 51


def check_config(man, entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith("port_bench/")
    cfg = man.config(entry["name"])
    assert cfg["name"] == entry["name"]
    reduced = entry["reduced"]
    assert isinstance(reduced, list) and len(reduced) <= 16 and len(set(reduced)) == len(reduced)
    for key in reduced:
        assert NAME.match(key) and key in _keys(cfg) and not WIDTH.search(key), key
    assert cfg["peak"] in man.peaks()
    assert any(w["config"] == entry["name"] for w in man.data["workloads"])
    for text in (entry["why"], entry["source"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def check_workload(man, entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200
    limits = man.limits(entry["name"])
    assert limits and all(v >= 0 for v in limits.values())
    e2e = {m["name"] for m in man.end_to_end(entry["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2 and man.per_layer(entry["name"])


def check_kind(man, entry):
    kind = man.kind(man.traffic(entry["traffic"])["kind"])
    for hook in ("batch", "build", "reseed", "before", "window", "end_to_end", "numbers"):
        assert callable(getattr(kind, hook)), hook


def check_unique(man):
    data = man.data
    pairs = [(w["config"], w["traffic"]) for w in data["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(set(names)) == len(names)


def check_end_to_end(man, metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["source"] in ("host_clock", "device_trace") and metric["better"] in ("lower", "higher")
    assert 0.01 <= metric["bound"] <= 0.25


def check_per_layer(man, metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    reader = man.reader(metric["name"])
    assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.SOURCE) == (
        metric["layer"], metric["unit"], metric["moves"], metric["source"])
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and callable(reader.read)
    cells = metric.get("workloads", [w["name"] for w in man.data["workloads"]])
    assert any(metric["name"] in {m["name"] for m in man.per_layer(w)} for w in cells)
    for w in metric.get("workloads", []):
        assert metric["moves"] in {m["name"] for m in man.end_to_end(w)}
    if metric["name"].split(".")[0].endswith("_roofline"):
        assert metric["unit"] == "%" and reader.KERNELS and reader.COUNTERS


def check_file_names(man):
    for path in man.bench.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(man.root))), path


def check_manifest(man):
    """Every check above, over every entry of ``man``."""
    check_top_level(man)
    check_unique(man)
    check_file_names(man)
    for entry in man.data["configs"]:
        check_config(man, entry)
    for entry in man.data["workloads"]:
        check_workload(man, entry)
        check_kind(man, entry)
    for metric in man.data["end_to_end"]:
        check_end_to_end(man, metric)
    for metric in man.data["per_layer"]:
        check_per_layer(man, metric)


def test_top_level_keys_and_size():
    check_top_level(MAN)


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", DATA["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    check_config(MAN, entry)


@pytest.mark.parametrize("entry", DATA["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(entry):
    check_workload(MAN, entry)


@pytest.mark.parametrize("entry", DATA["workloads"], ids=lambda w: w["name"])
def test_traffic_kind_resolves_to_a_kind_file(entry):
    check_kind(MAN, entry)


def test_pairs_and_names_are_unique():
    check_unique(MAN)


@pytest.mark.parametrize("metric", DATA["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    check_end_to_end(MAN, metric)


@pytest.mark.parametrize("metric", DATA["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_resolves_to_its_reader(metric):
    check_per_layer(MAN, metric)


def test_every_file_of_the_benchmark_is_named_from_name_characters():
    check_file_names(MAN)


def test_benchmark_json_is_the_canonical_form():
    assert json.loads((ROOT / "BENCHMARK.json").read_text()) == DATA
