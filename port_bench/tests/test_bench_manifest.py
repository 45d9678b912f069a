"""BENCHMARK.json against its schema and limits, and each of its names
against the file it leads to."""

import json
import re

import pytest

from port_bench.benchlib.manifest import BENCH, ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = Manifest()
DATA = MAN.data


def test_top_level_keys_and_size():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert DATA["paths"] == ["port_bench"] and DATA["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= DATA["run_seconds"] <= 51


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (DATA["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", DATA["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    assert NAME.match(entry["name"]) and entry["file"].startswith("port_bench/")
    cfg = MAN.config(entry["name"])
    assert cfg["name"] == entry["name"] and entry["reduced"] == []
    assert cfg["peak"] in MAN.peaks()
    assert any(w["config"] == entry["name"] for w in DATA["workloads"])
    for text in (entry["why"], entry["source"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("entry", DATA["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
    assert 1 <= len(entry["why"]) <= 200
    traffic = MAN.traffic(entry["traffic"])
    assert traffic["kind"] in ("serve", "chn_train")
    limits = MAN.limits(entry["name"])
    assert limits and all(v >= 0 for v in limits.values())
    e2e = {m["name"] for m in MAN.end_to_end(entry["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2 and MAN.per_layer(entry["name"])


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in DATA["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("metric", DATA["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["source"] in ("host_clock", "device_trace") and metric["better"] in ("lower", "higher")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", DATA["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_resolves_to_its_reader(metric):
    reader = MAN.reader(metric["name"])
    assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.SOURCE) == (
        metric["layer"], metric["unit"], metric["moves"], metric["source"])
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and callable(reader.read)
    for w in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in MAN.end_to_end(w)}
    if metric["name"].split(".")[0].endswith("_roofline"):
        assert metric["unit"] == "%" and reader.KERNELS and reader.COUNTERS


def test_every_file_of_the_benchmark_is_named_from_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path


def test_benchmark_json_is_the_canonical_form():
    assert json.loads((ROOT / "BENCHMARK.json").read_text()) == DATA
