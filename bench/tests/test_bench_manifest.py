"""BENCHMARK.json against the contract: names and units, the files each
cell names, the metrics each cell reports, and the check's time budget."""
import json
import re

import pytest

from bench import cell, counts
from bench.cell import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert MANIFEST["paths"] == ["bench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_text_fields(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    for key in entry.get("reduced", []):
        assert NAME.match(key)


@pytest.mark.parametrize("metric", METRICS, ids=lambda e: e["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in MANIFEST["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        assert set(metric) <= allowed | {"bound"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert set(metric) <= allowed | {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}


def test_names_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    spec = cell.load_spec(name)
    assert spec.workload["chips"] in (1, 4)
    assert (BENCH / "traffic" / f"{spec.workload['traffic']}.json").exists()
    assert (BENCH / "limits" / f"{name}.json").exists()
    for m in spec.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}
    assert len(spec.end_to_end) >= 2 and spec.per_layer


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda e: e["name"])
def test_per_layer_cells_report_what_they_move(metric):
    for name in metric.get("workloads", CELLS):
        spec = cell.load_spec(name)
        assert metric["moves"] in {m["name"] for m in spec.end_to_end}


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda e: e["name"])
def test_config_file(entry):
    path = ROOT / entry["file"]
    assert path.parent == BENCH / "configs"
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert counts.n_params(cfg) == cfg["params"]
    assert (BENCH / "models" / f"{cfg['model']}.py").exists()
    assert (BENCH / "ports" / f"{cfg['model']}.py").exists()


def test_every_config_used_and_four_chip_cells_rare():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_run_seconds_fits_a_full_check():
    s = MANIFEST["run_seconds"]
    assert 1 <= s <= 51 and s == int(s)
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
