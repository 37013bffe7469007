"""BENCHMARK.json against the contract's limits, and every file a name in it
points to."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH_JSON = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH_JSON) == KEYS
    assert BENCH_JSON["command"] == ["python3", "benchmark/run.py"]
    assert BENCH_JSON["paths"] == ["benchmark"]
    assert 1 <= BENCH_JSON["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    entries = BENCH_JSON[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_configs_and_cells_point_at_their_files():
    for c in BENCH_JSON["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        # the size the benchmark's own tests run the configuration at
        assert set(cfg["small"]) == {"grid", "output_interval"}, c["name"]
        assert cfg["small"]["output_interval"] > 0
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    configs = {c["name"] for c in BENCH_JSON["configs"]}
    pairs = set()
    for w in BENCH_JSON["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        cell = harness.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert w["config"] in configs and w["chips"] == 1
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH_JSON["workloads"])
    assert configs == {w["config"] for w in BENCH_JSON["workloads"]}


def test_metrics():
    e2e = {m["name"] for m in BENCH_JSON["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in BENCH_JSON["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH_JSON["workloads"]}
    for m in BENCH_JSON["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.metric_reader(m["name"]))
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in BENCH_JSON["per_layer"])
