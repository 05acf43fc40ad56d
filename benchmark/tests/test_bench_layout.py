"""The harness finds every configuration, cell, traffic kind and metric
reader by the names in BENCHMARK.json, and the file keeps to the rules the
benchmark's checker applies before any run."""

import json
import re

import pytest

from benchmark import core

SPEC = core.Benchmark().spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", sorted(core.Benchmark().cells))
def test_cell_files_found_by_name(cell):
    b = core.Benchmark()
    entry = b.cell(cell)
    assert NAME.match(cell) and entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    cfg, wl = b.config(cell), b.workload(cell)
    assert wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    assert cfg["name"] == entry["config"]
    mod = b.traffic(wl["traffic"])
    assert all(callable(getattr(mod, f, None)) for f in ("setup", "window", "check"))
    assert wl["limits"] and all(v >= 0 for v in wl["limits"].values())
    e2e = [m["name"] for m in b.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert b.per_layer(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    m = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    assert callable(core.Benchmark().reader(metric).read)
    assert NAME.match(metric) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for cell in m["workloads"]:
        assert m["moves"] in [e["name"] for e in core.Benchmark().end_to_end(cell)]


def test_end_to_end_bounds_and_configs():
    for m in SPEC["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used and c["file"].startswith("benchmark/")
        assert core.load_json(core.ROOT / c["file"])["reduced"] == c["reduced"] == []


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        core.Benchmark().cell("no-such.cell")
