"""``BENCHMARK.json`` against the contract's shape, and every name it
gives resolving to its files."""

import json
import re

import pytest

from benchmark.harness import spec

SPEC = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for entry in SPEC[group]:
            assert set(entry) == keys
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
            assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


def test_configs_resolve_and_state_their_cuts():
    for c in SPEC["configs"]:
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert c["file"].startswith("benchmark/configs/")
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    assert (spec.BENCH_DIR / "drivers" / f"{cell.driver}.py").exists()
    drv = spec.driver_module(cell.driver)
    for fn in ("setup", "window", "check", "layer_context"):
        assert callable(getattr(drv, fn))
    assert cell.limits, "a cell's check compares at least one number"
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e, "a per-layer metric's cells report what it moves"


def test_per_layer_layers_and_workloads():
    cells = set(CELLS)
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
