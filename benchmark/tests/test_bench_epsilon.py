"""The Epsilon-shaped cell (``epsilon.fit``, config ``epsilon-bin-d8``:
2,000 features, 500 packed words a row) resolves by name and runs end to
end on the CPU at a few hundred rows, judged by the reference under its
own limits."""

from benchmark.harness import spec
from benchmark.harness.cell import run_cell
from conftest import shrink

SEED = 2**33 + 4321
ROWS = 700


def test_the_cell_resolves():
    cell = spec.load_cell("epsilon.fit")
    assert cell.config["data"]["numeric_features"] == 2000
    assert cell.config["base_learner"]["hist"] == "fused"
    assert cell.driver == "fit" and cell.chips == 1
    assert "fit_rounds_per_s" in {m["name"] for m in cell.end_to_end}
    assert set(cell.limits) == set(spec.load_cell("higgs.fit").limits)


def test_a_cpu_run_is_correct_and_reports_its_rate():
    out = run_cell(shrink(spec.load_cell("epsilon.fit")), SEED, 0.1, False, "cpu", rows=ROWS)
    assert out["correct"], out["checks"]
    assert out["metrics"]["fit_rounds_per_s"]["value"] > 0


def test_a_traced_cpu_run_reports_what_the_cpu_can_read():
    """The launch and sync counts read the host's side of the profiler;
    the rooflines, idle share and memory peak need the card's events."""
    cell = shrink(spec.load_cell("epsilon.fit"))
    out = run_cell(cell, SEED, 0.1, True, "cpu", rows=ROWS)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"fit.launches_per_round", "fit.syncs_per_round"} <= set(out["metrics"])
