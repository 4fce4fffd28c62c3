"""Every cell run end to end on the CPU at a small size, through the
kernels' plain versions, and judged by the reference; the result line's
keys; the planted faults and the control failing the check."""

import json
import subprocess
import sys

import pytest

from benchmark import control, faults
from benchmark.harness import spec
from benchmark.harness.cell import judge, result_line, run_cell
from conftest import CELLS, FIT_ROWS, ROOT, shrink

SEED = 2**31 + 12345
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


def _run(cell, trace=False):
    return run_cell(cell, SEED, 0.2, trace, "cpu", rows=FIT_ROWS)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_matches_the_reference(name, trace):
    cell = shrink(spec.load_cell(name))
    out = _run(cell, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(cell.limits)
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in out["metrics"].values())
    else:
        assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 1}
    line = json.loads(result_line(out, device))
    assert set(line) <= LINE_KEYS and list(line)[-1] == "checks"
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("fault", faults.FIT_FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_fails_the_check(name, fault):
    cell = shrink(spec.load_cell(name))
    with faults.planted(fault):
        out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_fails_the_check(name):
    cell = shrink(spec.load_cell(name))
    drv = spec.driver_module(cell.driver)
    numbers = control.fit_reading(drv, cell, SEED, "control", "cpu", FIT_ROWS)
    assert not judge(numbers, cell.limits), numbers


def test_faults_restore_the_program():
    from spark_ensemble_tpu_torch.models import gbm

    before = gbm._advance
    with faults.planted("unchanged"):
        assert gbm._advance is not before
    assert gbm._advance is before


def test_run_without_a_card_prints_no_result(need_no_card):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                        str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
