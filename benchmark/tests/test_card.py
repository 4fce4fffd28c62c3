"""Checks that need the card: each cell's command end to end at a short
window, the refusal in a directory that holds only the benchmark, and the
control on the card at a test's size.  They skip without a CUDA device;
on the machine with the card: ``python -m pytest benchmark/tests -q``."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import control
from benchmark.harness import spec
from benchmark.harness.cell import judge
from conftest import CELLS, FIT_ROWS, ROOT, shrink
KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"}


def _run(cwd, name, trace):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                           str(2**31 + 99), "--seconds", "3", "--trace", str(trace)],
                          cwd=cwd, capture_output=True, text=True, timeout=1200)


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_command_on_the_card(need_card, name, trace):
    import torch

    p = _run(ROOT, name, trace)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert set(line) <= KEYS and line["correct"], line.get("checks")
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.card
def test_no_result_without_the_program(need_card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, CELLS[0], 0)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(need_card, name):
    cell = shrink(spec.load_cell(name))
    drv = spec.driver_module(cell.driver)
    import torch

    numbers = control.fit_reading(drv, cell, 2**31 + 5, "control", torch.device("cuda"), FIT_ROWS)
    assert not judge(numbers, cell.limits), numbers
