"""Tests of the benchmark harness, on the CPU at small sizes.

Run from the repository root: ``python -m pytest benchmark/tests -q``.
Tests marked ``card`` need a CUDA device and skip here; on the machine
with the card the same command runs them."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import env  # noqa: E402

env.prepare(ROOT)

from benchmark.harness import spec  # noqa: E402

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]

#: rows of the tables the tests fit on
FIT_ROWS = 6000


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped without one")


def shrink(cell):
    """``cell`` cut to a test's size: 3 rounds a fit."""
    cell = copy.deepcopy(cell)
    cell.config["estimator"]["num_base_learners"] = 3
    return cell


@pytest.fixture
def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def need_no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a CUDA device")
