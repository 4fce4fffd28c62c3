"""The distributed streaming fit's contract on spawned gloo ranks (widths 2
and 4, two shard counts each): a fixed program count, equal to the
committed pin, reductions only over the mesh's own axes; and the port's
``graftlint_torch --contracts --device cpu`` exiting 0 against the
committed baseline."""

import os
import subprocess
import sys

import pytest

from spark_ensemble_tpu.analysis import contracts as jax_contracts
from spark_ensemble_tpu_torch.analysis import contracts as contracts_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY = "gbm_regressor.fit_streaming_dist"


@pytest.fixture(scope="module")
def dist_report():
    return contracts_mod.trace_contracts(["distributed"], device="cpu", spawn_ranks=True)


def test_distributed_trace_holds(dist_report):
    assert dist_report.ok, [v.to_record() for v in dist_report.violations]
    assert ENTRY not in dist_report.skipped


def test_distributed_budget_equals_committed(dist_report):
    assert dist_report.budgets == {ENTRY: contracts_mod.load_baseline()["entry_points"][ENTRY]}
    assert contracts_mod.check_contracts(report=dist_report, entry_points=["distributed"]).ok


def test_distributed_budget_against_the_jax_package(dist_report):
    # a departure named in test_torch_analysis_contracts.DEPARTURES: the JAX
    # package dispatches each level's accumulation, reduce, split and route
    assert (jax_contracts.load_baseline()["entry_points"][ENTRY],
            dist_report.budgets[ENTRY]) == (20, 5)


def test_skipped_without_spawned_ranks():
    rep = contracts_mod.ContractReport()
    contracts_mod._trace_streaming_dist(rep, "cpu", spawn_ranks=False)
    assert ENTRY in rep.skipped and not rep.budgets


def _rank(counts, axes=(("data",),), mesh_axes=("data", "member"), violations=()):
    return {"counts": counts, "axes": [list(a) for a in axes], "mesh_axes": list(mesh_axes),
            "violations": list(violations)}


def test_rank_checks_pass_a_well_formed_group():
    rep, counts = contracts_mod.ContractReport(), {}
    # rank 3 holds no shard at 2 shards: fewer programs is fine
    contracts_mod._check_ranks(rep, ENTRY, 4, [_rank({"2": 5, "4": 5})] * 3
                               + [_rank({"2": 1, "4": 5})], counts)
    assert rep.ok and counts == {(4, 2): 5, (4, 4): 5}


@pytest.mark.parametrize("bad", ["foreign_axis", "unblessed_axis", "more_programs", "rank_f64"])
def test_rank_checks_flag(bad):
    rep = contracts_mod.ContractReport()
    ranks = [_rank({"2": 5}), _rank({"2": 5})]
    if bad == "foreign_axis":
        ranks[1] = _rank({"2": 5}, axes=(("member",),), mesh_axes=("data",))
    elif bad == "unblessed_axis":
        ranks[1] = _rank({"2": 5}, axes=(("rows",),), mesh_axes=("rows",))
    elif bad == "more_programs":
        ranks[1] = _rank({"2": 6})
    else:
        ranks[1] = _rank({"2": 5}, violations=[{"contract": "f64", "entry_point": ENTRY,
                                                "message": "wide"}])
    contracts_mod._check_ranks(rep, ENTRY, 2, ranks, {})
    want = {"foreign_axis": "axis-name", "unblessed_axis": "axis-name",
            "more_programs": "distributed", "rank_f64": "f64"}[bad]
    assert [v.contract for v in rep.violations] == [want]


def test_tool_contracts_on_the_cpu_exit_zero():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "graftlint_torch.py"), "--contracts",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "0 violation(s)" in out.stdout
