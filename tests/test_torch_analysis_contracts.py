"""The port's program contracts (tier 2 of ``spark_ensemble_tpu_torch.
analysis``) traced on the CPU: no intrinsic violation, the fresh budgets
equal to the committed ``analysis/contracts.json``, drift caught, the f64
watch, and every budget both packages count equal to the JAX package's
committed value except the departures named below."""

import copy

import pytest
import torch

from spark_ensemble_tpu.analysis import contracts as jax_contracts
from spark_ensemble_tpu_torch.analysis import contracts as contracts_mod
from spark_ensemble_tpu_torch.models.base import observe_program_calls, program_call
from spark_ensemble_tpu_torch.utils import random as rnd

#: JAX budget -> (the JAX package's value, the port's, why they differ)
DEPARTURES = {
    "gbm_regressor.fit": (3, 1, "the per-round keys, bag weights and masks are drawn "
                          "eagerly (models/gbm.py::_sampling_plan), not as the JAX "
                          "package's gbm_sampling_plan and gbm_bag_many programs; the "
                          "one program is the round chunk"),
    "gbm_classifier.fit": (3, 1, "as gbm_regressor.fit"),
    "bagging_regressor.fit": (2, 1, "the member plan is drawn eagerly "
                              "(models/bagging.py::_member_plan), not as the "
                              "bagging_member_plan program; the one program is the "
                              "forest fit"),
    "bagging_classifier.fit": (2, 1, "as bagging_regressor.fit"),
    "gbm_regressor.fit_sweep": (3, 1, "the sweep's plans are drawn eagerly; the one "
                                "program is the swept round, gbm_reg_sweep"),
    "gbm_regressor.fit_sampled": (3, 1, "the sampling plans are drawn eagerly; the "
                                  "compacted bucket's gathered rows run inside the "
                                  "round chunk"),
    "gbm_regressor.fit_streaming": (13, 1, "the shard sweep (data/streaming._ShardTrees "
                                    "over ops/tree.stream_forest) runs inside the round "
                                    "chunk; the JAX package dispatches each level's "
                                    "accumulation, split and route as programs"),
    "gbm_classifier.fit_streaming": (13, 1, "as gbm_regressor.fit_streaming"),
    "gbm_regressor.fit_streaming_dist": (20, 5, "the round chunk and one elastic step "
                                         "program a level (parallel/elastic.py); the "
                                         "JAX package's per-level accumulation, "
                                         "reduce, split and route programs"),
}

#: the port's own budgets (ROADMAP item 28), with the values the tests pin
PORT_ONLY = {
    "kernels.gbm_classifier.fused_round.hist_packed": 5,
    "kernels.gbm_classifier.fused_round.route_packed": 4,
    "kernels.gbm_classifier.fused_round.leaf_sums": 1,
    "kernels.gbm_classifier.pallas_round.hist_i32": 5,
    "kernels.boosting_regressor.fused_round.hist_packed": 5,
    "kernels.boosting_regressor.fused_round.route_packed": 4,
    "kernels.boosting_regressor.fused_round.leaf_sums": 1,
    "kernels.bagging_regressor.fused_fit.hist_packed": 5,
    "kernels.bagging_regressor.fused_fit.route_packed": 4,
    "kernels.bagging_regressor.fused_fit.leaf_sums": 1,
    "kernels.bagging_regressor.pallas_fit.hist_i32": 5,
    "host_reads.gbm_classifier.fused_round": 0,
}

#: budgets measured only on the card, or only on spawned ranks
CARD_ONLY = {"builds.gbm_classifier.fused_fit", "host_syncs.gbm_classifier.fused_round"}
SPAWNED = {"gbm_regressor.fit_streaming_dist"}


@pytest.fixture(scope="module")
def traced():
    return contracts_mod.trace_contracts(device="cpu")


def test_intrinsic_contracts_hold(traced):
    assert traced.ok, [v.to_record() for v in traced.violations]


def test_committed_baseline_matches_fresh_trace(traced):
    committed = contracts_mod.load_baseline()
    assert committed["version"] == 1
    pinned = committed["entry_points"]
    assert {k: pinned.get(k) for k in traced.budgets} == traced.budgets
    # what this trace cannot measure is pinned from the card or the ranks
    assert set(pinned) - set(traced.budgets) == CARD_ONLY | SPAWNED
    assert CARD_ONLY | SPAWNED <= set(traced.skipped)
    assert "serving.donation" in traced.skipped


def test_committed_baseline_is_sorted_and_timestamp_free():
    with open(contracts_mod._BASELINE_PATH) as f:
        text = f.read()
    base = contracts_mod.load_baseline()
    assert list(base["entry_points"]) == sorted(base["entry_points"])
    assert set(base) == {"version", "entry_points"}
    assert all(isinstance(v, int) and v >= 0 for v in base["entry_points"].values())
    assert text.endswith("}\n")


def test_check_contracts_clean_against_committed(traced):
    report = copy.deepcopy(traced)
    assert contracts_mod.check_contracts(report=report).ok


def test_corrupted_baseline_fails_then_committed_fixes(traced):
    committed = contracts_mod.load_baseline()
    bad = copy.deepcopy(committed)
    bad["entry_points"]["kernels.gbm_classifier.fused_round.hist_packed"] = 4
    bad["entry_points"]["serving.warmup"] = 99
    out = contracts_mod.check_contracts(baseline=bad, report=copy.deepcopy(traced))
    assert sorted(v.entry_point for v in out.violations) == [
        "kernels.gbm_classifier.fused_round.hist_packed", "serving.warmup"]
    assert all(v.contract == "budget" and "--update-baseline" in v.message
               for v in out.violations)
    assert contracts_mod.check_contracts(baseline=committed,
                                         report=copy.deepcopy(traced)).ok


def test_unpinned_entry_point_is_a_violation():
    rep = contracts_mod.ContractReport(budgets={"new_family.fit": 1})
    out = contracts_mod.check_contracts(baseline={"version": 1, "entry_points": {}}, report=rep)
    assert not out.ok
    assert "--update-baseline" in out.violations[0].message


def test_missing_baseline_is_a_violation(tmp_path, monkeypatch):
    monkeypatch.setattr(contracts_mod, "_BASELINE_PATH", str(tmp_path / "absent.json"))
    rep = contracts_mod.ContractReport(budgets={"gbm_regressor.fit": 1})
    out = contracts_mod.check_contracts(report=rep)
    assert [v.entry_point for v in out.violations] == ["*"]
    assert "--update-baseline" in out.violations[0].message


def test_violation_record_shape():
    v = contracts_mod.ContractViolation("budget", "gbm_regressor.fit", "msg")
    assert v.to_record() == {
        "event": "contract_violation", "contract": "budget",
        "entry_point": "gbm_regressor.fit", "message": "msg",
    }
    jv = jax_contracts.ContractViolation("budget", "gbm_regressor.fit", "msg")
    assert v.to_record() == jv.to_record()


def test_update_baseline_keeps_the_pins_it_cannot_measure(traced, tmp_path, monkeypatch):
    path = tmp_path / "contracts.json"
    path.write_text(open(contracts_mod._BASELINE_PATH).read())
    monkeypatch.setattr(contracts_mod, "trace_contracts",
                        lambda **kw: copy.deepcopy(traced))
    base = contracts_mod.update_baseline(path=str(path), device="cpu", spawn_ranks=False)
    assert base == contracts_mod.load_baseline()
    assert path.read_text() == open(contracts_mod._BASELINE_PATH).read()


# ---------------------------------------------------------------------------
# against the JAX package's committed budgets
# ---------------------------------------------------------------------------

JAX_BUDGETS = jax_contracts.load_baseline()["entry_points"]


def test_the_port_counts_every_jax_budget():
    port = contracts_mod.load_baseline()["entry_points"]
    assert set(JAX_BUDGETS) <= set(port)
    assert set(DEPARTURES) <= set(JAX_BUDGETS)
    assert set(port) - set(JAX_BUDGETS) == set(PORT_ONLY) | CARD_ONLY


@pytest.mark.parametrize("entry", sorted(JAX_BUDGETS))
def test_budget_equals_the_jax_package(traced, entry):
    port = traced.budgets.get(entry, contracts_mod.load_baseline()["entry_points"][entry])
    if entry in DEPARTURES:
        jax_value, port_value, why = DEPARTURES[entry]
        assert (JAX_BUDGETS[entry], port) == (jax_value, port_value), why
    else:
        assert port == JAX_BUDGETS[entry]


@pytest.mark.parametrize("entry", sorted(PORT_ONLY))
def test_port_only_budget(traced, entry):
    assert traced.budgets[entry] == PORT_ONLY[entry]


def test_card_only_budgets_are_pinned():
    pinned = contracts_mod.load_baseline()["entry_points"]
    assert pinned["builds.gbm_classifier.fused_fit"] == 0
    assert pinned["host_syncs.gbm_classifier.fused_round"] > 0


# ---------------------------------------------------------------------------
# the f64 watch
# ---------------------------------------------------------------------------


def _watched(fn, tag="gbm_reg_round"):
    report = contracts_mod.ContractReport()
    with observe_program_calls(lambda t, s: None):
        with contracts_mod._F64Watch("probe.fit", report):
            with program_call(tag, torch.zeros(2)):
                fn()
    return report


def test_f64_watch_flags_a_wide_tensor_in_a_round():
    report = _watched(lambda: torch.zeros(3).double())
    assert [v.contract for v in report.violations] == ["f64"]
    assert "gbm_reg_round" in report.violations[0].message


def test_f64_watch_ignores_programs_outside_the_round_loop():
    assert _watched(lambda: torch.zeros(3).double(), tag="predict:predict").ok


def test_f64_watch_allows_the_emulation_sites():
    key = rnd.PRNGKey(0)
    # uniform's fused multiply-add emulation takes float64 inside a round
    report = _watched(lambda: rnd.uniform(key, (4,), minval=-1.0, maxval=2.0))
    assert report.ok
    assert ("utils/random.py", "uniform") in contracts_mod.F64_EMULATION_SITES


def test_a_sweep_of_one_candidate_a_call_is_a_megabatch_violation(monkeypatch):
    """Slabs of one lane keep one swept-round program at 16 and at 32
    candidates, so only the count of calls a round catches them."""
    from spark_ensemble_tpu_torch.models import gbm_sweep

    tuned = gbm_sweep._tuned

    def one_lane(name, default, **kw):
        return 1 if name == "configs_per_dispatch" else tuned(name, default, **kw)

    monkeypatch.setattr(gbm_sweep, "_tuned", one_lane)
    report = contracts_mod.ContractReport()
    contracts_mod._trace_megabatch(report, "cpu")
    assert report.budgets["gbm_regressor.fit_sweep"] == 1
    assert [v.contract for v in report.violations] == ["megabatch", "megabatch"]
    assert "48 swept-round calls at 16 candidates, 3 expected" in report.violations[0].message


def test_the_report_keeps_the_host_reads_counts(traced):
    """The 2- and 4-round fits' counts stay on the report, split at the
    step search; their difference over 2 is the pinned budget."""
    counts = traced.host_calls
    assert sorted(counts) == [2, 4]
    key = "aten::_local_scalar_dense"
    assert (counts[4].get(key, 0) - counts[2].get(key, 0)) // 2 == traced.budgets[
        "host_reads.gbm_classifier.fused_round"]
    assert counts[4].get(key + ":step_search", 0) > counts[2].get(key + ":step_search", 0)
