"""The port's elastic shard sweep (``parallel/elastic.py``:
``fit_streaming(mesh=...)``, ``DistributedSweep``, ``ElasticCoordinator``),
case for case with tests/test_elastic.py.

One module-scoped spawn runs ``_torch_mesh_worker.run_elastic`` on 4 gloo
ranks on the CPU; each rank writes its results, and the tests read them.
Tolerances:
- ``reduce="ordered"`` vs the port's single-process ``fit_streaming``, at
  W = 2, 3 (ragged: 10 shards over 3 positions) and 4 and on the 2x2
  hybrid mesh, and vs the resident ``hist="stream"`` fit at matched chunk
  rows: EQUAL (params digests).  The fold adds the shards in the global
  order of the single-process sweep.
- ``reduce="psum"``: within rtol 1e-4, atol 1e-5 (one all_reduce a step).
- A preempted, repartitioned and resumed fit, and a fit under the measure
  mode (``SE_TPU_DIST_MEASURE=1``): EQUAL to the uninterrupted one.
- The port's 4-rank fit vs the JAX package's single-device
  ``fit_streaming`` on the same store: tests/test_torch_streaming.py's
  cross-package tolerances (round 0's splits equal on the dyadic fixture,
  leaves within 1e-6; three rounds' leaves within rtol 1e-5, predictions
  within 1e-5 of the label scale).
"""

import json
import os

import numpy as np
import pytest

import _torch_mesh_worker as mw
import spark_ensemble_tpu as se
from spark_ensemble_tpu.data import ShardStore as JaxShardStore
from spark_ensemble_tpu.parallel import elastic as jelastic
from spark_ensemble_tpu_torch.parallel import elastic

SPLITS = ("split_feature", "split_bin", "split_threshold")
RANKS = range(mw.W)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic")
    try:
        mw.free_port()
    except OSError as e:  # the sandbox forbids loopback sockets
        pytest.skip(f"no loopback sockets: {e}")
    mw.spawn("elastic", str(out), timeout=300)

    def load(case, rank=0):
        return dict(np.load(os.path.join(out, f"{case}_r{rank}.npz")))

    load.dir = str(out)
    return load


# -- single process: the module's pure parts -----------------------------


def test_flow_ids_and_site_rounds_match_the_jax_package():
    for victim, site in ((1, mw.PREEMPT_SITE), (0, "x"), (3, "a:stream_round:17:leaf")):
        assert elastic.preempt_flow_id(victim, site) == jelastic.preempt_flow_id(victim, site)
        assert elastic._site_round(site) == jelastic._site_round(site)
    assert elastic.REDUCE_MODES == jelastic.REDUCE_MODES


def test_rewind_flow_is_consumed_once():
    elastic._PENDING_REWIND_FLOW[:] = [7]
    assert elastic.consume_rewind_flow() == 7
    assert elastic.consume_rewind_flow() == 0


def test_host_lost_error_and_coordinator_arguments():
    e = elastic.HostLostError(2, "s")
    assert (e.victim, e.site) == (2, "s") and "ElasticCoordinator" in str(e)
    with pytest.raises(ValueError, match="reduce"):
        elastic.ElasticCoordinator(None, reduce="mean")


# -- the distributed sweep ------------------------------------------------


@pytest.mark.parametrize("rank", RANKS)
def test_ordered_is_bit_identical_at_every_width(runs, rank):
    """W=4, the 2x2 hybrid mesh, W=2 (each half of the ranks) and the
    ragged W=3 (rank 1 sits out) all land on the single-process bits."""
    r = runs("ordered", rank)
    widths = ["w4", "hybrid", "w2"] + (["w3"] if rank != 1 else [])
    for key in widths:
        assert str(r[key]) == str(r["single"]), key
    assert str(r["cls_w2"]) == str(r["cls_single"])
    assert str(r["single"]) == str(runs("ordered", 0)["single"])


def test_ordered_equals_the_resident_stream_fit(runs):
    for rank in RANKS:
        r = runs("ordered", rank)
        assert str(r["dist64"]) == str(r["resident64"])


def test_psum_is_allclose(runs):
    r = runs("ordered")
    np.testing.assert_allclose(r["psum_pred"], r["single_pred"], rtol=1e-4, atol=1e-5)


def test_mean_reduce_and_member_axis_raise(runs):
    for rank in RANKS:
        errs = runs("ordered", rank)["errors"]
        assert "reduce" in str(errs[0])
        assert "member=1" in str(errs[1])


def test_measure_mode_times_the_reduces_and_keeps_the_bits(runs):
    """``SE_TPU_DIST_MEASURE=1`` fences every per-step reduce and sums its
    wall time; off, nothing is timed.  The measured fit reads a
    manifest-only handle (``shards=[]``), so each rank opens and verifies
    just its own shards, and it lands on the single-process bits."""
    for rank in RANKS:
        r = runs("ordered", rank)
        assert str(r["measured"]) == str(r["single"])
        reduce_s, sweep_s, steps, plain_reduce_s, plain_steps = r["stats"].tolist()
        assert 0 < reduce_s <= sweep_s
        # 4 rounds x (3 levels + the leaf pass) x 3 steps (10 shards over 4)
        assert steps == plain_steps == 4 * 4 * 3
        assert plain_reduce_s == 0.0


def test_config_agreement_and_sweep_events(runs):
    r = runs("ordered")
    events = set(r["events"].tolist())
    assert {"dist_config", "dist_manifest_agreed", "dist_sweep"} <= events
    # 2 positions over 10 shards: 5 steps a sweep
    assert r["config"].tolist() == [2, 10, 5]


def test_collectives_a_sweep_do_not_depend_on_shards_or_width(runs):
    """The counterpart of the JAX package's fixed program count: every fit
    issues one gather a sweep step, one node-id gather a tree and one
    manifest agreement, of the same four kinds whatever the shard count
    (10 or 10 of half the rows) and the width (2 or 4)."""
    r = runs("ordered")
    kinds = {tuple(r[k].tolist()) for k in r if k.startswith("kinds_")}
    assert len(kinds) == 1 and len(next(iter(kinds))) == 4
    for k in (k for k in r if k.startswith("calls_")):
        got, expected = r[k].tolist()
        assert got == expected, k


# -- preemption, repartition, rewind, resume ------------------------------


def test_preempt_then_resume_is_bit_identical(runs):
    victim = runs("elastic_resume", 1)
    assert bool(victim["victim"]) and victim["fired"].tolist() == [mw.PREEMPT_SITE]
    for rank in (0, 2, 3):
        r = runs("elastic_resume", rank)
        assert not bool(r["victim"])
        assert str(r["digest"]) == str(r["single"])
        assert json.loads(str(r["losses"])) == [[1, mw.PREEMPT_SITE, 3]]
        assert int(r["width"]) == 3 and r["mesh_ranks"].tolist() == [0, 2, 3]


def test_statusz_counts_the_attempts(runs):
    for rank in (0, 2, 3):
        r = runs("elastic_resume", rank)
        sz = json.loads(str(r["statusz"]))
        assert sz["attempts"] == 2 and sz["width"] == 3 and sz["process_count"] == 4
        assert sz["losses"] == [{"victim": 1, "site": mw.PREEMPT_SITE, "width": 3}]
        assert int(r["mid_attempts"]) == 1 and bool(r["unregistered"])
        assert int(r["last_fit_steps"]) > 0


def test_preempt_events_flows_and_flight_dump(runs):
    """The victim's stream carries the ``host_preempt`` span's flow_out and
    every survivor's the matching ``rewind`` flow_in, the
    ``host_preempted`` event and the ``resume_from_checkpoint`` of the
    rewind; every rank's flight recorder is on disk."""
    fid = int(runs("elastic_resume")["fid"])
    for rank in RANKS:
        assert bool(runs("elastic_resume", rank)["flight"]), rank
        tel = os.path.join(runs.dir, f"tel_r{rank}")
        with open(os.path.join(tel, "t.jsonl")) as f:
            events = [json.loads(line) for line in f]
        kinds = [e["event"] for e in events]
        spans = {e["name"]: e for e in events if e["event"] == "span"}
        assert "host_preempted" in kinds
        if rank == 1:
            assert spans["host_preempt"]["flow_out"] == [fid]
            assert "rewind" not in spans
        else:
            assert spans["rewind"]["flow_in"] == fid
            assert "resume_from_checkpoint" in kinds
        dumps = [f for f in os.listdir(tel) if f.startswith("flight_p")]
        with open(os.path.join(tel, dumps[0])) as f:
            payload = json.load(f)
        assert payload["rows"]
        assert any(row.get("event") == "host_preempted" for row in payload["rows"])


def test_max_losses_is_respected(runs):
    for rank in RANKS:
        r = runs("max_losses", rank)
        want = "ChaosHostPreemption" if rank == 1 else "HostLostError"
        assert str(r["raised"]) == want
        assert int(r["losses"]) == 0 and int(r["attempts"]) == 1


def test_losing_the_store_host_raises_at_once(runs):
    """Rank 0 hosts the rendezvous store: its loss ends the fit with a clear
    error on every survivor, well inside the group's 120 s timeout."""
    assert str(runs("store_host", 0)["raised"]) == "victim"
    for rank in (1, 2, 3):
        r = runs("store_host", rank)
        assert "rendezvous store" in str(r["raised"])
        assert float(r["seconds"]) < 30.0


# -- against the JAX package ----------------------------------------------


def test_distributed_fit_matches_the_jax_package(runs):
    """The port's 4-rank fit (3 shards over 4 positions) against the JAX
    package's single-device ``fit_streaming`` over the same store."""
    Xm, ym = mw.mirrored_data()
    store = JaxShardStore.open(os.path.join(runs.dir, "m64"))
    mk = lambda r: se.GBMRegressor(base_learner=mw.stream_base(se), num_base_learners=r,
                                   **mw.XPKG_KW)
    one_j = mk(1).fit_streaming(store, ym).params["members"]
    three_j = mk(3).fit_streaming(store, ym)
    for rank in RANKS:
        r = runs("ordered", rank)
        for f in SPLITS:
            np.testing.assert_array_equal(r[f"xpkg1_{f}"], np.asarray(getattr(one_j, f)),
                                          err_msg=f)
        np.testing.assert_allclose(r["xpkg1_leaf_value"], np.asarray(one_j.leaf_value),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["xpkg3_leaf_value"],
                                   np.asarray(three_j.params["members"].leaf_value),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["xpkg3_predict"], np.asarray(three_j.predict(Xm)),
                                   rtol=0, atol=1e-5 * float(np.abs(ym).max()))
