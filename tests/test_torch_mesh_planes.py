"""The rest of the port's mesh planes: checkpoints and resumes under a
mesh (GBM and Boosting), Stacking, the tuners, ``Pipeline`` and the
megabatch sweep with ``mesh=`` (tests/test_distributed_fit.py:479-548 and
tests/test_tuning.py:262-300 in the JAX package).

One module-scoped spawn runs ``_torch_mesh_worker.run_planes`` on 4 gloo
ranks on the CPU.  Tolerances:
- A mesh fit preempted after a checkpoint and resumed: EQUAL to the
  uninterrupted mesh fit (the checkpoint holds the global padded carry and
  each rank takes its block back), on every rank.
- A single-device checkpoint whose validation padding differs starts the
  mesh fit fresh: EQUAL to a mesh fit without checkpoints.
- Stacking: each member fitted on one rank, every rank's model equal, and
  ``predict_proba`` within 2e-3 of the JAX package's single-device fit
  (the JAX package's own mesh-vs-single tolerance).
- The sharded sweep: every lane EQUAL to its lane of the unsharded sweep.
- CrossValidator, TrainValidationSplit and Pipeline over the mesh:
  accuracy above 0.7, as in the JAX package's test.
"""

import os

import numpy as np
import pytest

import _torch_mesh_worker as mw
import spark_ensemble_tpu as se

RANKS = range(mw.W)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_planes")
    try:
        mw.free_port()
    except OSError as e:  # the sandbox forbids loopback sockets
        pytest.skip(f"no loopback sockets: {e}")
    mw.spawn("planes", str(out), timeout=300)
    return lambda rank=0: dict(np.load(os.path.join(out, f"planes_r{rank}.npz")))


@pytest.mark.parametrize("case", ["gbm_cls", "gbm_reg_val", "samme"])
def test_preempted_mesh_fit_resumes_bit_identically(runs, case):
    """GBMClassifier over (data=2, member=2), a huber GBMRegressor with a
    validation split and SAMME Boosting over data=4: checkpoints every 2
    rounds, a preemption after round 4, then a refit that resumes at round
    4 (rank 0 streams the telemetry) and ends on the uninterrupted bits."""
    for rank in RANKS:
        r = runs(rank)
        assert bool(r[f"{case}_fired"]) and bool(r[f"{case}_equal"]), rank
        assert len(set(r[f"{case}_digests"].tolist())) == 1
    assert runs(0)[f"{case}_resumed_at"].tolist() == [4]


def test_stale_validation_padding_starts_fresh(runs):
    for rank in RANKS:
        r = runs(rank)
        assert bool(r["stale_equal"]) and int(r["stale_resumed"]) == 0
        assert r["stale_members"].tolist() == [6, 6]


def test_ranks_never_share_a_checkpoint_directory(runs):
    for rank in RANKS:
        shared, some = runs(rank)["dir_errors"].tolist()
        assert "each rank writes its own directory" in shared
        assert "set it on every rank or on none" in some


def test_stacking_members_fit_on_one_rank_each(runs):
    fits = [runs(rank)["stack_fits"].tolist() for rank in RANKS]
    assert fits == [["DecisionTreeClassifier"], ["LogisticRegression"],
                    ["GaussianNaiveBayes"], []]
    assert len({str(runs(rank)["stack_digest"]) for rank in RANKS}) == 1


@pytest.fixture(scope="module")
def jax_stacking():
    X, y = mw.stacking_data()
    return se.StackingClassifier(base_learners=mw.stacking_bases(se),
                                 stacker=se.LogisticRegression(reg_param=1e-2),
                                 stack_method="proba").fit(X, y).predict_proba(X)


@pytest.mark.parametrize("rank", RANKS)
def test_stacking_proba_is_close_to_the_single_device_fit(runs, jax_stacking, rank):
    np.testing.assert_allclose(runs(rank)["stack_proba"], np.asarray(jax_stacking),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("mesh", ["m42", "m4"])
def test_sharded_sweep_lanes_equal_the_unsharded_sweep(runs, mesh):
    """member=2 shards the 6 lanes 3 a rank; member=1 runs the sweep whole."""
    for rank in RANKS:
        assert runs(rank)[f"sweep_{mesh}_equal"].all(), rank


def test_cross_validator_pipeline_and_split_over_the_mesh(runs):
    for rank in RANKS:
        r = runs(rank)
        assert len(r["cv_avg"]) == 2 and r["cv_avg"].max() > 0.7
        assert r["tvs_metrics"].max() > 0.7
        assert float(r["pipe_accuracy"]) > 0.7
        # megabatch "on" shards the sweep over member=2: the same scores as
        # the sequential unmeshed search
        on, off = r["cv_on_off"]
        np.testing.assert_array_equal(on, off)
        for k in ("cv_digest", "pipe_digest"):
            assert str(r[k]) == str(runs(0)[k])
