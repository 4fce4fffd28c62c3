"""The port's program inventory (``telemetry/programz.py``), the program
calls of ``models/base.py`` and the kernel work of ``ops/hist_kernels.py``.

On the CPU every kernel wrapper runs its plain version and reports the same
``(kernel, signature, bytes, ops)`` the card's launch reports, so the rows
here are the rows a card run shows.  Fixtures are small (n <= 700, depth
<= 3).  Tolerances:
- ``kernel_work`` against counts written out by hand: EQUAL (integers).
- A fit with the inventory on against the same fit with it off: EQUAL
  params and predictions (the inventory only counts).
- The matmul tier's three-way join at "highest": ``xla_vs_analytic_flops_
  ratio`` is 1.0 within 1e-12, because the tier's one-hot products are the
  MACs ``round_cost_est`` counts (2 flops each, every level and the leaf
  pass).  At "high" the histogram subtraction computes only the left
  children of levels >= 1: the band found at depth 3 is [0.5, 1.0).  The
  JAX package's band on its CPU is [0.05, 2.0]
  (tests/test_operator_plane.py); its XLA counts are not the port's and
  are not compared.
- The fused tier's kernels do one add per statistic cell a row touches,
  far fewer than the one-hot MACs: the ratio is n_levels / (2 * B * ...)
  small, held here to (0, 0.1).
"""

import threading

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.telemetry import programz as jax_programz
from spark_ensemble_tpu_torch.models import base as mbase
from spark_ensemble_tpu_torch.models.base import program_call
from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor
from spark_ensemble_tpu_torch.ops import hist_kernels as hk
from spark_ensemble_tpu_torch.ops.binning import pack_bins, pack_width
from spark_ensemble_tpu_torch.serving import InferenceEngine
from spark_ensemble_tpu_torch.telemetry import programz, record_fits
from spark_ensemble_tpu_torch.telemetry.events import compile_snapshot

KERNELS = ("hist_i32", "hist_packed", "route_packed", "leaf_sums")


def _reg(n=400, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _cls(n=400, d=6, k=3, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(k, d).astype(np.float32).T, axis=1)
    return X, y.astype(np.float32)


def _tree(hist="fused", hp="highest", depth=3, bins=16):
    return DecisionTreeRegressor(max_depth=depth, max_bins=bins, hist=hist,
                                 hist_precision=hp)


@pytest.fixture()
def inventory():
    inv = programz.enable()
    inv.clear()
    try:
        yield inv
    finally:
        programz.disable()
        inv.clear()


def _kernel_calls(inv, kernel):
    return sum(r["calls"] for r in inv.kernel_rows(kernel))


# -- kernel_work ----------------------------------------------------------


@pytest.mark.parametrize("kernel,shapes,expect", [
    # bins n*d, node n*M, vals n*M*C in; H M*nodes*C*d*B out; n*M*C*d adds
    ("hist_i32", dict(n=15000, d=16, M=26, C=2, B=64, n_nodes=16),
     (4 * (15000 * 16 + 15000 * 26 + 15000 * 26 * 2 + 26 * 16 * 2 * 16 * 64),
      15000 * 26 * 2 * 16)),
    ("hist_packed", dict(n=15000, d=16, W=2, M=26, C=2, B=64, n_nodes=16),
     (4 * (15000 * 2 + 15000 * 26 + 15000 * 26 * 2 + 26 * 16 * 2 * 16 * 64),
      15000 * 26 * 2 * 16)),
    ("hist_packed", dict(n=7, d=3, W=1, M=1, C=3, B=16, n_nodes=1),
     (4 * (7 + 7 + 21 + 3 * 3 * 16), 7 * 3 * 3)),
    # words n*W, parents n*M in, children n*M out, two tables M*half
    ("route_packed", dict(n=15000, W=2, M=26, half=8),
     (4 * (15000 * 2 + 2 * 15000 * 26 + 2 * 26 * 8), 15000 * 26)),
    # routed: words, parents, leaf ids, vals, two tables, sums
    ("leaf_sums", dict(n=15000, M=26, C=2, leaves=32, W=2, half=16),
     (4 * (15000 * 2 + 2 * 15000 * 26 + 15000 * 26 * 2 + 2 * 26 * 16 + 26 * 32 * 2),
      15000 * 26 * 2)),
    # ids given: ids, vals in, sums out
    ("leaf_sums", dict(n=100, M=3, C=2, leaves=8),
     (4 * (300 + 600 + 48), 600)),
    ("matmul", dict(m=52, k=15000, n=1024),
     (4 * (52 * 15000 + 15000 * 1024 + 52 * 1024), 2 * 52 * 15000 * 1024)),
    ("matmul", dict(m=8, k=400, n=2, batch=3),
     (4 * 3 * (8 * 400 + 400 * 2 + 8 * 2), 2 * 3 * 8 * 400 * 2)),
])
def test_kernel_work_matches_hand_counts(kernel, shapes, expect):
    assert hk.kernel_work(kernel, **shapes) == expect


def test_kernel_work_rejects_unknown_kernels():
    with pytest.raises(ValueError):
        hk.kernel_work("index_add_", n=1)


def _kernel_inputs(rng, n=300, d=6, M=3, C=2, B=16, half=4):
    bits = pack_width(B)
    Xb = torch.as_tensor(rng.randint(0, B, size=(n, d)).astype(np.int32))
    packed = pack_bins(Xb, B, bits).packed
    node = torch.as_tensor(rng.randint(0, half, size=(n, M)).astype(np.int32))
    vals = torch.as_tensor(rng.randn(n, M, C).astype(np.float32))
    bf = torch.as_tensor(rng.randint(0, d, size=(M, half)).astype(np.int32))
    bt = torch.as_tensor(rng.randint(0, B, size=(M, half)).astype(np.int32))
    return Xb, packed, node, vals, bf, bt, bits


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrappers_report_their_work_on_the_cpu(inventory, kernel):
    """Each wrapper's row: one call, the signature's shapes, and the bytes
    and ops of ``kernel_work`` at them; ``LAUNCHES`` stays 0 (no card)."""
    rng = np.random.RandomState(3)
    Xb, packed, node, vals, bf, bt, bits = _kernel_inputs(rng)
    n, d = Xb.shape
    M, C = vals.shape[1:]
    kw = dict(bits=bits, num_features=d)
    before = dict(hk.LAUNCHES)
    if kernel == "hist_i32":
        hk.hist_level_pallas(Xb, node, vals, n_nodes=4, max_bins=16)
        shapes = dict(n=n, d=d, M=M, C=C, B=16, n_nodes=4)
    elif kernel == "hist_packed":
        hk.hist_level_packed(packed, node, vals, n_nodes=4, max_bins=16, **kw)
        shapes = dict(n=n, d=d, W=packed.shape[1], M=M, C=C, B=16, n_nodes=4)
    elif kernel == "route_packed":
        hk.route_packed(packed, node, bf, bt, **kw)
        shapes = dict(n=n, W=packed.shape[1], M=M, half=4)
    else:
        hk.fused_round_level(packed, node, vals, bf, bt, n_nodes=8, max_bins=16,
                             leaf=True, **kw)
        shapes = dict(n=n, M=M, C=C, leaves=8, W=packed.shape[1], half=4)
    rows = inventory.kernel_rows(kernel)
    assert len(rows) == 1 and rows[0]["calls"] == 1
    assert dict(map(tuple, rows[0]["signature"])) == shapes
    nbytes, nops = hk.kernel_work(kernel, **shapes)
    assert (rows[0]["bytes"], rows[0]["ops"]) == (nbytes, nops)
    assert hk.LAUNCHES == before


def test_no_hook_no_rows():
    """Without the inventory the wrappers report nowhere."""
    inv = programz.global_inventory()
    inv.clear()
    assert hk._WORK_HOOK[0] is None and not programz.enabled()
    rng = np.random.RandomState(0)
    Xb, packed, node, vals, bf, bt, bits = _kernel_inputs(rng)
    hk.hist_level_pallas(Xb, node, vals, n_nodes=4, max_bins=16)
    assert len(inv) == 0


# -- capture on the fit path ------------------------------------------------


def test_inventory_captures_round_programs_and_the_four_kernels(inventory):
    """A fused fit launches, per round at depth 3, 3 ``hist_packed``, 2
    ``route_packed`` and 1 ``leaf_sums``; a pallas-tier fit 3
    ``hist_i32``; each round chunk is one ``gbm_cls_round`` call whose
    work is the sum of its launches'."""
    X, y = _cls()
    rounds = 4
    st.GBMClassifier(num_base_learners=rounds, base_learner=_tree("fused"),
                     scan_chunk=2).fit(X, y, device="cpu")
    st.GBMClassifier(num_base_learners=rounds, base_learner=_tree("matmul", "pallas"),
                     scan_chunk=2).fit(X, y, device="cpu")
    calls = {k: _kernel_calls(inventory, k) for k in KERNELS}
    assert calls == {"hist_packed": 3 * rounds, "route_packed": 2 * rounds,
                     "leaf_sums": rounds, "hist_i32": 3 * rounds}
    # one row per level's shapes
    assert sorted(dict(map(tuple, r["signature"]))["n_nodes"]
                  for r in inventory.kernel_rows("hist_packed")) == [1, 2, 4]
    progs = [r for r in inventory.rows() if r["kind"] == "program"]
    assert {r["tag"] for r in progs} == {"gbm_cls_round"}
    assert sum(r["calls"] for r in progs) == 4  # 2 fits x 2 chunks of 2
    fused = next(r for r in progs if "hist_packed" in r["kernels"])
    kr = fused["kernels"]
    assert {k: kr[k]["launches"] for k in kr} == {
        "hist_packed": 3 * rounds, "route_packed": 2 * rounds, "leaf_sums": rounds}
    # the program's bytes are the sum of its kernels' rows
    assert fused["bytes"] == sum(r["bytes"] for k in ("hist_packed", "route_packed", "leaf_sums")
                                 for r in inventory.kernel_rows(k))
    summary = inventory.summary()
    assert summary["programs"] == 2 and summary["kernels"] == 3 + 2 + 1 + 3 + 1


def test_matmul_and_stream_tiers_report_their_products(inventory):
    X, y = _reg()
    st.GBMRegressor(num_base_learners=2, base_learner=_tree("matmul")).fit(X, y, device="cpu")
    st.GBMRegressor(num_base_learners=2, base_learner=_tree("stream")).fit(X, y, device="cpu")
    rows = inventory.kernel_rows("matmul")
    assert rows and all(r["ops"] > 0 for r in rows)
    progs = [r for r in inventory.rows() if r["kind"] == "program"]
    assert len(progs) == 2
    assert all(set(r["kernels"]) == {"matmul"} for r in progs)


def test_predict_and_family_programs_carry_the_jax_tags(inventory):
    X, y = _reg()
    Xc, yc = _cls()
    tree = _tree("fused", depth=2)
    models = [
        st.GBMRegressor(num_base_learners=2, base_learner=tree).fit(X, y, device="cpu"),
        st.GBMClassifier(num_base_learners=2, base_learner=tree).fit(Xc, yc, device="cpu"),
        st.BaggingRegressor(num_base_learners=3, base_learner=tree).fit(X, y, device="cpu"),
        st.BaggingClassifier(num_base_learners=3,
                             base_learner=st.DecisionTreeClassifier(max_depth=2, hist="fused")
                             ).fit(Xc, yc, device="cpu"),
        st.BoostingRegressor(num_base_learners=2, base_learner=tree).fit(X, y, device="cpu"),
        st.BoostingClassifier(num_base_learners=2,
                              base_learner=st.DecisionTreeClassifier(max_depth=2, hist="fused")
                              ).fit(Xc, yc, device="cpu"),
    ]
    for m in models:
        m.predict(Xc if m.is_classifier else X)
    tags = {r["tag"] for r in inventory.rows() if r["kind"] == "program"}
    assert tags == {"gbm_reg_round", "gbm_cls_round", "bagging_fit", "bagging_fit_cls",
                    "boosting_reg_chunk", "boosting_cls_chunk", "predict:predict",
                    "predict:raw", "predict:members", "predict:member_preds"}
    # the fit programs launched the fused kernels; predicts launch none
    for r in inventory.rows():
        if r["kind"] == "program":
            assert (r["launches"] > 0) == (not r["tag"].startswith("predict:")), r["tag"]


def test_the_jax_package_names_the_same_round_programs(inventory):
    """The same GBM fit in both packages, each with its inventory on: the
    port's round and predict tags are the JAX package's."""
    X, y = _reg(n=128, d=5)
    jinv = jax_programz.enable()
    jinv.clear()
    try:
        se.GBMRegressor(num_base_learners=2, seed=0).fit(X, y).predict(X)
        jtags = {r["tag"] for r in jinv.rows()}
    finally:
        jax_programz.disable()
        jinv.clear()
    st.GBMRegressor(num_base_learners=2, seed=0).fit(X, y, device="cpu").predict(X)
    tags = {r["tag"] for r in inventory.rows() if r["kind"] == "program"}
    assert tags == {"gbm_reg_round", "predict:predict"}
    assert tags <= jtags, (tags, jtags)


def test_engine_programs_record_each_run(inventory):
    X, y = _reg()
    model = st.GBMRegressor(num_base_learners=2, base_learner=_tree("fused", depth=2)).fit(
        X, y, device="cpu")
    with InferenceEngine(model, min_bucket=8, max_batch_size=16, warm=False) as eng:
        eng.warmup()
        eng.predict(X[:5])
        eng.predict(X[:12])
    eng_rows = [r for r in inventory.rows() if r["tag"] == "engine:predict"]
    assert sorted(r["signature"][0][0][0] for r in eng_rows) == [8, 16]
    assert sum(r["calls"] for r in eng_rows) == 4  # a warm run and a request each


def test_threads_attribute_work_to_their_own_programs(inventory):
    """Two fits on two threads at once: each chunk's work is its own
    launches', never the other thread's."""
    X, y = _reg()

    def fit(depth):
        st.GBMRegressor(num_base_learners=3, base_learner=_tree("fused", depth=depth),
                        scan_chunk=1).fit(X, y, device="cpu")

    # one recorder for both threads (record_fits is a process-wide slot)
    with record_fits() as rec:
        ts = [threading.Thread(target=fit, args=(d,)) for d in (2, 3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    by_fit = {}
    for e in rec.events:
        if e["event"] == "round_end":
            by_fit.setdefault(e["fit_id"], set()).add(e["xla_bytes_accessed"])
    # one hist_packed launch a level: a call of the depth-d fit launches d
    progs = {r["kernels"]["hist_packed"]["launches"] // r["calls"]: r
             for r in inventory.rows() if r["kind"] == "program"}
    assert set(progs) == {2, 3}
    # each fit's rounds join its own program's bytes a call (one round)
    assert sorted(by_fit.values(), key=min) == sorted(
        ({progs[d]["bytes"] / progs[d]["calls"]} for d in (2, 3)), key=min)


def test_nested_programs_count_in_the_enclosing_call(inventory):
    rng = np.random.RandomState(0)
    Xb, packed, node, vals, bf, bt, bits = _kernel_inputs(rng)
    with program_call("outer", Xb) as outer:
        hk.hist_level_pallas(Xb, node, vals, n_nodes=4, max_bins=16)
        with program_call("inner", Xb) as inner:
            hk.hist_level_pallas(Xb, node, vals, n_nodes=4, max_bins=16)
    assert inner.work["hist_i32"][0] == 1
    assert outer.work["hist_i32"][0] == 2
    assert outer.record.calls == 1 and inner.record.calls == 1


def test_program_call_is_a_shared_noop_when_nothing_watches():
    assert mbase._PROGRAM_SINK[0] is None
    with program_call("x", torch.zeros(3)) as call:
        assert call is None
    seen = []
    with mbase.observe_program_calls(lambda tag, sig: seen.append((tag, sig))):
        with program_call("x", torch.zeros(3, dtype=torch.int32), 5):
            pass
    assert seen == [("x", (((3,), "torch.int32"), ("int", "5")))]


# -- analysis and the round ledger's join -------------------------------------


def test_shallow_analysis_launches_and_builds_nothing(inventory):
    X, y = _cls()
    st.GBMClassifier(num_base_learners=2, base_learner=_tree("fused")).fit(X, y, device="cpu")
    launches, builds = dict(hk.LAUNCHES), compile_snapshot()
    pending = inventory.summary()["pending"]
    assert pending > 0
    done = inventory.analyze_pending()
    assert done == pending
    assert inventory.summary()["pending"] == 0
    assert hk.LAUNCHES == launches and compile_snapshot() == builds
    row = next(r for r in inventory.rows() if r["tag"] == "gbm_cls_round")
    assert row["status"] == "analyzed"
    assert row["flops"] == row["ops"] / row["calls"]
    assert row["bytes_accessed"] == row["bytes"] / row["calls"]
    # rows sort heaviest first: the round program above its kernels
    assert inventory.rows(top=1)[0]["tag"] == "gbm_cls_round"


def test_deep_analysis_needs_the_card(inventory):
    """Deep analysis reads the card's allocator peak: on the CPU the next
    call records none."""
    X, y = _reg()
    est = st.GBMRegressor(num_base_learners=2, base_learner=_tree("fused"))
    est.fit(X, y, device="cpu")
    inventory.analyze_pending(deep=True)
    est.fit(X, y, device="cpu")
    row = next(r for r in inventory.rows() if r["tag"] == "gbm_reg_round")
    assert "peak_hbm_bytes" not in row and "peak_hbm_bytes_at_most" not in row


def test_emit_rows_lands_program_events(inventory, tmp_path):
    X, y = _reg()
    st.GBMRegressor(num_base_learners=2, base_learner=_tree("fused")).fit(X, y, device="cpu")
    inventory.analyze_pending()
    path = tmp_path / "programs.jsonl"
    count = inventory.emit_rows(path=str(path))
    import json

    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert count == len(events) == len(inventory)
    assert all(e["event"] == "program" for e in events)
    assert any(e.get("flops") for e in events)


@pytest.mark.parametrize("hp,band", [("highest", (1.0 - 1e-12, 1.0 + 1e-12)),
                                     ("high", (0.5, 1.0))])
def test_round_ledger_three_way_join_matmul_tier(inventory, hp, band):
    """The port's counterpart of the JAX package's matmul-tier join (see
    the module docstring for the bands)."""
    X, y = _reg(n=128, d=5)
    with record_fits() as rec:
        st.GBMRegressor(base_learner=_tree("matmul", hp), num_base_learners=3, seed=0
                        ).fit(X, y, device="cpu")
    rounds = [e for e in rec.events if e["event"] == "round_end"]
    assert len(rounds) == 3 and all("xla_flops" in e for e in rounds)
    e = rounds[-1]
    assert e["program_tag"] == "gbm_reg_round"
    assert e["xla_modeled_s"] > 0 and e["mfu_xla"] >= 0 and e["xla_bytes_accessed"] > 0
    assert band[0] <= e["xla_vs_analytic_flops_ratio"] <= band[1], e
    # the JAX join's keys, every one
    assert {"program_tag", "xla_flops", "xla_bytes_accessed", "xla_modeled_s", "mfu_xla",
            "xla_vs_analytic_flops_ratio"} <= set(e)


def test_fused_round_join_is_the_launches_kernel_work(inventory):
    """A fused round's ``xla_bytes_accessed`` and ``xla_flops`` are the
    sum of ``kernel_work`` over the round's launches."""
    X, y = _cls(n=300, d=6, k=3)
    with record_fits() as rec:
        st.GBMClassifier(num_base_learners=2, base_learner=_tree("fused")).fit(X, y, device="cpu")
    e = [e for e in rec.events if e["event"] == "round_end"][-1]
    n, d, M, C, B, W = 300, 6, 3, 2, 16, 1
    nbytes = ops = 0
    for level in range(3):
        b, o = hk.kernel_work("hist_packed", n=n, d=d, W=W, M=M, C=C, B=B, n_nodes=2**level)
        nbytes, ops = nbytes + b, ops + o
        if level:
            b, o = hk.kernel_work("route_packed", n=n, W=W, M=M, half=2 ** (level - 1))
            nbytes, ops = nbytes + b, ops + o
    b, o = hk.kernel_work("leaf_sums", n=n, M=M, C=C, leaves=8, W=W, half=4)
    assert e["xla_bytes_accessed"] == nbytes + b
    assert e["xla_flops"] == ops + o
    assert 0 < e["xla_vs_analytic_flops_ratio"] < 0.1


def test_no_join_without_the_inventory():
    X, y = _reg()
    with record_fits() as rec:
        st.GBMRegressor(num_base_learners=2, base_learner=_tree("fused")).fit(X, y, device="cpu")
    e = [e for e in rec.events if e["event"] == "round_end"][-1]
    assert "program_tag" not in e and "xla_flops" not in e


# -- the inventory changes nothing ----------------------------------------------


def _params_equal(a, b):
    la, lb = mbase.tree_leaves(a), mbase.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("hist,hp", [("fused", "highest"), ("matmul", "pallas"),
                                     ("matmul", "highest"), ("stream", "highest")])
def test_fit_is_bit_identical_with_the_inventory_on_and_off(hist, hp):
    X, y = _cls()
    est = lambda: st.GBMClassifier(num_base_learners=3, base_learner=_tree(hist, hp))  # noqa: E731
    off = est().fit(X, y, device="cpu")
    inv = programz.enable()
    inv.clear()
    try:
        with record_fits():
            on = est().fit(X, y, device="cpu")
        inv.analyze_pending(deep=True)
        assert len(inv) > 0
    finally:
        programz.disable()
        inv.clear()
    assert _params_equal(off.params, on.params)
    assert torch.equal(off.predict_proba(X), on.predict_proba(X))


def test_hbm_sampler_publishes_nothing_on_the_cpu(inventory):
    from spark_ensemble_tpu_torch.telemetry.events import global_metrics

    X, y = _reg()
    st.GBMRegressor(num_base_learners=2, base_learner=_tree("fused")).fit(X, y, device="cpu")
    sampler = programz.HbmSampler(interval_s=3600.0)
    assert sampler.sample_once() == {}
    assert not [k for k in global_metrics().snapshot() if k.startswith("hbm/")]
    assert sampler.ticks == 1 and inventory.summary()["pending"] < len(inventory)
    assert not torch.cuda.is_initialized()


def test_lru_bound_and_clear():
    inv = programz.ProgramInventory(max_records=3)
    for i in range(5):
        call = mbase.ProgramCall(f"p{i}", ())
        call.add_work("hist_i32", 10, 1)
        inv.record_call(call)
    assert [r.tag for r in inv.records()] == ["p2", "p3", "p4"]
    assert inv.summary()["calls"] == 5
    inv.clear()
    assert len(inv) == 0 and inv.summary()["calls"] == 0
