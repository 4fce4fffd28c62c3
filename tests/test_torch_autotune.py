"""The port's autotune plane (``spark_ensemble_tpu_torch/autotune/``) case
for case with ``tests/test_autotune.py``, and against the JAX package.

The tunable space keeps the JAX package's 18 names, kinds and (where the
meaning carries over) candidates, with the port's literals as defaults;
the cache round-trips in the JAX package's format, both ways; the search
under one injected measure picks and publishes what the JAX package's
does; resolution order (override > off > cache > default) holds at every
wired site, a hand-set param wins there, and an empty cache keeps fits
bit-identical to ``SE_TPU_AUTOTUNE=off``.  The CUDA kernels' plan knobs
resolve into ``level_plan`` without a stale cached plan, and the build
cache directs ``build_kernels``.  CPU only: the plans are computed here,
the kernels run on the card (``chip_smoke.py``'s ``autotune`` phase)."""

import functools
import hashlib
import json
import os
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_ensemble_tpu.autotune as jat
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch import execution
from spark_ensemble_tpu_torch.autotune import (
    TUNABLES,
    TuningCache,
    autotune_fit,
    fingerprint,
    override,
    reset,
    resolve,
    resolved_snapshot,
    run_search,
    shape_class,
)
from spark_ensemble_tpu_torch.autotune import compilation_cache as cc
from spark_ensemble_tpu_torch.autotune import search as search_mod
from spark_ensemble_tpu_torch.autotune.cache import entry_key, manifest_signature
from spark_ensemble_tpu_torch.autotune.resolve import _device_identity
from spark_ensemble_tpu_torch.data import prefetch, shards
from spark_ensemble_tpu_torch.models import gbm, gbm_sweep
from spark_ensemble_tpu_torch.models.base import resolved_scan_chunk, tree_leaves
from spark_ensemble_tpu_torch.ops import binning
from spark_ensemble_tpu_torch.ops import hist_kernels as hk
from spark_ensemble_tpu_torch.ops import tree as tt

PORT = Path(st.__file__).resolve().parent

#: tunables whose candidates are the port's own: the card's plan sizes and
#: the predict chunk (rows x trees, not the JAX package's one-hot cells)
OWN_GRID = ("predict_fused_max_cells", "pallas_block_rows", "pallas_vmem_budget",
            "fused_block_rows", "fused_vmem_budget")


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test gets an empty cache directory and the default mode; both
    packages' memoized cache views are dropped on both sides."""
    monkeypatch.setenv("SE_TPU_AUTOTUNE_CACHE", str(tmp_path / "atc"))
    monkeypatch.delenv("SE_TPU_AUTOTUNE", raising=False)
    monkeypatch.delenv("SE_TPU_PIPELINE", raising=False)
    reset()
    jat.reset()
    yield
    reset()
    jat.reset()


def _fake_measure(times):
    """measure(tag, thunk, repeats) stub returning scripted times and
    recording every call."""
    calls = []

    def measure(tag, thunk, repeats):
        calls.append(tag)
        key = (tag["tunable"], tag["candidate"])
        return times.get(key, times.get(tag["tunable"], 1.0))

    measure.calls = calls
    return measure


def _publish(params, cls="*"):
    platform, kind = _device_identity()
    cache = TuningCache()
    cache.put(platform, kind, cls, params)
    cache.save()
    reset()


def _data(n=300, d=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _leaves(model):
    return tree_leaves(model.params)


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, z in zip(la, lb):
        assert torch.equal(x, z)


# ---------------------------------------------------------------------------
# space
# ---------------------------------------------------------------------------


def test_defaults_mirror_source_literals():
    """Every default equals the port's live literal at its site."""
    d = TUNABLES.defaults()
    assert d["scan_chunk"] == st.GBMRegressor().scan_chunk == st.BoostingClassifier().scan_chunk
    assert d["stream_chunk_rows"] == tt._STREAM_CHUNK_ROWS
    assert d["shard_rows"] == shards.DEFAULT_SHARD_ROWS
    assert d["prefetch_depth"] == prefetch.DEFAULT_PREFETCH_DEPTH
    assert d["predict_fused_max_cells"] == tt._PREDICT_MAX_CELLS
    assert d["pallas_block_rows"] == d["fused_block_rows"] == hk._LEVEL_ROWS
    assert d["pallas_vmem_budget"] == d["fused_vmem_budget"] == hk._CTA_HIST_BYTES
    assert d["pipeline_depth"] == execution.DEFAULT_PIPELINE_DEPTH
    assert d["configs_per_dispatch"] == gbm_sweep._CONFIGS_PER_DISPATCH
    assert d["sample_bucket_floor"] == gbm._SAMPLE_BUCKET_FLOOR
    assert d["goss_top_rate"] == st.GBMRegressor().top_rate
    assert d["goss_other_rate"] == st.GBMRegressor().other_rate
    assert d["hist_tier"] == "auto" and d["pack_bits"] == 0


def test_space_matches_the_jax_package():
    """The same 18 names in the same order with the same kinds; the same
    candidates and defaults wherever the meaning carries over; each site
    names a port file that holds the named symbol, or None with a reason."""
    assert TUNABLES.names() == jat.TUNABLES.names() and len(TUNABLES) == 18
    for t in TUNABLES:
        j = jat.TUNABLES[t.name]
        assert t.kind == j.kind, t.name
        if t.name not in OWN_GRID:
            assert t.candidates == j.candidates, t.name
            assert t.default == j.default, t.name
        assert t.default in t.candidates, t.name
        if t.site is None:
            assert "no site in the port" in t.doc, t.name
            continue
        path, symbol = t.site.split(":")
        assert symbol in (PORT / path).read_text(), t.site
    assert [t.name for t in TUNABLES if t.site is None] == [
        "predict_bucket_pow2_exact", "predict_bucket_octave_steps"]
    # the plan sizes are the card's: R in 32-row steps, budgets within one SM
    for name in ("pallas_block_rows", "fused_block_rows"):
        assert all(c % 64 == 0 for c in TUNABLES[name].candidates)
    for name in ("pallas_vmem_budget", "fused_vmem_budget"):
        assert max(TUNABLES[name].candidates) <= hk._MAX_SMEM


def test_validate_params_drops_unknown_and_invalid():
    got = TUNABLES.validate_params({
        "scan_chunk": 32,              # valid
        "hist_tier": "matmul",         # valid choice
        "stream_chunk_rows": -4,       # invalid: not positive
        "pallas_block_rows": "256",    # invalid: wrong type
        "scan_chunk_v2": 64,           # unknown name (future cache)
        "predict_bucket_octave_steps": True,  # bool is not an int here
    })
    assert got == {"scan_chunk": 32, "hist_tier": "matmul"}


def test_shape_class_buckets():
    assert shape_class(None) == "*"
    assert shape_class(0) == "*"
    assert shape_class(15000) == "n14"  # letter scale
    assert shape_class(16384) == "n14"
    assert shape_class(1) == "n0"


@pytest.mark.parametrize("n", [None, 0, 1, 1000, 15000, 2**21])
def test_shape_class_equals_the_jax_package(n):
    assert shape_class(n) == jat.shape_class(n)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def test_cache_round_trip(tmp_path):
    d = str(tmp_path / "c")
    cache = TuningCache()
    cache.put("cpu", "cpu", "n14", {"scan_chunk": 64, "hist_tier": "matmul"})
    cache.put("cpu", "cpu", "*", {"predict_bucket_pow2_exact": 1024})
    path = cache.save(d)
    assert os.path.isdir(path)
    loaded = TuningCache.load(d)
    # exact class merges over the platform-wide "*" entry
    assert loaded.lookup("cpu", "cpu", "n14") == {
        "scan_chunk": 64,
        "hist_tier": "matmul",
        "predict_bucket_pow2_exact": 1024,
    }
    # unknown shape class still serves the "*" entry
    assert loaded.lookup("cpu", "cpu", "n9") == {
        "predict_bucket_pow2_exact": 1024,
    }
    # a different device has no entries at all
    assert loaded.lookup("cuda", "NVIDIA H100 80GB HBM3", "n14") == {}


def test_cache_save_retains_previous_generation(tmp_path):
    d = str(tmp_path / "c")
    first = TuningCache()
    first.put("cpu", "cpu", "*", {"scan_chunk": 8})
    first.save(d)
    second = TuningCache()
    second.put("cpu", "cpu", "*", {"scan_chunk": 128})
    second.save(d)
    assert TuningCache.load(d).lookup("cpu", "cpu", "*") == {"scan_chunk": 128}
    assert os.path.isdir(os.path.join(d, ".cache-old"))


def test_manifest_corruption_falls_back(tmp_path):
    d = str(tmp_path / "c")
    cache = TuningCache()
    cache.put("cpu", "cpu", "*", {"scan_chunk": 64})
    cache.save(d)
    # a payload edit behind the manifest's back: rejected, and with no
    # .cache-old yet the cache loads empty
    with open(os.path.join(d, "latest", "tuned.json"), "a") as f:
        f.write(" ")
    assert TuningCache.load(d).entries == {}

    # a good generation, a newer one, then the newer manifest torn: load
    # falls back to the retained generation
    good = TuningCache()
    good.put("cpu", "cpu", "*", {"scan_chunk": 32})
    good.save(d)
    newer = TuningCache()
    newer.put("cpu", "cpu", "*", {"scan_chunk": 128})
    newer.save(d)
    with open(os.path.join(d, "latest", "manifest.json"), "w") as f:
        f.write("{not json")
    assert TuningCache.load(d).lookup("cpu", "cpu", "*") == {"scan_chunk": 32}


def test_cache_version_mismatch_ignored(tmp_path):
    d = str(tmp_path / "c")
    cache = TuningCache()
    cache.put("cpu", "cpu", "*", {"scan_chunk": 64})
    cache.save(d)
    man_path = os.path.join(d, "latest", "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    man["version"] = 999
    with open(man_path, "w") as f:
        json.dump(man, f)
    assert TuningCache.load(d).entries == {}


def test_entry_key_normalizes_slashes():
    assert entry_key("cuda", "NVIDIA H100 80GB HBM3", "n14") == "cuda/NVIDIA H100 80GB HBM3/n14"
    assert entry_key("cuda", "odd/kind", "n14") == "cuda/odd_kind/n14"


def test_default_directory_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("SE_TPU_AUTOTUNE_CACHE")
    mine, theirs = st.autotune.cache_dir(), jat.cache_dir()
    assert mine != theirs and mine.endswith(os.path.join("spark_ensemble_tpu_torch", "autotune"))


def _interop_entries():
    return {
        ("cuda", "NVIDIA H100 80GB HBM3", "n14"): {"scan_chunk": 32, "hist_tier": "fused",
                                                   "pallas_block_rows": 512},
        ("cuda", "NVIDIA H100 80GB HBM3", "*"): {"pipeline_depth": 2, "goss_top_rate": 0.3},
        ("tpu", "TPU v5 lite", "n14"): {"scan_chunk": 64},
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_interop_both_ways(tmp_path, writer):
    """A cache saved by either package loads in the other with equal
    lookups and equal entries."""
    make, read = ((jat.TuningCache, TuningCache) if writer == "jax"
                  else (TuningCache, jat.TuningCache))
    d = str(tmp_path / "interop")
    cache = make()
    for key, params in _interop_entries().items():
        cache.put(*key, params, meta={"budget": "smoke"})
    cache.save(d)
    a, b = TuningCache.load(d), jat.TuningCache.load(d)
    assert read.load(d).entries == cache.entries == a.entries == b.entries
    for platform, kind, cls in [*_interop_entries(), ("cuda", "NVIDIA H100 80GB HBM3", "n3")]:
        assert a.lookup(platform, kind, cls) == b.lookup(platform, kind, cls)
    assert a.lookup("cuda", "NVIDIA H100 80GB HBM3", "n14") == {
        "scan_chunk": 32, "hist_tier": "fused", "pallas_block_rows": 512,
        "pipeline_depth": 2, "goss_top_rate": 0.3}


# ---------------------------------------------------------------------------
# resolve
# ---------------------------------------------------------------------------


def test_resolution_order_cache_then_default():
    _publish({"scan_chunk": 64})
    assert resolve("scan_chunk", 16, n=2048) == 64
    # a name the cache has no entry for returns the caller's default
    assert resolve("stream_chunk_rows", 32768, n=2048) == 32768


def test_off_mode_ignores_cache(monkeypatch):
    _publish({"scan_chunk": 64})
    monkeypatch.setenv("SE_TPU_AUTOTUNE", "off")
    assert resolve("scan_chunk", 16, n=2048) == 16
    assert fingerprint() == ("autotune-off",)
    snap = resolved_snapshot(2048)
    assert snap["mode"] == "off" and not snap["cache_hit"]


def test_override_wins_over_cache():
    _publish({"scan_chunk": 64})
    with override(scan_chunk=4):
        assert resolve("scan_chunk", 16, n=2048) == 4
    assert resolve("scan_chunk", 16, n=2048) == 64
    with pytest.raises(ValueError):
        with override(not_a_tunable=1):
            pass


def test_fingerprint_tracks_tuning_state():
    base = fingerprint()
    with override(scan_chunk=4):
        assert fingerprint() != base
    _publish({"scan_chunk": 64})
    assert fingerprint() != base  # manifest signature changed


def test_manifest_signature_changes_on_save():
    assert manifest_signature() is None
    cache = TuningCache()
    cache.put("cpu", "cpu", "*", {"scan_chunk": 64})
    cache.save()
    assert manifest_signature() is not None


def test_bucket_ladder_tunables_resolve_but_have_no_site():
    """The JAX package's predict bucket ladder: its two tunables resolve
    from a cache entry like any other, and the port declares no site for
    them (its predict runs unpadded)."""
    _publish({"predict_bucket_pow2_exact": 2048, "predict_bucket_octave_steps": 4})
    assert resolve("predict_bucket_pow2_exact", 512) == 2048
    assert resolve("predict_bucket_octave_steps", 8) == 4
    snap = resolved_snapshot()
    assert snap["cache_hit"] and snap["values"]["predict_bucket_pow2_exact"] == 2048
    for name in ("predict_bucket_pow2_exact", "predict_bucket_octave_steps"):
        assert TUNABLES[name].site is None


def test_a_fit_resolves_each_site_once(monkeypatch):
    """Inside a fit each site resolves once, however many rounds read it
    (a resolve stats the cache's manifest); an override still wins there,
    and outside a fit every call resolves."""
    import sys

    rmod = sys.modules["spark_ensemble_tpu_torch.autotune.resolve"]
    calls = []
    real = rmod._lookup
    monkeypatch.setattr(rmod, "_lookup",
                        lambda name, default, n: calls.append(name) or real(name, default, n))
    X, y = _data(200, 4)
    st.GBMRegressor(num_base_learners=5, base_learner=st.DecisionTreeRegressor(
        max_depth=2, hist="fused")).fit(X, y, device="cpu")
    assert calls.count("pack_bits") == 1  # read by each round's forest fit
    calls.clear()
    with rmod.pinned():
        assert resolve("scan_chunk", 16) == 16
        _publish({"scan_chunk": 64})
        assert resolve("scan_chunk", 16) == 16  # the scope's first answer
        with override(scan_chunk=4):
            assert resolve("scan_chunk", 16) == 4
    assert resolve("scan_chunk", 16) == 64
    assert calls == ["scan_chunk", "scan_chunk"]


def test_hand_set_scan_chunk_wins():
    tuned = st.GBMRegressor()
    hand = st.GBMRegressor(scan_chunk=8)
    with override(scan_chunk=64):
        assert resolved_scan_chunk(tuned, 2048) == 64
        assert resolved_scan_chunk(hand, 2048) == 8
        assert resolved_scan_chunk(st.BoostingClassifier(scan_chunk=3), 2048) == 3


def test_hand_set_hist_tier_wins():
    with override(hist_tier="stream"):
        # 'auto' consults the tuned tier ...
        assert tt.resolve_forest_tier("auto", "highest", "cpu", 4096, 8, 32) == "stream"
        # ... but an explicit hist param short-circuits it
        assert tt.resolve_forest_tier("matmul", "highest", "cpu", 4096, 8, 32) == "matmul"


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def test_search_winner_is_deterministic_and_beats_noise_floor():
    """Scripted timings: a candidate that beats the default by more than
    the noise floor wins; one inside the floor loses to the default."""
    script = {
        ("scan_chunk", 16): 1.00,
        ("scan_chunk", 4): 0.90,    # -10%: a real win
        ("scan_chunk", 8): 0.995,   # -0.5%: noise
        ("scan_chunk", 32): 1.20,
        "hist_tier": 1.0,           # flat: default ("auto") must win
    }
    res = run_search(budget="smoke", groups=("fit",), measure=_fake_measure(script),
                     save=False)
    assert res["winners"] == {"scan_chunk": 4}
    res2 = run_search(budget="smoke", groups=("fit",), measure=_fake_measure(dict(script)),
                      save=False)
    assert res2["winners"] == res["winners"]


def test_search_publishes_both_shape_classes(tmp_path):
    d = str(tmp_path / "pub")
    measure = _fake_measure({("scan_chunk", 4): 0.5, "scan_chunk": 1.0, "hist_tier": 1.0})
    res = run_search(budget="smoke", groups=("fit",), measure=measure, directory=d)
    assert res["winners"] == {"scan_chunk": 4}
    loaded = TuningCache.load(d)
    platform, kind = _device_identity()
    assert loaded.lookup(platform, kind, res["shape_class"]) == res["winners"]
    assert loaded.lookup(platform, kind, "nope") == res["winners"]  # via "*"


def test_autotune_fit_cache_hit_short_circuits():
    X = np.zeros((2048, 4), np.float32)
    _publish({"scan_chunk": 64}, cls=shape_class(2048))
    measure = _fake_measure({})
    out = autotune_fit(st.GBMRegressor(), X, budget="smoke", measure=measure)
    assert out["cached"] is True
    assert out["params"] == {"scan_chunk": 64}
    assert measure.calls == []  # zero measurements on a hit
    out2 = autotune_fit(st.GBMRegressor(), X, budget="smoke", measure=measure,
                        save=False, force=True)
    assert "cached" not in out2
    assert len(measure.calls) > 0


def test_autotune_fit_hits_an_entry_that_kept_the_defaults(tmp_path):
    """A search that kept every default still publishes its shape class's
    entry; ``autotune_fit`` on that class hits it without measuring."""
    X = np.zeros((2048, 4), np.float32)
    run_search(budget="smoke", groups=("fit",), measure=_fake_measure({}))
    assert TuningCache.load().lookup(*_device_identity(), shape_class(2048)) == {}
    measure = _fake_measure({})
    out = autotune_fit(st.GBMRegressor(), X, budget="smoke", measure=measure)
    assert out["cached"] is True and out["params"] == {} and measure.calls == []


def test_unknown_budget_and_group_raise():
    with pytest.raises(ValueError):
        run_search(budget="huge", measure=_fake_measure({}), save=False)
    with pytest.raises(ValueError):
        run_search(budget="smoke", groups=("nope",), measure=_fake_measure({}), save=False)


def _deterministic_measure():
    """One measure for both packages, keyed on (tunable, candidate): a
    fixed pseudo-random time per pair, flat where the two packages'
    candidates differ (the default wins there in both)."""
    calls = []

    def measure(tag, thunk, repeats):
        calls.append((tag["tunable"], str(tag["candidate"])))
        if tag["tunable"] in OWN_GRID:
            return 1.0
        key = f"{tag['tunable']}={tag['candidate']}".encode()
        return 0.5 + (zlib.crc32(key) % 1000) / 1000

    measure.calls = calls
    return measure


def test_search_matches_the_jax_package_under_one_measure(tmp_path):
    """Every group, one deterministic measure: the same winners, the same
    tunables timed in the same order (the same candidates where the
    grids agree), and equal published entries."""
    groups = ("fit", "predict", "stream", "bucket", "pallas")
    m_port, m_jax = _deterministic_measure(), _deterministic_measure()
    mine = run_search("smoke", groups=groups, measure=m_port, directory=str(tmp_path / "p"))
    ref = jat.run_search("smoke", groups=groups, measure=m_jax, directory=str(tmp_path / "j"))
    assert mine["winners"] == ref["winners"] and mine["winners"]
    assert list(mine["timings"]) == list(ref["timings"])
    for name in mine["timings"]:
        if name not in OWN_GRID:
            assert mine["timings"][name] == ref["timings"][name], name
    assert [c for c in m_port.calls if c[0] not in OWN_GRID] == [
        c for c in m_jax.calls if c[0] not in OWN_GRID]
    assert (mine["shape_class"], mine["shape"]) == (ref["shape_class"], ref["shape"])
    assert (TuningCache.load(str(tmp_path / "p")).entries
            == jat.TuningCache.load(str(tmp_path / "j")).entries)


def test_pallas_group_skips_off_the_card_with_real_measurement():
    res = run_search("smoke", groups=("pallas",), save=False)
    assert res["timings"] == {} and res["winners"] == {}


def test_search_mode_runs_the_smoke_search_once(monkeypatch, tmp_path):
    """``SE_TPU_AUTOTUNE=search`` over an empty cache: the first fit runs
    the smoke search and publishes; the next fit finds the entry and does
    not search again.  ``search()`` runs it on demand."""
    calls = []
    real_search = search_mod.run_search

    def counted(budget="smoke", **kw):
        calls.append(budget)
        return real_search(budget, measure=_fake_measure({("scan_chunk", 4): 0.5}), **kw)

    monkeypatch.setattr(search_mod, "run_search", counted)
    monkeypatch.setenv("SE_TPU_AUTOTUNE", "search")
    X, y = _data(200, 4)
    est = st.GBMClassifier(num_base_learners=2, base_learner=st.DecisionTreeRegressor(max_depth=2))
    est.fit(X, y, device="cpu")
    assert calls == ["smoke"] and manifest_signature() is not None
    assert resolve("scan_chunk", 16) == 4
    est.fit(X, y, device="cpu")
    assert calls == ["smoke"]
    from spark_ensemble_tpu_torch.autotune.resolve import search

    search(directory=str(tmp_path / "again"))
    assert calls == ["smoke", "smoke"]


# ---------------------------------------------------------------------------
# the wired sites: default == off bit for bit, an entry moves the value, a
# hand-set param wins
# ---------------------------------------------------------------------------


def _fits():
    """Small fits through every wired fit-time site."""
    X, y = _data()
    tree = functools.partial(st.DecisionTreeRegressor, max_depth=3, max_bins=16)
    return {
        "gbm_scatter": (st.GBMClassifier(num_base_learners=4, seed=0, base_learner=tree()), X, y),
        "gbm_fused_goss": (st.GBMRegressor(num_base_learners=3, sampling="goss", seed=1,
                                           base_learner=tree(hist="fused")), X, y),
        "gbm_pallas_mvs": (st.GBMRegressor(num_base_learners=3, sampling="mvs",
                                           base_learner=tree(hist_precision="pallas")), X, y),
        "samme": (st.BoostingClassifier(num_base_learners=3, algorithm="discrete",
                                        base_learner=st.DecisionTreeClassifier(max_depth=2)),
                  X, y),
    }


@pytest.mark.parametrize("name", ["gbm_scatter", "gbm_fused_goss", "gbm_pallas_mvs", "samme"])
def test_empty_cache_fit_bit_identical_to_off(name, monkeypatch):
    """With no cache entries, mode 'cache' resolves every site to its
    default: fits are BIT-identical to mode 'off'."""
    est, X, y = _fits()[name]
    a = est.copy().fit(X, y, device="cpu")
    monkeypatch.setenv("SE_TPU_AUTOTUNE", "off")
    b = est.copy().fit(X, y, device="cpu")
    _assert_same(a, b)


def test_tuned_scan_chunk_and_depth_keep_the_fit_bit_identical():
    """A tuned chunk and lookahead depth resolve through the cache and, as
    host batching decisions, leave the fit bit-identical."""
    X, y = _data()
    est = st.GBMClassifier(num_base_learners=4, seed=0,
                           base_learner=st.DecisionTreeRegressor(max_depth=3))
    ref = est.copy().fit(X, y, device="cpu")
    _publish({"scan_chunk": 2, "pipeline_depth": 0})
    assert resolved_scan_chunk(est, 300) == 2
    assert execution.resolve_pipeline_depth(300) == 0
    _assert_same(est.copy().fit(X, y, device="cpu"), ref)
    boost = st.BoostingRegressor(num_base_learners=3,
                                 base_learner=st.DecisionTreeRegressor(max_depth=2))
    assert resolved_scan_chunk(boost, 300) == 2


def test_pipeline_depth_env_wins(monkeypatch):
    assert execution.resolve_pipeline_depth(300) == execution.DEFAULT_PIPELINE_DEPTH
    _publish({"pipeline_depth": 2})
    assert execution.resolve_pipeline_depth(300) == 2
    monkeypatch.setenv("SE_TPU_PIPELINE", "0")
    assert execution.resolve_pipeline_depth(300) == 0


def test_hist_tier_from_the_cache():
    X, y = _data()
    assert tt.resolve_forest_tier("auto", "highest", "cpu", 300, 6, 16) == "scatter"
    est = st.DecisionTreeRegressor(max_depth=3, max_bins=16)
    ref = st.DecisionTreeRegressor(max_depth=3, max_bins=16, hist="matmul").fit(X, y, device="cpu")
    _publish({"hist_tier": "matmul"})
    assert tt.resolve_forest_tier("auto", "highest", "cpu", 300, 6, 16) == "matmul"
    _assert_same(est.fit(X, y, device="cpu"), ref)
    # a hand-set hist never reads it
    assert tt.resolve_forest_tier("scatter", "highest", "cpu", 300, 6, 16) == "scatter"
    assert tt.resolve_forest_tier("fused", "highest", "cpu", 300, 6, 16) == "fused"


def test_tuned_fused_tier_past_256_bins_falls_back():
    """A tuned 'fused' at max_bins=512 takes the heuristic's tier with a
    warning and fits; an explicit hist='fused' there still raises."""
    X, y = _data(200, 4)
    with override(hist_tier="fused"):
        assert tt.resolve_forest_tier("auto", "highest", "cpu", 200, 4, 16) == "fused"
        with pytest.warns(UserWarning, match="packable range"):
            assert tt.resolve_forest_tier("auto", "highest", "cpu", 200, 4, 512) == "scatter"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            st.DecisionTreeRegressor(max_depth=2, max_bins=512).fit(X, y, device="cpu")
    with pytest.raises(ValueError, match="packable"):
        tt.resolve_forest_tier("fused", "highest", "cpu", 200, 4, 512)


def test_predict_cells_from_the_cache(monkeypatch):
    """A tuned predict budget chunks the heap walk (more walks) and leaves
    the predictions bit-identical."""
    X, y = _data()
    model = st.GBMRegressor(num_base_learners=4,
                            base_learner=st.DecisionTreeRegressor(max_depth=3)).fit(X, y, device="cpu")
    walks = []
    real_walk = tt._walk
    monkeypatch.setattr(tt, "_walk", lambda *a: walks.append(1) or real_walk(*a))
    ref = model.predict(X)
    n_ref = len(walks)
    _publish({"predict_fused_max_cells": 64})
    walks.clear()
    assert torch.equal(model.predict(X), ref)
    assert len(walks) > n_ref


def test_pack_bits_from_the_cache_never_narrows():
    assert binning.pack_width(16) == 4 and binning.pack_width(64) == 8
    X, y = _data()
    est = st.GBMRegressor(num_base_learners=2,
                          base_learner=st.DecisionTreeRegressor(max_depth=3, max_bins=16,
                                                                hist="fused"))
    ref = est.copy().fit(X, y, device="cpu")
    _publish({"pack_bits": 8})
    assert binning.pack_width(16) == 8 and binning.pack_width(300) == 32
    _assert_same(est.copy().fit(X, y, device="cpu"), ref)  # packing is lossless
    with override(pack_bits=4):
        assert binning.pack_width(64) == 8  # never below what 64 bins need
    # an explicit width wins
    Xb = torch.zeros((3, 5), dtype=torch.int32)
    assert binning.pack_bins(Xb, 16, bits=4).bits == 4


def test_sampling_sites_from_the_cache():
    n = 3000
    goss = st.GBMRegressor(sampling="goss")
    plan = goss._resolved_sampling(n)
    assert (plan["top_rate"], plan["other_rate"], plan["bucket"]) == (0.2, 0.1, 1024)
    _publish({"goss_top_rate": 0.3, "goss_other_rate": 0.05, "sample_bucket_floor": 2048})
    plan = goss._resolved_sampling(n)
    assert (plan["top_rate"], plan["other_rate"], plan["bucket"]) == (0.3, 0.05, 2048)
    hand = st.GBMRegressor(sampling="goss", top_rate=0.2, other_rate=0.1)._resolved_sampling(n)
    assert (hand["top_rate"], hand["other_rate"]) == (0.2, 0.1)  # hand-set rates win
    mvs = st.GBMRegressor(sampling="mvs")._resolved_sampling(n)
    assert mvs["bucket"] == 2048 and mvs["top_rate"] == 0.2  # MVS reads no GOSS rate


def test_configs_per_dispatch_from_the_cache(monkeypatch):
    """A tuned slab splits the sweep into more slabs; each lane's model is
    bit-identical."""
    X, y = _data(160, 5)
    base = st.GBMRegressor(num_base_learners=2,
                           base_learner=st.DecisionTreeRegressor(max_depth=2, hist="fused"))
    cands = [base.copy(learning_rate=0.1 + 0.1 * i, seed=i) for i in range(3)]
    slabs = []
    real_slab = gbm_sweep._fit_reg_slab
    monkeypatch.setattr(gbm_sweep, "_fit_reg_slab",
                        lambda ests, *a: slabs.append(len(ests)) or real_slab(ests, *a))
    wide = st.fit_sweep([e.copy() for e in cands], X, y, device="cpu")
    _publish({"configs_per_dispatch": 2})
    narrow = st.fit_sweep([e.copy() for e in cands], X, y, device="cpu")
    assert slabs == [3, 2, 1]
    for a, b in zip(wide, narrow):
        _assert_same(a, b)


def test_data_plane_sites_from_the_cache(tmp_path):
    X, _ = _data(500, 4)
    _publish({"shard_rows": 128, "prefetch_depth": 3, "stream_chunk_rows": 64})
    store = st.write_shards(X, str(tmp_path / "s"), max_bins=16, device="cpu")
    assert store.shard_rows == 128
    assert resolve("prefetch_depth", prefetch.DEFAULT_PREFETCH_DEPTH) == 3
    assert resolve("stream_chunk_rows", tt._STREAM_CHUNK_ROWS, n=500) == 64


# ---------------------------------------------------------------------------
# the kernels' plan knobs
# ---------------------------------------------------------------------------

MAIN = (15000, 16, 26, 2, 64, 16)  # n, d, M, C, B, nodes: the main path's level 4


def test_level_knobs_resolve_per_tier():
    assert hk.level_knobs(2) == hk.level_knobs(3) == (hk._LEVEL_ROWS, hk._CTA_HIST_BYTES)
    _publish({"fused_block_rows": 512, "pallas_vmem_budget": 96 * 1024})
    assert hk.level_knobs(2) == (hk._LEVEL_ROWS, 96 * 1024)
    assert hk.level_knobs(3) == (512, hk._CTA_HIST_BYTES)
    with override(fused_block_rows=64):
        assert hk.level_knobs(3, 15000) == (64, hk._CTA_HIST_BYTES)


def test_level_plan_follows_an_override_not_a_stale_plan():
    """The plan cache keys on the knobs: an override after the first call
    gets its own plan, whose row chunking is the shipped R's."""
    base = hk.level_plan(*MAIN, 8)
    assert base.rows == hk._LEVEL_ROWS
    for R in (64, 128, 512):
        with override(fused_block_rows=R):
            plan = hk.level_plan(*MAIN, 8)
            assert plan.rows == R
            assert (plan.cs, plan.rows_per_chunk) == (base.cs, base.rows_per_chunk)
            lane = hk.lane_level_plan(*MAIN, 8, 2)
            assert lane.rows == R
    assert hk.level_plan(*MAIN, 8) == base
    # a 32-bit launch halves R for its wide staged rows, on the pallas knob
    with override(pallas_block_rows=512):
        assert hk.level_plan(*MAIN, 32).rows == 256
    # the budget retiles the features, and with them the chunking
    with override(fused_vmem_budget=64 * 1024):
        narrow = hk.level_plan(*MAIN, 8)
    assert narrow.nf < base.nf and narrow.smem < base.smem


def test_knobs_that_do_not_fit_fall_back_to_the_shipped_ones():
    base = hk.level_plan(*MAIN, 8)
    assert hk.level_plan(*MAIN, 8, (4096, hk._CTA_HIST_BYTES)) == base  # R: tile > 227 KB
    assert hk.level_plan(*MAIN, 8, (80, hk._CTA_HIST_BYTES)) == base  # 80 rows: not 32-row steps
    wide = (15000, 16, 10, 27, 64, 16, 32)  # letter's C=27 forests
    assert hk.level_plan(*wide, (256, 2**20)) == hk.level_plan(*wide, (256, hk._CTA_HIST_BYTES))
    with pytest.raises(ValueError, match="shared memory"):
        hk.level_plan(100, 4, 2, 64, 4096, 1, 32, (64, 2**20))  # nothing fits


def test_cpu_wrappers_ignore_the_knobs():
    rng = np.random.RandomState(0)
    Xb = torch.as_tensor(rng.randint(0, 16, (200, 4)).astype(np.int32))
    node = torch.as_tensor(rng.randint(0, 4, (200, 3)).astype(np.int32))
    vals = torch.as_tensor(rng.randn(200, 3, 2).astype(np.float32))
    a = hk.hist_level_pallas(Xb, node, vals, n_nodes=4, max_bins=16)
    b = hk.hist_level_pallas(Xb, node, vals, n_nodes=4, max_bins=16, knobs=(64, 64 * 1024))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the build cache
# ---------------------------------------------------------------------------


def test_build_cache_directs_build_kernels(tmp_path, monkeypatch):
    """``SE_TPU_COMPILE_CACHE`` moves the kernels' library: a library of
    the current source found there loads without nvcc; another source
    names another library, which then needs nvcc."""
    monkeypatch.setattr(cc, "_ENABLED_DIR", None)
    monkeypatch.delenv(cc.COMPILE_CACHE_ENV, raising=False)
    assert hk.build_dir() == hk._BUILD_DIR and cc.compilation_cache_dir() is None

    def no_nvcc():
        raise AssertionError("nvcc called")

    monkeypatch.setattr(hk, "_nvcc", no_nvcc)
    kc = tmp_path / "kc"
    monkeypatch.setenv(cc.COMPILE_CACHE_ENV, str(kc))
    assert hk.build_dir() == kc and kc.is_dir()
    assert cc.compilation_cache_dir() == str(kc)
    sha = hashlib.sha256(hk._SOURCE.read_bytes()).hexdigest()[:16]
    so = kc / f"libse_hist_{sha}.so"
    so.write_bytes(b"")
    assert hk.build_kernels() == so
    other = tmp_path / "other.cu"
    other.write_text("// another source\n")
    monkeypatch.setattr(hk, "_SOURCE", other)
    with pytest.raises(AssertionError, match="nvcc called"):
        hk.build_kernels()
    # the first enabled directory stays, as in the JAX package
    assert cc.enable_compilation_cache(str(tmp_path / "second"))
    assert cc.compilation_cache_dir() == str(kc)
