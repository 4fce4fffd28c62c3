"""Packed export of the PyTorch port (``spark_ensemble_tpu_torch/serving/
export.py``), case for case with the JAX package's export tests where the
case exists in the port, plus the cross-package contract: an artifact
saved by either package's ``PackedModel.save`` loads in the other.

Tolerances: within the port a packed model predicts with the live model's
own tensors, so predictions are EQUAL (``torch.equal``), after save/load
and offload too.  Across packages the loaded model holds the very arrays
the other package wrote (split tables equal), and outputs are held within
1e-5 (probabilities) or 1e-5 of the label scale, the persistence tests'
bound (tests/test_torch_persist.py), which covers the f32 sums each
package takes in its own order.  The quality sidecar is integer and f32
data carried as written: equal.
"""

import json
import os

import numpy as np
import pytest
import torch

import spark_ensemble_tpu as se
import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.serving import export as jexport
from spark_ensemble_tpu_torch.serving import PACKED_FORMAT_VERSION, fit_resume, load_packed, pack
from spark_ensemble_tpu_torch.serving.export import PackedModel


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    X = rng.randn(400, 6).astype(np.float32)
    yr = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(400)).astype(np.float32)
    ym = np.digitize(X[:, 0] + X[:, 1], [-1, 0, 1]).astype(np.float32)
    return X, yr, ym


def _tree(pkg, cls="DecisionTreeRegressor"):
    return getattr(pkg, cls)(max_depth=3, max_bins=16)


def _families(pkg):
    return {
        "gbm_r": (pkg.GBMRegressor(num_base_learners=4, base_learner=_tree(pkg)), "r"),
        "gbm_c": (pkg.GBMClassifier(num_base_learners=3, base_learner=_tree(pkg)), "c"),
        "boost_r": (pkg.BoostingRegressor(num_base_learners=3, base_learner=_tree(pkg)), "r"),
        "boost_c": (pkg.BoostingClassifier(
            num_base_learners=3, base_learner=_tree(pkg, "DecisionTreeClassifier")), "c"),
        "bag_r": (pkg.BaggingRegressor(num_base_learners=3, base_learner=_tree(pkg)), "r"),
        "bag_c": (pkg.BaggingClassifier(
            num_base_learners=3, base_learner=_tree(pkg, "DecisionTreeClassifier")), "c"),
        "stack_r": (pkg.StackingRegressor(
            base_learners=[_tree(pkg), pkg.LinearRegression()],
            stacker=pkg.LinearRegression()), "r"),
        "stack_c": (pkg.StackingClassifier(
            base_learners=[_tree(pkg, "DecisionTreeClassifier"), pkg.GaussianNaiveBayes()],
            stacker=pkg.LogisticRegression(max_iter=30), stack_method="proba"), "c"),
    }


def _fit(family, data, pkg=st):
    X, yr, ym = data
    est, kind = _families(pkg)[family]
    y = yr if kind == "r" else ym
    if pkg is st:
        return est.fit(X, y, device="cpu"), kind
    return est.fit(X, y), kind


def _outputs(model, X, kind):
    out = model.predict_proba(X) if kind == "c" else model.predict(X)
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _assert_same_outputs(a, b, X, kind):
    assert torch.equal(a.predict(X), b.predict(X))
    if kind == "c":
        assert torch.equal(a.predict_proba(X), b.predict_proba(X))


@pytest.mark.parametrize("family", sorted(_families(st)))
def test_pack_predicts_bit_for_bit(tmp_path, data, family):
    """A packed model, and its save/load round trip, predict like the live
    model, bit for bit."""
    X = data[0]
    model, kind = _fit(family, data)
    packed = pack(model)
    assert packed.class_name == type(model).__name__
    assert packed.num_features == X.shape[1]
    assert packed.is_classifier == (kind == "c")
    assert packed.nbytes == sum(a.nbytes for a in packed.device_arrays().values())
    assert packed.array_names == sorted(packed.device_arrays())
    _assert_same_outputs(packed, model, X, kind)
    path = str(tmp_path / family)
    packed.save(path)
    loaded = load_packed(path, device="cpu")
    assert loaded.node == json.loads(json.dumps(packed.node))
    _assert_same_outputs(loaded, model, X, kind)


def test_save_is_atomic_and_manifested(tmp_path, data):
    packed = pack(_fit("gbm_c", data)[0])
    path = str(tmp_path / "art")
    packed.save(path)
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json", "packed.json"]
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == PACKED_FORMAT_VERSION
    assert set(manifest["files"]) == {"arrays.npz", "packed.json"}
    packed.save(path)  # overwrite in place
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".packed-tmp-")]


def _saved(tmp_path, data):
    path = str(tmp_path / "art")
    pack(_fit("gbm_r", data)[0]).save(path)
    return path


def test_load_rejects_a_corrupt_artifact(tmp_path, data):
    path = _saved(tmp_path, data)
    p = os.path.join(path, "arrays.npz")
    with open(p, "r+b") as f:
        f.seek(os.path.getsize(p) // 2)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(ValueError, match="checksum"):
        load_packed(path, device="cpu")


def test_load_rejects_a_missing_manifest_or_payload(tmp_path, data):
    path = _saved(tmp_path, data)
    os.remove(os.path.join(path, "arrays.npz"))
    with pytest.raises(ValueError, match="missing"):
        load_packed(path, device="cpu")
    os.remove(os.path.join(path, "manifest.json"))
    with pytest.raises(FileNotFoundError, match="manifest"):
        load_packed(path, device="cpu")


@pytest.mark.parametrize("key,value,match", [
    ("format_version", PACKED_FORMAT_VERSION + 1, "format_version"),
    ("kind", "something.else", "kind"),
])
def test_load_rejects_version_skew_and_foreign_kinds(tmp_path, data, key, value, match):
    """A re-sealed manifest over a changed ``packed.json``: the checksums
    pass, the version or kind check refuses it."""
    from spark_ensemble_tpu_torch.utils.checkpoint import _file_sha256

    path = _saved(tmp_path, data)
    meta_path = os.path.join(path, "packed.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta[key] = value
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    mf_path = os.path.join(path, "manifest.json")
    with open(mf_path) as f:
        manifest = json.load(f)
    manifest["files"]["packed.json"] = {"sha256": _file_sha256(meta_path),
                                        "bytes": os.path.getsize(meta_path)}
    with open(mf_path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match=match):
        load_packed(path, device="cpu")


def test_offload_and_reupload(data):
    X = data[0]
    model, kind = _fit("gbm_c", data)
    packed = pack(model)
    first = packed.predict_proba(X)
    packed.offload()
    assert packed._model is None and not packed.on_device()
    assert all(a.device.type == "cpu" for a in packed._arrays.values())
    assert torch.equal(packed.predict_proba(X), first)
    assert packed.ensure_device() is packed
    assert torch.equal(packed.predict_proba(X), first)


@pytest.mark.parametrize("family", ["gbm_r", "gbm_c", "boost_r", "boost_c"])
def test_take_equals_the_models_prefix(data, family):
    X = data[0]
    model, kind = _fit(family, data)
    packed = pack(model)
    prefix = packed.take(2)
    assert prefix.num_members == 2
    _assert_same_outputs(prefix, model.take(2), X, kind)
    with pytest.raises(ValueError, match="out of range"):
        packed.take(model.num_members + 1)


@pytest.mark.parametrize("family", ["bag_c", "stack_r"])
def test_take_and_fit_resume_need_stagewise_families(data, family):
    packed = pack(_fit(family, data)[0])
    with pytest.raises(TypeError, match="prefix"):
        packed.take(1)
    with pytest.raises(TypeError, match="stagewise"):
        fit_resume(packed, data[0], data[1], 1)
    with pytest.raises(TypeError, match="fitted Model"):
        pack(st.GBMRegressor())


@pytest.mark.parametrize("family", ["gbm_r", "gbm_c"])
def test_fit_resume_equals_the_longer_fit(data, family):
    """``fit_resume(pack(k-round model), n)`` packs the ``k + n``-round fit,
    bit for bit."""
    X, yr, ym = data
    est, kind = _families(st)[family]
    y = yr if kind == "r" else ym
    short = est.copy(num_base_learners=2).fit(X, y, device="cpu")
    full = est.copy(num_base_learners=4).fit(X, y, device="cpu")
    resumed = fit_resume(pack(short), X, y, 2)
    assert isinstance(resumed, PackedModel) and resumed.num_members == 4
    _assert_same_outputs(resumed, full, X, kind)


def _quality(pm):
    q = pm.quality
    return None if q is None else (q["thresholds"], q["occupancy"], q["rows"])


@pytest.mark.parametrize("family", ["gbm_r", "gbm_c", "bag_c", "stack_c"])
def test_jax_artifact_loads_in_the_port(tmp_path, data, family):
    """A JAX ``pack(...).save`` artifact loads in the port with outputs
    within 1e-5; its quality sidecar (the JAX GBM models carry one) is
    read, survives a port save, and loads back in the JAX package."""
    X, yr, _ = data
    jm, kind = _fit(family, data, se)
    jpacked = jexport.pack(jm)
    path = str(tmp_path / "jax")
    jpacked.save(path)
    tp = load_packed(path, device="cpu")
    assert tp.class_name == jpacked.class_name and tp.num_members == jpacked.num_members
    scale = np.abs(yr).max() if kind == "r" else 1.0
    np.testing.assert_allclose(_outputs(tp, X, kind), _outputs(jm, X, kind),
                               rtol=0, atol=1e-5 * scale)
    jq = jpacked.quality
    assert (jq is None) == (tp.quality is None) and (jq is None) == (family not in ("gbm_r", "gbm_c"))
    again = str(tmp_path / "port")
    tp.save(again)
    back = jexport.load_packed(again)
    if jq is not None:
        for a, b in zip(_quality(tp), (jq["thresholds"], jq["occupancy"], jq["rows"])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_quality(back), _quality(tp)):
            np.testing.assert_array_equal(a, b)
        prefix = tp.take(1)
        assert prefix.quality is not None and prefix.quality["rows"] == jq["rows"]
    np.testing.assert_allclose(_outputs(back, X, kind), _outputs(jm, X, kind),
                               rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("family", sorted(_families(st)))
def test_port_artifact_loads_in_the_jax_package(tmp_path, data, family):
    """A port artifact loads in the JAX package: same class, split tables
    as written, outputs within 1e-5, and the GBM models' quality sidecar
    (every port GBM fit captures ``drift_ref_``) as written."""
    X, yr, _ = data
    tm, kind = _fit(family, data)
    path = str(tmp_path / family)
    pack(tm).save(path)
    jp = jexport.load_packed(path)
    assert jp.class_name == type(tm).__name__
    assert (jp.quality is None) == (family not in ("gbm_r", "gbm_c"))
    if jp.quality is not None:
        for a, b in zip(_quality(pack(tm)), (jp.quality["thresholds"],
                                             jp.quality["occupancy"],
                                             jp.quality["rows"])):
            np.testing.assert_array_equal(a, b)
    scale = np.abs(yr).max() if kind == "r" else 1.0
    np.testing.assert_allclose(_outputs(jp, X, kind), _outputs(tm, X, kind),
                               rtol=0, atol=1e-5 * scale)


def test_load_packed_defaults_to_the_card(tmp_path, data):
    """Like every port entry point, load_packed serves on CUDA unless told
    otherwise: without a card it raises instead of falling back."""
    path = _saved(tmp_path, data)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        load_packed(path)
