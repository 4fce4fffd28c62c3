"""The port's dataset loader (``spark_ensemble_tpu_torch.utils.datasets``)
against the JAX package's, on small libsvm files written here: blank and
``#`` lines, gaps in the 1-based indices, an ``n_features`` that drops
columns; the native C++ parser and the numpy parser; ``load_dataset``'s
label normalisations over a generated ``data_dir``; ``train_test_split``
index for index."""

import os

import numpy as np
import pytest

from spark_ensemble_tpu.utils import datasets as jax_datasets
from spark_ensemble_tpu_torch.utils import _libsvm_native, datasets

FILES = {
    "plain": "1 1:0.5 2:1.5 3:-2\n0 1:1 2:2 3:3\n",
    "blank_and_comments": "# header\n\n1 1:0.25\n   \n# mid\n-1 3:4.5\n\n",
    "gaps": "3 2:1.5 7:-0.125\n1 1:1e-3 4:2.5e2\n2 10:7\n",
    "drop": "1 1:1 2:2 5:5\n0 4:4 6:6\n",
    "no_features": "1\n0 2:1\n",
    "exponents": "0.5 1:1.5E+2 2:-3.25e-4 3:inf\n-2 1:0 3:nan\n",
}

CASES = [("plain", None), ("blank_and_comments", None), ("gaps", None), ("gaps", 5),
         ("drop", 3), ("drop", 8), ("no_features", None), ("exponents", None)]


def _write(tmp_path, name):
    p = tmp_path / f"{name}.svm"
    p.write_text(FILES[name])
    return str(p)


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)  # NaN positions equal too


# the native path raises where it fails; the numpy one is the fallback's;
# the default is parse_libsvm itself
PARSERS = {
    "native": lambda path, n: _libsvm_native.parse_libsvm_native(path, n),
    "numpy": lambda path, n: datasets._parse_numpy(path, n),
    "default": lambda path, n: datasets.parse_libsvm(path, n),
}


@pytest.mark.parametrize("parser", list(PARSERS))
@pytest.mark.parametrize("name,n_features", CASES)
def test_parse_libsvm_equals_the_jax_package(tmp_path, name, n_features, parser):
    path = _write(tmp_path, name)
    want = jax_datasets.parse_libsvm(path, n_features)
    got = PARSERS[parser](path, n_features)
    assert got[0].dtype == np.float32 and got[1].dtype == np.float32
    _same(got, want)


def test_native_and_numpy_paths_agree_on_a_larger_file(tmp_path):
    rng = np.random.default_rng(3)
    lines = []
    for i in range(500):
        idx = np.sort(rng.choice(np.arange(1, 41), rng.integers(0, 12), replace=False))
        feats = " ".join(f"{j}:{rng.standard_normal():.7g}" for j in idx)
        lines.append(f"{rng.integers(-1, 2)} {feats}".strip())
    p = tmp_path / "big.svm"
    p.write_text("\n".join(lines) + "\n")
    a = _libsvm_native.parse_libsvm_native(str(p))
    b = datasets._parse_numpy(str(p), None)
    _same(a, b)
    _same(a, jax_datasets.parse_libsvm(str(p)))


def test_the_native_library_is_built_in_the_ports_build_dir(tmp_path):
    path = _write(tmp_path, "plain")
    _libsvm_native.parse_libsvm_native(path)
    so = _libsvm_native.library_path()
    assert so.exists() and so.name.startswith("libsvm_parser_")
    home = os.path.expanduser("~")
    assert not str(so).startswith(os.path.join(home, ".cache"))


def test_a_failed_native_build_falls_back_and_logs(tmp_path, monkeypatch, caplog):
    path = _write(tmp_path, "gaps")

    def broken():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(_libsvm_native, "_build_lib", broken)
    with pytest.raises(RuntimeError, match="no compiler"):
        _libsvm_native.parse_libsvm_native(path)
    with caplog.at_level("WARNING", logger="spark_ensemble_tpu_torch"):
        got = datasets.parse_libsvm(path)
    _same(got, jax_datasets.parse_libsvm(path))
    assert any("native libsvm parser unavailable" in r.message for r in caplog.records)


def _data_dir(tmp_path):
    rng = np.random.default_rng(0)
    files = {
        "adult/adult.svm": lambda i: rng.choice([-1, 1]),
        "cpusmall/cpusmall.svm": lambda i: round(float(rng.standard_normal() * 10), 3),
        "letter/letter.svm": lambda i: int(rng.integers(1, 27)),
    }
    for rel, label in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True)
        rows = []
        for i in range(40):
            idx = np.sort(rng.choice(np.arange(1, 9), 4, replace=False))
            rows.append(f"{label(i)} " + " ".join(f"{j}:{rng.integers(0, 9) / 4}" for j in idx))
        p.write_text("\n".join(rows) + "\n")
    return str(tmp_path)


@pytest.mark.parametrize("name", ["adult", "cpusmall", "letter"])
def test_load_dataset_equals_the_jax_package(tmp_path, name):
    d = _data_dir(tmp_path)
    got = datasets.load_dataset(name, data_dir=d)
    _same(got, jax_datasets.load_dataset(name, data_dir=d))
    y = got[1]
    if name == "adult":
        assert set(np.unique(y)) <= {0.0, 1.0}
    if name == "letter":
        assert y.min() == 0.0 and y.max() <= 25.0


def test_load_dataset_errors(tmp_path):
    with pytest.raises(KeyError):
        datasets.load_dataset("iris", data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        datasets.load_dataset("adult", data_dir=str(tmp_path))


def test_reference_data_probe(tmp_path, monkeypatch):
    """The same three files as the JAX package's; the default directory is
    the checkout's ``reference/data`` (the JAX package's is a fixed
    absolute path), ``SPARK_ENSEMBLE_REFERENCE_DATA`` overriding both."""
    assert datasets._DATASETS == jax_datasets._DATASETS
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert datasets.REFERENCE_DATA == os.environ.get(
        "SPARK_ENSEMBLE_REFERENCE_DATA", os.path.join(root, "reference", "data"))
    monkeypatch.setattr(datasets, "REFERENCE_DATA", _data_dir(tmp_path))
    assert datasets.has_reference_data()
    monkeypatch.setattr(datasets, "REFERENCE_DATA", str(tmp_path / "absent"))
    assert not datasets.has_reference_data()


@pytest.mark.parametrize("n,frac,seed", [(10, 0.3, 0), (97, 0.25, 5), (200, 0.5, 11)])
def test_train_test_split_equals_the_jax_package(n, frac, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 3)).astype(np.float32)
    y = np.arange(n, dtype=np.float32)  # the labels name each row
    got = datasets.train_test_split(X, y, test_fraction=frac, seed=seed)
    want = jax_datasets.train_test_split(X, y, test_fraction=frac, seed=seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(got[3]) == int(round(n * frac))
