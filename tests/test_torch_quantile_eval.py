"""PyTorch port parity: the weighted median and quantile
(``spark_ensemble_tpu_torch/utils/quantile.py`` vs the local path of
``utils/quantile.py``) and the evaluators (``evaluation.py``).

The median and quantile select an element, so they are held exactly, on
ties, zero weights and q at 0 and 1.  Weights are dyadic, so the
cumulative sums are exact in any order.  The evaluators' metrics are held
within 1e-6 on the same predictions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_ensemble_tpu.evaluation as jev
import spark_ensemble_tpu_torch.evaluation as tev
from spark_ensemble_tpu.utils import quantile as jq
from spark_ensemble_tpu_torch.utils import quantile as tq


def _values(seed, n, ties, zero_frac):
    rng = np.random.RandomState(seed)
    v = (rng.randint(0, 6, n) if ties else rng.randn(n) * 3).astype(np.float32)
    w = (rng.randint(0, 9, n) / 4.0).astype(np.float32)
    w[: int(n * zero_frac)] = 0.0
    w[-1] = max(w[-1], 0.25)  # a positive total
    return v, w


CASES = [(0, 1, False, 0.0), (1, 7, True, 0.0), (2, 101, True, 0.3),
         (3, 100, False, 0.5), (4, 64, True, 0.9)]


@pytest.mark.parametrize("seed,n,ties,zero_frac", CASES)
def test_weighted_median_equals_jax(seed, n, ties, zero_frac):
    v, w = _values(seed, n, ties, zero_frac)
    want = np.asarray(jq.weighted_median(jnp.asarray(v), jnp.asarray(w)))
    got = tq.weighted_median(torch.as_tensor(v), torch.as_tensor(w)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n,ties,zero_frac", CASES)
def test_weighted_quantile_equals_jax(seed, n, ties, zero_frac):
    v, w = _values(seed, n, ties, zero_frac)
    for q in (0.0, 0.1, 0.5, 0.75, 1.0):
        want = np.asarray(jq.weighted_quantile(jnp.asarray(v), q, jnp.asarray(w)))
        got = tq.weighted_quantile(torch.as_tensor(v), q, torch.as_tensor(w)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"q={q}")
    qs = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    np.testing.assert_array_equal(
        tq.weighted_quantile(torch.as_tensor(v), torch.as_tensor(qs)).numpy(),
        np.asarray(jq.weighted_quantile(jnp.asarray(v), jnp.asarray(qs))),
    )


def test_row_median_equals_jax_vmap():
    """Drucker's median vote: one weight vector over the members of every
    row, as the JAX package vmaps ``weighted_median`` over rows."""
    rng = np.random.RandomState(5)
    preds = rng.randint(0, 4, size=(9, 203)).astype(np.float32)  # [m, n], ties
    weights = (rng.randint(0, 5, 9) / 2.0).astype(np.float32)
    want = np.asarray(jax.vmap(jq.weighted_median, in_axes=(1, None))(
        jnp.asarray(preds), jnp.asarray(weights)))
    got = tq.weighted_median_rows(torch.as_tensor(preds.T), torch.as_tensor(weights))
    np.testing.assert_array_equal(got.numpy(), want)


class _Fixed:
    """A stand-in model that returns fixed predictions and probabilities
    as its package's arrays."""

    def __init__(self, pred, proba, num_classes, to):
        self._pred, self._proba, self.num_classes, self._to = pred, proba, num_classes, to

    def predict(self, X):
        return self._to(self._pred)

    def predict_proba(self, X):
        return self._to(self._proba)


def _pair(pred, proba=None, num_classes=None):
    return (_Fixed(pred, proba, num_classes, jnp.asarray),
            _Fixed(pred, proba, num_classes, torch.as_tensor))


def _weights(n, weighted):
    if not weighted:
        return None
    return (np.random.RandomState(9).randint(0, 5, n) / 2.0).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", ["rmse", "mse", "mae", "r2", "var"])
def test_regression_evaluator_matches(metric, weighted):
    rng = np.random.RandomState(1)
    y = rng.randn(301).astype(np.float32)
    pred = (y + 0.3 * rng.randn(301)).astype(np.float32)
    jm, tm = _pair(pred)
    w = _weights(301, weighted)
    want = jev.RegressionEvaluator(metric=metric).evaluate(jm, None, y, w)
    got = tev.RegressionEvaluator(metric=metric).evaluate(tm, None, y, w)
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    assert (tev.RegressionEvaluator(metric=metric).is_larger_better
            == jev.RegressionEvaluator(metric=metric).is_larger_better)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize(
    "metric",
    ["f1", "accuracy", "weightedPrecision", "weightedRecall", "logLoss", "hammingLoss"],
)
def test_multiclass_evaluator_matches(metric, weighted):
    rng = np.random.RandomState(2)
    k, n = 5, 400
    y = rng.randint(0, k, n).astype(np.float32)
    proba = rng.dirichlet(np.ones(k), n).astype(np.float32)
    proba[:3] = np.eye(k, dtype=np.float32)[:3]  # exact 0 and 1: the eps clamp
    pred = np.argmax(proba, axis=1).astype(np.float32)
    jm, tm = _pair(pred, proba, k)
    w = _weights(n, weighted)
    want = jev.MulticlassClassificationEvaluator(metric=metric).evaluate(jm, None, y, w)
    got = tev.MulticlassClassificationEvaluator(metric=metric).evaluate(tm, None, y, w)
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric", ["areaUnderROC", "areaUnderPR"])
def test_binary_evaluator_matches(metric, weighted):
    rng = np.random.RandomState(3)
    n = 300
    y = rng.randint(0, 2, n).astype(np.float32)
    score = np.round(np.clip(0.3 * y + 0.7 * rng.rand(n), 0, 1), 1)  # tied scores
    proba = np.stack([1 - score, score], axis=1).astype(np.float32)
    jm, tm = _pair(None, proba, 2)
    w = _weights(n, weighted)
    want = jev.BinaryClassificationEvaluator(metric=metric).evaluate(jm, None, y, w)
    got = tev.BinaryClassificationEvaluator(metric=metric).evaluate(tm, None, y, w)
    assert abs(got - want) <= 1e-6
