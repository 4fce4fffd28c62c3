"""The GBM models' sum over rounds (``models/gbm.py::_weighted_round_sum``)
does not depend on how many rows share a call: a row's bits at n = 1 equal
its bits inside a batch, so a one-row request served by the engine or the
fleet equals the same row in a batch, bit for bit.  The sum is a fixed
pairwise tree of elementwise adds over the rounds; on the CPU here and on
the card (``chip_smoke.py``'s ``serving`` phase requires n = 1 too).
Against a float64 reference it is within float32 rounding (rtol 1e-6)."""

import numpy as np
import pytest
import torch

import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu_torch.models.gbm import _weighted_round_sum


def _stack(rounds, dim, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((rounds, dim), generator=g)
    p = torch.randn((rounds, dim, n), generator=g)
    return w, p


def test_one_row_equals_row_zero_of_a_batch_100_rounds_26_classes():
    w, p = _stack(100, 26, 4096)
    batch = _weighted_round_sum(w, p)
    one = _weighted_round_sum(w, p[..., :1].contiguous())
    assert batch.shape == (26, 4096) and one.shape == (26, 1)
    assert torch.equal(one[:, 0], batch[:, 0])


@pytest.mark.parametrize("rounds", [1, 2, 3, 7, 64, 100])
@pytest.mark.parametrize("n", [1, 5, 8, 257])
def test_every_row_equals_its_batch_row(rounds, n):
    w, p = _stack(rounds, 3, 300, seed=rounds)
    batch = _weighted_round_sum(w, p)
    part = _weighted_round_sum(w, p[..., :n].contiguous())
    assert torch.equal(part, batch[:, :n])
    for i in (0, n - 1):
        assert torch.equal(_weighted_round_sum(w, p[..., i:i + 1]), batch[:, i:i + 1])


@pytest.mark.parametrize("rounds", [1, 5, 100])
def test_regressor_layout_and_float64_reference(rounds):
    g = torch.Generator().manual_seed(1)
    w, p = torch.randn((rounds,), generator=g), torch.randn((rounds, 50), generator=g)
    out = _weighted_round_sum(w, p)
    ref = (w.double()[:, None] * p.double()).sum(0)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(_weighted_round_sum(w, p[:, :1]), out[:1])


def test_classifier_predict_proba_one_row_equals_batch():
    rng = np.random.RandomState(0)
    X = rng.randn(200, 5).astype(np.float32)
    y = np.argmax(X @ rng.randn(5, 6).astype(np.float32), axis=1).astype(np.float32)
    m = st.GBMClassifier(base_learner=st.DecisionTreeRegressor(max_depth=2),
                         num_base_learners=5).fit(X, y, device="cpu")
    batch = m.predict_proba(X)
    for i in (0, 17, 199):
        assert torch.equal(m.predict_proba(X[i:i + 1])[0], batch[i])
