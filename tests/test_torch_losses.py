"""PyTorch port parity: the seven GBM losses ported after squared and
logloss (``spark_ensemble_tpu_torch/ops/losses.py`` vs ``ops/losses.py``).

The same seeded numpy labels and predictions go through both packages.
Every function is elementwise float32 math (exp, log1p, tanh, sign) in
both, so values agree to rtol 1e-6; atol 4 ulp of 1.0 (4.8e-7) covers
terms that cancel to near zero (``1 - tanh^2`` at large residuals, where
the two libraries' tanh may differ by an ulp near 1).  The reductions
(``aggregate_loss``, the line-search sums) add in different orders: rtol
1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_ensemble_tpu.ops import losses as jlo
from spark_ensemble_tpu_torch.ops import losses as tlo

TOL = dict(rtol=1e-6, atol=4 * 2.0**-23)
SUM_TOL = dict(rtol=1e-5, atol=1e-5)

REGRESSION = [
    ("absolute", {}),
    ("logcosh", {}),
    ("scaledlogcosh", {"alpha": 0.8}),
    ("huber", {"delta": 0.7}),
    ("quantile", {"quantile": 0.9}),
]
CLASSIFICATION = ["exponential", "bernoulli"]


def _losses(name, kw):
    if name in CLASSIFICATION:
        return jlo.get_classification_loss(name), tlo.get_classification_loss(name)
    return jlo.get_regression_loss(name, **kw), tlo.get_regression_loss(name, **kw)


def _inputs(name, n=400, seed=0):
    rng = np.random.RandomState(seed)
    if name in CLASSIFICATION:
        y = rng.randint(0, 2, size=n).astype(np.float32)
    else:
        y = (3.0 * rng.randn(n)).astype(np.float32)
    pred = (2.0 * rng.randn(n, 1)).astype(np.float32)
    dirs = rng.randn(n, 1).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    return y, pred, dirs, w


@pytest.mark.parametrize("name,kw", REGRESSION + [(c, {}) for c in CLASSIFICATION])
def test_loss_matches_the_reference(name, kw):
    jloss, tloss = _losses(name, kw)
    assert (tloss.name, tloss.has_hessian, tloss.dim) == (
        jloss.name, jloss.has_hessian, jloss.dim
    )
    y, pred, dirs, w = _inputs(name)
    lj, lt = jloss.encode_label(jnp.asarray(y)), tloss.encode_label(torch.as_tensor(y))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    P, Pt = jnp.asarray(pred), torch.as_tensor(pred)
    fns = ["loss", "gradient", "negative_gradient", "sampling_scores"]
    if jloss.has_hessian:
        fns.append("hessian")
    for fn in fns:
        np.testing.assert_allclose(
            getattr(tloss, fn)(lt, Pt).numpy(),
            np.asarray(getattr(jloss, fn)(lj, P)), **TOL, err_msg=fn,
        )
    np.testing.assert_allclose(
        float(tlo.aggregate_loss(tloss, lt, torch.as_tensor(w), Pt)),
        float(jlo.aggregate_loss(jloss, lj, jnp.asarray(w), P)), **SUM_TOL,
    )
    jgh = jloss.linesearch_grad_hess(lj, P, jnp.asarray(dirs), jnp.asarray(w))
    tgh = tloss.linesearch_grad_hess(lt, Pt, torch.as_tensor(dirs), torch.as_tensor(w))
    if jgh is None:
        assert tgh is None
    else:
        for a, b in zip(tgh, jgh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **SUM_TOL)
    if name in CLASSIFICATION:
        # the composed (-f, f) raw vector, as the classifier model builds it
        raw = np.concatenate([-pred, pred], axis=1)
        np.testing.assert_allclose(
            tloss.raw2probability(torch.as_tensor(raw)).numpy(),
            np.asarray(jloss.raw2probability(jnp.asarray(raw))), **TOL,
        )


def test_classification_sign_conventions():
    """Bernoulli reads P(y=1) = sigmoid(f), exponential sigmoid(-2f), on the
    raw vector (-f, f): the reference's composed mappings, kept as they are."""
    f = torch.tensor([[0.5]])
    raw = torch.cat([-f, f], dim=1)
    p_b = tlo.BernoulliLoss().raw2probability(raw)[0, 1]
    p_e = tlo.ExponentialLoss().raw2probability(raw)[0, 1]
    assert float(p_b) == pytest.approx(float(torch.sigmoid(f)))
    assert float(p_e) == pytest.approx(float(torch.sigmoid(-2.0 * f)))


@pytest.mark.parametrize(
    "cfg",
    [{"name": "squared"}, {"name": "absolute"}, {"name": "logcosh"},
     {"name": "scaledlogcosh", "alpha": 0.3}, {"name": "huber", "delta": 2.5},
     {"name": "quantile", "quantile": 0.25}, {"name": "logloss", "num_classes": 5},
     {"name": "exponential"}, {"name": "bernoulli"}],
)
def test_loss_from_config_round_trips(cfg):
    """``loss_from_config`` inverts ``config()`` in the port, and reads the
    JAX package's configs into the same losses."""
    tloss = tlo.loss_from_config(cfg)
    assert tloss.config() == cfg
    assert tlo.loss_from_config(jlo.loss_from_config(cfg).config()).config() == cfg
    assert type(tloss).__name__ == type(jlo.loss_from_config(cfg)).__name__
