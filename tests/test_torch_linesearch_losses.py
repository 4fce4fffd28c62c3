"""PyTorch port parity: GBM losses and line searches
(``spark_ensemble_tpu_torch/ops/{losses,linesearch}.py`` vs the JAX
package's).  Elementwise float32 math in both packages, reductions in
different orders: allclose at 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_ensemble_tpu.ops import linesearch as jl
from spark_ensemble_tpu.ops import losses as jlo
from spark_ensemble_tpu_torch.ops import linesearch as tl
from spark_ensemble_tpu_torch.ops import losses as tlo

TOL = dict(rtol=1e-5, atol=1e-5)


def _problem(name, n=300, K=5, seed=0):
    rng = np.random.RandomState(seed)
    if name == "squared":
        y = rng.randn(n).astype(np.float32)
        pred = rng.randn(n, 1).astype(np.float32)
        dirs = rng.randn(n, 1).astype(np.float32)
        return jlo.SquaredLoss(), tlo.SquaredLoss(), y, pred, dirs
    y = rng.randint(0, K, size=n).astype(np.float32)
    pred = rng.randn(n, K).astype(np.float32)
    dirs = rng.randn(n, K).astype(np.float32)
    return jlo.LogLoss(K), tlo.LogLoss(K), y, pred, dirs


@pytest.mark.parametrize("name", ["squared", "logloss"])
def test_loss_gradient_hessian_and_linesearch_terms(name):
    jloss, tloss, y, pred, dirs = _problem(name)
    bag_w = np.random.RandomState(1).rand(len(y)).astype(np.float32)
    label_j = jloss.encode_label(jnp.asarray(y))
    label_t = tloss.encode_label(torch.as_tensor(y))
    np.testing.assert_array_equal(label_t.numpy(), np.asarray(label_j))
    P, D = jnp.asarray(pred), jnp.asarray(dirs)
    Pt, Dt = torch.as_tensor(pred), torch.as_tensor(dirs)
    for fn in ("loss", "gradient", "negative_gradient", "hessian"):
        np.testing.assert_allclose(
            getattr(tloss, fn)(label_t, Pt).numpy(),
            np.asarray(getattr(jloss, fn)(label_j, P)), **TOL, err_msg=fn,
        )
    jg, jh = jloss.linesearch_grad_hess(label_j, P, D, jnp.asarray(bag_w))
    tg, th = tloss.linesearch_grad_hess(label_t, Pt, Dt, torch.as_tensor(bag_w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-4)
    if name == "logloss":
        np.testing.assert_allclose(
            tloss.raw2probability(Pt).numpy(),
            np.asarray(jloss.raw2probability(P)), **TOL,
        )


@pytest.mark.parametrize(
    "factory,name,want",
    [
        (tlo.get_regression_loss, "huber", tlo.HuberLoss),
        (tlo.get_regression_loss, "absolute", tlo.AbsoluteLoss),
        (tlo.get_regression_loss, "nope", ValueError),
        (tlo.get_classification_loss, "bernoulli", tlo.BernoulliLoss),
        (tlo.get_classification_loss, "nope", ValueError),
    ],
)
def test_loss_factories(factory, name, want):
    if issubclass(want, Exception):
        with pytest.raises(want):
            factory(name)
    else:
        assert isinstance(factory(name.upper()), want)
    assert isinstance(tlo.get_regression_loss("Squared"), tlo.SquaredLoss)
    assert tlo.get_classification_loss("logloss", 7).dim == 7


def test_chol_solve_psd_matches():
    rng = np.random.RandomState(2)
    A = rng.randn(6, 6).astype(np.float32)
    A = A @ A.T + 0.5 * np.eye(6, dtype=np.float32)
    b = rng.randn(6).astype(np.float32)
    np.testing.assert_allclose(
        tl.chol_solve_psd(torch.as_tensor(A), torch.as_tensor(b)).numpy(),
        np.asarray(jl.chol_solve_psd(jnp.asarray(A), jnp.asarray(b))),
        rtol=1e-4, atol=1e-5,
    )


@pytest.mark.parametrize("center", [0.0, 3.7, 55.0, 150.0])
def test_brent_minimize_matches(center):
    """On a polynomial objective both packages evaluate bit-identical f32
    values, so the Brent trajectories, and the minimizers, agree; with a
    transcendental term the objective is flat to f32 resolution near the
    minimum, so the two minimizers are held by their objective values."""
    def poly(a):
        return 1.5 * (a - center) ** 2 + 0.25 * a

    want = float(jl.brent_minimize(poly, 0.0, 100.0, tol=1e-6, max_iter=100))
    got = float(tl.brent_minimize(poly, 0.0, 100.0, tol=1e-6, max_iter=100))
    np.testing.assert_allclose(got, want, **TOL)

    want = jl.brent_minimize(lambda a: poly(a) + jnp.log1p(a), 0.0, 100.0)
    got = tl.brent_minimize(lambda a: poly(a) + torch.log1p(a), 0.0, 100.0)
    np.testing.assert_allclose(
        float(poly(got) + torch.log1p(got)),
        float(poly(want) + jnp.log1p(want)), rtol=1e-6,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_projected_newton_box_matches_on_the_logloss_step(seed):
    """The classifier's step-size problem: minimize the bag-weighted
    logloss along per-class directions over [0, inf)^K.  The first Newton
    iterations agree to 1e-5; once the objective is flat to f32 resolution
    an accept/reject can go either way in either package, so the solutions
    are held by their objective values (rtol 1e-6)."""
    jloss, tloss, y, pred, dirs = _problem("logloss", seed=seed)
    bag_w = np.ones(len(y), np.float32)
    x0 = np.ones(pred.shape[1], np.float32)
    lj, lt = jloss.encode_label(jnp.asarray(y)), tloss.encode_label(torch.as_tensor(y))
    Pj, Dj, Wj = jnp.asarray(pred), jnp.asarray(dirs), jnp.asarray(bag_w)
    Pt, Dt, Wt = torch.as_tensor(pred), torch.as_tensor(dirs), torch.as_tensor(bag_w)

    def phi_j(a):
        return jnp.sum(Wj * jloss.loss(lj, Pj + a[None, :] * Dj))

    def phi_t(a):
        return torch.sum(Wt * tloss.loss(lt, Pt + a[None, :] * Dt))

    def gh_j(a):
        return jloss.linesearch_grad_hess(lj, Pj + a[None, :] * Dj, Dj, Wj)

    def gh_t(a):
        return tloss.linesearch_grad_hess(lt, Pt + a[None, :] * Dt, Dt, Wt)

    for it in (1, 2):
        want = jl.projected_newton_box(phi_j, jnp.asarray(x0), max_iter=it,
                                       tol=1e-6, grad_hess=gh_j)
        got = tl.projected_newton_box(phi_t, torch.as_tensor(x0), max_iter=it,
                                      tol=1e-6, grad_hess=gh_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jl.projected_newton_box(phi_j, jnp.asarray(x0), max_iter=25,
                                   tol=1e-6, grad_hess=gh_j)
    got = tl.projected_newton_box(phi_t, torch.as_tensor(x0), max_iter=25,
                                  tol=1e-6, grad_hess=gh_t)
    assert (got.numpy() >= 0).all()
    np.testing.assert_allclose(float(phi_t(got)), float(phi_j(want)), rtol=1e-6)


def test_projected_newton_box_needs_closed_form_grad_hess():
    with pytest.raises(NotImplementedError):
        tl.projected_newton_box(lambda a: a.sum(), torch.ones(3))
