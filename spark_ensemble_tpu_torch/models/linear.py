"""Linear base learners (PyTorch port of ``models/linear.py``): ridge
regression by the normal equations and multinomial logistic regression.

- ``LinearRegression`` standardizes the features and solves the weighted
  ridge normal equations ``(X'WX + reg·I) beta = X'Wy`` by Cholesky.
- ``LogisticRegression`` minimizes weighted multinomial cross-entropy:
  ``solver="newton"`` assembles the exact softmax Hessian (damped Newton
  with halving backtracking); ``solver="lbfgs"`` is a plain-torch L-BFGS
  (memory 10, strong-Wolfe line search) where the JAX package runs
  optax's, with the same stopping rule; ``"auto"`` picks newton when
  ``(d+1)*k <= 1024``.  The two L-BFGS codes take different line-search
  steps, so they meet at the optimum of the (strictly convex) objective,
  not iterate by iterate.

Feature subspace masks multiply into X at fit and at predict (the params
carry the mask).  The solvers' loops run on the host and read one device
scalar per condition, as ``ops/linesearch.py`` does.
"""

from __future__ import annotations

import torch

from spark_ensemble_tpu_torch.models.base import (
    BaseLearner,
    ClassificationModel,
    RegressionModel,
)
from spark_ensemble_tpu_torch.ops.collective import preduce
from spark_ensemble_tpu_torch.params import Param, gt_eq, in_array

# parameter-count ceiling of the exact-Hessian Newton path under
# solver="auto": above it L-BFGS takes over
_NEWTON_MAX_PARAMS = 1024
_LBFGS_MEMORY = 10


def _apply_mask(X, feature_mask):
    if feature_mask is None:
        return X
    return X * feature_mask.to(X.dtype)[None, :]


def _mask_vector(feature_mask, d, device):
    if feature_mask is None:
        return torch.ones((d,), dtype=torch.float32, device=device)
    return feature_mask.to(torch.float32)


def _feature_stats(X, w, axis_name=None):
    """Weighted per-feature mean and std; constant (or masked) columns get
    sd=1, so they contribute nothing and stay solvable.  Under a mesh the
    moments are reduced over ``axis_name``."""
    wsum, wx = preduce([torch.sum(w)[None], torch.sum(w[:, None] * X, dim=0)],
                       axis_name)
    wsum = torch.clamp(wsum[0], min=1e-30)
    mu = wx / wsum
    var = preduce(torch.sum(w[:, None] * (X - mu[None, :]) ** 2, dim=0),
                  axis_name) / wsum
    sd = torch.sqrt(var)
    sd = torch.where(sd > 1e-7 * (1.0 + torch.abs(mu)), sd, torch.ones_like(sd))
    return mu, sd


class LinearRegression(BaseLearner):
    reg_param = Param(1e-6, gt_eq(0.0), doc="L2 ridge strength")
    fit_intercept = Param(True, doc="learn a bias column")

    is_classifier = False

    def fit_from_ctx(self, ctx, y, w, feature_mask, key=None, axis_name=None):
        X = _apply_mask(ctx, feature_mask)
        n, d = X.shape
        # standardize (as Spark's LinearRegression does): f32 normal
        # equations on raw-scale data would lose the small features
        mu, sd = _feature_stats(X, w, axis_name)
        Xs = (X - mu[None, :]) / sd[None, :]
        if self.fit_intercept:
            Xs = torch.cat([Xs, torch.ones((n, 1), dtype=X.dtype, device=X.device)], dim=1)
        Xw = Xs * w[:, None]
        A, b = preduce([Xs.T @ Xw, Xw.T @ y], axis_name)
        A = A + (self.reg_param + 1e-6) * torch.eye(
            Xs.shape[1], dtype=X.dtype, device=X.device
        )
        L, _ = torch.linalg.cholesky_ex(A)
        beta = torch.cholesky_solve(b[:, None], L)[:, 0]
        coef_s = beta[:d]
        icpt_s = beta[d] if self.fit_intercept else torch.zeros((), device=X.device)
        coef = coef_s / sd
        intercept = icpt_s - torch.sum(coef * mu)
        return {"coef": coef, "intercept": intercept,
                "mask": _mask_vector(feature_mask, d, X.device)}

    def predict_fn(self, params, X):
        return (X * params["mask"][None, :]) @ params["coef"] + params["intercept"]

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None):
        return LinearRegressionModel(
            params=params, num_features=num_features, device=device,
            **self.get_params(),
        )


class LinearRegressionModel(RegressionModel, LinearRegression):
    def predict(self, X):
        return self.predict_fn(self.params, self._input(X))


def _wolfe_step(fg, x, f0, g0, d, c1=1e-4, c2=0.9, max_evals=25):
    """Strong-Wolfe line search along ``d`` from ``x`` (Nocedal & Wright,
    algorithms 3.5 and 3.6, with a safeguarded quadratic zoom) ->
    ``(t, f, g)`` at the accepted step, or None when ``d`` does not
    descend or no step decreases ``f``."""
    dphi0 = float(g0 @ d)
    f0 = float(f0)
    if not dphi0 < 0.0:
        return None
    evals = [0]

    def phi(t):
        evals[0] += 1
        f, g = fg(x + t * d)
        return t, float(f), float(g @ d), f, g

    def zoom(lo, hi):
        # lo, hi: (t, f, dphi, f_tensor, g_tensor) bracketing a Wolfe step
        while evals[0] < max_evals:
            t_lo, f_lo, dp_lo = lo[:3]
            t_hi, f_hi = hi[0], hi[1]
            span = t_hi - t_lo
            denom = 2.0 * (f_hi - f_lo - dp_lo * span)
            t = t_lo - dp_lo * span * span / denom if denom > 0 else t_lo + 0.5 * span
            lo_b, hi_b = sorted((t_lo + 0.1 * span, t_hi - 0.1 * span))
            t = min(max(t, lo_b), hi_b)
            cur = phi(t)
            if cur[1] > f0 + c1 * t * dphi0 or cur[1] >= f_lo:
                hi = cur
            else:
                if abs(cur[2]) <= -c2 * dphi0:
                    return cur
                if cur[2] * span >= 0:
                    hi = lo
                lo = cur
        return lo if lo[0] > 0 else None

    prev = (0.0, f0, dphi0, None, g0)
    t = 1.0
    while evals[0] < max_evals:
        cur = phi(t)
        if cur[1] > f0 + c1 * t * dphi0 or (prev[0] > 0 and cur[1] >= prev[1]):
            out = zoom(prev, cur)
            break
        if abs(cur[2]) <= -c2 * dphi0:
            out = cur
            break
        if cur[2] >= 0:
            out = zoom(cur, prev)
            break
        prev, t = cur, 2.0 * t
    else:
        out = prev if prev[0] > 0 else None
    if out is None or not out[1] < f0:
        return None
    return out[0], out[3], out[4]


def _lbfgs_minimize(fg, x0, max_iter: int, tol: float):
    """L-BFGS (memory 10, strong-Wolfe steps) on a flat parameter vector
    from ``x0``; ``fg(x) -> (f, g)``.  Runs while ``count == 0 or (count <
    max_iter and ||g|| >= tol)``, the JAX package's rule around optax."""
    x = x0
    f, g = fg(x)
    s_hist, y_hist = [], []
    count = 0
    while count == 0 or (count < max_iter and float(torch.linalg.vector_norm(g)) >= tol):
        # two-loop recursion: d = -H g
        q = g.clone()
        alphas = []
        for s, yv in zip(reversed(s_hist), reversed(y_hist)):
            rho = 1.0 / (yv @ s)
            a = rho * (s @ q)
            q = q - a * yv
            alphas.append((rho, a))
        if s_hist:
            q = q * ((s_hist[-1] @ y_hist[-1]) / (y_hist[-1] @ y_hist[-1]))
        for (s, yv), (rho, a) in zip(zip(s_hist, y_hist), reversed(alphas)):
            q = q + s * (a - rho * (yv @ q))
        direction = -q
        step = _wolfe_step(fg, x, f, g, direction)
        if step is None and s_hist:
            # a stale curvature memory: restart from steepest descent
            s_hist, y_hist = [], []
            direction = -g
            step = _wolfe_step(fg, x, f, g, direction)
        count += 1
        if step is None:
            break
        t, f_new, g_new = step
        s, yv = t * direction, g_new - g
        if float(s @ yv) > 1e-10:
            s_hist.append(s)
            y_hist.append(yv)
            if len(s_hist) > _LBFGS_MEMORY:
                s_hist.pop(0)
                y_hist.pop(0)
        x, f, g = x + s, f_new, g_new
    return x


def _damped_newton(fval, grad_step, x0, max_iter: int, tol: float):
    """Damped Newton: halving backtracking to the first decrease (up to 20
    steps), gradient-norm convergence, stop when no step decreases ``fval``.
    ``grad_step(x) -> (g, step)`` supplies the gradient and Newton step."""
    x, f = x0, fval(x0)
    for _ in range(max_iter):
        g, step = grad_step(x)
        converged = torch.linalg.vector_norm(g) <= tol * (1.0 + torch.abs(f))
        t = 1.0
        fc = fval(x + step)
        conv, accepted = torch.stack([converged, fc < f]).tolist()
        j = 1
        while not accepted and j < 20:
            t *= 0.5
            fc = fval(x + t * step)
            accepted = bool(fc < f)
            j += 1
        if conv or not accepted:
            break
        x, f = x + t * step, fc
    return x


def _solve_ridged(H, g, reg_vec):
    """Newton step from a possibly ill-conditioned f32 Hessian (the
    softmax's null direction, rare standardized binary columns): a
    diagonal-scaled ridge and an LU solve."""
    dim = H.shape[0]
    ridge = 1e-5 * torch.diagonal(H) + 1e-7 * torch.trace(H) / dim
    H = H + torch.diag(reg_vec + ridge)
    return -torch.linalg.solve(H, g)


def _newton_multinomial(Xs, onehot, w_norm, reg, max_iter, tol, fit_intercept,
                        axis_name=None):
    """Damped Newton for weighted multinomial cross-entropy with the exact
    softmax Hessian ``sum_i w_i x_i x_i' (x) (diag(p_i) - p_i p_i')``.  With
    ``fit_intercept`` the last column of ``Xs`` is ones and its row of
    ``theta`` the unpenalized intercept.  Binary problems solve the sigmoid
    form on ``d1`` parameters and return the symmetric softmax solution.
    Under a mesh the data terms of the objective, gradient and Hessian are
    reduced over ``axis_name``; the penalty is added once, after."""
    red = lambda v: preduce(v, axis_name)  # noqa: E731
    n, d1 = Xs.shape
    k = onehot.shape[1]
    dev = Xs.device
    reg_diag = torch.full((d1,), reg, dtype=torch.float32, device=dev)
    if fit_intercept:
        reg_diag[-1] = 0.0  # no penalty on the intercept row

    if k == 2:
        # the softmax optimum splits beta = c1 - c0 symmetrically, so its
        # penalty on beta is reg/4 |beta|^2: match it
        reg_b = 0.5 * reg_diag
        y1 = onehot[:, 1]

        def fval_b(beta):
            f = Xs @ beta
            ce = torch.logaddexp(f, torch.zeros_like(f)) - y1 * f
            return red(torch.sum(w_norm * ce)) + 0.5 * torch.sum(reg_b * beta**2)

        def grad_step_b(beta):
            p1 = torch.sigmoid(Xs @ beta)
            s = w_norm * p1 * (1.0 - p1)
            g, H = red([Xs.T @ (w_norm * (p1 - y1)), (Xs * s[:, None]).T @ Xs])
            g = g + reg_b * beta
            return g, _solve_ridged(H, g, reg_b)

        beta = _damped_newton(
            fval_b, grad_step_b, torch.zeros((d1,), dtype=torch.float32, device=dev),
            max_iter, tol,
        )
        return torch.stack([-0.5 * beta, 0.5 * beta], dim=1)

    def fval(theta):
        logits = Xs @ theta
        ce = -torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1)
        return (red(torch.sum(w_norm * ce))
                + 0.5 * torch.sum(reg_diag[:, None] * theta**2))

    def grad_step(theta):
        p = torch.softmax(Xs @ theta, dim=-1)  # [n, k]
        # H[(a,c),(b,e)] = sum_i w x_a x_b (d_ce p_c - p_c p_e), by GEMMs
        Xw = Xs * w_norm[:, None]
        U = (Xs[:, :, None] * p[:, None, :]).reshape(n, d1 * k)
        Uw = (Xw[:, :, None] * p[:, None, :]).reshape(n, d1 * k)
        g, Mdiag, UU = red([Xs.T @ (w_norm[:, None] * (p - onehot)), Xw.T @ U,
                            Uw.T @ U])
        g = g + reg_diag[:, None] * theta
        Mdiag = Mdiag.reshape(d1, d1, k)  # the c == e part
        H = -UU.reshape(d1, k, d1, k)
        ii = torch.arange(k, device=dev)
        H[:, ii, :, ii] += torch.movedim(Mdiag, 2, 0)
        H = H.reshape(d1 * k, d1 * k)
        reg_vec = reg_diag[:, None].expand(d1, k).reshape(-1)
        step = _solve_ridged(H, g.reshape(-1), reg_vec).reshape(d1, k)
        return g, step

    return _damped_newton(
        fval, grad_step, torch.zeros((d1, k), dtype=torch.float32, device=dev),
        max_iter, tol,
    )


class LogisticRegression(BaseLearner):
    reg_param = Param(1e-6, gt_eq(0.0), doc="L2 penalty")
    fit_intercept = Param(True, doc="learn a bias column")
    max_iter = Param(100, gt_eq(1), doc="solver iteration cap")
    tol = Param(1e-6, gt_eq(0.0), doc="gradient-norm convergence tolerance")
    solver = Param(
        "auto",
        in_array(["auto", "newton", "lbfgs"]),
        doc="auto | newton | lbfgs: newton assembles the exact softmax-CE "
        "Hessian (fast for small d*k, e.g. stackers); auto picks newton "
        "when (d+1)*k <= 1024",
    )

    is_classifier = True

    def make_fit_ctx(self, X, num_classes=None):
        return {"X": X, "num_classes": num_classes}

    def ctx_row_leaves(self, ctx):
        return {"X": True, "num_classes": False}

    def fit_from_ctx(self, ctx, y, w, feature_mask, key=None, axis_name=None):
        X = _apply_mask(ctx["X"], feature_mask)
        k = int(ctx["num_classes"])
        n, d = X.shape
        dev = X.device
        fit_icpt = bool(self.fit_intercept)
        red = lambda v: preduce(v, axis_name)  # noqa: E731
        mu, sd = _feature_stats(X, w, axis_name)
        if not fit_icpt:
            # scale-only standardization: centering would smuggle an
            # implicit intercept into a no-intercept model
            mu = torch.zeros_like(mu)
        Xs = (X - mu[None, :]) / sd[None, :]
        onehot = torch.nn.functional.one_hot(y.to(torch.int64), k).to(torch.float32)
        w_norm = w / torch.clamp(red(torch.sum(w)), min=1e-30)
        reg = float(self.reg_param)

        solver = self.solver.lower()
        if solver == "auto":
            solver = "newton" if (d + 1) * k <= _NEWTON_MAX_PARAMS else "lbfgs"
        if solver == "newton":
            Xn = (torch.cat([Xs, torch.ones((n, 1), dtype=Xs.dtype, device=dev)], dim=1)
                  if fit_icpt else Xs)
            th = _newton_multinomial(Xn, onehot, w_norm, reg, int(self.max_iter),
                                     float(self.tol), fit_icpt, axis_name)
            coef_s = th[:d]
            icpt_s = th[d] if fit_icpt else torch.zeros((k,), device=dev)
        else:
            icpt_scale = 1.0 if fit_icpt else 0.0

            def fg(theta):
                coef, icpt = theta[: d * k].reshape(d, k), theta[d * k:]
                logits = Xs @ coef + icpt_scale * icpt[None, :]
                logp = torch.log_softmax(logits, dim=-1)
                r = w_norm[:, None] * (torch.exp(logp) - onehot)
                f, g_coef, g_icpt = red([
                    torch.sum(w_norm * -torch.sum(onehot * logp, dim=-1))[None],
                    Xs.T @ r, torch.sum(r, dim=0)])
                f = f[0] + 0.5 * reg * torch.sum(coef**2)
                g_coef = g_coef + reg * coef
                g_icpt = icpt_scale * g_icpt
                return f, torch.cat([g_coef.reshape(-1), g_icpt])

            theta = _lbfgs_minimize(
                fg, torch.zeros((d * k + k,), dtype=torch.float32, device=dev),
                int(self.max_iter), float(self.tol),
            )
            coef_s, icpt_s = theta[: d * k].reshape(d, k), theta[d * k:]
        coef = coef_s / sd[:, None]
        intercept = (icpt_s - (mu / sd) @ coef_s if fit_icpt
                     else torch.zeros((k,), dtype=torch.float32, device=dev))
        return {"coef": coef, "intercept": intercept,
                "mask": _mask_vector(feature_mask, d, dev)}

    def predict_raw_fn(self, params, X):
        return (X * params["mask"][None, :]) @ params["coef"] + params["intercept"][None, :]

    def predict_proba_fn(self, params, X):
        return torch.softmax(self.predict_raw_fn(params, X), dim=-1)

    def predict_fn(self, params, X):
        return torch.argmax(self.predict_raw_fn(params, X), dim=-1).to(torch.float32)

    def model_from_params(self, params, num_features, num_classes=None,
                          device=None):
        return LogisticRegressionModel(
            params=params, num_features=num_features,
            num_classes=num_classes or 2, device=device, **self.get_params(),
        )


class LogisticRegressionModel(ClassificationModel, LogisticRegression):
    def predict_proba(self, X):
        return self.predict_proba_fn(self.params, self._input(X))

    def predict_raw(self, X):
        return self.predict_raw_fn(self.params, self._input(X))

    def predict(self, X):
        return self.predict_fn(self.params, self._input(X))
