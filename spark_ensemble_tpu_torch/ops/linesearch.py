"""Line-search optimizers for GBM step sizes (PyTorch port of
``ops/linesearch.py``).

- 1-D: Brent minimization over a bracket (reference: commons-math
  ``BrentOptimizer``), used by regression losses without a closed-form
  step.
- K-dim: projected Newton over the box ``x >= lower`` (reference: breeze
  ``LBFGSB``), the classifier's per-round step sizes.

The JAX package runs both as ``lax.while_loop``s inside one device
program.  Here they are Python loops: each loop condition reads a device
scalar, which costs one host sync per Newton iteration and per extra
backtracking step.  That is the bring-up form; moving the loop onto the
device is a later speed item (ROADMAP).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_CGOLD = 0.3819660112501051  # golden-section fraction


def chol_solve_psd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for small SPD ``A`` by Cholesky.  The JAX package
    hand-rolls the factorization so a ``vmap``-ed sweep stays bit-stable;
    the port has no vmap, so the library factorization serves (results
    agree allclose).  ``cholesky_ex`` skips the error check that would
    sync with the device."""
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b[:, None], L)[:, 0]


def brent_minimize(
    f: Callable[[torch.Tensor], torch.Tensor],
    lo: float,
    hi: float,
    tol: float = 1e-6,
    max_iter: int = 100,
) -> torch.Tensor:
    """Classic Brent minimization (golden section + parabolic steps), the
    JAX package's update rules with its float32 bookkeeping kept in numpy
    float32 scalars.  NaN objective values count as +inf."""
    f32 = np.float32

    def f_safe(x):
        fx = f32(float(f(torch.tensor(x, dtype=torch.float32))))
        return f32(np.inf) if np.isnan(fx) else fx

    tol = f32(tol)
    a, b = f32(lo), f32(hi)
    x = a + f32(_CGOLD) * (b - a)
    w = v = x
    fx = fw = fv = f_safe(x)
    d = e = f32(0.0)
    for _ in range(max_iter):
        m = f32(0.5) * (a + b)
        tol1 = tol * abs(x) + tol
        tol2 = f32(2.0) * tol1
        # as in the JAX loop, the iteration that detects convergence
        # still takes its step; the loop stops after it
        done = abs(x - m) <= tol2 - f32(0.5) * (b - a)
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q = f32(2.0) * (q - r)
        p = -p if q > 0 else p
        q = abs(q)
        etemp = e
        use_para = (
            abs(p) < abs(f32(0.5) * q * etemp)
            and p > q * (a - x)
            and p < q * (b - x)
            and q != 0.0
        )
        d_para = p / q if q != 0.0 else f32(0.0)
        u_para = x + d_para
        if (u_para - a < tol2) or (b - u_para < tol2):
            d_para = f32(np.sign(m - x)) * tol1 + (tol1 if m == x else f32(0.0))
        e_gold = (a - x) if x >= m else (b - x)
        d_gold = f32(_CGOLD) * e_gold
        e = etemp if use_para else e_gold
        d = d_para if use_para else d_gold
        u = x + d if abs(d) >= tol1 else x + f32(np.sign(d)) * tol1
        fu = f_safe(u)
        if fu <= fx:
            if u >= x:
                a = x
            else:
                b = x
            v, fv, w, fw = w, fw, x, fx
            x, fx = u, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, fv, w, fw = w, fw, u, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
        if done:
            break
    return torch.tensor(x, dtype=torch.float32)


def projected_newton_box(
    f: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lower: float = 0.0,
    max_iter: int = 20,
    tol: float = 1e-6,
    num_backtracks: int = 15,
    grad_hess: Callable = None,
) -> torch.Tensor:
    """Minimize ``f`` over the box ``x >= lower`` by projected Newton.

    Active set = coordinates pinned at the bound with inward-pointing
    gradient; the Newton system is solved on the free set with a small
    ridge; steps backtrack by first-success halving.  ``grad_hess(x) ->
    (g, H)`` is required: the losses supply it in closed form
    (``linesearch_grad_hess``)."""
    if grad_hess is None:
        raise NotImplementedError(
            "projected_newton_box needs grad_hess: autodiff hessians are "
            "not ported (ROADMAP queue 1, item 3)"
        )

    def proj(x):
        return torch.clamp(x, min=lower)

    x = proj(x0)
    fx = f(x)
    for _ in range(max_iter):
        g, H = grad_hess(x)
        free = ~((x <= lower + 1e-12) & (g > 0))
        fm = free.to(x.dtype)
        converged = torch.max(torch.abs(g * fm)) <= tol * (1.0 + torch.abs(fx))
        Hm = H * fm[:, None] * fm[None, :] + torch.diag(
            torch.where(free, 1e-6, 1.0).to(x.dtype)
        )
        step = -chol_solve_psd(Hm, g * fm) * fm
        t = 1.0
        fc = f(proj(x + step))
        # one sync for both conditions of this iteration
        conv, accepted = torch.stack([converged, fc < fx]).tolist()
        if conv:
            break
        j = 1
        # `not (fc < fx)`: a NaN objective counts as "not accepted"
        while not accepted and j < num_backtracks:
            t *= 0.5
            fc = f(proj(x + t * step))
            accepted = bool(fc < fx)
            j += 1
        if not accepted:
            break
        x = proj(x + t * step)
        fx = fc
    return x
