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

The projected Newton search runs over lanes (``projected_newton_box_lanes``):
a megabatch sweep searches every candidate's step at once, with one host
sync per iteration for all of them, and a fit is its one-lane case.  Each
lane's objective, gradient, hessian and Newton solve run on the lane's own
tensors with the one-lane search's own calls, so a lane equals its own
search bit for bit.  The solve is the library Cholesky (``chol_solve_psd``)
one lane at a time: the JAX package's Crout arithmetic
(``chol_solve_psd_lanes``, masked vector ops over every lane) runs about
750 dependent kernels a solve at 26 class dims, and on an H100 it took a
quarter of the main path's fit rate.
"""

from __future__ import annotations

from typing import Callable, Sequence

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


def chol_solve_psd_lanes(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A[i] x[i] = b[i]`` for a batch of small SPD matrices ``A
    [..., k, k]`` by the JAX package's ``chol_solve_psd`` arithmetic: a
    Cholesky-Crout factorization and two triangular solves, each step a
    masked vector op over every lane at once.  A lane whose matrix is not
    positive definite comes out NaN instead of raising (a square root of a
    negative pivot), so the caller can replace it (the linear leaves fall
    back to the constant leaf there)."""
    k = A.shape[-1]
    idx = torch.arange(k, device=A.device)
    L = torch.zeros_like(A)
    for j in range(k):
        prior = (idx < j).to(A.dtype)
        s = A[..., :, j] - torch.sum(L * (L[..., j, :] * prior)[..., None, :], dim=-1)
        dj = torch.sqrt(s[..., j])[..., None]
        L[..., :, j] = torch.where(idx == j, dj, torch.where(idx > j, s / dj, 0.0))
    y = torch.zeros_like(b)
    for i in range(k):  # L y = b
        prior = (idx < i).to(A.dtype)
        y[..., i] = (b[..., i] - torch.sum(L[..., i, :] * y * prior, dim=-1)) / L[..., i, i]
    x = torch.zeros_like(b)
    for i in range(k - 1, -1, -1):  # L^T x = y
        later = (idx > i).to(A.dtype)
        x[..., i] = (y[..., i] - torch.sum(L[..., :, i] * x * later, dim=-1)) / L[..., i, i]
    return x


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
    """Minimize ``f`` over the box ``x >= lower`` by projected Newton:
    ``projected_newton_box_lanes`` over one lane.  ``grad_hess(x) -> (g,
    H)`` is required: the losses supply it in closed form
    (``linesearch_grad_hess``)."""
    return projected_newton_box_lanes(
        [f], x0[None], lower, max_iter, tol, num_backtracks,
        None if grad_hess is None else [grad_hess],
    )[0]


def projected_newton_box_lanes(
    fs: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    x0: torch.Tensor,
    lower: float = 0.0,
    max_iter: int = 20,
    tol: float = 1e-6,
    num_backtracks: int = 15,
    grad_hess: Sequence[Callable] = None,
) -> torch.Tensor:
    """Minimize every lane's ``fs[s]`` over the box ``x >= lower`` from
    ``x0[s]`` (``x0 [S, k]``) by projected Newton -> ``x [S, k]``.

    Active set = coordinates pinned at the bound with inward-pointing
    gradient; the Newton system is solved on the free set with a small
    ridge; steps backtrack by first-success halving.  ``grad_hess[s](x) ->
    (g, H)`` is required: the losses supply it in closed form.

    Each lane keeps its own iteration, convergence, acceptance and
    backtrack count, and a finished lane is frozen where the one-lane
    search stops.  Objectives, gradients, hessians and solves run per lane
    on the lane's own tensors; the projections and steps are elementwise
    ops over the live lanes.  One host read
    per Newton iteration covers every live lane, and one per backtracking
    step every lane still backtracking."""
    if grad_hess is None:
        raise NotImplementedError(
            "projected_newton_box needs grad_hess: autodiff hessians are "
            "not ported (ROADMAP queue 1, item 3)"
        )

    def proj(x):
        return torch.clamp(x, min=lower)

    S = x0.shape[0]
    xs = [proj(x0[s]) for s in range(S)]
    fxs = [fs[s](xs[s]) for s in range(S)]
    live = list(range(S))
    for _ in range(max_iter):
        if not live:
            break
        gh = [grad_hess[s](xs[s]) for s in live]
        x = torch.stack([xs[s] for s in live])
        g = torch.stack([a for a, _ in gh])
        H = torch.stack([b for _, b in gh])
        fx = torch.stack([fxs[s] for s in live])
        free = ~((x <= lower + 1e-12) & (g > 0))
        fm = free.to(x.dtype)
        converged = torch.amax(torch.abs(g * fm), dim=1) <= tol * (1.0 + torch.abs(fx))
        Hm = H * fm[:, :, None] * fm[:, None, :] + torch.diag_embed(
            torch.where(free, 1e-6, 1.0).to(x.dtype)
        )
        gm = g * fm
        step = -torch.stack([chol_solve_psd(Hm[i], gm[i]) for i in range(len(live))]) * fm
        fc = [fs[s](proj(xs[s] + step[i])) for i, s in enumerate(live)]
        # one read for every live lane's two conditions
        flags = torch.stack(
            [converged, torch.stack(fc) < fx]
        ).tolist()
        t = [1.0] * len(live)
        j = [1] * len(live)
        accepted = flags[1]
        # `not (fc < fx)`: a NaN objective counts as "not accepted"
        back = [i for i in range(len(live))
                if not flags[0][i] and not accepted[i] and j[i] < num_backtracks]
        while back:
            for i in back:
                t[i] *= 0.5
                fc[i] = fs[live[i]](proj(xs[live[i]] + t[i] * step[i]))
                j[i] += 1
            ok = torch.stack([fc[i] < fxs[live[i]] for i in back]).tolist()
            for i, a in zip(back, ok):
                accepted[i] = a
            back = [i for i in back if not accepted[i] and j[i] < num_backtracks]
        still = []
        for i, s in enumerate(live):
            if flags[0][i] or not accepted[i]:
                continue  # converged, or no step decreases f: frozen here
            xs[s] = proj(xs[s] + t[i] * step[i])
            fxs[s] = fc[i]
            still.append(s)
        live = still
    return torch.stack(xs)
