"""Plain reference of the GBM fit that the cells drive.

Plain PyTorch, in float64 wherever a sum is taken; it imports nothing of
the port, of JAX or of the JAX package, and takes from the program only
the outputs it judges (a fitted model's trees and step weights).  Everything the program derives from the inputs
(thresholds, bin ids, routes, histograms, leaf sums, step sizes) is
worked out here again.

The fit is checked round by round from the program's own state: the
predictions before round ``r`` are the sum of the program's first ``r``
trees, each routed here, at the program's step weights.  From them the
reference works out the round's gradient statistics, and, following the
program's splits level by level, every node's histogram, its best split
and the gain of the split the program took, every leaf value, and the
step the line search should find.  The start is worked out from the
data alone: the quantile thresholds, which the program's splits are
compared with bit for bit, and the prior, which the reference takes as
its own (the program's is not read, so a wrong one shows in round 0's
leaves and step).

Definitions the program is held to:

- thresholds: ``jnp.quantile(X, (i+1)/B, axis=0)`` by its 'linear' rule,
  positions ``q * (n-1)`` in float32, the interpolation
  ``low * (1-w) + f32(high * w)`` rounded once to float32;
- bin id: the number of a feature's thresholds strictly below the value;
  a split at bin ``b`` sends a row left iff its bin is at most ``b``;
- GBM round (Newton updates, unit row weights): from the loss's gradient
  ``g`` and hessian ``h`` per raw score (softmax logloss, or the logistic
  ``bernoulli`` loss on one raw score), targets ``-g/max(h, 0.01)`` and
  tree weights ``0.5 max(h, 0.01) / sum max(h, 0.01)``;
  a node's statistics are the weights and the weighted targets centred at
  the tree's root mean; a split's gain is
  ``S_L^2/W_L + S_R^2/W_R - S^2/W``; a leaf is its weighted mean (an
  empty one takes its parent's), plus the root mean;
- step: the minimiser over ``a >= 0`` of the summed loss of
  ``F + a * direction``, per raw score; the round's weight is
  ``learning_rate * a``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

F64 = torch.float64
_FLOOR = 1e-12


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------


def quantile_thresholds(X: torch.Tensor, max_bins: int) -> torch.Tensor:
    """``f32[d, max_bins - 1]``: the thresholds of the module docstring."""
    n = X.shape[0]
    dev = X.device
    q = torch.arange(1, max_bins, dtype=torch.float32, device=dev) / max_bins
    pos = q * torch.tensor(float(n - 1), dtype=torch.float32, device=dev)
    low = torch.floor(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    lo = low.to(torch.int64).clamp(0, n - 1)
    hi = torch.ceil(pos).to(torch.int64).clamp(0, n - 1)
    cols = []
    for f in range(X.shape[1]):  # one column at a time: a sorted copy is n values
        s = torch.sort(X[:, f]).values
        hh = (s[hi] * w_high).to(F64)  # float32 product, then exact in float64
        cols.append((s[lo].to(F64) * w_low.to(F64) + hh).to(torch.float32))
    return torch.stack(cols)


def bin_ids(X: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """``u8[n, d]``: per value, the count of its feature's thresholds
    strictly below it."""
    out = torch.empty(X.shape, dtype=torch.uint8, device=X.device)
    for f in range(X.shape[1]):
        out[:, f] = torch.searchsorted(thresholds[f].contiguous(), X[:, f].contiguous(),
                                       right=False).to(torch.uint8)
    return out


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def leaf_of(bins: torch.Tensor, split_feature: torch.Tensor, split_bin: torch.Tensor) -> torch.Tensor:
    """Leaf index ``i64[n]`` of every row in one heap-layout tree
    (``2^D - 1`` internal nodes), routed on bin ids."""
    J = split_feature.shape[0]
    depth = (J + 1).bit_length() - 1
    sf, sb = split_feature.long(), split_bin.long()
    node = torch.zeros(bins.shape[0], dtype=torch.long, device=bins.device)
    for _ in range(depth):
        b = bins.gather(1, sf[node][:, None])[:, 0].long()
        node = 2 * node + 1 + (b > sb[node]).long()
    return node - J


def _bincount(idx: torch.Tensor, weights: torch.Tensor, size: int) -> torch.Tensor:
    return torch.bincount(idx, weights=weights, minlength=size)[:size]


def level_histograms(bins, node, n_nodes, max_bins, w, wy, block=7):
    """``(HW, HS) f64[n_nodes, d, B]``: per node, feature and bin, the sums
    of the weights and of the weighted targets."""
    n, d = bins.shape
    B = max_bins
    HW = torch.empty((n_nodes, d, B), dtype=F64, device=bins.device)
    HS = torch.empty_like(HW)
    for f0 in range(0, d, block):
        nf = min(d, f0 + block) - f0
        cell = (node[:, None] * nf + torch.arange(nf, device=bins.device)[None, :]) * B
        key = (cell + bins[:, f0:f0 + nf].long()).reshape(-1)
        size = n_nodes * nf * B
        HW[:, f0:f0 + nf] = _bincount(key, w[:, None].expand(n, nf).reshape(-1), size).view(n_nodes, nf, B)
        HS[:, f0:f0 + nf] = _bincount(key, wy[:, None].expand(n, nf).reshape(-1), size).view(n_nodes, nf, B)
        del cell, key
    return HW, HS


def split_gains(HW, HS, Wn, Sn):
    """``(gain, valid) [n_nodes, d, B-1]`` of every candidate split."""
    cw, cs = HW.cumsum(-1)[..., :-1], HS.cumsum(-1)[..., :-1]
    W, S = Wn[:, None, None], Sn[:, None, None]
    wr, sr = W - cw, S - cs
    gain = (cs * cs / cw.clamp(min=_FLOOR) + sr * sr / wr.clamp(min=_FLOOR)
            - S * S / W.clamp(min=_FLOOR))
    return gain, (cw > _FLOOR) & (wr > _FLOOR)


# ---------------------------------------------------------------------------
# the fit, round by round
# ---------------------------------------------------------------------------


class Softmax:
    """K-class softmax logloss on one-hot labels (``loss="logloss"``)."""

    def __init__(self, y: torch.Tensor, K: int):
        self.Y = torch.nn.functional.one_hot(y.long(), K).to(F64)
        self.K = K
        counts = torch.bincount(y.long(), minlength=K).to(F64)
        self.init = torch.log((counts / counts.sum()).clamp(min=1e-30))

    def grad_hess_rows(self, Z):
        P = torch.softmax(Z, dim=1)
        return P - self.Y, P * (1.0 - P)

    def total(self, Z) -> float:
        return float(torch.sum(torch.logsumexp(Z, dim=1) - torch.sum(self.Y * Z, dim=1)))

    def step_grad_hess(self, Z, D):
        """Gradient and hessian of ``a -> total(Z + a * D)`` at ``a = 0``."""
        P = torch.softmax(Z, dim=1)
        PD = P * D
        return (torch.sum((P - self.Y) * D, dim=0),
                torch.diag(torch.sum(P * D * D, dim=0)) - PD.T @ PD)


class Bernoulli:
    """Logistic loss ``log(1 + exp(-2 y' f))`` on labels ``y' = 2y - 1``, one
    raw score a row (``loss="bernoulli"``), starting at the prior's
    log-odds."""

    def __init__(self, y: torch.Tensor, K: int = 1):
        self.s = (2.0 * y.to(F64) - 1.0)[:, None]
        self.K = 1
        p1 = torch.mean(y.to(F64))
        self.init = torch.log(p1.clamp(min=1e-30) / (1.0 - p1).clamp(min=1e-30))[None]

    def grad_hess_rows(self, Z):
        e = torch.exp(2.0 * self.s * Z)
        return -2.0 * self.s / (1.0 + e), 4.0 * e * self.s * self.s / (1.0 + e) ** 2

    def total(self, Z) -> float:
        return float(torch.sum(torch.nn.functional.softplus(-2.0 * self.s * Z)))

    def step_grad_hess(self, Z, D):
        g, h = self.grad_hess_rows(Z)
        return torch.sum(g * D, dim=0), torch.sum(h * D * D, dim=0)[:, None]


LOSSES = {"logloss": Softmax, "bernoulli": Bernoulli}


def step_search(loss, F, D, iters=200):
    """``f64[K]``: a minimiser over ``a >= 0`` of ``loss.total(F + a * D)``:
    projected Newton on the exact hessian with a small ridge (two class
    dims of a binary softmax move the probabilities along one line, so
    there the minimiser is not unique and the hessian singular) and
    halving backtracking, until no step lowers the objective."""
    K = F.shape[1]
    a = torch.ones(K, dtype=F64, device=F.device)
    fa = loss.total(F + a * D)
    eye = torch.eye(K, dtype=F64, device=F.device)
    for _ in range(iters):
        G, H = loss.step_grad_hess(F + a * D, D)
        free = (~((a <= 0) & (G > 0))).to(F64)
        Hf = H * free[:, None] * free[None, :] + eye * (1e-9 * float(H.diagonal().max()) + (1 - free))
        step = -torch.linalg.solve(Hf, G * free) * free
        t, improved = 1.0, False
        for _ in range(60):
            cand = (a + t * step).clamp(min=0.0)
            fc = loss.total(F + cand * D)
            if fc < fa:
                improved = True
                break
            t *= 0.5
        if not improved:
            break
        done = fa - fc <= 1e-15 * abs(fa)
        a, fa = cand, fc
        if done:
            break
    return a


def step_suboptimality(loss, F, D, a_prog) -> float:
    """How far the program's step falls short of the best: ``(phi(a_prog)
    - phi(a*)) / (phi(0) - phi(a*))``, 0 at the optimum and 1 for no step
    at all, whatever minimiser ``a*`` the search finds when it is not
    unique."""
    a_ref = step_search(loss, F, D)
    f_ref = loss.total(F + a_ref * D)
    drop = loss.total(F) - f_ref
    gap = loss.total(F + a_prog * D) - f_ref
    return max(0.0, gap / drop) if drop > 0 else (0.0 if gap <= 0 else math.inf)


def _rel(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den``, 0 where both are 0."""
    return torch.where(num == 0, torch.zeros_like(num), num / den.clamp(min=1e-300))


def check_fit(X, y, model: Dict[str, torch.Tensor], *, loss: str, num_classes: int,
              max_bins: int, learning_rate: float, check_rounds: Iterable[int]) -> Dict[str, float]:
    """Numbers that judge one fitted model (``model``: the program's
    ``split_feature``, ``split_bin``, ``split_threshold``, ``split_gain``
    ``[R, K, 2^D - 1]``, ``leaf_value [R, K, 2^D]``, ``weights [R, K]``;
    ``K`` is the loss's raw scores a row)
    against the reference, over the rounds ``check_rounds``:

    - ``thr_mismatch``: split thresholds (every round) not equal, bit for
      bit, to the reference's threshold of their feature and bin;
    - ``split_gap``: the most by which a node's best gain exceeds the gain
      of the split the program took, over the node's scale ``Q`` (the
      weighted sum of squared centred targets of its rows, which bounds
      every gain of the node);
    - ``gain_err``: the most by which a split's gain as the program stored
      it differs from the reference's gain of that split, over ``Q``;
    - ``leaf_err``: the most by which a leaf value differs, over the
      larger of the reference leaf's magnitude and the tree's median;
    - ``step_subopt``: the most by which a round's step (weight over the
      learning rate) falls short of the best step, as a share of the drop
      in the objective that the best step gives (:func:`step_suboptimality`)."""
    B = max_bins
    sf, sb = model["split_feature"], model["split_bin"]
    R, _, J = sf.shape
    depth = (J + 1).bit_length() - 1
    thr_ref = quantile_thresholds(X, B)
    split = sb < B - 1
    f_used, b_used = sf.long()[split], sb.long()[split].clamp(max=B - 2)
    ref_at = thr_ref[f_used, b_used]
    prog_at = model["split_threshold"][split]
    out = {"thr_mismatch": float(torch.sum(ref_at.view(torch.int32) != prog_at.view(torch.int32)))}
    bins = bin_ids(X, thr_ref)
    del thr_ref
    n = X.shape[0]
    L = LOSSES[loss](y, num_classes)
    K = L.K
    F = L.init[None, :].expand(n, K).clone()
    weights = model["weights"].to(F64)
    leaf_values = model["leaf_value"].to(F64)
    todo = sorted(set(int(r) for r in check_rounds))
    gap = gain_err = leaf_err = step = 0.0
    for r in range(max(todo) + 1):
        leaves = [leaf_of(bins, sf[r, k], sb[r, k]) for k in range(K)]
        D = torch.stack([leaf_values[r, k][leaves[k]] for k in range(K)], dim=1)
        if r in todo:
            g, h = L.grad_hess_rows(F)
            h = h.clamp(min=1e-2)
            targets = -g / h
            tw = 0.5 * h / h.sum(dim=0, keepdim=True)
            for k in range(K):
                g, e, lf = _check_tree(bins, targets[:, k], tw[:, k], sf[r, k], sb[r, k],
                                       model["split_gain"][r, k], model["leaf_value"][r, k],
                                       B, depth)
                gap, gain_err, leaf_err = max(gap, g), max(gain_err, e), max(leaf_err, lf)
            step = max(step, step_suboptimality(L, F, D, weights[r] / learning_rate))
        F += weights[r][None, :] * D
    out.update(split_gap=gap, gain_err=gain_err, leaf_err=leaf_err, step_subopt=step)
    return out


def _check_tree(bins, yv, w, sf, sb, prog_gain, prog_leaf, B, depth):
    """``(split_gap, gain_err, leaf_err)`` of one tree fitted to targets
    ``yv`` at weights ``w``, following the program's splits."""
    wtot = torch.sum(w)
    ymean = torch.sum(w * yv) / wtot
    yc = yv - ymean
    wy, q = w * yc, w * yc * yc
    sf, sb = sf.long(), sb.long()
    node = torch.zeros(bins.shape[0], dtype=torch.long, device=bins.device)
    parent_val = torch.zeros(1, dtype=F64, device=bins.device)
    gap = err = 0.0
    for level in range(depth):
        nn = 2**level
        heap = slice(nn - 1, 2 * nn - 1)
        Wn, Sn, Qn = (_bincount(node, v, nn) for v in (w, wy, q))
        HW, HS = level_histograms(bins, node, nn, B, w, wy)
        gain, valid = split_gains(HW, HS, Wn, Sn)
        best = torch.where(valid, gain, torch.full_like(gain, -math.inf)).reshape(nn, -1).amax(dim=1)
        f, b = sf[heap], sb[heap]
        takes = b < B - 1
        at = gain[torch.arange(nn, device=bins.device), f, b.clamp(max=B - 2)]
        live = Wn > _FLOOR
        node_gap = torch.where(takes, best - at, best.clamp(min=0.0))
        node_gap = torch.where(live, _rel(torch.nan_to_num(node_gap, neginf=0.0), Qn),
                               torch.where(takes, torch.full_like(Qn, math.inf), torch.zeros_like(Qn)))
        gap = max(gap, float(torch.max(node_gap)))
        e = torch.where(takes & live, _rel(torch.abs(prog_gain[heap].to(F64) - at), Qn),
                        torch.zeros_like(Qn))
        err = max(err, float(torch.max(e)))
        val = torch.where(live, Sn / Wn.clamp(min=_FLOOR), parent_val.repeat_interleave(nn // len(parent_val)))
        parent_val = val
        fb = bins.gather(1, f[node][:, None])[:, 0].long()
        node = 2 * node + (fb > b[node]).long()
        del HW, HS, gain, valid
    L = 2**depth
    Wl, Sl = _bincount(node, w, L), _bincount(node, wy, L)
    fallback = parent_val.repeat_interleave(2)
    ref_leaf = torch.where(Wl > _FLOOR, Sl / Wl.clamp(min=_FLOOR), fallback) + ymean
    prog = prog_leaf.reshape(-1).to(F64)
    scale = torch.clamp(torch.abs(ref_leaf), min=float(torch.median(torch.abs(ref_leaf))))
    leaf_err = float(torch.max(_rel(torch.abs(prog - ref_leaf), scale)))
    return gap, err, leaf_err
