"""Traffic driver ``fit``: whole fits of the config's estimator, back to
back, on one device-resident dataset.

The window runs fits until ``seconds`` have passed and lets the last one
finish; its rate is every round of every fit over all that time, binning
included.  A traced run profiles one whole fit of the window (its
second).  The check draws one fit of the window and ``check_rounds`` of
its rounds (the first always) from the seed, and follows them with the
reference (``benchmark/reference/gbm.py``).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Optional

import torch

from benchmark.harness.data import make_table
from benchmark.harness.trace import Tracer
from benchmark.reference import gbm as ref
from spark_ensemble_tpu_torch.models.gbm import GBMClassifier
from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor

#: the fit of the window that a traced run profiles
TRACED_FIT = 1


def estimator(config: dict, rounds: Optional[int] = None, **tree_overrides) -> GBMClassifier:
    params = dict(config["estimator"])
    if rounds is not None:
        params["num_base_learners"] = int(rounds)
    base = DecisionTreeRegressor(**{**config["base_learner"], **tree_overrides})
    return GBMClassifier(base_learner=base, **params)


@dataclass
class State:
    X: torch.Tensor
    y: torch.Tensor
    est: GBMClassifier
    device: torch.device


def setup(cell, seed: int, device, rows: Optional[int] = None, **tree_overrides) -> State:
    X, y = make_table(cell.config["data"], seed, device, rows)
    warm = estimator(cell.config, cell.mix["warm_rounds"], **tree_overrides)
    warm.fit(X, y, device=device)
    _sync(device)
    return State(X, y, estimator(cell.config, **tree_overrides), torch.device(device))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(cell, state: State, seconds: float, trace: bool, seed: int) -> dict:
    models, rounds, tracer, fit_s = [], 0, None, []
    t0 = time.perf_counter()
    while True:
        t_fit = time.perf_counter()
        if trace and len(models) == TRACED_FIT:
            with Tracer(state.device) as tracer:
                model = state.est.fit(state.X, state.y, device=state.device)
        else:
            model = state.est.fit(state.X, state.y, device=state.device)
            _sync(state.device)
        models.append(model)
        rounds += model.num_members
        elapsed = time.perf_counter() - t0
        fit_s.append(time.perf_counter() - t_fit)
        if elapsed >= seconds and (not trace or tracer is not None):
            break
    summary = None
    if tracer is not None:
        summary = tracer.summary()
        summary.rounds = models[TRACED_FIT].num_members
    return {"attempted": len(models), "failed": 0, "rounds": rounds, "elapsed": elapsed,
            "models": models, "trace": summary, "notes": {"fit_s": fit_s},
            "metrics": {"fit_rounds_per_s": rounds / elapsed}}


def model_arrays(model) -> dict:
    """The program's fitted model as plain tensors: the trees ``[R, K,
    ...]`` and step weights ``[R, K]``."""
    m = model.params["members"]
    return {
        "split_feature": m.split_feature, "split_bin": m.split_bin,
        "split_threshold": m.split_threshold, "split_gain": m.split_gain,
        "leaf_value": m.leaf_value[..., 0], "weights": model.params["weights"],
    }


def check(cell, state: State, result: dict, seed: int) -> dict:
    """The check's numbers for one fit of the window drawn from the seed."""
    rng = random.Random(seed ^ 0x5EED_F17)
    models = result.pop("models")
    model = models[rng.randrange(len(models))]
    del models
    arrays = model_arrays(model)
    R = arrays["weights"].shape[0]
    rounds = [0] + rng.sample(range(1, R), min(R - 1, int(cell.mix["check_rounds"]) - 1))
    del model
    state.est = None
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    return ref.check_fit(
        state.X, state.y, arrays, loss=cell.config["estimator"]["loss"],
        num_classes=int(cell.config["data"]["classes"]),
        max_bins=int(cell.config["base_learner"]["max_bins"]),
        learning_rate=float(cell.config["estimator"]["learning_rate"]), check_rounds=rounds,
    )


def layer_context(cell, state: State, result: dict) -> dict:
    """What the per-layer metrics of a fit cell read besides the trace:
    the fit's shape, ``K`` the model's raw scores a row (trees a round)."""
    base = cell.config["base_learner"]
    return {
        "shape": {"n": state.X.shape[0], "d": state.X.shape[1], "K": int(result["models"][0].dim),
                  "max_bins": int(base["max_bins"]), "depth": int(base["max_depth"])},
    }
