"""Positive fixture: the same key feeds two draws — identical randomness."""

from spark_ensemble_tpu_torch.utils.random import bernoulli, uniform


def draw(key):
    a = uniform(key, (4,))
    b = bernoulli(key, 0.5, (4,))  # reuses `key`: flagged
    return a, b


def fold_twice(key):
    from spark_ensemble_tpu_torch.utils import random as rnd

    a = rnd.fold_in(key, 3)
    b = rnd.fold_in(key, 3)  # the same child key again: flagged
    return a, b
