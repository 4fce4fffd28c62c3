"""Negative fixture: keys are split or folded before each draw."""

from spark_ensemble_tpu_torch.utils import random as rnd


def draw(key):
    k1, k2 = rnd.split(key)
    a = rnd.uniform(k1, (4,))
    b = rnd.bernoulli(k2, 0.5, (4,))
    return a, b


def per_round(key, rounds):
    # fold_in with distinct data derives distinct children
    return [rnd.uniform(rnd.fold_in(key, i), (4,)) for i in range(rounds)]


def branches(key, flag):
    # mutually exclusive draws are not reuse
    if flag:
        return rnd.uniform(key, (4,))
    return rnd.permutation(key, 4)


def rethreaded(key):
    key, sub = rnd.split(key)
    a = rnd.uniform(sub, (4,))
    key, sub = rnd.split(key)
    b = rnd.uniform(sub, (4,))
    return a, b
