"""Positive fixture: blocking device reads with no timed fence around them."""

import numpy as np
import torch

from spark_ensemble_tpu_torch.utils.random import uniform


def run(model, X):
    out = model.predict(X)
    torch.cuda.synchronize()  # unfenced host stall: flagged
    return out


def host_copy(model, X):
    return model.predict_proba(X).cpu()  # device -> host fetch: flagged


def as_array(model, X):
    return np.asarray(model.predict(X))  # flagged


def draw_value(key):
    return float(uniform(key))  # a draw read back to the host: flagged


def wait(stream):
    stream.synchronize()  # flagged


def join(futures):
    return [f.result() for f in futures]  # unfenced future join: flagged
